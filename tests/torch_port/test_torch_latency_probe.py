"""The port's ``examples/latency_probe.py`` against the reference's own
latency table (docs/PERFORMANCE.md, "ARQ latency, measured"): one
XModem transfer of a 32-byte payload at 1200 baud is 520 ms of audio on
the interactive path at the 128-sample quantum and 1300 ms on the hard
farm hub at B = 16 and the 4800-sample quantum, over a decode floor of
483 ms; 2500 ms on the soft farm hub at B = 16 over the soft wire's
decode floor of 1193 ms.  Audio-time latency counts quanta, so the port must come out
exactly so on the CPU as on any card.  The farm probe measures, as the
reference's does, the transfer after a warm-up transfer (a fresh hub's
first transfer takes one quantum more, 1400 ms, in both packages); the
interactive path's first transfer already takes the table's 520 ms, so
that probe runs it alone."""

import asyncio

import pytest

from webaudio_modem_tpu_torch.examples import latency_probe


def test_interactive_transfer_latency_matches_the_reference_row():
    r = asyncio.run(latency_probe.interactive_probe(
        32, 128, reps=1, device="cpu", warmup=False))
    assert round(r["audio_latency_s"] * 1e3) == 520
    assert round(r["decode_floor_s"] * 1e3) == 483
    assert r["quantum"] == 128


def test_hard_farm_transfer_latency_matches_the_reference_row():
    r = asyncio.run(latency_probe.farm_probe(
        "hard", 16, 32, 4800, reps=1, noise=0.0, device="cpu"))
    assert round(r["audio_latency_s"] * 1e3) == 1300
    assert round(r["decode_floor_s"] * 1e3) == 483
    assert r["topology"].startswith("hard farm hub, B=16")


def test_soft_farm_transfer_latency_matches_the_reference_row():
    r = asyncio.run(latency_probe.farm_probe(
        "soft", 16, 32, 4800, reps=1, noise=0.0, device="cpu"))
    assert round(r["audio_latency_s"] * 1e3) == 2500
    assert round(r["decode_floor_s"] * 1e3) == 1193
    assert r["topology"].startswith("soft farm hub, B=16")


@pytest.mark.parametrize("kind", ["soft", "blind"])
def test_soft_and_blind_hubs_name_their_roadmap_item(kind):
    """The soft and blind hubs run (item 12); their RS outer code and
    block body codes are slice E (item 14) and raise, naming it."""
    for kw in ({"rs_parity": 8}, {"body_code": object()}):
        with pytest.raises(NotImplementedError, match="item 14"):
            asyncio.run(latency_probe.farm_probe(
                kind, 2, 32, 4800, 1, 0.0, device="cpu", **kw))


def test_endurance_soft_and_blind_name_their_roadmap_item():
    from webaudio_modem_tpu_torch.examples import farm_endurance

    for flag in ("--soft", "--blind"):
        for opt in (["--rs-parity", "8"], ["--body", "ldpc"]):
            with pytest.raises(NotImplementedError, match="item 14"):
                farm_endurance.main([flag, *opt, "--device", "cpu"])
