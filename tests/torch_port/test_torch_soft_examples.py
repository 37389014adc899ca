"""CPU smoke runs of the port's soft-wire example scripts at tiny
batches: ``farm_endurance.py --soft`` / ``--blind`` (every payload exact,
exit code 0), ``farm_host_cost.py`` (the scheduled soft hub with every
device program stubbed: a round's host cost at B = 256) and
``blind_host_cost.py`` (the blind receiver's host stages with its
device programs stubbed).  The blind smoke runs only the endurance
script's warm-up transfer (``--rounds 0``): each quantum pays K1's plain
version in both directions."""

import asyncio

from webaudio_modem_tpu_torch.examples import (blind_host_cost,
                                               farm_endurance,
                                               farm_host_cost)

ARGS = ["--device", "cpu", "--timeout-ms", "120000"]


def test_endurance_soft(capsys):
    assert farm_endurance.main(["--soft", "--batch", "2", "--rounds", "1",
                                *ARGS]) == 0
    out = capsys.readouterr().out
    assert "over the soft-FEC (conv) wire" in out
    assert "round 1/1: OK" in out and "result: ALL OK" in out
    assert "soft window finalize per decode" in out


def test_endurance_blind(capsys):
    assert farm_endurance.main(["--blind", "--batch", "1", "--rounds", "0",
                                "--payload", "8", *ARGS]) == 0
    out = capsys.readouterr().out
    assert "over the BLIND soft-FEC (conv) wire" in out
    assert "warmup transfer OK" in out and "result: ALL OK" in out


def test_soft_ring_sizing_follows_the_reference():
    from webaudio_modem_tpu_torch.models.config import DEFAULT_FSK_CONFIG

    # a 133-byte XModem packet at 1200 baud: 20 quanta of 4800, plus 2
    assert farm_endurance.soft_ring_quanta(DEFAULT_FSK_CONFIG, 4800) == 22


def test_farm_host_cost_stubbed_round_at_batch_256(capsys):
    out = asyncio.run(farm_host_cost.run(256, 1, 40, 4800))
    assert out["ok"] and out["steps"] > 0
    assert out["timers"]["farm_hub.soft_finalize"][0] > 0
    printed = capsys.readouterr().out
    assert "B=256 x 1 rounds (40 B payloads), device stubbed: ALL OK" \
        in printed
    assert "s per round" in printed


def test_blind_host_cost_stubbed(capsys):
    means = blind_host_cost.run(64, 4)
    assert set(means) == {"collect", "disp_hdr", "fin_hdr", "disp_body",
                          "fin_body", "emit", "total"}
    assert means["total"] > 0
    assert "B=64 cohort-aligned" in capsys.readouterr().out
