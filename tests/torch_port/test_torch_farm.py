"""ModemFarm and FSKCore of the port against their reference
counterparts, on the CPU: decoded bytes, status, reset semantics and
chunking invariance."""

import dataclasses

import numpy as np
import pytest

from torch_port_helpers import configs, random_messages
from webaudio_modem_tpu.models.farm import ModemFarm as JaxFarm
from webaudio_modem_tpu.models.fsk import FSKCore as JaxCore
from webaudio_modem_tpu_torch.models.farm import ModemFarm
from webaudio_modem_tpu_torch.models.fsk import FSKCore
from webaudio_modem_tpu_torch.models.psk import PSKConfig
from webaudio_modem_tpu_torch.ops.fsk_demod import max_bytes

B = 8


@pytest.fixture(scope="module")
def farm_case():
    pc, jc, pp, _ = configs()
    msgs = random_messages(np.random.default_rng(31), B, 3)
    farm = ModemFarm(pc, B, device="cpu")
    sig = farm.modulate(msgs)
    return pc, jc, msgs, sig


def test_farm_decodes_like_reference(farm_case):
    pc, jc, msgs, sig = farm_case
    farm = ModemFarm(pc, B, device="cpu")
    ref = JaxFarm(jc, B, donate=False)
    x = sig.numpy()
    assert farm.demodulate(x, chunk_size=1000) == msgs
    assert ref.demodulate(x, chunk_size=1000) == msgs
    got, want = farm.get_status(), ref.get_status()
    assert got["batch"] == want["batch"] == B
    for key in ("sync_detections", "eod_events", "frames_started"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for q_port, q_ref in zip(farm.get_signal_quality(),
                             ref.get_signal_quality()):
        for field in ("snr", "ber", "eye_opening", "phase_jitter",
                      "frequency_offset"):
            assert getattr(q_port, field) == pytest.approx(
                getattr(q_ref, field), abs=0.05), field


def test_farm_chunking_invariance_and_reset(farm_case):
    pc, _, msgs, sig = farm_case
    farm = ModemFarm(pc, B, device="cpu")
    assert farm.demodulate(sig) == msgs
    farm.reset()
    assert farm.get_status()["sync_detections"].tolist() == [0] * B
    assert farm.demodulate_stream(sig, chunk_size=777) == msgs
    farm.reset()
    out = farm.demodulate_chunk(sig[:, :1001])
    assert out.bytes_out.shape == (B, max_bytes(farm.params, 500))
    assert farm.collect_bytes(out) == [b""] * B


def test_farm_rejects_unported_options():
    pc, _, _, _ = configs()
    with pytest.raises(NotImplementedError, match="slice G"):
        ModemFarm(pc, B, device="cpu", mesh=object())

    @dataclasses.dataclass
    class PSKLike:
        baud_rate: int = 1200
    with pytest.raises(NotImplementedError, match="FSKConfig or a PSKConfig"):
        ModemFarm(PSKLike(), B, device="cpu")


def test_farm_takes_psk_config():
    """A PSKConfig selects the DBPSK family: its state carries the delay
    ring, and its parameters put mark and space on the carrier."""
    farm = ModemFarm(PSKConfig(), B, device="cpu")
    assert farm.params.mark_freq == farm.params.space_freq == 1800.0
    assert farm.state.ring.shape == (2 * farm.params.ds_samples_per_bit, B)
    assert farm.state.front.shape == (15, B)


def _status_without_threshold(status):
    status = dict(status)
    return status.pop("silence_threshold"), status


def test_core_matches_reference_with_reset_quirks():
    pc, jc, _, _ = configs()
    core, ref = FSKCore(pc, device="cpu"), JaxCore(jc)
    data = b"RST"
    sig = core.modulate_data(data)
    np.testing.assert_allclose(sig, ref.modulate_data(data), atol=1e-5)
    cut = len(sig) // 3           # mid-flight: amp window and AGC warm
    assert core.demodulate_data(sig[:cut]) == ref.demodulate_data(sig[:cut])
    core.reset()
    ref.reset()
    assert core.demodulate_data(sig) == ref.demodulate_data(sig) == data
    thr_c, st_c = _status_without_threshold(core.get_status())
    thr_r, st_r = _status_without_threshold(ref.get_status())
    assert st_c == st_r
    assert thr_c == pytest.approx(thr_r, rel=1e-5)

    # an abandoned frame leaves no residue after reset, and the silence
    # threshold survives configure()
    core.demodulate_data(sig[:len(sig) * 2 // 3])
    ref.demodulate_data(sig[:len(sig) * 2 // 3])
    core.configure(pc)
    ref.configure(jc)
    assert core.get_status()["silence_threshold"] == pytest.approx(
        ref.get_status()["silence_threshold"], rel=1e-5)
    assert not core.get_status()["frame_started"]
    assert core.demodulate_data(sig) == ref.demodulate_data(sig) == data
    q_c, q_r = core.get_signal_quality(), ref.get_signal_quality()
    assert q_c.ber == q_r.ber
    assert q_c.snr == pytest.approx(q_r.snr, abs=0.05)


def test_core_chunking_invariance():
    pc, _, _, _ = configs()
    core = FSKCore(pc, device="cpu")
    data = b"\x00\xffHi"
    sig = core.modulate_data(data)
    whole = core.demodulate_data(sig)
    core.reset()
    pieces = b"".join(core.demodulate_data(sig[s:s + 333])
                      for s in range(0, len(sig), 333))
    assert whole == pieces == data
    assert core.get_status()["demodulation_calls"] == -(-len(sig) // 333)
