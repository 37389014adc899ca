"""The port's decode under the reference suite's impairments and
false-positive inputs (tests/modems/test_fsk_demodulation.py), held
against the golden scalar model.

All cases ride one ModemFarm call, one channel each (padded with
silence to a common length), so the CPU pays the plain path's per-step
cost once; each case is its own test.  Decoded bytes and the sync and
EOD counts must equal the golden model's.
"""

import numpy as np
import pytest

from torch_port_helpers import configs
from webaudio_modem_tpu.golden import GoldenFSK
from webaudio_modem_tpu_torch.models.farm import ModemFarm
from webaudio_modem_tpu_torch.ops import fsk_mod


def _add_noise(sig, snr_db, rng):
    power = float(np.mean(sig.astype(np.float64) ** 2))
    amp = np.sqrt(3 * power / (10 ** (snr_db / 10)))
    return (sig + amp * (rng.uniform(size=len(sig)) * 2 - 1)).astype(
        np.float32)


def _cases(pp):
    mod = lambda data: fsk_mod.modulate(pp, data, "cpu")  # noqa: E731
    f32 = np.float32
    hel = mod(b"\x48\x65\x6c")
    b42 = mod(b"\x42")
    n = len(hel)
    t = np.arange(n)
    return {
        "clean": hel,
        "noise_30db": _add_noise(hel, 30, np.random.RandomState(1234)),
        "noise_20db": _add_noise(mod(b"\x48"), 20,
                                 np.random.RandomState(5678)),
        "amplitude_0.1": b42 * f32(0.1),
        "amplitude_0.3": b42 * f32(0.3),
        "dc_offset": b42 * f32(0.3) + f32(0.2),
        "combined": np.concatenate([
            np.zeros(313, f32),
            _add_noise(mod(b"\x5a\xa5") * f32(0.25), 28,
                       np.random.RandomState(77)) + f32(0.1)]),
        "silence_prefix": np.concatenate([np.zeros(1000, f32), b42]),
        "two_frames_gap": np.concatenate([mod(b"\x11"), np.zeros(2400, f32),
                                          mod(b"\x22")]),
        "silence": np.zeros(n, f32),
        "dc": np.full(n, 0.5, f32),
        "off_band_tone": np.sin(2 * np.pi * 400 * t / 48000.0).astype(f32),
        "square_wave": np.where((t // 100) % 2 == 0, 0.8, -0.8).astype(f32),
        "uniform_noise": np.random.RandomState(42).uniform(
            -1, 1, n).astype(f32),
    }


@pytest.fixture(scope="module")
def decoded():
    pc, jc, pp, _ = configs()
    cases = _cases(pp)
    L = max(len(s) for s in cases.values())
    x = np.stack([np.pad(s, (0, L - len(s))) for s in cases.values()])
    farm = ModemFarm(pc, len(cases), device="cpu")
    out = farm.demodulate(x, chunk_size=1001)
    status = farm.get_status()
    port, golden = {}, {}
    for b, name in enumerate(cases):
        port[name] = (out[b], int(status["sync_detections"][b]),
                      int(status["eod_events"][b]))
        g = GoldenFSK(jc)
        golden[name] = (g.demodulate(x[b]), g.sync_detections, g.eod_events)
    return port, golden


CASES = ["clean", "noise_30db", "noise_20db", "amplitude_0.1",
         "amplitude_0.3", "dc_offset", "combined", "silence_prefix",
         "two_frames_gap", "silence", "dc", "off_band_tone", "square_wave",
         "uniform_noise"]

EXPECTED = {"clean": b"\x48\x65\x6c", "noise_30db": b"\x48\x65\x6c",
            "amplitude_0.1": b"\x42", "amplitude_0.3": b"\x42",
            "dc_offset": b"\x42", "combined": b"\x5a\xa5",
            "silence_prefix": b"\x42", "two_frames_gap": b"\x11\x22",
            "silence": b"", "dc": b"", "off_band_tone": b"",
            "square_wave": b""}


@pytest.mark.parametrize("name", CASES)
def test_matches_golden(decoded, name):
    port, golden = decoded
    assert port[name] == golden[name]
    if name in EXPECTED:
        assert port[name][0] == EXPECTED[name]
    if name == "uniform_noise":
        assert len(port[name][0]) <= 1
