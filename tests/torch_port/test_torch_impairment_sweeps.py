"""The impairment sweeps of the port (``sim/impairments.py``): carrier
offset and sample-clock skew, mirroring ``tests/modems/test_impairments.py``
at two or three points per sweep, on the CPU, and held against the golden
scalar comparator and the JAX package's resampler.
"""

import numpy as np

from webaudio_modem_tpu.sim import impairments as jax_impairments
from webaudio_modem_tpu_torch.models.config import FSKConfig
from webaudio_modem_tpu_torch.sim.ber import golden_demodulate
from webaudio_modem_tpu_torch.sim.impairments import (ImpairmentPoint,
                                                      carrier_offset_sweep,
                                                      clock_skew,
                                                      clock_skew_sweep)

MSG = b"\x6b\x2e\x91\xd4"


class TestClockSkewResample:
    def test_identity_at_zero(self):
        sig = np.sin(np.arange(300, dtype=np.float32) * 0.13)
        assert np.array_equal(clock_skew(sig, 0.0), sig)

    def test_fast_clock_shortens(self):
        sig = np.sin(np.arange(1000, dtype=np.float32) * 0.05)
        out = clock_skew(sig, 0.01)
        assert len(out) == int(1000 / 1.01)

    def test_small_skew_close_to_input(self):
        sig = np.sin(np.arange(1000, dtype=np.float32) * 0.05)
        out = clock_skew(sig, 1e-5)
        n = len(out)
        assert np.allclose(out[: n // 2], sig[: n // 2], atol=1e-3)

    def test_equals_the_reference(self):
        sig = np.sin(np.arange(2000, dtype=np.float32) * 0.07)
        for eps in (0.0, 3e-4, 0.01, -0.004):
            np.testing.assert_array_equal(
                clock_skew(sig, eps), jax_impairments.clock_skew(sig, eps))


class TestCarrierOffsetEnvelope:
    def test_hard_path_tolerates_10hz(self):
        pts = carrier_offset_sweep(FSKConfig(), [0.0, 10.0],
                                   message=MSG, messages_per_point=4,
                                   snr_db=None, device="cpu")
        assert all(p.fer == 0.0 for p in pts)

    def test_hard_path_fails_far_off(self):
        (p,) = carrier_offset_sweep(FSKConfig(), [120.0], message=MSG,
                                    messages_per_point=2, snr_db=None,
                                    device="cpu")
        assert p.fer == 1.0

    def test_device_matches_golden_under_offset(self):
        # degradation parity on identical impaired signals, including a
        # failing point
        cfg = FSKConfig()
        kw = dict(message=MSG, messages_per_point=4, snr_db=30.0, seed=3)
        ours = carrier_offset_sweep(cfg, [20.0, 60.0], device="cpu", **kw)
        gold = carrier_offset_sweep(cfg, [20.0, 60.0],
                                    demodulate=golden_demodulate(cfg), **kw)
        assert [(p.fer, p.ber) for p in ours] \
            == [(p.fer, p.ber) for p in gold]
        assert ours[1].fer > 0

    def test_soft_path_tolerates_40hz(self):
        (p,) = carrier_offset_sweep(FSKConfig(), [40.0], message=MSG,
                                    messages_per_point=2, snr_db=None,
                                    soft=True, device="cpu")
        assert p.fer == 0.0


class TestClockSkewEnvelope:
    def test_hard_path_tolerates_2000ppm(self):
        pts = clock_skew_sweep(FSKConfig(), [0.0, 0.002], message=MSG,
                               messages_per_point=4, snr_db=None,
                               device="cpu")
        assert all(p.fer == 0.0 for p in pts)

    def test_hard_path_fails_at_2pct(self):
        (p,) = clock_skew_sweep(FSKConfig(), [0.02], message=MSG,
                                messages_per_point=2, snr_db=None,
                                device="cpu")
        assert p.fer == 1.0

    def test_device_matches_golden_under_skew(self):
        cfg = FSKConfig()
        kw = dict(message=MSG, messages_per_point=4, snr_db=30.0, seed=5)
        ours = clock_skew_sweep(cfg, [0.005, 0.01], device="cpu", **kw)
        gold = clock_skew_sweep(cfg, [0.005, 0.01],
                                demodulate=golden_demodulate(cfg), **kw)
        assert [(p.fer, p.ber) for p in ours] \
            == [(p.fer, p.ber) for p in gold]

    def test_soft_path_tolerates_2000ppm(self):
        (p,) = clock_skew_sweep(FSKConfig(), [0.002], message=MSG,
                                messages_per_point=2, snr_db=None,
                                soft=True, device="cpu")
        assert p.fer == 0.0


def test_point_properties():
    p = ImpairmentPoint(value=20.0, messages=4, frame_errors=1, bit_errs=6,
                        total_bits=128)
    assert p.fer == 0.25
    assert abs(p.ber - 6 / 128) < 1e-12
