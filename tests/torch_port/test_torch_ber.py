"""BASELINE config 2 in the port: the Bell-202 BER harness (``sim/ber.py``)
and its golden comparator (``golden/fsk_golden.py``), mirroring
``tests/modems/test_v21_and_ber.py``'s ``TestBitErrors`` and
``TestBERSweep`` on the CPU, and held against the JAX package's harness
on the same seeds.

The CPU runs K1's plain version at ~0.3 ms a sample whatever the batch,
so a sweep point costs about a second (3,280 samples); the sweeps that
several tests read are made once per module.
"""

import numpy as np
import pytest

from webaudio_modem_tpu.golden import GoldenFSK as JaxGoldenFSK
from webaudio_modem_tpu.models.config import FSKConfig as JaxFSKConfig
from webaudio_modem_tpu.sim import ber as jax_ber
from webaudio_modem_tpu_torch.golden import GoldenFSK
from webaudio_modem_tpu_torch.models.config import FSKConfig
from webaudio_modem_tpu_torch.sim import ber
from webaudio_modem_tpu_torch.sim.ber import (BERPoint, ber_parity_report,
                                              ber_sweep, bit_errors,
                                              clean_signal, golden_demodulate,
                                              noisy_batch)
from webaudio_modem_tpu_torch.sim.channels import awgn_snr

BELL202_KW = dict(baud_rate=1200, mark_frequency=1200.0,
                  space_frequency=2200.0)
BELL202 = FSKConfig(**BELL202_KW)
PARITY_SNRS = [30.0, 10.0, -6.0]


def _fields(points):
    return [(p.snr_db, p.messages, p.byte_errors, p.bit_errors,
             p.total_bits) for p in points]


@pytest.fixture(scope="module")
def parity_sweep():
    """The port's sweep at 30 / 10 / -6 dB, seed 99, six messages a
    point (the reference suite's failure-region setting)."""
    return ber_sweep(BELL202, PARITY_SNRS, messages_per_point=6, seed=99,
                     device="cpu")


class TestBitErrors:
    def test_exact(self):
        assert bit_errors(b"abc", b"abc") == 0

    def test_single_bit(self):
        assert bit_errors(b"\x00", b"\x01") == 1

    def test_length_mismatch(self):
        assert bit_errors(b"ab", b"a") == 8

    def test_empty_decoded(self):
        assert bit_errors(b"ab", b"") == 16

    def test_matches_reference(self):
        rng = np.random.default_rng(4)
        for _ in range(20):
            a = bytes(rng.integers(0, 256, rng.integers(0, 6), np.uint8))
            b = bytes(rng.integers(0, 256, rng.integers(0, 6), np.uint8))
            assert bit_errors(a, b) == jax_ber.bit_errors(a, b)


class TestBERSweep:
    def test_clean_decode_at_high_snr(self, parity_sweep):
        pt = parity_sweep[0]
        assert pt.snr_db == 30.0
        assert pt.ber == 0.0
        assert pt.fer == 0.0

    def test_ber_monotone_with_snr(self, parity_sweep):
        bers = [p.ber for p in parity_sweep]
        assert bers == sorted(bers)
        assert bers[-1] > 0

    def test_device_parity_with_golden(self):
        snrs = [30.0]
        ours = ber_sweep(BELL202, snrs, messages_per_point=3, seed=7,
                         device="cpu")
        gold = ber_sweep(BELL202, snrs, messages_per_point=3, seed=7,
                         demodulate=golden_demodulate(BELL202))
        assert ours[0].ber == gold[0].ber == 0.0

    def test_device_parity_in_failure_region(self, parity_sweep):
        # deep degradation (-6 dB): the port and the golden model make the
        # SAME errors on the same noise
        gold = ber_sweep(BELL202, [-6.0], messages_per_point=6, seed=99,
                         demodulate=golden_demodulate(BELL202))
        ours = parity_sweep[-1]
        assert ours.bit_errors == gold[0].bit_errors
        assert ours.byte_errors == gold[0].byte_errors
        assert ours.bit_errors > 0  # genuinely in the failure region

    def test_point_properties(self):
        p = BERPoint(snr_db=10, messages=4, byte_errors=1, bit_errors=3,
                     total_bits=96)
        assert p.fer == 0.25
        assert abs(p.ber - 3 / 96) < 1e-12


def test_sweep_equals_the_jax_packages_on_the_same_seed(parity_sweep):
    """Bit and byte errors of every point exactly as the JAX package's
    ``ber_sweep`` counts them on the same seed."""
    ref = jax_ber.ber_sweep(JaxFSKConfig(**BELL202_KW), PARITY_SNRS,
                            messages_per_point=6, seed=99)
    assert _fields(parity_sweep) == _fields(ref)


def test_noise_is_the_reference_noise(monkeypatch):
    """The same RandomState draws as the reference harness: the noisy
    signals differ only by the two modulators' float32 sines (1e-5)."""
    from webaudio_modem_tpu.models.config import FSKParams as JaxParams
    from webaudio_modem_tpu.ops import fsk_mod as jax_mod
    from webaudio_modem_tpu.sim.channels import awgn_snr as jax_awgn_snr

    clean = clean_signal(BELL202, b"\x55\x0f\xa3\xc1")
    ref_clean = np.asarray(jax_mod.modulate(
        JaxParams.from_config(JaxFSKConfig(**BELL202_KW)),
        b"\x55\x0f\xa3\xc1"))
    assert clean.shape == ref_clean.shape == (3280,)
    snr = -6.0
    ours = noisy_batch(clean, snr, 4, seed=99)
    rng = np.random.RandomState(99 + int(snr * 1000) % 99991)
    ref = np.stack([jax_awgn_snr(ref_clean, snr, rng) for _ in range(4)])
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    # the batched draws equal one awgn_snr per message, exactly; a subset
    # is the first rows of the full batch
    rng = np.random.RandomState(99 + int(snr * 1000) % 99991)
    loop = np.stack([awgn_snr(clean, snr, rng) for _ in range(5)])
    monkeypatch.setattr(ber, "_ROWS_PER_DRAW", 2)
    np.testing.assert_array_equal(noisy_batch(clean, snr, 5, seed=99), loop)
    np.testing.assert_array_equal(noisy_batch(clean, snr, 2, seed=99),
                                  ours[:2])


@pytest.mark.parametrize("snr", [20.0, 3.0, -6.0])
def test_golden_copy_decodes_like_the_jax_packages(snr):
    """The port's GoldenFSK and the JAX package's on the same signals,
    three messages at three SNRs, and with parity and mark > space."""
    cases = [(BELL202_KW, b"\x55\x0f\xa3\xc1"),
             (dict(parity="even"), b"\x3c\x81"),
             (dict(baud_rate=300, mark_frequency=1270,
                   space_frequency=1070), b"\x42")]
    for kw, msg in cases:
        clean = clean_signal(FSKConfig(**kw), msg)
        for row in noisy_batch(clean, snr, 3, seed=5):
            got = GoldenFSK(FSKConfig(**kw)).demodulate(row)
            want = JaxGoldenFSK(JaxFSKConfig(**kw)).demodulate(row)
            assert got == want, (kw, snr)


def test_parity_report_pairs_the_curves():
    report = ber_parity_report(BELL202, [25.0], messages_per_point=2,
                               seed=3, device="cpu")
    assert set(report) == {"device", "golden"}
    assert _fields(report["device"]) == _fields(report["golden"])
    assert report["device"][0].fer == 0.0
