"""The port's copy of tests/modems/test_fsk_modulation.py (the batched
modulator), in the reference's call form ``fsk_mod.modulate(PARAMS,
data)`` with the device by keyword (the CPU here)."""

import numpy as np
import pytest

from webaudio_modem_tpu_torch.models.config import (DEFAULT_FSK_CONFIG,
                                                    FSKConfig, FSKParams,
                                                    _framed_bits)
from webaudio_modem_tpu_torch.ops import fsk_mod

PARAMS = FSKParams.from_config(DEFAULT_FSK_CONFIG)


def _mod(data, params=PARAMS):
    return fsk_mod.modulate(params, data, device="cpu")


def test_signal_length_formula():
    for n in (0, 1, 5, 13):
        sig = _mod(bytes(n))
        assert len(sig) == fsk_mod.signal_length(PARAMS, n)


def test_amplitude_bounds():
    sig = _mod(b"\x55")
    assert sig.max() <= 1.1
    assert sig.min() >= -1.1
    assert sig.max() > 0.8
    assert sig.min() < -0.8


@pytest.mark.parametrize("data", [b"\x3c", b"\x0f", b"\xf0"])
def test_phase_continuity(data):
    sig = _mod(data)
    assert np.abs(np.diff(sig.astype(np.float64))).max() < 0.5


def test_leading_padding_and_trailing_silence():
    sig = _mod(b"\x42")
    pad = PARAMS.samples_per_bit * 2
    silence = PARAMS.bits_per_byte * PARAMS.samples_per_bit
    assert np.all(sig[:pad] == 0)
    assert np.all(sig[-silence:] == 0)
    assert np.abs(sig[pad:pad + 100]).max() > 0.5


def test_matches_golden_modulator():
    # the batched synthesis against the scalar golden modulator: same
    # phase law, different evaluation order
    from webaudio_modem_tpu_torch.golden import GoldenFSK

    g = GoldenFSK(DEFAULT_FSK_CONFIG)
    data = b"Hello, World!"
    ref = g.modulate(data)
    sig = _mod(data)
    assert sig.shape == ref.shape
    np.testing.assert_allclose(sig, ref, atol=2e-4)


def test_batch_modulation_matches_single():
    msgs = [b"abc", b"xyz"]
    batch = fsk_mod.modulate_batch(PARAMS, msgs, device="cpu").numpy()
    for i, m in enumerate(msgs):
        np.testing.assert_array_equal(batch[i], _mod(m))


def test_different_patterns_differ_but_same_length():
    s1 = _mod(b"\x0f")
    s2 = _mod(b"\xf0")
    assert len(s1) == len(s2)
    diff_frac = np.mean(np.abs(s1 - s2) > 0.1)
    assert diff_frac > 0.10


def test_framed_table_matches_direct():
    # the 256-entry framing table equals per-byte _framed_bits for every
    # byte, including parity configs
    for parity in ("none", "even", "odd"):
        cfg = FSKConfig(parity=parity)
        table = fsk_mod._framed_table(cfg)
        for v in (0, 1, 0x55, 0x7E, 0xAA, 0xFF, 137):
            assert tuple(table[v]) == _framed_bits(v, cfg), (parity, v)


def test_int_phase_tables_match_float64():
    # the exact integer phase prefix (the production path for integer
    # frequencies) against the float64 host tables: the same phases mod
    # 2*pi to float32 rounding, near-identical signals
    for baud, mark, space in ((1200, 1650, 1850), (300, 1270, 1070)):
        params = FSKParams.from_config(FSKConfig(
            baud_rate=baud, mark_frequency=mark, space_frequency=space))
        msgs = [b"Ab\x00\xff", b"\x55\x7e\x7e\x55"]
        bits = fsk_mod.frame_bits_batch(params, msgs)
        off64, om64 = fsk_mod._phase_tables(params, bits)
        acc = fsk_mod._phase_acc_int(params, bits)
        off32 = (acc.astype(np.float32)
                 * np.float32(2 * np.pi / params.sample_rate))
        # circular comparison: an exact-integer zero and a float64 value
        # infinitesimally below 2*pi are the same phase
        d = np.abs(off32 - off64)
        d = np.minimum(d, 2 * np.pi - d)
        assert d.max() < 2e-4
        lead = params.samples_per_bit * 2
        trail = params.bits_per_byte * params.samples_per_bit
        ref = fsk_mod._synth(off64, om64, params.samples_per_bit,
                             (lead, trail), "cpu")
        import torch

        prod = fsk_mod._synth_int(torch.from_numpy(acc),
                                  torch.from_numpy(bits),
                                  int(params.sample_rate),
                                  float(params.mark_freq),
                                  float(params.space_freq),
                                  params.samples_per_bit, (lead, trail))
        np.testing.assert_allclose(prod.numpy(), ref.numpy(), atol=5e-4)
        np.testing.assert_array_equal(
            prod.numpy(),
            fsk_mod.modulate_batch(params, msgs, device="cpu").numpy())


class TestFrameBitsBatchValidation:
    """frame_bits_batch is a public batch API and validates its own
    inputs rather than rely on callers."""

    def test_empty_message_list_rejected(self):
        with pytest.raises(ValueError, match="at least one"):
            fsk_mod.frame_bits_batch(PARAMS, [])

    def test_unequal_lengths_rejected(self):
        # total byte count divisible by B: would silently mis-reshape
        with pytest.raises(ValueError, match="equal-length"):
            fsk_mod.frame_bits_batch(PARAMS, [b"abc", b"a"])
