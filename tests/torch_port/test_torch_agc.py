"""The port's copy of tests/modems/test_agc.py: the AGC recurrence,
driven from a fresh state in the reference's call form
``fsk_demod.init_state(PARAMS, batch=1)`` (device by keyword), against
the golden scalar implementation."""

import numpy as np
import torch

from webaudio_modem_tpu_torch.golden.fsk_golden import GoldenFSK
from webaudio_modem_tpu_torch.models.config import (DEFAULT_FSK_CONFIG,
                                                    FSKParams)
from webaudio_modem_tpu_torch.ops import fsk_demod

PARAMS = FSKParams.from_config(DEFAULT_FSK_CONFIG)


def _run_kernel_agc(samples):
    """Drive only the AGC portion of the full-rate step and return the
    gained samples + final gain."""
    state = fsk_demod.init_state(PARAMS, batch=1, device="cpu")
    g = state.front[0]          # AGC gain row, [1]
    f32 = torch.float32
    target = torch.tensor(PARAMS.agc_target, dtype=f32)
    outs = []
    for s in samples:
        x = torch.tensor([np.float32(s)], dtype=f32)
        y = x * g
        level = torch.abs(y)
        tgt = target / torch.clamp(level, min=1e-30)
        rate = torch.where(level > target,
                           torch.tensor(PARAMS.agc_attack, dtype=f32),
                           torch.tensor(PARAMS.agc_release, dtype=f32))
        g = torch.where(level > 0,
                        torch.clamp(g + (tgt - g) * rate, 0.1, 10.0), g)
        outs.append(float(y[0]))
    return np.array(outs), float(g[0])


def test_agc_amplifies_quiet_signal():
    t = np.arange(4800)
    quiet = (0.05 * np.sin(2 * np.pi * 1750 * t / 48000)).astype(np.float32)
    out, gain = _run_kernel_agc(quiet)
    assert gain > 3.0  # gain rises toward target/|x| ~ 10
    assert np.abs(out[-400:]).max() > 0.3  # output pulled toward 0.5


def test_agc_attenuates_loud_signal():
    t = np.arange(2400)
    loud = (3.0 * np.sin(2 * np.pi * 1750 * t / 48000)).astype(np.float32)
    out, gain = _run_kernel_agc(loud)
    # on a pure sine target/|y| explodes near every zero crossing and the
    # clamp slams the gain to 10: parity with the golden model, not a
    # smooth-AGC intuition
    assert 0.1 <= gain <= 10.0
    golden = GoldenFSK(DEFAULT_FSK_CONFIG)
    np.testing.assert_allclose(out, golden._agc(loud.copy()), rtol=2e-3,
                               atol=2e-3)


def test_agc_gain_clamped():
    tiny = np.full(2000, 1e-4, np.float32)
    _, gain = _run_kernel_agc(tiny)
    assert gain <= 10.0 + 1e-5


def test_agc_zero_input_keeps_gain():
    _, gain = _run_kernel_agc(np.zeros(100, np.float32))
    assert gain == 1.0


def test_agc_matches_golden_exactly_enough():
    rng = np.random.RandomState(3)
    sig = (0.2 * rng.uniform(-1, 1, 1000)).astype(np.float32)
    golden = GoldenFSK(DEFAULT_FSK_CONFIG)
    gold_out = golden._agc(sig.copy())
    kern_out, _ = _run_kernel_agc(sig)
    np.testing.assert_allclose(kern_out, gold_out, atol=2e-4)
