"""Shared inputs for the port's differential tests: configurations in
both packages, seeded signals, and reference states as numpy."""

import dataclasses

import numpy as np

from webaudio_modem_tpu.models import config as jax_config_mod
from webaudio_modem_tpu_torch.models import config as port_config_mod
from webaudio_modem_tpu_torch.ops import fsk_mod as port_mod

BENCH = dict(baud_rate=300, mark_frequency=1270, space_frequency=1070)

CONFIGS = {
    "default": {},
    "bench_300_mark_gt_space": BENCH,
    "even_parity": dict(parity="even"),
    "2400_baud": dict(baud_rate=2400, mark_frequency=1200,
                      space_frequency=2400),
    "ds_over_256": dict(baud_rate=50, mark_frequency=1270,
                        space_frequency=1070),
}


def configs(**overrides):
    """(port FSKConfig, reference FSKConfig, port FSKParams, reference
    FSKParams) for the same settings."""
    pc = port_config_mod.FSKConfig(**overrides)
    jc = jax_config_mod.FSKConfig(**dataclasses.asdict(pc))
    return (pc, jc, port_config_mod.FSKParams.from_config(pc),
            jax_config_mod.FSKParams.from_config(jc))


def add_noise(sig, snr_db, rng):
    """Uniform noise at ``snr_db`` below the signal's power, per row."""
    sig = np.asarray(sig, np.float32)
    power = np.mean(sig.astype(np.float64) ** 2, axis=-1, keepdims=True)
    amp = np.sqrt(3 * power / (10 ** (snr_db / 10)))
    noise = amp * (rng.uniform(size=sig.shape) * 2 - 1)
    return (sig + noise).astype(np.float32)


def random_messages(rng, batch, n_bytes):
    return [bytes(rng.integers(0, 256, n_bytes, dtype=np.uint8))
            for _ in range(batch)]


def signals(params, messages, snr_db=None, rng=None):
    """Port-modulated f32 [B, T] numpy signal (noisy when snr_db given)."""
    sig = port_mod.modulate_batch(params, messages, "cpu").numpy()
    return sig if snr_db is None else add_noise(sig, snr_db, rng)


def reference_fields(state):
    """A reference DemodState as numpy arrays by field name (tuple fields
    stacked, bf16 planes as float32)."""
    out = {}
    for name, value in state._asdict().items():
        if isinstance(value, tuple):
            value = np.stack([np.asarray(v, np.float32) for v in value])
        else:
            value = np.asarray(value)
            if value.dtype.name == "bfloat16":
                value = value.astype(np.float32)
        out[name] = value
    return out
