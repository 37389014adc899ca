"""Channel simulators for loopback tests and BER evaluation.

Counterpart of ``webaudio_modem_tpu/sim/channels.py``.  The noise model
is the reference test helper's (tests/modems/fsk-demodulation.node.test.ts
:1184-1205): uniform noise in [-A, A] with A = sqrt(3 * noise_power), so
the variance equals the requested noise power.  The numpy functions are
copies of the reference's; ``make_device_awgn`` draws the same model on
the frame's device from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch


def signal_power(signal: np.ndarray) -> float:
    signal = np.asarray(signal, dtype=np.float64)
    return float(np.mean(signal * signal))


def awgn(signal: np.ndarray, noise_power: float,
         rng: np.random.RandomState) -> np.ndarray:
    amplitude = np.sqrt(3.0 * noise_power)
    noise = amplitude * (rng.uniform(size=np.shape(signal)) * 2.0 - 1.0)
    return (np.asarray(signal, np.float32)
            + noise.astype(np.float32))


def awgn_snr(signal: np.ndarray, snr_db: float,
             rng: np.random.RandomState,
             reference_power: Optional[float] = None) -> np.ndarray:
    """Add uniform noise at the given SNR relative to the signal power
    (or an explicit reference power for batched/streamed use)."""
    power = signal_power(signal) if reference_power is None \
        else reference_power
    noise_power = power / (10.0 ** (snr_db / 10.0))
    return awgn(signal, noise_power, rng)


def make_awgn_channel(noise_power: float,
                      seed: int = 0) -> Callable[[np.ndarray], np.ndarray]:
    """Streaming AWGN channel function (fixed noise power, since streamed
    quanta have varying signal content)."""
    rng = np.random.RandomState(seed)
    return lambda x: awgn(x, noise_power, rng)


def make_gain(gain: float) -> Callable[[np.ndarray], np.ndarray]:
    return lambda x: (np.asarray(x, np.float32) * np.float32(gain))


def make_dc_offset(offset: float) -> Callable[[np.ndarray], np.ndarray]:
    return lambda x: (np.asarray(x, np.float32) + np.float32(offset))


def make_dropout_channel(drop_probability: float, seed: int = 0,
                         block: int = 128) -> Callable[[np.ndarray],
                                                       np.ndarray]:
    """Randomly zeroes whole blocks — a burst-loss model that forces the
    ARQ layer to retransmit."""
    rng = np.random.RandomState(seed)

    def fn(x):
        x = np.array(x, np.float32, copy=True)
        for start in range(0, len(x), block):
            if rng.uniform() < drop_probability:
                x[start:start + block] = 0.0
        return x

    return fn


def make_device_awgn(noise_power: float):
    """AWGN drawn on the frame's device: ``fn(frame, generator) -> frame``
    adds uniform noise of amplitude sqrt(3 * noise_power) from
    ``generator`` (a ``torch.Generator`` on that device), so a noisy
    stream never exists on the host.  The blind receiver applies it to
    each quantum as its ``channel_fn``."""
    amplitude = float(np.float32(np.sqrt(3.0 * noise_power)))

    def fn(frame: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        u = torch.rand(frame.shape, generator=generator, dtype=torch.float32,
                       device=frame.device)
        return frame + amplitude * (u * 2.0 - 1.0)

    return fn


def make_chain(*fns: Sequence[Callable]) -> Callable[[np.ndarray],
                                                     np.ndarray]:
    def chained(x):
        for f in fns:
            x = f(x)
        return x

    return chained
