"""Biquad filter design: the port's copy of the design functions of
``webaudio_modem_tpu/ops/filters.py`` that ``models/config.py`` calls.

2nd-order Butterworth low-pass and band-pass via the bilinear
transform, and the a0 normalization, coefficient-identical to the
reference (numpy-free float64 arithmetic in the same order).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

SQRT2 = math.sqrt(2.0)


def butterworth_lowpass(cutoff_freq: float,
                        sample_rate: float) -> Tuple[List[float], List[float]]:
    nyquist = sample_rate / 2.0
    normalized = cutoff_freq / nyquist
    c = math.tan(math.pi * normalized / 2.0)
    c2 = c * c
    sqrt2c = SQRT2 * c
    denom = 1.0 + sqrt2c + c2
    b = [c2 / denom, 2.0 * c2 / denom, c2 / denom]
    a = [1.0, (2.0 * c2 - 2.0) / denom, (1.0 - sqrt2c + c2) / denom]
    return b, a


def butterworth_bandpass(center_freq: float, bandwidth: float,
                         sample_rate: float) -> Tuple[List[float], List[float]]:
    omega = 2.0 * math.pi * center_freq / sample_rate
    bw = 2.0 * math.pi * bandwidth / sample_rate
    c = math.tan(bw / 2.0)
    d = 2.0 * math.cos(omega)
    c2 = c * c
    denom = 1.0 + c + c2
    b = [c / denom, 0.0, -c / denom]
    a = [1.0, (-d * (1.0 + c2)) / denom, (1.0 - c + c2) / denom]
    return b, a


def normalize_biquad(b: Sequence[float],
                     a: Sequence[float]) -> Tuple[float, float, float,
                                                  float, float]:
    """Normalize so a[0] == 1 and return (b0, b1, b2, a1, a2)."""
    a0 = a[0]
    if a0 == 0:
        raise ValueError("a[0] cannot be zero")
    b = [x / a0 for x in b] + [0.0] * (3 - len(b))
    a = [x / a0 for x in a] + [0.0] * (3 - len(a))
    return (b[0], b[1], b[2], a[1], a[2])
