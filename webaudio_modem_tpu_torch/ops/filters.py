"""Filters: the port's copy of what it uses of
``webaudio_modem_tpu/ops/filters.py``.

* Biquad design (``models/config.py``): 2nd-order Butterworth low-pass
  and band-pass via the bilinear transform, and the a0 normalization,
  coefficient-identical to the reference (numpy-free float64 arithmetic
  in the same order).
* Windowed-sinc FIR design (``sinc_lowpass`` / ``highpass`` /
  ``bandpass``, numpy float64, copies of the reference's), which
  ``models/v21.py`` uses for its channel-separation filter.
* Batched streaming filters in torch on the input's device:
  ``fir_apply`` (a ``conv1d`` over the carried history and the new
  samples, in full float32) and ``biquad_scan`` (a plain loop over time).
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from webaudio_modem_tpu_torch.utils.device import resolve_device

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


# ---------------------------------------------------------------------------
# FIR design (reference FilterDesign.sinc*, filters.ts:243-314)
# ---------------------------------------------------------------------------

def sinc_lowpass(cutoff_freq: float, sample_rate: float,
                 num_taps: int) -> np.ndarray:
    if num_taps % 2 == 0:
        num_taps += 1  # odd-tap enforcement (filters.ts:244-246)
    normalized = cutoff_freq / sample_rate
    center = (num_taps - 1) // 2
    i = np.arange(num_taps, dtype=np.float64)
    x = np.pi * (i - center)
    with np.errstate(invalid="ignore", divide="ignore"):
        coeffs = np.sin(2.0 * normalized * x) / x
    coeffs[center] = 2.0 * normalized
    # Hamming window (filters.ts:261)
    coeffs *= 0.54 - 0.46 * np.cos(2.0 * np.pi * i / (num_taps - 1))
    return coeffs


def sinc_highpass(cutoff_freq: float, sample_rate: float,
                  num_taps: int) -> np.ndarray:
    if num_taps % 2 == 0:
        num_taps += 1
    coeffs = -sinc_lowpass(cutoff_freq, sample_rate, num_taps)
    coeffs[(num_taps - 1) // 2] += 1.0  # spectral inversion
    return coeffs


def sinc_bandpass(center_freq: float, bandwidth: float, sample_rate: float,
                  num_taps: int) -> np.ndarray:
    if num_taps % 2 == 0:
        num_taps += 1
    low_freq = center_freq - bandwidth / 2.0
    high_freq = center_freq + bandwidth / 2.0
    highpass = sinc_highpass(low_freq, sample_rate, num_taps)
    lowpass = sinc_lowpass(high_freq, sample_rate, num_taps)
    # Truncated linear convolution, keeping the first num_taps terms
    # (filters.ts:304-311).
    full = np.convolve(highpass, lowpass)
    return full[:num_taps]


# ---------------------------------------------------------------------------
# Batched streaming filters (torch)
# ---------------------------------------------------------------------------

def biquad_init_state(batch_shape=(), device="cuda"):
    """Zeroed (x1, x2, y1, y2) biquad state of ``batch_shape`` on
    ``device`` (the card unless the caller asks for the CPU)."""
    z = torch.zeros(batch_shape, dtype=torch.float32,
                    device=resolve_device(device))
    return (z, z.clone(), z.clone(), z.clone())


def biquad_scan(coeffs, state, x: torch.Tensor):
    """Batched streaming biquad over [B, T] (or [T]), one step at a time.

    coeffs: (b0, b1, b2, a1, a2) python floats, rounded to float32.
    state:  (x1, x2, y1, y2) tensors of shape [B] (carried across chunks).
    Returns (state', y [B, T]), on ``x``'s device."""
    b0, b1, b2, a1, a2 = [float(np.float32(c)) for c in coeffs]
    x1, x2, y1, y2 = state
    ys = []
    for xt in torch.unbind(x.to(torch.float32), dim=-1):
        y = b0 * xt + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
        x1, x2, y1, y2 = xt, x1, y, y1
        ys.append(y)
    y = (torch.stack(ys, dim=-1) if ys
         else torch.zeros_like(x, dtype=torch.float32))
    return (x1, x2, y1, y2), y


@contextlib.contextmanager
def _full_f32_conv():
    """Run float32 convolutions in full float32 inside the block: cuDNN
    takes TF32 by default, which keeps about three decimal digits."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def fir_apply(coeffs, x, history=None):
    """Batched streaming FIR over [B, T] (or [T]).

    ``history``: [B, num_taps-1] previous input tail (zeros initially).
    ``x`` is a tensor (or array, taken to the CPU); the filter runs on its
    device.  Returns (new_history, y [B, T]):
    y[t] = sum_k coeffs[k] * ext[t + (n-1) - k] over ext = [history, x]."""
    x = torch.as_tensor(x, dtype=torch.float32)
    taps = torch.as_tensor(np.asarray(coeffs, dtype=np.float32),
                           device=x.device)
    n = taps.shape[0]
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    if history is None:
        history = x.new_zeros((x.shape[0], n - 1))
    ext = torch.cat([history, x], dim=-1)            # [B, n-1+T]
    with _full_f32_conv():
        y = torch.nn.functional.conv1d(ext[:, None, :],
                                       taps.flip(0)[None, None, :])[:, 0, :]
    new_history = ext[:, ext.shape[1] - (n - 1):] if n > 1 else history
    if squeeze:
        y = y[0]
    return new_history, y
