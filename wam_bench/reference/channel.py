"""The channel between the benchmark's transmitters and the program.

``awgn_`` adds frozen Gaussian noise in place at an SNR measured against
the power of a unit-amplitude tone (0.5), so silence carries noise too.
"""

from __future__ import annotations

import math

import torch

TONE_POWER = 0.5


def noise_sigma(snr_db: float) -> float:
    return math.sqrt(TONE_POWER / 10.0 ** (snr_db / 10.0))


def awgn_(x: torch.Tensor, snr_db: float, gen: torch.Generator,
          rows: int = 256) -> torch.Tensor:
    """Add Gaussian noise at ``snr_db`` to ``x`` [B, T] in place, a block
    of ``rows`` rows at a time (bounded temporaries)."""
    sigma = noise_sigma(snr_db)
    for r in range(0, x.shape[0], rows):
        blk = x[r:r + rows]
        blk.add_(torch.randn(blk.shape, generator=gen, device=x.device,
                             dtype=x.dtype), alpha=sigma)
    return x
