"""Kernel K4: per-channel aligned LLR windows of the soft decode.

Replaces ``webaudio_modem_tpu/ops/pallas/align.py`` ``_kernel``
(through ``aligned_wsum``) and the lax barrel shifters
``_aligned_rows`` / ``_aligned_strided`` of
``webaudio_modem_tpu/ops/soft_fsk.py``:

    out[j, b] = wsumpad[base[b] + j * stride, b]
    wsumpad   = pad_lo zero rows ++ polarity * (csum[ds:] - csum[:-ds])

with zeros past the plane.  ``virt0``: ``csum`` is the inclusive cumsum
(K1's ``emit_csum`` stream) read as if a zero row were prepended.  The
barrel ladder existed only because a per-lane gather serializes on the
TPU; here the kernel gathers directly and the plain version is one
``torch.gather`` over the materialized window sums.

On CUDA tensors ``aligned_wsum`` launches ``csrc/align.cu``; on CPU
tensors it runs ``aligned_wsum_plain``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from webaudio_modem_tpu_torch.ops.kernels import _build

# kernel launches through ``aligned_wsum`` (CPU calls run the plain
# version and are not counted)
launches = 0


def window_sums(csum: torch.Tensor, ds: int, polarity: float,
                virt0: bool = False) -> torch.Tensor:
    """polarity * (csum[i + ds] - csum[i]) for every i: [n_wsum, B]."""
    if virt0:
        csum = torch.cat([torch.zeros_like(csum[:1]), csum])
    pol = float(np.float32(polarity))
    return pol * (csum[ds:] - csum[:-ds])


def rows(base: torch.Tensor, n_out: int, stride: int,
         pad_lo: int) -> torch.Tensor:
    """[n_out, B] int64 window-sum row of every output (may lie outside
    the plane)."""
    j = torch.arange(n_out, dtype=torch.int64, device=base.device)
    return base.to(torch.int64)[None, :] + j[:, None] * stride - pad_lo


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def aligned_wsum_plain(csum: torch.Tensor, base: torch.Tensor, n_out: int,
                       ds: int, stride: int = 1, pad_lo: int = 0,
                       polarity: float = 1.0,
                       virt0: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``aligned_wsum``: the window sums, then
    one gather, zeros outside the plane."""
    wsum = window_sums(csum, ds, polarity, virt0)
    r = rows(base, n_out, stride, pad_lo)
    n_wsum = wsum.shape[0]
    if n_wsum <= 0:
        return torch.zeros((n_out, csum.shape[1]), dtype=torch.float32,
                           device=csum.device)
    inside = (r >= 0) & (r < n_wsum)
    got = torch.gather(wsum, 0, r.clamp(0, n_wsum - 1))
    return torch.where(inside, got, torch.zeros_like(got))


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def _entry():
    fn = _build.library("align").wam_align
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ci, ci, vp, ci, ci, ci, ci, ctypes.c_float, ci,
                       vp, vp]
        fn.restype = ci
    return fn


def aligned_wsum(csum: torch.Tensor, base: torch.Tensor, n_out: int,
                 ds: int, stride: int = 1, pad_lo: int = 0,
                 polarity: float = 1.0, virt0: bool = False) -> torch.Tensor:
    """csum f32 [n_rows, B] (zero-prefixed cumsum, or the inclusive one
    with ``virt0``), base i32 [B] -> out f32 [n_out, B] with
    out[j, b] = wsumpad[base[b] + j * stride, b]."""
    global launches
    if not _build.use_kernel(csum, base):
        return aligned_wsum_plain(csum, base, n_out, ds, stride, pad_lo,
                                  polarity, virt0)
    n_rows, B = csum.shape
    if ds < 1 or stride < 1 or pad_lo < 0:
        raise ValueError(f"ds {ds}, stride {stride}, pad_lo {pad_lo}")
    _build.check(csum, "csum", torch.float32, (n_rows, B))
    _build.check(base, "base", torch.int32, (B,))
    out = torch.empty((n_out, B), dtype=torch.float32, device=csum.device)
    if n_out and B:
        p = _build.ptr
        with torch.cuda.device(csum.device):
            err = _entry()(p(csum), n_rows, B, p(base), n_out, ds, stride,
                           pad_lo, float(np.float32(polarity)), int(virt0),
                           p(out), _build.stream())
        _build.raise_on_error(err, "align")
        launches += 1
    return out
