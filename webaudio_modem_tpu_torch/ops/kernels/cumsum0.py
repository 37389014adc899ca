"""Kernel K5: the zero-prefixed exclusive f32 prefix sum over time.

Replaces ``webaudio_modem_tpu/ops/pallas/cumsum0.py`` ``_kernel``
(through ``csum0``), which the blind receiver runs over every header and
body window of the soft ring (``ops/soft_blind.py``):

    x f32 [n, B] -> out f32 [n + 1, B],
    out[0] = 0,  out[t + 1] = out[t] + x[t]

added one row at a time in float32, so it equals ``np.cumsum`` of the
float32 input bit for bit.  ``torch.cumsum`` is not this function's plain
version: on the CPU it accumulates float32 in float64, on the card it is
a parallel scan; both round differently.

The rows may be a window of a ring (the blind receiver's soft ring):
``csum0(ring, start, n)`` sums ring rows start, start + 1, ... taken
modulo the ring's length, so a window that wraps past the last row is
read in two row ranges, in order, without a copy; the result is bit for
bit ``csum0`` of the two ranges concatenated.

On CUDA tensors ``csum0`` launches ``csrc/cumsum0.cu``; on CPU tensors it
runs ``csum0_plain``.  Any n >= 0 and B >= 1, any 4-byte aligned base:
the TPU kernel's row-block ladder, T_BLK padding and lane gates are gone.
"""

from __future__ import annotations

import ctypes

import torch

from webaudio_modem_tpu_torch.ops.kernels import _build

# kernel launches through ``csum0`` (CPU calls run the plain version and
# are not counted)
launches = 0


def _window(x: torch.Tensor, start: int, n):
    """(rows, n) of the window of ``n`` rows of ``x`` from ``start``
    (default: to the last row), checked."""
    rows = x.shape[0]
    n = rows - start if n is None else n
    if not (0 <= start < rows or start == rows == 0) or not 0 <= n <= rows:
        raise ValueError(f"csum0: window of {n} rows from row {start} does "
                         f"not fit {rows} rows")
    return rows, n


def csum0_plain(x: torch.Tensor, start: int = 0, n=None) -> torch.Tensor:
    """Plain PyTorch version of ``csum0``: one add per row, in row order,
    each written straight into the next output row."""
    rows, n = _window(x, start, n)
    B = x.shape[1]
    x = x.to(torch.float32)
    if start + n > rows:
        x = torch.cat([x[start:], x[:start + n - rows]])
    else:
        x = x[start:start + n]
    out = torch.empty((n + 1, B), dtype=torch.float32, device=x.device)
    out[0] = 0.0
    for t in range(n):
        torch.add(out[t], x[t], out=out[t + 1])
    return out


def _entry():
    fn = _build.library("cumsum0").wam_cumsum0
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ci, ci, ci, ci, vp, vp]
        fn.restype = ci
    return fn


def csum0(x: torch.Tensor, start: int = 0, n=None) -> torch.Tensor:
    """x f32 [rows, B] time-major -> the zero-prefixed f32 prefix sum
    [n + 1, B] in strict row order of its ``n`` rows from row ``start``
    (default: all rows), wrapping past the last row at most once."""
    global launches
    if not _build.use_kernel(x):
        return csum0_plain(x, start, n)
    rows, B = x.shape
    if B < 1:
        raise ValueError(f"csum0 needs B >= 1 channels, got {B}")
    rows, n = _window(x, start, n)
    _build.check(x, "x", torch.float32, (rows, B))
    out = torch.empty((n + 1, B), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _entry()(_build.ptr(x), rows, start, n, B, _build.ptr(out),
                       _build.stream())
    _build.raise_on_error(err, "cumsum0")
    launches += 1
    return out
