"""Kernel K3: the batched soft-decision Viterbi decoder (K=7, rate 1/2).

Replaces ``webaudio_modem_tpu/ops/pallas/viterbi.py`` ``_kernel``
(through ``decode``) and the lax scan of
``webaudio_modem_tpu/ops/fec.py:_viterbi_core`` it is bit-identical to.
The trellis runs over time-major branch sums ``a = x0 + x1`` and
``d = x0 - x1`` [T, L] (one lane per channel x candidate): per step
every state's two candidates are one add of +-a or +-d to a
predecessor metric, the decision is ``c1 > c0``, and after every 16
steps the max over the 64 states is subtracted; the traceback starts
from state 0.

On CUDA tensors ``decode`` launches ``csrc/viterbi.cu``; on CPU tensors
it runs ``decode_plain``.  There is no lane-count or trellis-length
gate: the reference fell back to the lax scan above ~90-byte payloads
because of its VMEM budget, the port runs the kernel there too.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from webaudio_modem_tpu_torch.ops.kernels import _build

N_STATES = 64
GROUP = 16               # normalization period of the grouped schedule
_NEG = -1e9              # initial metric of every state but 0
_G0, _G1 = 0o171, 0o133  # generator taps (ops/fec.py G0, G1)
# kernel launches through ``decode`` (CPU calls run the plain version and
# are not counted)
launches = 0


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


@functools.lru_cache(maxsize=1)
def branch_terms() -> np.ndarray:
    """[2, 64] index of each transition's branch term in the stack
    (+a, -a, +d, -d): row h is the predecessor half, column s2 the new
    state.  The coded bits of pred(s2, h) -> s2 are (o0, o1); their +-1
    correlation with (x0, x1) is +-a when o0 == o1, else +-d, with the
    sign of o0 (the reference's ``_branch_terms``)."""
    idx = np.zeros((2, N_STATES), np.int64)
    for h in (0, 1):
        for s2 in range(N_STATES):
            s = (s2 >> 1) | (h << 5)
            reg = (s << 1) | (s2 & 1)
            o0, o1 = _parity(reg & _G0), _parity(reg & _G1)
            kind = 0 if o0 == o1 else 2
            idx[h, s2] = kind + (0 if o0 else 1)
    return idx


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def decode_plain(a: torch.Tensor, d: torch.Tensor, n_bits: int,
                 group: int = GROUP) -> torch.Tensor:
    """Plain PyTorch version of ``decode``: [L, 64] metrics one step at a
    time.  ``group`` is the normalization period: 16 for the kernel's
    schedule, 1 for the reference's normalize-every-step form."""
    T, L = a.shape
    dev = a.device
    sel = torch.from_numpy(branch_terms()).to(dev)
    pm = torch.full((L, N_STATES), _NEG, dtype=torch.float32, device=dev)
    pm[:, 0] = 0.0
    decs = torch.empty((T, L, N_STATES), dtype=torch.bool, device=dev)
    half = N_STATES // 2
    for t in range(T):
        terms = torch.stack([a[t], -a[t], d[t], -d[t]], 1)      # [L, 4]
        c0 = pm[:, :half].repeat_interleave(2, 1) + terms[:, sel[0]]
        c1 = pm[:, half:].repeat_interleave(2, 1) + terms[:, sel[1]]
        dec = c1 > c0
        pm = torch.where(dec, c1, c0)
        decs[t] = dec
        if (t + 1) % group == 0:
            pm = pm - pm.amax(1, keepdim=True)
    bits = torch.empty((T, L), dtype=torch.uint8, device=dev)
    state = torch.zeros((L,), dtype=torch.int64, device=dev)
    lanes = torch.arange(L, device=dev)
    for t in range(T - 1, -1, -1):
        h = decs[t, lanes, state].to(torch.int64)
        bits[t] = (state & 1).to(torch.uint8)
        state = (state >> 1) | (h << 5)
    return bits[:n_bits].t()


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def _entry():
    fn = _build.library("viterbi").wam_viterbi
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, ci, vp, vp, vp]
        fn.restype = ci
    return fn


def decode(a: torch.Tensor, d: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Decode L trellises of T steps: a, d f32 [T, L] time-major ->
    bits u8 [L, n_bits] (the first n_bits input bits; the flush steps are
    consumed)."""
    global launches
    if not _build.use_kernel(a, d):
        return decode_plain(a, d, n_bits)
    T, L = a.shape
    if not 0 <= n_bits <= T:
        raise ValueError(f"n_bits {n_bits} outside [0, T={T}]")
    _build.check(a, "a", torch.float32, (T, L))
    _build.check(d, "d", torch.float32, (T, L))
    bits = torch.empty((T, L), dtype=torch.uint8, device=a.device)
    if T and L:
        dec = torch.empty((T, 2, L), dtype=torch.int32, device=a.device)
        p = _build.ptr
        with torch.cuda.device(a.device):
            err = _entry()(p(a), p(d), T, L, p(dec), p(bits),
                           _build.stream())
        _build.raise_on_error(err, "viterbi")
        launches += 1
    return bits[:n_bits].t()
