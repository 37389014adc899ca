"""Kernel K3: the batched soft-decision Viterbi decoder (K=7, rate 1/2).

Replaces ``webaudio_modem_tpu/ops/pallas/viterbi.py`` ``_kernel``
(through ``decode``) and the lax scan of
``webaudio_modem_tpu/ops/fec.py:_viterbi_core`` it is bit-identical to.
The trellis runs over the branch sums ``a = x0 + x1`` and
``d = x0 - x1`` of the coded pairs of a soft view [L, T, 2] (one lane
per channel x candidate): per step every state's two candidates are one
add of +-a or +-d to a predecessor metric, the decision is ``c1 > c0``,
and after every 16 steps the max over the 64 states is subtracted; the
traceback starts from state 0.

On CUDA tensors ``decode`` launches ``csrc/viterbi.cu`` on the soft view
in place (any strides); its trellises run on groups of 1, 8 or 32
threads (``pick``), with their decision records in shared memory while
they fit, else in a device-memory scratch.  On CPU tensors it runs
``decode_plain`` over ``branch_sums``.  There is no lane-count or
trellis-length gate: the reference fell back to the lax scan above
~90-byte payloads because of its VMEM budget, the port runs the kernel
there too.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from webaudio_modem_tpu_torch.ops.kernels import _build

N_STATES = 64
GROUP = 16               # normalization period of the grouped schedule
THREADS = 128            # threads a block (csrc/viterbi.cu kThreads)
SMEM_BUDGET = 112 * 1024  # shared-memory records a block (kSmemBudget)
GROUPS = (1, 8, 32)      # threads per trellis the kernel takes
# ``pick``'s thresholds, from the ladder of ``tools/variants.py k3`` on an
# H100 (T = 38, 150 and 822; L from 1 to 32,768): one thread a trellis
# from 8192 lanes (at 6144 it is 4 % faster at T = 38, 10 % slower at
# T = 150), 8 from 768 (where 8 and 32 tie at T = 150 and 8 is 3 %
# faster at T = 822), 32 below (at 512, 0.75 x the time of 8)
ONE_THREAD_MIN_L = 8192
FEW_LANES = 768
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

def branch_sums(soft: torch.Tensor):
    """The trellis inputs of correlations soft [..., T, 2]: a = x0 + x1
    and d = x0 - x1, one add each as the reference, time-major [T, L]
    with L the flattened batch."""
    flat = soft.reshape(-1, soft.shape[-2], 2)
    a = (flat[..., 0] + flat[..., 1]).t().contiguous()
    d = (flat[..., 0] - flat[..., 1]).t().contiguous()
    return a, d


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
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp, ci, ci, cl, cl, cl, ci, ci, vp, vp, vp]
        fn.restype = ci
    return fn


def shared_max_steps(threads: int) -> int:
    """The longest trellis whose decision records fit a block's shared
    memory at ``threads`` threads a trellis (8 bytes a step, 128 /
    threads trellises a block)."""
    return SMEM_BUDGET // (8 * (THREADS // threads))


def pick(L: int, T: int):
    """(threads per trellis, records in shared memory) for L trellises
    of T steps: 1 thread a trellis from ONE_THREAD_MIN_L lanes, 8 from
    FEW_LANES, else 32; records in shared memory while they fit."""
    threads = 1 if L >= ONE_THREAD_MIN_L else 8 if L >= FEW_LANES else 32
    return threads, T <= shared_max_steps(threads)


def decode(soft: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Decode L trellises of T steps: soft f32 [L, T, 2] correlations,
    any strides -> bits u8 [L, n_bits] (the first n_bits input bits; the
    flush steps are consumed), on the instantiation ``pick`` names."""
    global launches
    if not _build.use_kernel(soft):
        a, d = branch_sums(soft)
        return decode_plain(a, d, n_bits)
    if soft.dim() != 3 or soft.shape[2] != 2:
        raise ValueError(f"soft: expected [L, T, 2], got {tuple(soft.shape)}")
    if soft.dtype != torch.float32:
        raise TypeError(f"soft: expected torch.float32, got {soft.dtype}")
    L, T, _ = soft.shape
    if not 0 <= n_bits <= T:
        raise ValueError(f"n_bits {n_bits} outside [0, T={T}]")
    bits = _launch(soft, *pick(L, T))
    if T and L:
        launches += 1
    return bits[:n_bits].t()


def _launch(soft: torch.Tensor, threads: int, shared: bool) -> torch.Tensor:
    """One launch of the kernel's (threads, shared) instantiation on a
    checked soft view: bits u8 [T, L] of every step."""
    L, T, _ = soft.shape
    bits = torch.empty((T, L), dtype=torch.uint8, device=soft.device)
    if T and L:
        dec = None if shared else torch.empty(
            (T, L), dtype=torch.int64, device=soft.device)
        p = _build.ptr
        s_lane, s_step, s_pair = soft.stride()
        with torch.cuda.device(soft.device):
            err = _entry()(p(soft), T, L, s_lane, s_step, s_pair, threads,
                           int(shared), p(dec), p(bits), _build.stream())
        _build.raise_on_error(err, "viterbi")
    return bits
