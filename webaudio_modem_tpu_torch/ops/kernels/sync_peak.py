"""The soft decode's sync peak (``csrc/sync_peak.cu``): stage C in one pass.

Replaces no TPU kernel: the JAX package leaves this correlation to XLA
(``webaudio_modem_tpu/ops/fsk_demod.py`` ``_sync_ratios_from_r``, a ±1
band matrix product, then ``argmax``), and the port ran it as two dense
f32 GEMMs and four passes of glue over the [n_ds, B] ratio plane.

  ``sync_peak(params, rsum)``: K1's R plane bf16 [n_ds, B] ->
      (t_peak int64 [B], the first t of the largest sync ratio with a
      zero carried tail; peak_ok bool [B], that ratio > the sync
      threshold), one launch and the zeroing of its keys on the card.

On CPU tensors it runs ``sync_peak_plain`` (``_sync_ratios_from_r``,
``argmax``, the gate), which the kernel equals bit for bit, ties
included, on R planes of integers in [0, ds] (K1's ds-wide bit sums):
every partial sum is then an integer, exact in any order.  The kernel
has two lanes: the reference's pattern, stepped by a recurrence in fp16
two channels at once where every partial sum stays exact (``_fast``),
and any pattern of up to 63 taps summed directly in f32, one channel a
thread.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams
from webaudio_modem_tpu_torch.ops import fsk_demod
from webaudio_modem_tpu_torch.ops.kernels import _build

# kernel launches through ``sync_peak`` (CPU calls run the plain version
# and are not counted)
launches = 0

THREADS = 128                 # columns a block (csrc/sync_peak.cu kThreads)
MAX_TAPS = 63                 # the f32 lane's taps (kMaxTaps)
FP16_EXACT = 2048             # integers up to here are exact in fp16
# time segments (grid z): about one wave of blocks on an H100 (132 SMs, 5
# blocks of the fast lane each), each segment at least MIN_SEGMENT steps
# long (its halo re-reads 31 or 63 steps before it).  Two segments at
# B = 4096 ran 3-15 % faster than one or four at every payload length of
# the frames cell (NVIDIA H100 80GB HBM3, 700 W).
TARGET_BLOCKS = 640
MIN_SEGMENT = 128


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def sync_peak_plain(params: FSKParams, rsum: torch.Tensor):
    """Sync match ratios from R with a zero carried tail (a one-shot
    decode's all-zero window prefix), their first maximum t_peak [B] and
    whether it clears the sync threshold."""
    ds = params.ds_samples_per_bit
    W = params.sync_window
    B = rsum.shape[1]
    ratios = fsk_demod._sync_ratios_from_r(
        params, torch.zeros((W - ds, B), dtype=rsum.dtype,
                            device=rsum.device), rsum)
    t_peak = torch.argmax(ratios, dim=0)            # first maximum
    peak = torch.take_along_dim(ratios, t_peak[None, :], dim=0)[0]
    threshold = float(np.float32(params.config.sync_threshold))
    return t_peak, peak > threshold


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

class _Plan(ctypes.Structure):
    _fields_ = [("n_ds", ctypes.c_int32), ("B", ctypes.c_int32),
                ("ds", ctypes.c_int32), ("seg_steps", ctypes.c_int32),
                ("taps", ctypes.c_int32), ("n_zero_ds", ctypes.c_float),
                ("window", ctypes.c_float), ("threshold", ctypes.c_float),
                ("plus", ctypes.c_uint64),
                ("sign", ctypes.c_float * (MAX_TAPS + 1))]


def _signs(params: FSKParams):
    """(s_j for j = 1..taps, the count of -1): the plain version's band
    (``fsk_demod._sync_sign_const``), whose one row holds s_taps .. s_1."""
    sign2, n_zero = fsk_demod._sync_sign_const(params, 1)
    return tuple(float(v) for v in sign2[0, ::-1]), n_zero


def _recurrence(signs):
    """The fast lane's recurrence m(tau + 1) = sigma m(tau) + sum_i c_i
    x(tau - i) (csrc/sync_peak.cu): (sigma, [c_0 .. c_taps]), sigma the
    one of fewer nonzero c (-1 on a tie)."""
    def coefs(sigma):
        return ([signs[0]] + [signs[i] - sigma * signs[i - 1]
                              for i in range(1, len(signs))]
                + [-sigma * signs[-1]])
    down, up = coefs(-1), coefs(1)
    if sum(c != 0 for c in down) <= sum(c != 0 for c in up):
        return -1, down
    return 1, up


@functools.lru_cache(maxsize=1)
def _reference_signs():
    """The reference's pattern (``FSKConfig``'s, fsk.ts's): the one the
    fast lane is built for."""
    return _signs(FSKParams.from_config(FSKConfig()))[0]


@functools.lru_cache(maxsize=16)
def _reach(signs: tuple):
    """The fast lane's largest partial sum over ds, for the reference's
    pattern (the taps' direct sum, then the recurrence's terms beside
    it); None for another pattern."""
    if signs != _reference_signs():
        return None
    return len(signs) + sum(abs(c) for c in _recurrence(signs)[1])


def _fast(params: FSKParams, rsum: torch.Tensor) -> bool:
    """The fast lane: the reference's pattern, an even B (4-byte loads of
    channel pairs), and every partial sum an integer within fp16's exact
    range."""
    reach = _reach(_signs(params)[0])
    return (reach is not None and rsum.shape[1] % 2 == 0
            and rsum.data_ptr() % 4 == 0
            and reach * params.ds_samples_per_bit <= FP16_EXACT)


def _segments(n_tau: int, blocks_a_segment: int):
    """(steps a segment, segments): TARGET_BLOCKS blocks in all where the
    segments stay MIN_SEGMENT steps long."""
    most = max(1, n_tau // MIN_SEGMENT)
    n_seg = min(most, max(1, -(-TARGET_BLOCKS // blocks_a_segment)))
    seg = -(-n_tau // n_seg)
    return seg, -(-n_tau // seg)


@functools.lru_cache(maxsize=64)
def _plan(signs: tuple, n_zero: int, ds: int, window: int, threshold: float,
          n_ds: int, B: int, seg_steps: int) -> _Plan:
    plus = sum(1 << j for j, s in enumerate(signs, 1) if s > 0)
    plan = _Plan(n_ds, B, ds, seg_steps, len(signs), float(n_zero * ds),
                 float(window), float(np.float32(threshold)), plus)
    for j, s in enumerate(signs, 1):
        plan.sign[j] = s
    return plan


def _entry():
    fn = _build.library("sync_peak").wam_sync_peak
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, ci, vp, vp, vp]
        fn.restype = ci
    return fn


def sync_peak(params: FSKParams, rsum: torch.Tensor):
    """R bf16 [n_ds, B] (contiguous) -> (t_peak int64 [B], peak_ok bool
    [B]); the plain version on CPU tensors."""
    if rsum is None:
        raise ValueError("no R plane: K1 ran without R (emit_rsum=False)")
    if not _build.use_kernel(rsum):
        return sync_peak_plain(params, rsum)
    return _launch(params, rsum)


def _launch(params: FSKParams, rsum: torch.Tensor, fast=None,
            segments=None):
    """One launch: ``fast`` None picks the lane (``_fast``), True or False
    forces it; ``segments`` None sizes the time segments (``_segments``),
    else the count of them."""
    global launches
    _build.check(rsum, "rsum", torch.bfloat16, (None, None))
    n_ds, B = rsum.shape
    ds = params.ds_samples_per_bit
    signs, n_zero = _signs(params)
    taps = len(signs)
    if taps > MAX_TAPS:
        raise ValueError(f"{taps} pattern taps: the kernel takes at most "
                         f"{MAX_TAPS}")
    if n_ds == 0:
        raise ValueError("rsum: no rows, no peak")
    if n_ds * B >= 2 ** 31:
        raise ValueError(f"rsum [{n_ds}, {B}]: 2^31 elements or more")
    can = _fast(params, rsum)
    fast = can if fast is None else fast
    if fast and not can:
        raise ValueError("the fast lane needs the reference's pattern, an "
                         "even B, 4-byte aligned R and its sums within "
                         f"{FP16_EXACT} (ds small enough)")
    n_tau = -(-n_ds // ds)
    if segments is None:
        cols = -(-B // 2) if fast else B
        seg, n_seg = _segments(n_tau, -(-cols // THREADS) * ds)
    else:
        seg = -(-n_tau // segments)
        n_seg = -(-n_tau // seg)
    # the keys, then the blocks' counter: t_peak is the keys' first B
    keys = torch.zeros(B + 1, dtype=torch.int64, device=rsum.device)
    peak_ok = torch.empty(B, dtype=torch.bool, device=rsum.device)
    if B:
        p = _build.ptr
        plan = _plan(signs, n_zero, ds, params.sync_window,
                     params.config.sync_threshold, n_ds, B, seg)
        with torch.cuda.device(rsum.device):
            err = _entry()(p(rsum), ctypes.byref(plan), n_seg, int(fast),
                           p(keys), p(peak_ok), _build.stream())
        _build.raise_on_error(err, "sync_peak")
        launches += 1
    return keys[:B], peak_ok
