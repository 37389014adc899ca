"""Kernel K1: the demodulator's sequential stage, with the R stream
(and K7, the same stage without R).

Replaces ``webaudio_modem_tpu/ops/pallas/fsk_seq.py`` ``_kernel_r`` and
``_kernel`` (and the lax prefix / leftover code around them in
``webaudio_modem_tpu/ops/fsk_demod.py:_sequential_stage``).  Per
downsample group of ``ratio`` full-rate samples: AGC, band-pass
biquad, NCO rotation with first-order renormalization, I/Q low-pass
biquads, 2x average, atan2, wrapped phase difference, post low-pass
biquad, polarity slicer; plus R, the rolling ds-wide sum of the sliced
bits, through a ds-deep ring seeded with the last ds bits of the
previous chunk.

Stream flags, as the reference's ``emit_*`` options: ``emit_bits`` /
``emit_amps`` drop those planes (``None`` in their slots; no sqrt
without amps), ``emit_rsum=False`` skips the ring and R (K7, for
ds > 256 where R is inexact in bf16), and ``emit_csum`` puts the
INCLUSIVE f32 running sum of the softs in the softs slot, added one
decision at a time in stream order from 0.  Retained streams are
bit-identical to the full run.

``seq`` takes the whole chunk, whatever its length and downsample
phase: the pending accumulators come in with the state and the
leftover samples' accumulators go out with it.  On CUDA tensors it
launches ``csrc/fsk_seq.cu``; on CPU tensors it runs ``seq_plain``.

Front-end state layout, ``front`` f32 [20, B]: agc_gain, pre (x1, x2,
y1, y2), nco (cos, sin), iq_i (x1, x2, y1, y2), iq_q (x1, x2, y1, y2),
last_phase, post (x1, x2, y1, y2).  ``ds_acc`` f32 [2, B] holds the
pending I and Q downsample sums.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace

import numpy as np
import torch

from webaudio_modem_tpu_torch.models.config import FSKParams
from webaudio_modem_tpu_torch.ops.kernels import _build, cumsum0

N_FRONT = 20
N_SHARED = 15      # rows of the full-rate front end, shared with K6
# kernel launches through ``seq`` (CPU calls run the plain version and
# are not counted)
launches = 0

_PI = float(np.float32(np.pi))
_TWO_PI = 2.0 * _PI        # 2 * float32(pi), exact in float32


def _f32(v) -> float:
    """A Python float holding ``v`` rounded to float32 — the value
    ``jnp.float32(v)`` has, so scalar-tensor ops round identically."""
    return float(np.float32(v))


@functools.lru_cache(maxsize=64)
def _coefs(params: FSKParams) -> SimpleNamespace:
    w = 2.0 * np.pi * params.center_freq / params.sample_rate
    return SimpleNamespace(
        pre=tuple(_f32(c) for c in params.pre_filter),
        iq=tuple(_f32(c) for c in params.iq_filter),
        post=tuple(_f32(c) for c in params.post_filter),
        agc=bool(params.config.agc_enabled),
        target=_f32(params.agc_target),
        attack=_f32(params.agc_attack),
        release=_f32(params.agc_release),
        cw=_f32(np.cos(w)), sw=_f32(np.sin(w)),
        polarity=_f32(params.polarity),
        ratio=int(params.downsample_ratio),
        ds=int(params.ds_samples_per_bit))


def n_decisions(params: FSKParams, ds_phase: int, T: int) -> int:
    """Downsampled decisions a chunk of T samples yields at ``ds_phase``."""
    return (ds_phase + T) // params.downsample_ratio


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

class _Front:
    """The unpacked full-rate front end of a plain version, rows 0..14 of
    the front plane (shared by K1 and K6): [B] tensors, with the NCO
    phasor and the I/Q filter taps stacked as [2, B] (row 0 = I, row 1 =
    Q) so one elementwise op serves both rails."""

    def __init__(self, front: torch.Tensor):
        r = [front[i].clone() for i in range(N_SHARED)]
        self.g = r[0]
        self.pre = tuple(r[1:5])
        self.nco = torch.stack([r[5], r[6]])
        self.iq = tuple(torch.stack([r[7 + k], r[11 + k]])
                        for k in range(4))

    def rows(self) -> list:
        return [self.g, *self.pre, self.nco[0], self.nco[1],
                *(t[0] for t in self.iq), *(t[1] for t in self.iq)]

    def pack(self) -> torch.Tensor:
        return torch.stack(self.rows())


class _FskFront(_Front):
    """K1's front plane: the shared rows, then the discriminator's
    last_phase and post filter (rows 15..19)."""

    def __init__(self, front: torch.Tensor):
        super().__init__(front)
        self.last_phase = front[15].clone()
        self.post = tuple(front[16 + k].clone() for k in range(4))

    def rows(self) -> list:
        return super().rows() + [self.last_phase, *self.post]


def _consts(c, dev) -> SimpleNamespace:
    """The AGC and NCO scalars as tensors on ``dev``, for the plain
    versions' elementwise ops."""
    return SimpleNamespace(
        target=torch.tensor(c.target, device=dev),
        attack=torch.tensor(c.attack, device=dev),
        release=torch.tensor(c.release, device=dev),
        sw_signed=torch.tensor([[-c.sw], [c.sw]], device=dev))


def _full_rate_step(c, s: _Front, x_t: torch.Tensor, k) -> torch.Tensor:
    """One full-rate sample through AGC -> pre-filter -> NCO -> I/Q LPF
    (``fsk_demod._full_rate_step``); returns (fi, fq) as [2, B]."""
    if c.agc:
        y = x_t * s.g
        level = y.abs()
        tgt = k.target / torch.clamp_min(level, 1e-30)
        rate = torch.where(level > c.target, k.attack, k.release)
        s.g = torch.where(level > 0,
                          torch.clamp(s.g + (tgt - s.g) * rate, 0.1, 10.0),
                          s.g)
    else:
        y = x_t
    b0, b1, b2, a1, a2 = c.pre
    x1, x2, y1, y2 = s.pre
    f = b0 * y + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
    s.pre = (y, x1, f, y1)
    mixed = f * s.nco                               # (f*cos, f*sin)
    # rotate the phasor by omega: (c*cw - s*sw, s*cw + c*sw), written as
    # p*cw + swap(p)*(-sw, +sw); a + (-b) rounds exactly like a - b
    rot = s.nco * c.cw + s.nco.flip(0) * k.sw_signed
    sq = rot * rot
    s.nco = rot * (1.5 - 0.5 * (sq[0] + sq[1]))
    b0, b1, b2, a1, a2 = c.iq
    x1, x2, y1, y2 = s.iq
    fo = b0 * mixed + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
    s.iq = (mixed, x1, fo, y1)
    return fo


def _ds_decision(c, s: _FskFront, acc: torch.Tensor, with_amp: bool):
    """atan2 phase / amplitude, wrapped phase diff, post-LPF, slicer
    (``fsk_demod._ds_decision``).  Returns (bit f32, amp or None, soft)."""
    avg = acc / float(c.ratio)
    cur = torch.atan2(avg[1], avg[0])
    amp = (torch.sqrt(avg[0] * avg[0] + avg[1] * avg[1]) if with_amp
           else None)
    diff = cur - s.last_phase
    diff = torch.where(diff > _PI, diff - _TWO_PI,
                       torch.where(diff < -_PI, diff + _TWO_PI, diff))
    b0, b1, b2, a1, a2 = c.post
    x1, x2, y1, y2 = s.post
    filt = b0 * diff + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
    s.post = (diff, x1, filt, y1)
    s.last_phase = cur
    bit = (c.polarity * filt > 0).to(torch.float32)
    return bit, amp, filt


def run_groups(c, s: _Front, ds_phase: int, ds_acc: torch.Tensor,
               x: torch.Tensor, decide) -> torch.Tensor:
    """Run the front end over a chunk x [T, B] and call ``decide(acc)``
    with the I/Q downsample sums [2, B] of each completed group, summed
    in the reference's order (``fsk_demod._sequential_stage``: pending +
    fi for the prefix, fi then + fi for whole groups, 0 + fi for the
    leftover).  Returns the pending sums of the leftover samples."""
    k = _consts(c, x.device)
    T = x.shape[0]
    ratio = c.ratio
    t = 0
    acc = ds_acc.clone()
    if ds_phase > 0:                 # complete the pending group
        for _ in range(min(ratio - ds_phase, T)):
            acc = acc + _full_rate_step(c, s, x[t], k)
            t += 1
        if ds_phase + T < ratio:     # still pending
            return acc
        decide(acc)
    while t + ratio <= T:            # whole groups
        acc = _full_rate_step(c, s, x[t], k)
        for r in range(1, ratio):
            acc = acc + _full_rate_step(c, s, x[t + r], k)
        decide(acc)
        t += ratio
    acc = torch.zeros_like(ds_acc)   # leftover starts the next group
    while t < T:
        acc = acc + _full_rate_step(c, s, x[t], k)
        t += 1
    return acc


def seq_plain(params: FSKParams, ds_phase: int, front: torch.Tensor,
              ds_acc: torch.Tensor, ring0, x: torch.Tensor, *,
              emit_bits: bool = True, emit_amps: bool = True,
              emit_csum: bool = False, emit_rsum: bool = True):
    """Plain PyTorch version of ``seq``: the same contract, one sample
    at a time on [B] tensors (``run_groups``)."""
    flags = (emit_bits, emit_amps, emit_csum, emit_rsum)
    c = _coefs(params)
    s = _FskFront(front)
    bits, amps, softs = [], [], []

    def decide(acc):
        bit, amp, soft = _ds_decision(c, s, acc, emit_amps)
        bits.append(bit)
        amps.append(amp)
        softs.append(soft)

    acc = run_groups(c, s, ds_phase, ds_acc, x, decide)
    return (s.pack(), acc) + _planes(params, bits, amps, softs, ring0,
                                     x.shape[1], x.device, flags)


def csum_strict(softs: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 running sum over the rows, one row at a time from 0:
    K5's plain version without its zero row (``torch.cumsum`` on float
    data accumulates in another order: f64 on the CPU, a parallel scan on
    the card)."""
    return cumsum0.csum0_plain(softs)[1:]


def _planes(params, bits, amps, softs, ring0, B, dev, flags):
    """Stack the per-group outputs, keep the requested streams, and
    derive R from the bits: an exact integer cumsum over the ds-deep
    history followed by the new bits."""
    emit_bits, emit_amps, emit_csum, emit_rsum = flags
    ds = params.ds_samples_per_bit
    n = len(bits)
    f32 = dict(dtype=torch.float32, device=dev)
    bits_f = torch.stack(bits) if n else torch.zeros((0, B), **f32)
    amps_t = (torch.stack(amps) if n else torch.zeros((0, B), **f32)) \
        if emit_amps else None
    softs_t = torch.stack(softs) if n else torch.zeros((0, B), **f32)
    if emit_csum:
        softs_t = csum_strict(softs_t)
    rsum = None
    if emit_rsum:
        ext = torch.cat([ring0.to(torch.float32), bits_f])
        cs = torch.cumsum(ext, 0)         # integers: exact in any order
        rsum = (cs[ds:] - cs[:-ds]).to(torch.bfloat16)
    return (bits_f.to(torch.bfloat16) if emit_bits else None, amps_t,
            softs_t, rsum)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

class _Coef(ctypes.Structure):
    """Mirror of ``FskSeqCoef`` in csrc/fsk_seq.cu."""
    _fields_ = [("pre", ctypes.c_float * 5), ("iq", ctypes.c_float * 5),
                ("post", ctypes.c_float * 5),
                ("agc_target", ctypes.c_float),
                ("agc_attack", ctypes.c_float),
                ("agc_release", ctypes.c_float),
                ("cw", ctypes.c_float), ("sw", ctypes.c_float),
                ("polarity", ctypes.c_float),
                ("agc_enabled", ctypes.c_int), ("ratio", ctypes.c_int),
                ("ds", ctypes.c_int)]


@functools.lru_cache(maxsize=64)
def _kernel_coef(params: FSKParams) -> _Coef:
    c = _coefs(params)
    return _Coef((ctypes.c_float * 5)(*c.pre), (ctypes.c_float * 5)(*c.iq),
                 (ctypes.c_float * 5)(*c.post), c.target, c.attack,
                 c.release, c.cw, c.sw, c.polarity, int(c.agc), c.ratio,
                 c.ds)


def _entry():
    fn = _build.library("fsk_seq").wam_fsk_seq
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ci, ci, vp, vp, vp, vp, vp, ci, vp, vp, vp, vp,
                       ci, ci, ctypes.POINTER(_Coef), vp]
        fn.restype = ci
    return fn


def seq(params: FSKParams, ds_phase: int, front: torch.Tensor,
        ds_acc: torch.Tensor, ring0, x: torch.Tensor, *,
        emit_bits: bool = True, emit_amps: bool = True,
        emit_csum: bool = False, emit_rsum: bool = True):
    """Sequential stage over one chunk.

    front f32 [20, B], ds_acc f32 [2, B], ring0 bf16 [ds, B] (the last ds
    sliced bits, oldest first; may be None with ``emit_rsum=False``), x
    f32 [T, B] time-major.  Returns (front', ds_acc', bits bf16, amps
    f32, softs f32, rsum bf16), the four planes [n, B] with
    n = (ds_phase + T) // ratio; a dropped stream is None, and with
    ``emit_csum`` the softs slot holds their inclusive running sum.
    rsum[i] is the sum of the ds bits ending at decision i; it is exact
    for ds <= 256.
    """
    global launches
    flags = dict(emit_bits=emit_bits, emit_amps=emit_amps,
                 emit_csum=emit_csum, emit_rsum=emit_rsum)
    operands = (front, ds_acc, x) + ((ring0,) if emit_rsum else ())
    if not _build.use_kernel(*operands):
        return seq_plain(params, ds_phase, front, ds_acc, ring0, x, **flags)
    T, B = x.shape
    ds = params.ds_samples_per_bit
    if not 0 <= ds_phase < params.downsample_ratio:
        raise ValueError(f"ds_phase {ds_phase} out of range")
    _build.check(x, "x", torch.float32, (None, B))
    _build.check(front, "front", torch.float32, (N_FRONT, B))
    _build.check(ds_acc, "ds_acc", torch.float32, (2, B))
    if emit_rsum:
        _build.check(ring0, "ring0", torch.bfloat16, (ds, B))
    n = n_decisions(params, ds_phase, T)
    new = dict(device=x.device)
    front_out = torch.empty((N_FRONT, B), dtype=torch.float32, **new)
    acc_out = torch.empty((2, B), dtype=torch.float32, **new)

    def plane(keep, dtype):
        return torch.empty((n, B), dtype=dtype, **new) if keep else None

    bits = plane(emit_bits, torch.bfloat16)
    amps = plane(emit_amps, torch.float32)
    softs = plane(True, torch.float32)
    rsum = plane(emit_rsum, torch.bfloat16)
    p = _build.ptr
    with torch.cuda.device(x.device):
        err = _entry()(p(x), T, B, p(front), p(front_out), p(ds_acc),
                       p(acc_out), p(ring0), ds_phase, p(bits), p(amps),
                       p(softs), p(rsum), int(emit_csum), int(emit_rsum),
                       ctypes.byref(_kernel_coef(params)), _build.stream())
    _build.raise_on_error(err, "fsk_seq")
    launches += 1
    return front_out, acc_out, bits, amps, softs, rsum
