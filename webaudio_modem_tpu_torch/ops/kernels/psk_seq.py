"""Kernel K6: the DBPSK demodulator's sequential stage, with the R stream
(or without it, for D > 256).

Replaces ``webaudio_modem_tpu/ops/pallas/psk_seq.py`` ``_kernel`` (and
the lax prefix / leftover code around it in
``webaudio_modem_tpu/ops/psk.py:_sequential_stage``).  Per downsample
group of ``ratio`` full-rate samples: the front end K1 shares (AGC,
band-pass biquad, NCO rotation, I/Q low-pass biquads), the 2x average
z_k, and the DBPSK decision against z_{k-D}, the sample one bit period
(D = ds decisions) earlier (``psk._psk_soft``): bit = Re(z_k conj
z_{k-D}) > 0, the amplitude |z_k|, and the soft value, the differential
phase wrapped to its nearest constellation point.  With ``emit_rsum``,
R: the rolling D-wide sum of the sliced bits, through a D-deep ring
seeded with the last D bits of the previous chunk.

``seq`` takes the whole chunk, whatever its length and downsample
phase.  On CUDA tensors it launches ``csrc/psk_seq.cu``; on CPU tensors
it runs ``seq_plain``.

State: ``front`` f32 [15, B] in the reference's ``_pack_fr`` order
(agc_gain, pre (x1, x2, y1, y2), nco (cos, sin), iq_i (x1, x2, y1, y2),
iq_q (x1, x2, y1, y2)) — rows 0..14 of K1's plane; ``ds_acc`` f32
[2, B], the pending I and Q downsample sums; ``ring`` f32 [2D, B], the
last D averaged I samples then the last D Q samples, each oldest first.
The ring goes in and comes out in that order, so nobody rolls it.
"""

from __future__ import annotations

import ctypes
import torch

from webaudio_modem_tpu_torch.models.config import FSKParams
from webaudio_modem_tpu_torch.ops.kernels import _build, fsk_seq

N_FRONT = fsk_seq.N_SHARED
# kernel launches through ``seq`` (CPU calls run the plain version and
# are not counted)
launches = 0

n_decisions = fsk_seq.n_decisions


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _psk_soft(avg: torch.Tensor, di: torch.Tensor, dq: torch.Tensor):
    """The DBPSK decision on z = avg [2, B] against the delayed (di, dq):
    (bit f32, amp, soft) as ``psk._psk_soft`` (two products, then the
    add or subtract; sign(0) = 0)."""
    ai, aq = avg[0], avg[1]
    re = ai * di + aq * dq
    im = aq * di - ai * dq
    bit = (re > 0).to(torch.float32)
    amp = torch.sqrt(ai * ai + aq * aq)
    ang = torch.atan2(im, re)
    soft = torch.where(re > 0, ang, ang - torch.sign(ang) * fsk_seq._PI)
    return bit, amp, soft


def seq_plain(params: FSKParams, ds_phase: int, front: torch.Tensor,
              ds_acc: torch.Tensor, ring: torch.Tensor, ring0,
              x: torch.Tensor, *, emit_rsum: bool = True):
    """Plain PyTorch version of ``seq``: the same contract, one sample at
    a time on [B] tensors (``fsk_seq.run_groups``).  The chunk's k-th
    decision reads and overwrites ring slot k mod D; the ring is handed
    back rolled so that row 0 is again the oldest."""
    c = fsk_seq._coefs(params)
    D = params.ds_samples_per_bit
    s = fsk_seq._Front(front)
    zi, zq = ring[:D].clone(), ring[D:].clone()
    bits, amps, softs = [], [], []

    def decide(acc):
        avg = acc / float(c.ratio)
        slot = len(bits) % D
        bit, amp, soft = _psk_soft(avg, zi[slot], zq[slot])
        zi[slot] = avg[0]
        zq[slot] = avg[1]
        bits.append(bit)
        amps.append(amp)
        softs.append(soft)

    acc = fsk_seq.run_groups(c, s, ds_phase, ds_acc, x, decide)
    shift = len(bits) % D
    ring_out = torch.cat([zi.roll(-shift, 0), zq.roll(-shift, 0)])
    return (s.pack(), acc, ring_out) + fsk_seq._planes(
        params, bits, amps, softs, ring0, x.shape[1], x.device,
        (True, True, False, emit_rsum))


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def _entry():
    fn = _build.library("psk_seq").wam_psk_seq
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ci, ci, vp, vp, vp, vp, vp, vp, vp, ci, vp, vp,
                       vp, vp, ci, ctypes.POINTER(fsk_seq._Coef), vp]
        fn.restype = ci
    return fn


def seq(params: FSKParams, ds_phase: int, front: torch.Tensor,
        ds_acc: torch.Tensor, ring: torch.Tensor, ring0, x: torch.Tensor,
        *, emit_rsum: bool = True):
    """Sequential stage over one chunk.

    front f32 [15, B], ds_acc f32 [2, B], ring f32 [2D, B] (oldest
    first), ring0 bf16 [D, B] (the last D sliced bits, oldest first; may
    be None with ``emit_rsum=False``), x f32 [T, B] time-major.  Returns
    (front', ds_acc', ring', bits bf16, amps f32, softs f32, rsum bf16 or
    None), the four planes [n, B] with n = (ds_phase + T) // ratio.
    rsum[i] is the sum of the D bits ending at decision i; it is exact
    for D <= 256.  The kernel keeps the I/Q rings in shared memory where
    they fit (D <= 908), in ``ring'`` in device memory beyond.
    """
    global launches
    operands = (front, ds_acc, ring, x) + ((ring0,) if emit_rsum else ())
    if not _build.use_kernel(*operands):
        return seq_plain(params, ds_phase, front, ds_acc, ring, ring0, x,
                         emit_rsum=emit_rsum)
    T, B = x.shape
    D = params.ds_samples_per_bit
    if not 0 <= ds_phase < params.downsample_ratio:
        raise ValueError(f"ds_phase {ds_phase} out of range")
    _build.check(x, "x", torch.float32, (None, B))
    _build.check(front, "front", torch.float32, (N_FRONT, B))
    _build.check(ds_acc, "ds_acc", torch.float32, (2, B))
    _build.check(ring, "ring", torch.float32, (2 * D, B))
    if emit_rsum:
        _build.check(ring0, "ring0", torch.bfloat16, (D, B))
    n = n_decisions(params, ds_phase, T)
    new = dict(device=x.device)
    front_out = torch.empty((N_FRONT, B), dtype=torch.float32, **new)
    acc_out = torch.empty((2, B), dtype=torch.float32, **new)
    ring_out = torch.empty((2 * D, B), dtype=torch.float32, **new)
    bits = torch.empty((n, B), dtype=torch.bfloat16, **new)
    amps = torch.empty((n, B), dtype=torch.float32, **new)
    softs = torch.empty((n, B), dtype=torch.float32, **new)
    rsum = torch.empty((n, B), dtype=torch.bfloat16, **new) \
        if emit_rsum else None
    p = _build.ptr
    with torch.cuda.device(x.device):
        err = _entry()(p(x), T, B, p(front), p(front_out), p(ds_acc),
                       p(acc_out), p(ring), p(ring_out),
                       p(ring0 if emit_rsum else None), ds_phase, p(bits),
                       p(amps), p(softs), p(rsum), int(emit_rsum),
                       ctypes.byref(fsk_seq._kernel_coef(params)),
                       _build.stream())
    _build.raise_on_error(err, "psk_seq")
    launches += 1
    return front_out, acc_out, ring_out, bits, amps, softs, rsum
