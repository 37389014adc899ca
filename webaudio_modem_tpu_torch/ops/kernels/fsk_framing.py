"""Kernels K2 and K8: the framing state machine (stage D).

Per downsampled step, ``_d_step`` of
``webaudio_modem_tpu/ops/fsk_demod.py``: silence EOD, sync firing gated
on the bit-window fill, majority-vote bit decisions, UART byte
assembly and the fused rolling amplitude mean.  Two kernels run it,
the two output modes of one kernel body (``csrc/fsk_framing.cu``, the
step in ``csrc/framing_step.cuh``), with one copy-ahead input pipeline:

* K2, ``stage_d_compact`` (entry ``wam_fsk_framing``), replaces
  ``webaudio_modem_tpu/ops/pallas/fsk_framing.py`` ``_kernel_compact``.
  Out come the decoded bytes, packed per channel from slot 0, the
  counts of bytes, EODs and sync fires, and the step of the last fire
  (-1 for none).  It writes each byte straight to ``bytes_out[b,
  cursor]``, so unlike the TPU kernel it has no slot bound (the TPU's
  ``MAX_SLOTS``) and no fallback for long chunks: ``demod_chunk`` runs it
  at every chunk length.
* K8, ``stage_d`` (entry ``wam_fsk_stage_d``), replaces the same file's
  ``_kernel``: the per-step events as the four planes ``stage_d_plain``
  returns, written by the kernel in one launch (the TPU kernel's packed
  word is not kept).  ``fsk_demod.stage_d`` is its entry point, the
  counterpart of the reference's ``_stage_d``.

Carry layout (as the reference's ``pack_carry``): ``ints`` i32 [10, B]
= started, counter, sil, accum, count, bsc, next_idx, byte_cur, pos,
amp-window fill; ``flts`` f32 [2, B] = silence threshold, rolling
amp-window sum.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from webaudio_modem_tpu_torch.models.config import FSKParams
from webaudio_modem_tpu_torch.ops.kernels import _build

N_I32 = 10
N_F32 = 2
# kernel launches through ``stage_d_compact`` (K2) and ``stage_d`` (K8);
# CPU calls run the plain version and are not counted
launches = 0
stage_d_launches = 0


def _wrap(params: FSKParams) -> int:
    """The largest multiple of quarter_bit below 2^30: the step counter
    wraps there, so its only modular use (% quarter_bit) stays exact."""
    return (2 ** 30 // params.quarter_bit) * params.quarter_bit


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def stage_d_plain(params: FSKParams, ints: torch.Tensor, flts: torch.Tensor,
                  bit_fill: torch.Tensor, bits: torch.Tensor,
                  amps: torch.Tensor, ratios: torch.Tensor,
                  sub_amps: torch.Tensor):
    """Run ``_d_step`` over [n_ds, B] streams, one step at a time.

    ``sub_amps`` is the amplitude stream delayed by amp_window (rows
    0..n_ds-1 are read).  Returns ((ints', flts'), (byte_vals, emits,
    eods, fires)) with the per-step outputs [n_ds, B]."""
    n_ds, B = bits.shape
    ds_per_bit = params.ds_samples_per_bit
    quarter = params.quarter_bit
    eod_after = float(np.float32(params.samples_for_eod))
    sync_thr = float(np.float32(params.config.sync_threshold))
    stop_pos = params.stop_bit_position
    parity_on = params.config.parity != "none"
    A = params.amp_window
    W = params.sync_window
    wrap = _wrap(params)

    (started, counter, sil, accum, count, bsc, nxt, byte_cur, pos,
     fillv) = [ints[i].clone() for i in range(N_I32)]
    thr, run_sum = flts[0].clone(), flts[1].clone()
    zero = torch.zeros_like(started)
    vals, emits, eods, fires = [], [], [], []
    for t in range(n_ds):
        amp = amps[t]
        bit_i = bits[t].to(torch.int32)
        gate = (bit_fill + (t + 1)) >= W

        run_sum = run_sum + amp - sub_amps[t]
        fillv = torch.clamp_max(fillv + 1, A)
        mean = run_sum / fillv.to(torch.float32)

        counter1 = counter + 1
        counter1 = torch.where(counter1 >= wrap, counter1 - wrap, counter1)
        is_sil = amp < thr
        sil1 = torch.where(is_sil, sil + 1, zero)
        eod = is_sil & (sil1.to(torch.float32) >= eod_after)
        alive = ~eod

        st = started > 0
        fire = alive & ~st & gate & (counter1 % quarter == 0) \
            & (ratios[t] > sync_thr)

        post = alive & st
        accum1 = accum + bit_i
        count1 = count + 1
        bsc1 = bsc + 1
        decide = post & (bsc1 >= nxt)
        b = (2 * accum1) > count1

        start_fail = decide & (pos == 0) & b
        is_data = (pos >= 1) & (pos <= 8)
        is_parity = (pos == 9) & parity_on
        is_stop = pos == stop_pos
        stop_fail = decide & is_stop & ~b
        emit = decide & is_stop & b
        bad = decide & ~((pos == 0) | is_data | is_parity | is_stop)
        data_write = decide & is_data
        shift = torch.clamp(8 - pos, 0, 8)
        byte1 = torch.where(
            data_write, byte_cur | torch.bitwise_left_shift(
                b.to(torch.int32), shift), byte_cur)

        reset_full = eod | start_fail
        drop_frame = stop_fail | bad
        clear = reset_full | fire
        post_keep = post & ~reset_full
        ok_advance = decide & ~(start_fail | stop_fail | bad)

        vals.append(byte_cur)
        emits.append(emit)
        eods.append(eod)
        fires.append(fire)

        started = torch.where(reset_full | drop_frame, zero,
                              torch.where(fire, zero + 1, started))
        counter = torch.where(reset_full, zero, counter1)
        sil = torch.where(reset_full, zero, sil1)
        thr = torch.where(fire, mean * float(np.float32(0.1)), thr)
        accum = torch.where(clear, zero, torch.where(
            post_keep, torch.where(decide, zero, accum1), accum))
        count = torch.where(clear, zero, torch.where(
            post_keep, torch.where(decide, zero, count1), count))
        bsc = torch.where(clear, zero,
                          torch.where(post_keep, bsc1, bsc))
        nxt = torch.where(clear, zero,
                          torch.where(post_keep & decide, nxt + ds_per_bit,
                                      nxt))
        byte_cur = torch.where(clear | emit, zero,
                               torch.where(data_write, byte1, byte_cur))
        pos = torch.where(clear | emit, zero,
                          torch.where(ok_advance, pos + 1, pos))

    ints_out = torch.stack([started, counter, sil, accum, count, bsc, nxt,
                            byte_cur, pos, fillv])
    flts_out = torch.stack([thr, run_sum])
    if n_ds:
        planes = (torch.stack(vals), torch.stack(emits), torch.stack(eods),
                  torch.stack(fires))
    else:
        e = torch.zeros((0, B), dtype=torch.int32, device=bits.device)
        planes = (e, e.bool(), e.bool(), e.bool())
    return (ints_out, flts_out), planes


def compact(byte_vals: torch.Tensor, emits: torch.Tensor,
            eods: torch.Tensor, fires: torch.Tensor, maxb: int):
    """Masked-sum compaction of per-step planes (the reference's lax
    path, ``fsk_demod.demod_chunk``).  Returns (bytes_out u8 [B, maxb],
    byte_count, eod_fired, sync_fired, fire_t), i32 [B] each."""
    n_ds = emits.shape[0]
    t_idx = torch.arange(n_ds, dtype=torch.int32,
                         device=emits.device)[:, None]
    fire_t = torch.where(fires, t_idx, -1).amax(0) if n_ds else \
        torch.full(emits.shape[1:], -1, dtype=torch.int32,
                   device=emits.device)
    slot = torch.where(emits, torch.cumsum(emits.to(torch.int32), 0) - 1,
                       -1)
    vals = byte_vals & 0xFF
    cols = [torch.where(slot == j, vals, 0).sum(0) for j in range(maxb)]
    bytes_out = (torch.stack(cols, 1) if cols else
                 vals.new_zeros((emits.shape[1], 0))).to(torch.uint8)
    as_i32 = lambda m: m.to(torch.int32).sum(0, dtype=torch.int32)  # noqa: E731
    return (bytes_out, as_i32(emits), as_i32(eods), as_i32(fires),
            fire_t.to(torch.int32))


def stage_d_compact_plain(params: FSKParams, ints, flts, bit_fill, bits,
                          amps, ratios, sub_amps, maxb: int):
    """Plain PyTorch version of ``stage_d_compact``."""
    (ints_out, flts_out), planes = stage_d_plain(
        params, ints, flts, bit_fill, bits, amps, ratios, sub_amps)
    return (ints_out, flts_out) + compact(*planes, maxb)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

class _Coef(ctypes.Structure):
    """Mirror of ``FskFramingCoef`` in csrc/framing_step.cuh."""
    _fields_ = [("ds_per_bit", ctypes.c_int), ("quarter", ctypes.c_int),
                ("stop_pos", ctypes.c_int), ("parity_on", ctypes.c_int),
                ("amp_window", ctypes.c_int),
                ("sync_window", ctypes.c_int), ("wrap", ctypes.c_int),
                ("eod_steps", ctypes.c_int),
                ("sync_thr", ctypes.c_float)]


def _eod_steps(params: FSKParams) -> int:
    """ceil(eod_after): the kernels' ``sil1 >= eod_steps`` equals the
    plain version's ``float(sil1) >= eod_after`` for every int32 sil1
    while |eod_steps| < 2^24 (int-to-float rounding is monotone and exact
    below 2^24).  Raises beyond that bound."""
    n = int(np.ceil(np.float32(params.samples_for_eod)))
    if abs(n) >= 2 ** 24:
        raise ValueError(f"samples_for_eod {params.samples_for_eod}: the "
                         "kernels' integer EOD compare is exact only below "
                         "2^24 steps")
    return n


@functools.lru_cache(maxsize=64)
def _kernel_coef(params: FSKParams) -> _Coef:
    return _Coef(params.ds_samples_per_bit, params.quarter_bit,
                 params.stop_bit_position,
                 int(params.config.parity != "none"), params.amp_window,
                 params.sync_window, _wrap(params), _eod_steps(params),
                 float(np.float32(params.config.sync_threshold)))


def _entry():
    fn = _build.library("fsk_framing").wam_fsk_framing
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, ci, vp, vp, vp, vp, vp, vp, ci,
                       vp, vp, vp, vp, ctypes.POINTER(_Coef), vp]
        fn.restype = ci
    return fn


def _stage_d_entry():
    fn = _build.library("fsk_framing").wam_fsk_stage_d
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, ci, vp, vp, vp, vp, vp, vp, vp,
                       vp, vp, ctypes.POINTER(_Coef), vp]
        fn.restype = ci
    return fn


def _check_operands(ints, flts, bit_fill, bits, amps, ratios, sub_amps):
    n_ds, B = bits.shape
    _build.check(bits, "bits", torch.bfloat16, (n_ds, B))
    _build.check(amps, "amps", torch.float32, (n_ds, B))
    _build.check(ratios, "ratios", torch.float32, (n_ds, B))
    _build.check(sub_amps, "sub_amps", torch.float32, (None, B))
    if sub_amps.shape[0] < n_ds:
        raise ValueError("sub_amps: needs at least n_ds rows")
    _build.check(ints, "ints", torch.int32, (N_I32, B))
    _build.check(flts, "flts", torch.float32, (N_F32, B))
    _build.check(bit_fill, "bit_fill", torch.int32, (B,))


def stage_d(params: FSKParams, ints: torch.Tensor, flts: torch.Tensor,
            bit_fill: torch.Tensor, bits: torch.Tensor, amps: torch.Tensor,
            ratios: torch.Tensor, sub_amps: torch.Tensor):
    """Framing state machine over [n_ds, B] streams with per-step events
    (K8), the contract of ``stage_d_plain``.

    bits bf16, amps / ratios f32 [n_ds, B]; sub_amps f32 [>= n_ds, B]
    (the amplitude stream delayed by amp_window); ints i32 [10, B], flts
    f32 [2, B], bit_fill i32 [B].  Returns ((ints', flts'), (byte_vals
    i32, emits, eods, fires bool)), the planes [n_ds, B]."""
    global stage_d_launches
    if not _build.use_kernel(ints, flts, bit_fill, bits, amps, ratios,
                             sub_amps):
        return stage_d_plain(params, ints, flts, bit_fill, bits, amps,
                             ratios, sub_amps)
    _check_operands(ints, flts, bit_fill, bits, amps, ratios, sub_amps)
    n_ds, B = bits.shape
    new = dict(device=bits.device)
    ints_out = torch.empty((N_I32, B), dtype=torch.int32, **new)
    flts_out = torch.empty((N_F32, B), dtype=torch.float32, **new)
    byte_vals = torch.empty((n_ds, B), dtype=torch.int32, **new)
    flags = torch.empty((3, n_ds, B), dtype=torch.bool, **new)
    p = _build.ptr
    with torch.cuda.device(bits.device):
        err = _stage_d_entry()(
            p(bits), p(amps), p(ratios), p(sub_amps), n_ds, B, p(ints),
            p(flts), p(bit_fill), p(ints_out), p(flts_out), p(byte_vals),
            p(flags[0]), p(flags[1]), p(flags[2]),
            ctypes.byref(_kernel_coef(params)), _build.stream())
    _build.raise_on_error(err, "fsk_stage_d")
    stage_d_launches += 1
    return (ints_out, flts_out), (byte_vals, flags[0], flags[1], flags[2])


def stage_d_compact(params: FSKParams, ints: torch.Tensor,
                    flts: torch.Tensor, bit_fill: torch.Tensor,
                    bits: torch.Tensor, amps: torch.Tensor,
                    ratios: torch.Tensor, sub_amps: torch.Tensor,
                    maxb: int):
    """Framing state machine over one chunk with in-kernel compaction.

    bits bf16, amps / ratios f32 [n_ds, B]; sub_amps f32 [>= n_ds, B]
    (the amplitude stream delayed by amp_window); ints i32 [10, B], flts
    f32 [2, B], bit_fill i32 [B].  Returns (ints', flts', bytes_out u8
    [B, maxb], byte_count, eod_fired, sync_fired, fire_t), the last four
    i32 [B].  ``maxb`` must bound the bytes a chunk can hold
    (``fsk_demod.max_bytes``)."""
    global launches
    if not _build.use_kernel(ints, flts, bit_fill, bits, amps, ratios,
                             sub_amps):
        return stage_d_compact_plain(params, ints, flts, bit_fill, bits,
                                     amps, ratios, sub_amps, maxb)
    _check_operands(ints, flts, bit_fill, bits, amps, ratios, sub_amps)
    n_ds, B = bits.shape
    new = dict(device=bits.device)
    ints_out = torch.empty((N_I32, B), dtype=torch.int32, **new)
    flts_out = torch.empty((N_F32, B), dtype=torch.float32, **new)
    bytes_out = torch.empty((B, maxb), dtype=torch.uint8, **new)
    counts = torch.empty((4, B), dtype=torch.int32, **new)
    p = _build.ptr
    with torch.cuda.device(bits.device):
        err = _entry()(p(bits), p(amps), p(ratios), p(sub_amps), n_ds, B,
                       p(ints), p(flts), p(bit_fill), p(ints_out),
                       p(flts_out), p(bytes_out), maxb, p(counts[0]),
                       p(counts[1]), p(counts[2]), p(counts[3]),
                       ctypes.byref(_kernel_coef(params)), _build.stream())
    _build.raise_on_error(err, "fsk_framing")
    launches += 1
    return (ints_out, flts_out, bytes_out, counts[0], counts[1], counts[2],
            counts[3])
