"""Batched streaming FSK demodulator — PyTorch port.

Counterpart of ``webaudio_modem_tpu/ops/fsk_demod.py``, with the same
time-major [T, B] layout at function boundaries and the same four
stages per chunk:

  A+B. sequential stage (AGC, pre-filter, NCO, I/Q LPFs, 2x average,
       atan2 discriminator, post LPF, slicer) and the rolling ds-wide
       bit sums R — kernel K1, ``ops/kernels/fsk_seq.py`` (K7, the same
       kernel with ``emit_rsum=False``, where ds > 256);
  C.   frame-sync correlation: one exact f32 band matmul over R
       (``_sync_ratios_from_r``), or an exact cumsum form for ds > 256;
  D.   framing state machine and byte compaction — kernel K2,
       ``ops/kernels/fsk_framing.py``, at every chunk length;
  then the SignalQuality window refresh at the last sync fire.
``stage_d`` is stage D with per-step events instead of compaction —
kernel K8, the counterpart of the reference's ``_stage_d`` (which the
reference's chunk step takes where its compact kernel runs out of
slots; the port's K2 has no slot bound).
Stages C and D and the quality refresh are ``sync_and_frame``, which the
DBPSK chunk step (``ops/psk.py``) shares.  ``soft_stream`` is the
soft-value surface of the streaming soft decoder: K1 with every plane
and no R.

``demod_chunk`` runs K1 and K2 on CUDA tensors and their plain PyTorch
versions on CPU tensors; ``plain=True`` forces the plain versions on
any device (used to compare and time the kernels against them).
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import threading
from typing import Mapping, Tuple

import numpy as np
import torch

from webaudio_modem_tpu_torch.models.config import FSKParams
from webaudio_modem_tpu_torch.ops.kernels import fsk_framing, fsk_seq
from webaudio_modem_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class DemodState:
    """Carried demodulator state; per-channel planes are [.., B].

    The field packing matches the kernels' operands, so nothing is
    repacked per chunk:
      front    f32 [20, B]  ops/kernels/fsk_seq.py layout (AGC gain,
                            pre-filter, NCO phasor, I/Q and post filter
                            taps, last phase)
      ds_acc   f32 [2, B]   pending I / Q downsample sums
      bit_tail bf16 [W, B]  last W sliced bits
      r_tail   bf16 [W-ds, B] last W-ds rolling bit sums R
      amp_tail f32 [A, B]   last A amplitudes
      framing  i32 [9, B]   started, counter, sil, accum, count, bsc,
                            next_idx, byte_cur, pos
      quality  f32 [4, B]   last_sync_ratio, q_win_sum, q_win_sumsq,
                            q_win_cnt
    """

    front: torch.Tensor
    ds_acc: torch.Tensor
    bit_tail: torch.Tensor
    r_tail: torch.Tensor
    amp_tail: torch.Tensor
    bit_fill: torch.Tensor     # i32 [B] bits seen since configure/reset
    amp_fill: torch.Tensor     # i32 [B] amps seen since configure
    framing: torch.Tensor
    threshold: torch.Tensor    # f32 [B] adaptive silence threshold
    sync_count: torch.Tensor   # i32 [B]
    eod_count: torch.Tensor    # i32 [B]
    quality: torch.Tensor

    def replace(self, **kwargs) -> "DemodState":
        return dataclasses.replace(self, **kwargs)

    @property
    def started(self) -> torch.Tensor:
        return self.framing[0] > 0

    @property
    def counter(self) -> torch.Tensor:
        return self.framing[1]


@dataclasses.dataclass
class DemodOut:
    bytes_out: torch.Tensor       # u8 [B, maxb] compacted decoded bytes
    byte_count: torch.Tensor      # i32 [B]
    sync_fired: torch.Tensor      # i32 [B] syncs detected in this chunk
    eod_fired: torch.Tensor       # i32 [B] EOD events in this chunk
    mean_amplitude: torch.Tensor  # f32 [B] mean I/Q amplitude


def init_state(params: FSKParams, batch: int = 1,
               device="cuda") -> DemodState:
    """A fresh carried state of ``batch`` channels on ``device`` (the card
    unless the caller asks for the CPU)."""
    device = resolve_device(device)
    f32, i32 = torch.float32, torch.int32
    W = params.sync_window
    front = torch.zeros((fsk_seq.N_FRONT, batch), dtype=f32, device=device)
    front[0] = 1.0      # AGC gain
    front[5] = 1.0      # NCO phasor (cos, sin) = (1, 0)
    return DemodState(
        front=front,
        ds_acc=torch.zeros((2, batch), dtype=f32, device=device),
        bit_tail=torch.zeros((W, batch), dtype=torch.bfloat16,
                             device=device),
        r_tail=torch.zeros((W - params.ds_samples_per_bit, batch),
                           dtype=torch.bfloat16, device=device),
        amp_tail=torch.zeros((params.amp_window, batch), dtype=f32,
                             device=device),
        bit_fill=torch.zeros((batch,), dtype=i32, device=device),
        amp_fill=torch.zeros((batch,), dtype=i32, device=device),
        framing=torch.zeros((9, batch), dtype=i32, device=device),
        threshold=torch.full((batch,), 0.01, dtype=f32, device=device),
        sync_count=torch.zeros((batch,), dtype=i32, device=device),
        eod_count=torch.zeros((batch,), dtype=i32, device=device),
        quality=torch.zeros((4, batch), dtype=f32, device=device),
    )


def max_bytes(params: FSKParams, n_ds: int) -> int:
    """Upper bound on bytes decodable from ``n_ds`` downsampled steps:
    after sync a byte takes at least (bits_per_byte - 1) * ds steps."""
    per_byte = (params.bits_per_byte - 1) * params.ds_samples_per_bit
    return n_ds // max(per_byte, 1) + 2


# ---------------------------------------------------------------------------
# Carrying a JAX stream across
# ---------------------------------------------------------------------------

# front rows, in fsk_seq's layout, from the reference DemodState fields
_FRONT_FIELDS = (("agc_gain", 1), ("pre", 4), ("phi", 2), ("iq_i", 4),
                 ("iq_q", 4), ("last_phase", 1), ("post", 4))
_FRAMING_FIELDS = ("started", "counter", "sil", "accum", "count", "bsc",
                   "next_idx", "byte_cur", "pos")
_QUALITY_FIELDS = ("last_sync_ratio", "q_win_sum", "q_win_sumsq",
                   "q_win_cnt")


def _fields_from_reference(fields: Mapping[str, np.ndarray], device,
                           front_fields) -> dict:
    """The port's state fields, by name, from a reference state's numpy
    fields; ``front_fields`` lists the reference fields packed into the
    ``front`` plane, in order."""
    def f32(name):
        return np.asarray(fields[name], dtype=np.float32)

    def rows(names, dtype):
        return torch.from_numpy(np.stack(
            [np.asarray(fields[n]).astype(dtype) for n in names])).to(device)

    B = f32("agc_gain").shape[-1]
    front = np.concatenate([f32(n).reshape(k, B) for n, k in front_fields])
    ds_acc = np.stack([f32("ds_iacc"), f32("ds_qacc")])
    t = lambda a, dt=torch.float32: torch.from_numpy(  # noqa: E731
        np.array(a)).to(device=device, dtype=dt)
    return dict(
        front=t(front), ds_acc=t(ds_acc),
        bit_tail=t(f32("bit_tail"), torch.bfloat16),
        r_tail=t(f32("r_tail"), torch.bfloat16),
        amp_tail=t(f32("amp_tail")),
        bit_fill=t(np.asarray(fields["bit_fill"]), torch.int32),
        amp_fill=t(np.asarray(fields["amp_fill"]), torch.int32),
        framing=rows(_FRAMING_FIELDS, np.int32),
        threshold=t(f32("threshold")),
        sync_count=t(np.asarray(fields["sync_count"]), torch.int32),
        eod_count=t(np.asarray(fields["eod_count"]), torch.int32),
        quality=rows(_QUALITY_FIELDS, np.float32),
    )


def _fields_to_reference(state: DemodState, front_fields) -> dict:
    """The inverse of ``_fields_from_reference``."""
    n = lambda t: t.detach().to("cpu", torch.float32).numpy()  # noqa: E731
    front = n(state.front)
    out, row = {}, 0
    for name, k in front_fields:
        out[name] = front[row] if k == 1 else tuple(front[row:row + k])
        row += k
    out["ds_iacc"], out["ds_qacc"] = n(state.ds_acc)
    out["bit_tail"] = n(state.bit_tail)
    out["r_tail"] = n(state.r_tail)
    out["amp_tail"] = n(state.amp_tail)
    framing = state.framing.cpu().numpy()
    for i, name in enumerate(_FRAMING_FIELDS):
        out[name] = framing[i]
    out["started"] = framing[0] > 0
    for name in ("bit_fill", "amp_fill", "sync_count", "eod_count"):
        out[name] = getattr(state, name).cpu().numpy()
    out["threshold"] = n(state.threshold)
    for i, name in enumerate(_QUALITY_FIELDS):
        out[name] = n(state.quality[i])
    return out


def state_from_reference(fields: Mapping[str, np.ndarray],
                         device) -> DemodState:
    """Build the port's state from a reference ``DemodState`` given as
    numpy arrays by field name (``state._asdict()`` with each leaf, or
    tuple of leaves, converted by ``np.asarray``; bf16 planes as their
    exact float32 values).  A reference stream can then be continued by
    the port mid-stream."""
    return DemodState(**_fields_from_reference(fields, device,
                                               _FRONT_FIELDS))


def state_to_reference(state: DemodState) -> dict:
    """The inverse of ``state_from_reference``: numpy arrays keyed by the
    reference's field names, tuple fields as tuples of [B] rows, bf16
    planes as float32 and ``started`` as bool."""
    return _fields_to_reference(state, _FRONT_FIELDS)


# ---------------------------------------------------------------------------
# Stage C: frame-sync correlation
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _sync_sign_const(params: FSKParams, n_tau: int) -> Tuple[np.ndarray,
                                                             int]:
    """±1 pattern-sign band matrix for the R-based correlation:
    matched(tau*ds + phi) = Σ_m sign2[tau, m]·r3v[m, phi] + n_zero·ds with
    m = n_pat-1-j+tau for pattern blocks j = 1..n_pat-1 (block j = 0 is
    the reference's out-of-bounds pattern index: it never matches).
    Returns (sign2 [n_tau, n_tau + n_pat - 2] f32, n_zero_blocks)."""
    n_pat = len(params.pattern_bits)
    sign2 = np.zeros((n_tau, n_tau + n_pat - 2), np.float32)
    for tau in range(n_tau):
        for j in range(1, n_pat):
            sign2[tau, n_pat - 1 - j + tau] = (
                1.0 if params.pattern_bits[n_pat - j] else -1.0)
    n_zero = sum(1 for j in range(1, n_pat)
                 if params.pattern_bits[n_pat - j] == 0)
    return sign2, n_zero


@functools.lru_cache(maxsize=64)
def _sync_sign_tensor(params: FSKParams, n_tau: int,
                      device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_sync_sign_const(params, n_tau)[0]).to(device)


@contextlib.contextmanager
def _full_f32_matmul():
    """Run float32 matmuls in full float32 (no TF32) inside the block.
    Every operand and partial sum of the sync contraction is an integer
    below 2^24, so it is exact then, in any summation order."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _sync_ratios_from_r(params: FSKParams, r_tail: torch.Tensor,
                        rsum: torch.Tensor) -> torch.Tensor:
    """Sync match ratio [n_ds, B] from the carried and fresh rolling bit
    sums (``r_tail`` [W-ds, B], ``rsum`` [n_ds, B]).  The contraction
    runs over the major axis of pure reshapes as two f32 matmuls, one
    per operand (the tail splits into whole ds-blocks), exact."""
    ds = params.ds_samples_per_bit
    n_pat = len(params.pattern_bits)
    n_ds, B = rsum.shape
    n_tau = -(-n_ds // ds)
    n_zero = _sync_sign_const(params, n_tau)[1]
    sign2 = _sync_sign_tensor(params, n_tau, rsum.device)
    Mt = n_pat - 1        # whole ds-blocks in the tail
    Mf = n_tau - 1        # fresh blocks consumed (the newest never match)
    with _full_f32_matmul():
        m3 = sign2[:, :Mt] @ r_tail.reshape(Mt, ds * B).to(torch.float32)
        if Mf:
            m3 = m3 + sign2[:, Mt:] @ rsum[:Mf * ds].reshape(
                Mf, ds * B).to(torch.float32)
    matched = m3.reshape(n_tau * ds, B)[:n_ds] + float(n_zero * ds)
    return matched / params.sync_window


def _sync_ratios_cumsum(params: FSKParams,
                        ext_bits: torch.Tensor) -> torch.Tensor:
    """Exact cumsum form for any ds, from ext_bits [W + n_ds, B]:
    matched(t) = Σ_{j=1..n_pat-1} (p_j ? R(t-j·ds) : ds - R(t-j·ds))."""
    ds = params.ds_samples_per_bit
    n_pat = len(params.pattern_bits)
    W = params.sync_window
    n_ds = ext_bits.shape[0] - W
    ext = ext_bits.to(torch.float32)
    csum = torch.cumsum(torch.cat([torch.zeros_like(ext[:1]), ext]), 0)
    base, hi = ds, W - ds + n_ds
    r = csum[base + 1:hi + 1] - csum[base + 1 - ds:hi + 1 - ds]
    matched = torch.zeros_like(ext[:n_ds])
    n_zero = 0
    for j in range(1, n_pat):
        p = params.pattern_bits[n_pat - j]
        n_zero += p == 0
        off = W - j * ds - base
        rj = r[off:off + n_ds]
        matched = matched + (rj if p == 1 else -rj)
    matched = matched + float(n_zero * ds)
    return matched / W


# ---------------------------------------------------------------------------
# Stage D carry and the quality window
# ---------------------------------------------------------------------------

def _framing_carry(params: FSKParams, state: DemodState):
    """(ints [10, B], flts [2, B]) for fsk_framing: the framing registers
    plus the amp-window fill, and the threshold plus the exact window sum
    over amp_tail — re-anchored every chunk, so rolling f32 error cannot
    build up across a stream."""
    fillv = torch.clamp_max(state.amp_fill, params.amp_window)
    ints = torch.cat([state.framing, fillv[None]])
    flts = torch.stack([state.threshold, state.amp_tail.sum(0)])
    return ints, flts


def stage_d(params: FSKParams, state: DemodState, bits, amps, ratios,
            sub_amps, plain: bool = False):
    """Stage D with per-step events: the framing state machine over
    [n_ds, B] streams from ``state``'s framing registers and amp window,
    the sync gate from ``state.bit_fill``.  ``sub_amps`` is the amplitude
    stream delayed by amp_window (``cat([state.amp_tail, amps])``; rows
    0..n_ds-1 are read).  Runs K8 on CUDA tensors and its plain version
    on CPU tensors or where ``plain=True``.  Returns ((ints', flts'),
    (byte_vals i32, emits, eods, fires bool)) with the planes [n_ds, B]
    and the carry in K2's layout (``_framing_carry``)."""
    ints, flts = _framing_carry(params, state)
    framing = fsk_framing.stage_d_plain if plain else fsk_framing.stage_d
    return framing(params, ints, flts, state.bit_fill, bits, amps, ratios,
                   sub_amps)


def quality_window_update(params: FSKParams, quality: torch.Tensor,
                          ratios: torch.Tensor, softs: torch.Tensor,
                          fire_t: torch.Tensor) -> torch.Tensor:
    """Refresh the SignalQuality accumulators [4, B] at the last sync
    fire of the chunk: the peak match ratio near the fire, and Σ soft,
    Σ soft² and the count over the sync window ending at that peak.
    A fire within a bit period of the chunk end keeps the old values
    (its peak may lie in the next chunk).  Branchless: channels without
    a fire keep their values, and no host sync happens."""
    n_ds = softs.shape[0]
    dsb = params.ds_samples_per_bit
    t_idx = torch.arange(n_ds, dtype=torch.int32,
                         device=softs.device)[:, None]
    has_fire = (fire_t >= 0) & (fire_t + dsb <= n_ds - 1)
    near = (t_idx >= fire_t[None] - dsb) & (t_idx <= fire_t[None] + dsb)
    peak_ratio = torch.where(near, ratios, -1.0).amax(0)
    t_peak = torch.where(near & (ratios >= peak_ratio[None]), t_idx,
                         -1).amax(0)
    in_win = (t_idx <= t_peak[None]) & \
        (t_idx > t_peak[None] - params.sync_window)
    fresh = torch.stack([
        peak_ratio,
        torch.where(in_win, softs, 0.0).sum(0),
        torch.where(in_win, softs * softs, 0.0).sum(0),
        in_win.to(torch.float32).sum(0)])
    return torch.where(has_fire[None], fresh, quality)


# ---------------------------------------------------------------------------
# Full chunk step
# ---------------------------------------------------------------------------

def sync_and_frame(params: FSKParams, state: DemodState, bits, amps,
                   softs, rsum, *, plain: bool = False, **carried):
    """Stages C and D and the quality window, shared by the FSK and DBPSK
    chunk steps: from the sequential stage's planes [n_ds, B] (``rsum``
    None where ds > 256), the sync ratios, the framing kernel K2 and the
    quality refresh.  Returns (state', DemodOut), with the family's own
    sequential-stage fields ``carried`` (front, ds_acc, ...) set in
    state'.  ``plain=True`` runs K2's plain version on any device."""
    B = bits.shape[1]
    dev = bits.device
    ds = params.ds_samples_per_bit
    W = params.sync_window
    n_ds = bits.shape[0]
    maxb = max_bytes(params, n_ds)
    if n_ds == 0:
        zi = torch.zeros((B,), dtype=torch.int32, device=dev)
        return state.replace(**carried), DemodOut(
            bytes_out=torch.zeros((B, maxb), dtype=torch.uint8, device=dev),
            byte_count=zi, sync_fired=zi.clone(), eod_fired=zi.clone(),
            mean_amplitude=torch.zeros((B,), dtype=torch.float32,
                                       device=dev))

    ext_amps = torch.cat([state.amp_tail, amps])
    if rsum is not None:
        ratios = _sync_ratios_from_r(params, state.r_tail, rsum)
        r_tail = (rsum[-(W - ds):] if n_ds >= W - ds else
                  torch.cat([state.r_tail, rsum])[-(W - ds):]).clone()
        bit_tail = (bits[-W:] if n_ds >= W else
                    torch.cat([state.bit_tail, bits])[-W:]).clone()
    else:
        ext_bits = torch.cat([state.bit_tail, bits])
        ratios = _sync_ratios_cumsum(params, ext_bits)
        r_tail = state.r_tail
        bit_tail = ext_bits[-W:].clone()

    framing = (fsk_framing.stage_d_compact_plain if plain
               else fsk_framing.stage_d_compact)
    ints, flts = _framing_carry(params, state)
    (ints_out, flts_out, bytes_out, byte_count, eod_fired, sync_fired,
     fire_t) = framing(params, ints, flts, state.bit_fill, bits, amps,
                       ratios, ext_amps, maxb)
    quality = quality_window_update(params, state.quality, ratios, softs,
                                    fire_t)
    new_state = state.replace(
        bit_tail=bit_tail, r_tail=r_tail,
        amp_tail=ext_amps[-params.amp_window:].clone(),
        bit_fill=torch.clamp_max(state.bit_fill + n_ds, 2 ** 30),
        amp_fill=torch.clamp_max(state.amp_fill + n_ds, 2 ** 30),
        framing=ints_out[:9], threshold=flts_out[0],
        sync_count=state.sync_count + sync_fired,
        eod_count=state.eod_count + eod_fired,
        quality=quality, **carried)
    return new_state, DemodOut(
        bytes_out=bytes_out, byte_count=byte_count, sync_fired=sync_fired,
        eod_fired=eod_fired, mean_amplitude=amps.mean(0))


def demod_chunk(params: FSKParams, ds_phase: int, state: DemodState,
                samples: torch.Tensor, plain: bool = False
                ) -> Tuple[DemodState, DemodOut]:
    """Process one f32 [B, T] sample frame; returns (state', outputs).

    ``ds_phase`` = samples already pending in the downsample accumulator
    (host-tracked: (previous ds_phase + T) % downsample_ratio).
    ``plain=True`` runs the plain PyTorch versions of K1 and K2 on
    whatever device the tensors are on."""
    ds = params.ds_samples_per_bit
    # R is exact in bf16 only up to ds = 256; above it K7 (no R) runs and
    # stage C takes the exact cumsum form over the bits
    use_r = ds <= 256
    seq = fsk_seq.seq_plain if plain else fsk_seq.seq
    front, ds_acc, bits, amps, softs, rsum = seq(
        params, ds_phase, state.front, state.ds_acc,
        state.bit_tail[-ds:] if use_r else None, samples.t().contiguous(),
        emit_rsum=use_r)
    return sync_and_frame(params, state, bits, amps, softs, rsum,
                          plain=plain, front=front, ds_acc=ds_acc)


def make_demod_chunk(params: FSKParams, ds_phase: int, donate: bool = True):
    """``demod_chunk`` bound to (params, ds_phase): the counterpart of the
    reference's jitted step, with no compilation.  ``donate`` is the
    reference's buffer-donation switch, accepted for its callers: the
    step returns new state tensors and donates nothing, so the state
    passed in stays valid for either value."""
    return functools.partial(demod_chunk, params, ds_phase)


# ---------------------------------------------------------------------------
# SignalQuality
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _quality_calibration(params: FSKParams):
    """The FSK family's ``quality_calibration``: the plain sequential
    stage (B=1, CPU) over a clean preamble+SFD+payload signal."""
    from webaudio_modem_tpu_torch.ops import fsk_mod

    x = fsk_mod.modulate_batch(params, [b"\x55"], "cpu").t().contiguous()
    state = init_state(params, 1, "cpu")
    _, _, bits, amps, softs, _ = fsk_seq.seq_plain(
        params, 0, state.front, state.ds_acc, None, x, emit_rsum=False)
    return quality_calibration(params, state, bits, amps, softs)


def quality_calibration(params: FSKParams, state: DemodState, bits, amps,
                        softs):
    """Clean-signal discriminator statistics over the sync window.

    From a family's sequential-stage planes [n, 1] over a clean
    preamble+SFD+payload signal (from ``state``, a fresh B=1 CPU state),
    runs stages C and D plainly and records, anchored at the
    sync-correlation peak, the peak match ratio and, for every suffix
    length c of the window, the mean and variance of the soft
    discriminator.  Returns (mean_table [W+1], var_table [W+1],
    peak_ratio), numpy float64, index = sample count.  Each family builds
    it lazily at the first quality query of a configuration."""
    W = params.sync_window
    dsb = params.ds_samples_per_bit
    ratios = _sync_ratios_cumsum(params, torch.cat([state.bit_tail, bits]))
    _, (_, _, _, fires) = stage_d(params, state, bits, amps, ratios,
                                  torch.cat([state.amp_tail, amps]))
    fires_np = fires[:, 0].numpy()
    softs_np = softs[:, 0].double().numpy()
    ratios_np = ratios[:, 0].double().numpy()
    fire_idx = np.nonzero(fires_np)[0]
    mean_t = np.zeros(W + 1)
    var_t = np.zeros(W + 1)
    if len(fire_idx) == 0:  # pattern too weak to self-sync (unusual)
        return mean_t, var_t, float((W - dsb) / W)
    t_fire = int(fire_idx[0])
    lo_n = max(0, t_fire - dsb)
    hi_n = min(len(ratios_np), t_fire + dsb + 1)
    t_peak = lo_n + int(np.argmax(ratios_np[lo_n:hi_n]))
    cal_ratio = float(ratios_np[t_peak])
    lo = max(0, t_peak - W + 1)
    win = softs_np[lo:t_peak + 1][::-1]       # newest-first suffixes
    cs = np.cumsum(win)
    cs2 = np.cumsum(win * win)
    n = len(win)
    cnt = np.arange(1, n + 1, dtype=np.float64)
    mean_t[1:n + 1] = cs / cnt
    var_t[1:n + 1] = np.maximum(cs2 / cnt - (cs / cnt) ** 2, 0.0)
    if n < W:  # extend with the full-window stats
        mean_t[n + 1:] = mean_t[n]
        var_t[n + 1:] = var_t[n]
    return mean_t, var_t, cal_ratio


def quality_from_state(params: FSKParams, state: DemodState,
                       delay_ds: int = 1, family: str = "fsk", *,
                       calibration=None, separation=None):
    """SignalQuality estimates [B] from the carried accumulators, as
    numpy: (ber, frequency_offset_hz, phase_jitter, eye_opening), each a
    differential measurement against ``calibration``, the family's
    ``quality_calibration`` tables (None: those of ``family``, "fsk" or
    "psk" for DBPSK, whose caller passes ``delay_ds`` = one bit period):

    * ``ber``: re-sliced bit errors in the known preamble+SFD window,
      (calibrated peak ratio - measured) over the W - ds valid positions;
    * ``frequency_offset``: the window's mean discriminator output minus
      the calibration mean for the same window length, in Hz, scaled by
      the differential delay ``delay_ds`` (one ds-step for FSK, one bit
      period, ds, for DBPSK);
    * ``phase_jitter``: sqrt of the variance above the calibration's;
    * ``eye_opening``: 1 - jitter / (class separation / 4), in [0, 1],
      with ``separation`` in radians (None: the FSK discriminator's level
      separation, or pi for "psk", the constellation points at 0 and pi);
      0 until a frame has synced.
    """
    if family not in ("fsk", "psk"):
        raise ValueError(f"family {family!r}: 'fsk' or 'psk'")
    q = state.quality.detach().to("cpu", torch.float64).numpy()
    lsr, wsum, wsq, wcnt = q
    W = params.sync_window
    n_valid = W - params.ds_samples_per_bit
    mean_t, var_t, cal_ratio = (_family_calibration(params, family)
                                if calibration is None else calibration)
    ber = np.where(lsr > 0,
                   np.clip((cal_ratio - lsr) * W / max(n_valid, 1),
                           0.0, 1.0),
                   0.0)
    idx = np.clip(wcnt.astype(np.int64), 0, W)
    have = wcnt >= 1
    mean = wsum / np.maximum(wcnt, 1.0)
    var = np.maximum(wsq / np.maximum(wcnt, 1.0) - mean * mean, 0.0)
    # the quadrature NCO yields phase -(w_tone - w_c)t, so a positive
    # carrier offset shows up as a negative mean shift
    hz_per_rad = params.downsample_rate / (2.0 * np.pi * delay_ds)
    freq = np.where(have, -(mean - mean_t[idx]) * hz_per_rad, 0.0)
    jitter = np.where(have, np.sqrt(np.maximum(var - var_t[idx], 0.0)),
                      0.0)
    if separation is None and family == "psk":
        separation = np.pi
    elif separation is None:
        dev_hz = abs(params.space_freq - params.mark_freq) / 2.0
        separation = 2.0 * (2.0 * np.pi * dev_hz / params.downsample_rate)
    eye = np.where(have,
                   np.clip(1.0 - jitter / (separation / 4.0), 0.0, 1.0),
                   0.0)
    return ber, freq, jitter, eye


# Build the quality calibration ahead of the first SignalQuality query (a
# facade's configure() calls ``warm_quality_calibration``); tests may pin
# it off.
AUTO_WARM_QUALITY = True
_warm_started: set = set()
_warm_threads: list = []


def _join_warm_threads() -> None:
    """atexit: wait out background builds still running, so none is torn
    down mid-computation at interpreter exit."""
    for t in _warm_threads:
        t.join(timeout=30)
    _warm_threads.clear()


def _family_calibration(params: FSKParams, family: str):
    """The ``quality_calibration`` tables of ``family``, lru-cached by
    each family's builder (``ops.psk`` is imported here, not at module
    import: it imports this module)."""
    if family == "psk":
        from webaudio_modem_tpu_torch.ops import psk

        return psk._quality_calibration(params)
    return _quality_calibration(params)


def warm_quality_calibration(params: FSKParams, family: str = "fsk",
                             background: bool = True) -> None:
    """Build the clean-signal calibration of ``family`` ("fsk", or "psk"
    for DBPSK) ahead of the first ``get_signal_quality`` poll.
    Idempotent per (params, family); with ``background`` the build runs
    on a daemon thread so ``configure()`` never blocks on it (a
    concurrent poll at worst duplicates the lru-cached build), else on
    the caller's thread."""
    if family not in ("fsk", "psk"):
        raise ValueError(f"family {family!r}: 'fsk' or 'psk'")
    key = (params, family)
    if key in _warm_started:
        return
    _warm_started.add(key)
    if not background:
        _family_calibration(params, family)
        return

    def build():
        try:
            _family_calibration(params, family)
        except Exception:  # noqa: BLE001 — the lazy path retries it
            _warm_started.discard(key)

    if not _warm_threads:
        atexit.register(_join_warm_threads)
    t = threading.Thread(target=build, daemon=True, name="wam-quality-warm")
    _warm_threads.append(t)
    t.start()


# ---------------------------------------------------------------------------
# Soft-value surface
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SoftOut:
    """Result of ``soft_stream``: time-major numpy planes [n_ds, B] and the
    carry for the next chunk."""

    bits: np.ndarray     # hard-sliced bits (float32 0/1)
    amps: np.ndarray     # I/Q amplitudes
    softs: np.ndarray    # analog post-LPF discriminator
    state: DemodState    # carry: feed back with the next chunk
    ds_phase: int        # carry: downsample phase of the next chunk


def soft_stream(params: FSKParams, samples, state: DemodState = None,
                ds_phase: int = 0, device="cuda") -> SoftOut:
    """The soft-value surface (the FEC memo's SoftDecisionDemodulator): K1
    with every plane and no R, on ``device``.

    ``samples`` [B, T] or [T] (numpy or a tensor).  Returns numpy planes
    [n_ds, B]: ``softs`` is the analog discriminator whose sign (times the
    polarity) is the hard bit.  Streaming: pass ``out.state`` and
    ``out.ds_phase`` back with the next chunk; the concatenated planes
    equal one whole-signal call."""
    device = resolve_device(device)
    if not isinstance(samples, torch.Tensor):
        samples = torch.from_numpy(np.array(samples, np.float32))
    x = samples.to(device=device, dtype=torch.float32)
    if x.dim() == 1:
        x = x[None]
    if state is None:
        state = init_state(params, x.shape[0], device)
    front, ds_acc, bits, amps, softs, _ = fsk_seq.seq(
        params, ds_phase, state.front, state.ds_acc, None,
        x.t().contiguous(), emit_rsum=False)
    # one copy to the host for the three planes
    planes = torch.stack([bits.to(torch.float32), amps, softs]).cpu().numpy()
    return SoftOut(planes[0], planes[1], planes[2],
                   state.replace(front=front, ds_acc=ds_acc),
                   (ds_phase + x.shape[1]) % params.downsample_ratio)
