"""Soft-decision FSK + FEC farm path — PyTorch port.

Counterpart of ``webaudio_modem_tpu/ops/soft_fsk.py`` for the farm
decode (``decode_frames_batch`` / ``decode_frames_batch_async``, the
path of ``bench.py --family soft``) and the frame builders:

  TX  ``encode_frames_batch``: payloads -> [LEN+CRC | payload+CRC]
      frames, convolutionally coded (rate 1/2, K=7, ``ops/fec.py``),
      after the preamble+SFD pattern -> phase-continuous FSK, one
      synthesis on the device; ``frames_synth_device_fn``: the same
      signals, sample for sample, framed on the device from a [B, pl]
      payload plane (the soft farm hubs' cohort synthesis).
  RX  ``_decode_frames_fused``, one pass over the batch on the device:
      1. K1 (``ops/kernels/fsk_seq.py``) with the bit and amp streams
         dropped and the softs slot holding their inclusive f32 running
         sum (``emit_csum``), plus R;
      2. the sync peak from R (one launch of ``ops/kernels/sync_peak.py``:
         the banded correlation, its first maximum and gate), the
         header LLR windows at every grid offset around it (K4 at
         stride 1, ``ops/kernels/align.py``), top-k pruning by the
         windowed-|LLR| score, and ONE batched Viterbi over the B x k
         candidates (K3, ``ops/kernels/viterbi.py``);
      3. ``_select_candidate``: the first candidate whose header CRC and
         LEN pass (the CRC one launch of ``ops/kernels/crc16.py``);
      4. the body LLR windows at each channel's chosen grid (K4 at
         stride ds) and ONE batched Viterbi over the B bodies (K3);
      5. ``_pack_bodies``: the body CRC gate and one [B, payload + 1]
         uint8 plane (payload bytes + ok flag), one launch of
         ``crc16.pack_bodies``.
      Nothing in it waits for the device: no ``.item()``, no branch on
      a tensor, no copy to the host before the packed plane.
      Each stage is a ``metrics`` timer (soft.k1, soft.sync,
      soft.header, soft.select, soft.body, soft.pack), inside
      ``decode_frames_batch_async``'s soft.dispatch beside soft.copy, and
      its finalizer is soft.finalize around soft.finalize.wait: spans in
      a ``torch.profiler`` trace while one records (``utils/trace.py``).

The header and body helpers also serve the blind receiver
(``ops/soft_blind.py``), which hands them windows of its soft ring
prefix-summed by K5 (``_csum0``), a ``top_k`` of its own and no
payload length (``_select_candidate(max_len=...)``).

The streaming single-channel path, ``decode_frame_signal``,
``SoftFrameDecoder`` and ``decode_frame_chunks``, runs K1 through
``fsk_demod.soft_stream`` and the Viterbi (K3) per sync candidate; the
rest of it is numpy on the host, as in the reference.

The Reed-Solomon outer code (``rs_parity``) and the block body codes
(``body_code``) belong to slice E of the port (ROADMAP queue 1, item
14) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from webaudio_modem_tpu_torch.models.config import FSKParams
from webaudio_modem_tpu_torch.ops import fec, fsk_demod, fsk_mod
from webaudio_modem_tpu_torch.ops.kernels import (align, crc16, cumsum0,
                                                  fsk_seq, sync_peak)
from webaudio_modem_tpu_torch.utils.crc16 import CRC16
from webaudio_modem_tpu_torch.utils.device import resolve_device
from webaudio_modem_tpu_torch.utils.trace import metrics

HEADER_PLAIN = fec.FRAME_HEADER_PLAIN  # LEN(2) + CRC16(LEN)
HEADER_CODED_BITS = 2 * (8 * HEADER_PLAIN + fec.K - 1)

# Header-grid candidates per channel that survive the alignment score
# and reach the candidate Viterbi (the reference's HEADER_TOP_K: the
# best-scoring decodable offset ranks <= 7 near the decode cliff, so
# top-8 keeps frame success of the full grid).
HEADER_TOP_K = 8


def _body_coded_bits(payload_len: int, rs_parity: int = 0,
                     body_code=None) -> int:
    if body_code is not None:
        n_cw = -(-8 * (payload_len + 2) // body_code.k)
        return n_cw * body_code.n
    return 2 * (8 * (payload_len + 2 + rs_parity) + fec.K - 1)


def _check_rs(payload_len: int, rs_parity: int, body_code=None) -> None:
    """The reference's validation of the body-code options; then, for
    any option the port does not run yet, ``NotImplementedError``."""
    if body_code is not None and rs_parity:
        raise ValueError("rs_parity is the concatenated mode of the "
                         "convolutional body code; it cannot combine "
                         "with an alternate body_code")
    if rs_parity:
        if rs_parity % 2 or rs_parity < 2:
            raise ValueError(
                f"rs_parity must be even >= 2, got {rs_parity}")
        if payload_len + 2 + rs_parity > 255:
            raise ValueError(
                f"RS codeword {payload_len + 2 + rs_parity} bytes exceeds "
                "255; shorten the payload or the parity")
    if rs_parity or body_code is not None:
        raise NotImplementedError(
            "rs_parity / body_code: the Reed-Solomon outer code and the "
            "LDPC / turbo body codes are ported in slice E (ROADMAP "
            "queue 1, item 14)")


# ---------------------------------------------------------------------------
# TX
# ---------------------------------------------------------------------------

def encode_frame_signal(params: FSKParams, payload: bytes,
                        rs_parity: int = 0, body_code=None,
                        device="cuda") -> np.ndarray:
    """payload -> FSK signal carrying a coded frame (float32 numpy [T])."""
    payload = bytes(payload)
    _check_rs(len(payload), rs_parity, body_code)
    body = fec.build_frame_body(payload)
    coded = np.concatenate([
        fec.conv_encode_bits(fec.bytes_to_bits(
            fec.build_frame_header(len(payload)))),
        fec.conv_encode_bits(fec.bytes_to_bits(body))])
    bits = np.concatenate([np.asarray(params.pattern_bits, np.int8),
                           coded.astype(np.int8)])
    return fsk_mod.modulate_bits(params, bits, resolve_device(device))


def encode_frames_batch(params: FSKParams, payloads, rs_parity: int = 0,
                        body_code=None, device="cuda") -> torch.Tensor:
    """Equal-length payloads -> FSK signals f32 [B, T] on ``device``, one
    synthesis.  Same frame layout as ``encode_frame_signal`` (sync
    pattern + coded header + coded body, lead/trail padding); framing
    and the exact integer phase prefix run on the host (vectorized conv
    encode and CRC), the sine expansion on the device, as
    ``fsk_mod.modulate_batch``."""
    payloads = [bytes(p) for p in payloads]
    if not payloads:
        raise ValueError("encode_frames_batch requires >= 1 payload")
    if len({len(p) for p in payloads}) != 1:
        raise ValueError("encode_frames_batch requires equal-length "
                         "payloads")
    _check_rs(len(payloads[0]), rs_parity, body_code)
    device = resolve_device(device)
    B = len(payloads)
    hdr_coded = fec.conv_encode_bits(fec.bytes_to_bits(
        fec.build_frame_header(len(payloads[0])))).astype(np.int8)
    pl = len(payloads[0])
    pay = np.frombuffer(b"".join(payloads), np.uint8).reshape(B, pl)
    crcs = CRC16.calculate_rows(pay)
    body_bytes = np.concatenate(
        [pay, (crcs >> 8).astype(np.uint8)[:, None],
         (crcs & 0xFF).astype(np.uint8)[:, None]], axis=1)
    body_coded = fec.conv_encode_bits_batch(
        np.unpackbits(body_bytes, axis=1)).astype(np.int8)
    pattern = np.asarray(params.pattern_bits, np.int8)
    bits = np.concatenate([
        np.broadcast_to(pattern, (B, pattern.shape[0])),
        np.broadcast_to(hdr_coded, (B, hdr_coded.shape[0])),
        body_coded], axis=1)
    return fsk_mod.synth_bits_batch(params, bits, params.samples_per_bit * 2,
                                    device)


@functools.lru_cache(maxsize=None)
def frames_synth_device_fn(params: FSKParams, payload_len: int):
    """``synth(pay, device="cuda")``: a [B, payload_len] uint8 payload
    plane -> f32 [B, T] frame signals, the framing and the synthesis both
    on ``device`` (the convolutional body; no RS / block code).

    ``encode_frames_batch`` frames on the host and uploads the phase
    prefix and the bits of every sample row; this uploads only the
    payload bytes and runs on the device:

      * CRC16 per row: ``_crc16_bits_device`` over the payload bits
        (one launch of ``crc16.crc_rows`` on the card);
      * the rate-1/2 K=7 conv encode: the shifted-column XOR form of
        ``fec.conv_encode_bits_batch``;
      * the exact integer phase prefix: within the coded body the per-bit
        advance takes two values, so the exclusive prefix is
        ``head_total + space_step * i + (mark - space) * ones_before_i``,
        the ones counted by an exclusive int64 ``torch.cumsum`` (the
        reference multiplies by a triangular f32 matrix instead, a
        workaround for XLA:TPU's cumsum compile); the largest sum,
        ~5.7e7 for a 133-byte payload, is far inside int64;
      * the sine expansion and lead / trail padding of
        ``fsk_mod._synth_int``, the function ``encode_frames_batch``
        reaches through ``fsk_mod.synth_bits_batch``.

    The phase prefixes are the same integers as ``encode_frames_batch``'s
    and the expansion the same function, so the two give the same samples
    bit for bit on one device.  Returns None when the configuration has
    non-integer frequencies (callers then use ``encode_frames_batch``)."""
    if not fsk_mod._int_config(params):
        return None
    K = fec.K
    pattern = np.asarray(params.pattern_bits, np.int64)
    hdr = fec.conv_encode_bits(fec.bytes_to_bits(
        fec.build_frame_header(payload_len))).astype(np.int64)
    head_bits = np.concatenate([pattern, hdr])            # [P + H]
    spb = params.samples_per_bit
    fs = int(params.sample_rate)
    mark_step = int(params.mark_freq) * spb % fs
    space_step = int(params.space_freq) * spb % fs
    # exclusive integer phase prefix over the shared head bits (host,
    # once per (params, payload_len))
    head_steps = np.where(head_bits == 1, mark_step, space_step)
    head_acc = (np.cumsum(head_steps) - head_steps) % fs
    head_total = int(head_steps.sum())
    nb = 2 * (8 * (payload_len + 2) + K - 1)   # coded body bits
    pad = (spb * 2, params.bits_per_byte * spb)
    consts = {}                                # device -> head tensors

    def synth(pay, device="cuda") -> torch.Tensor:
        device = resolve_device(device)
        if not isinstance(pay, torch.Tensor):
            pay = torch.from_numpy(np.array(pay, np.uint8))
        if pay.dim() != 2 or pay.shape[1] != payload_len:
            raise ValueError(f"synth expects [B, {payload_len}] payload "
                             f"bytes, got {tuple(pay.shape)}")
        pay = pay.to(device=device, dtype=torch.int64)
        key = str(pay.device)
        if key not in consts:
            consts[key] = (torch.from_numpy(head_bits).to(pay.device),
                           torch.from_numpy(head_acc).to(pay.device))
        h_bits, h_acc = consts[key]
        B = pay.shape[0]
        shifts = torch.arange(7, -1, -1, device=pay.device)
        pbits = ((pay[:, :, None] >> shifts) & 1).reshape(B, -1)
        crc = _crc16_bits_device(pbits).to(torch.int64)       # [B]
        crc_bits = (crc[:, None] >> torch.arange(15, -1, -1,
                                                 device=pay.device)) & 1
        body_bits = torch.cat([pbits, crc_bits], dim=1)       # [B, n]
        n = body_bits.shape[1]
        padded = torch.nn.functional.pad(body_bits, (K - 1, K - 1))
        streams = []
        for g in (fec.G0, fec.G1):
            acc = torch.zeros((B, n + K - 1), dtype=torch.int64,
                              device=pay.device)
            # G bit (K-1-j) taps window column j (oldest bit at the MSB)
            for j in range(K):
                if (g >> (K - 1 - j)) & 1:
                    acc = acc ^ padded[:, j:j + n + K - 1]
            streams.append(acc)
        coded = torch.stack(streams, dim=2).reshape(B, nb)
        ones_before = torch.cumsum(coded, dim=1) - coded
        body_acc = (head_total
                    + space_step * torch.arange(nb, device=pay.device)
                    + (mark_step - space_step) * ones_before) % fs
        acc = torch.cat([h_acc.expand(B, -1), body_acc], dim=1)
        bits = torch.cat([h_bits.expand(B, -1), coded], dim=1)
        return fsk_mod._synth_int(acc.to(torch.int32), bits, fs,
                                  float(params.mark_freq),
                                  float(params.space_freq), spb, pad)

    return synth


def frame_signal_length(params: FSKParams, payload_len: int,
                        rs_parity: int = 0, body_code=None) -> int:
    _check_rs(payload_len, rs_parity, body_code)
    n_bits = (len(params.pattern_bits) + HEADER_CODED_BITS
              + _body_coded_bits(payload_len, rs_parity, body_code))
    return (n_bits * params.samples_per_bit
            + 2 * params.samples_per_bit
            + params.bits_per_byte * params.samples_per_bit)


# ---------------------------------------------------------------------------
# RX stages
# ---------------------------------------------------------------------------

def _grid_offsets(params: FSKParams) -> np.ndarray:
    """The header-start search grid around the correlation peak (+1):
    consecutive integer offsets spanning one bit period plus a quarter
    bit of slack each side."""
    ds = params.ds_samples_per_bit
    return np.arange(-ds - ds // 4, ds // 4 + 1)


def _header_window(params: FSKParams, n_ds: int, t_peak: torch.Tensor):
    """K4's arguments for the header windows over an [n_ds, B] csum
    plane: every (offset, grid bit) read of the candidates lands in one
    window per channel that starts at the lowest grid offset, with
    ``pad_lo`` zero rows absorbing grids that reach below the stream
    start.  Returns (base [B] int32, the largest base, the keyword
    arguments of ``align.aligned_wsum``)."""
    ds = params.ds_samples_per_bit
    offsets = _grid_offsets(params)
    pad_lo = -int(offsets[0])
    n_out = len(offsets) + (HEADER_CODED_BITS - 1) * ds + 1
    max_base = max(pad_lo + (n_ds + 1 - ds) - n_out, 0)
    base = torch.clamp(t_peak + 1, 0, max_base).to(torch.int32)
    return base, max_base, dict(n_out=n_out, ds=ds, stride=1, pad_lo=pad_lo,
                                polarity=params.polarity, virt0=True)


def _body_window(params: FSKParams, n_ds: int, b_starts: torch.Tensor,
                 payload_len: int):
    """K4's arguments for the body windows at each channel's grid start;
    starts past the stream clip to the last full window (those channels
    are masked later).  Returns (base, the largest base, keywords) as
    ``_header_window``."""
    ds = params.ds_samples_per_bit
    body_bits = _body_coded_bits(payload_len)
    span = (body_bits - 1) * ds + 1
    max_base = max(n_ds + 1 - ds - span, 0)        # virtual zero row
    base = torch.clamp(b_starts, 0, max_base).to(torch.int32)
    return base, max_base, dict(n_out=body_bits, ds=ds, stride=ds, pad_lo=0,
                                polarity=params.polarity, virt0=True)


def _csum0(softs: torch.Tensor, start: int = 0, n=None) -> torch.Tensor:
    """Zero-prefixed f32 prefix sum [n + 1, B] of a soft plane [n, B] (or
    of ``n`` rows of a ring from row ``start``, wrapping), in strict row
    order: K5 (``ops/kernels/cumsum0.py``) on the card, its plain version
    on the CPU.  ``_csum0(x)[1:]`` is a contiguous view that equals K1's
    inclusive cumsum, the form the header and body helpers read."""
    return cumsum0.csum0(softs, start, n)


def _header_llrs(params: FSKParams, csum: torch.Tensor,
                 t_peak: torch.Tensor, gate: torch.Tensor,
                 body_bits_n: int, top_k: int = HEADER_TOP_K):
    """The header-candidate LLR windows: grid starts around ``t_peak``
    ([B] int), one aligned window per channel (K4 at stride 1 over the
    inclusive cumsum ``csum`` [n_ds, B]), the per-offset LLRs as strided
    reads of it, and pruning to the ``top_k`` best by the
    alignment-coherence score sum_j |llr[o, j]| (invalid candidates rank
    last; ties keep the lower offset, as the reference's iterative
    argmax).  ``top_k`` 0, or not below the grid size, keeps the whole
    grid in grid order.  ``body_bits_n`` 0 asks only for the header span
    inside the stream (the blind receiver learns the length from the
    header).

    Returns (starts [B, n_sel] int64, llrs [B, n_sel, HEADER_CODED_BITS]
    f32, valid [B, n_sel] bool), candidates in descending score order
    when pruned."""
    ds = params.ds_samples_per_bit
    h_bits = HEADER_CODED_BITS
    grid = _grid_offsets(params)
    n_off = len(grid)
    n_ds = csum.shape[0]
    dev = csum.device
    # made on the device: a copy from host memory would wait for the stream
    offsets = torch.arange(int(grid[0]), int(grid[-1]) + 1, device=dev)

    starts = t_peak.to(torch.int64)[:, None] + 1 + offsets[None, :]
    valid = ((starts >= 0) & (starts + h_bits * ds <= n_ds)
             & gate[:, None]
             & (starts + (h_bits + body_bits_n) * ds <= n_ds))

    # align one window per channel, then the candidates are static
    # strided reads of it
    base, _, kw = _header_window(params, n_ds, t_peak)
    al = align.aligned_wsum(csum, base, **kw)
    rows = (torch.arange(n_off, device=dev)[:, None]
            + ds * torch.arange(h_bits, device=dev)[None, :])
    llrs = al[rows].permute(2, 0, 1)               # [B, n_off, h_bits]

    if top_k and top_k < n_off:
        score = llrs.abs().sum(-1)                  # [B, n_off]
        score = torch.where(valid, score,
                            torch.full_like(score, float("-inf")))
        picks = []
        for _ in range(top_k):
            idx = torch.argmax(score, dim=-1)       # first maximum
            picks.append(idx)
            score = score.scatter(
                1, idx[:, None], torch.full_like(score[:, :1],
                                                 float("-inf")))
        sel = torch.stack(picks, 1)                  # [B, k]
        # exact selection by index: no LLR passes through a matmul
        llrs = torch.take_along_dim(llrs, sel[..., None], dim=1)
        starts = torch.take_along_dim(starts, sel, dim=1)
        valid = torch.take_along_dim(valid, sel, dim=1)
    return starts, llrs, valid


def _candidate_headers(params: FSKParams, csum: torch.Tensor,
                       t_peak: torch.Tensor, gate: torch.Tensor,
                       body_bits_n: int, top_k: int = HEADER_TOP_K):
    """``_header_llrs`` then ONE batched Viterbi over the surviving
    (channel x offset) candidates.  Returns (starts, headers [B, n_sel,
    32] uint8, valid)."""
    starts, llrs, valid = _header_llrs(params, csum, t_peak, gate,
                                       body_bits_n, top_k)
    B, n_sel, h_bits = llrs.shape
    headers = fec._viterbi_core(
        llrs.reshape(B * n_sel, h_bits // 2, 2),
        8 * HEADER_PLAIN).reshape(B, n_sel, 8 * HEADER_PLAIN)
    return starts, headers, valid


def _sync_peak(params: FSKParams, rsum: torch.Tensor):
    """The first maximum t_peak [B] of the sync match ratios from R (a
    zero carried tail: a one-shot decode's all-zero window prefix) and
    whether it clears the sync threshold: one launch of
    ``sync_peak.sync_peak`` on the card, its plain version on the CPU."""
    return sync_peak.sync_peak(params, rsum)


def _body_llrs(params: FSKParams, csum: torch.Tensor,
               b_starts: torch.Tensor, payload_len: int) -> torch.Tensor:
    """Body LLR windows [body_bits, B] at each channel's grid start (K4
    at stride ds over the inclusive cumsum)."""
    base, _, kw = _body_window(params, csum.shape[0], b_starts, payload_len)
    return align.aligned_wsum(csum, base, **kw)


def _batch_body_stage(params: FSKParams, csum: torch.Tensor,
                      b_starts: torch.Tensor,
                      payload_len: int) -> torch.Tensor:
    """Body LLR windows + ONE batched Viterbi over the B bodies ->
    decoded body bits [B, 8 * (payload_len + 2)] uint8."""
    b_llr = _body_llrs(params, csum, b_starts, payload_len)
    B = b_llr.shape[1]
    return fec._viterbi_core(b_llr.t().reshape(B, -1, 2),
                             8 * (payload_len + 2))


def _select_candidate(headers: torch.Tensor, starts: torch.Tensor,
                      valid: torch.Tensor, payload_len=None, max_len=None):
    """LEN/CRC header selection over the candidate axis.

    Candidates must pass their own CRC16; ``payload_len`` (the farm
    decode: every frame has that length) or ``max_len`` (the blind
    receiver: the length comes from the header, bounded) further gate the
    LEN field.  Returns (found [B] bool, ln [B] int64 — the chosen
    candidate's decoded length, 0 when none is found, st [B] — its grid
    start, in ``starts``' type); the first passing candidate wins."""
    hb = headers.to(torch.int32)                      # [B, n_sel, 32]
    w16 = 1 << torch.arange(15, -1, -1, dtype=torch.int32,
                            device=hb.device)
    ln = (hb[..., :16] * w16).sum(-1)
    crc = (hb[..., 16:32] * w16).sum(-1)
    ok = valid & (_crc16_bits_device(headers[..., :16]) == crc)
    if payload_len is not None:
        ok = ok & (ln == payload_len)
    if max_len is not None:
        ok = ok & (ln <= max_len)
    found = ok.any(1)
    chosen = torch.argmax(ok.to(torch.int32), dim=1)[:, None]  # first True
    st = torch.take_along_dim(starts, chosen, dim=1)[:, 0]
    # where no candidate passes, the chosen one fails: its LEN reads 0
    ln_sel = torch.take_along_dim(torch.where(ok, ln, 0), chosen, dim=1)
    return found, ln_sel[:, 0], st


def _pack_bodies(bodies: torch.Tensor, payload_len: int,
                 found: torch.Tensor) -> torch.Tensor:
    """Body CRC gate + packing: decoded body bits [B, 8*(payload_len+2)]
    -> ONE [B, payload_len + 1] uint8 plane (payload bytes + ok flag),
    ok = ``found`` AND the CRC16 over the payload bytes matches the
    frame's trailing CRC bytes: one launch of ``crc16.pack_bodies`` on
    the card, its plain version on the CPU."""
    return crc16.pack_bodies(bodies, found, payload_len)


def _crc16_bits_device(bits: torch.Tensor) -> torch.Tensor:
    """CRC-16-CCITT-FALSE over an MSB-first bit stream, on the tensor's
    device: bits [..., n] 0/1 -> crc [...] int32 (``crc16.crc_rows``:
    one launch on the card, the table recurrence on the CPU)."""
    return crc16.crc_rows(bits)


# ---------------------------------------------------------------------------
# RX entry points
# ---------------------------------------------------------------------------

def _decode_frames_fused(params: FSKParams, samples: torch.Tensor,
                         payload_len: int, top_k=None) -> torch.Tensor:
    """The whole farm decode on the samples' device: f32 [B, T] ->
    packed [B, payload_len + 1] uint8 (payload bytes + ok flag column).
    K1 once, K4 twice, K3 twice; no host sync.  ``top_k``: header
    candidates kept per channel (None: ``HEADER_TOP_K``; 0: the whole
    grid)."""
    B = samples.shape[0]
    ds = params.ds_samples_per_bit
    with metrics.timer("soft.k1"):
        state = fsk_demod.init_state(params, B, samples.device)
        # only the softs' prefix sum and R are read: K1 drops the bit and
        # amp streams and stores the inclusive cumsum in the softs slot
        _, _, _, _, csum, rsum = fsk_seq.seq(
            params, 0, state.front, state.ds_acc, state.bit_tail[-ds:],
            samples.t().contiguous(), emit_bits=False, emit_amps=False,
            emit_csum=True)
    with metrics.timer("soft.sync"):
        t_peak, peak_ok = _sync_peak(params, rsum)
    with metrics.timer("soft.header"):
        starts, headers, valid = _candidate_headers(
            params, csum, t_peak, peak_ok, _body_coded_bits(payload_len),
            HEADER_TOP_K if top_k is None else top_k)
    with metrics.timer("soft.select"):
        found, _, st = _select_candidate(headers, starts, valid,
                                         payload_len=payload_len)
        b_starts = torch.where(found, st + HEADER_CODED_BITS * ds,
                               torch.zeros_like(st))
    with metrics.timer("soft.body"):
        bodies = _batch_body_stage(params, csum, b_starts, payload_len)
    with metrics.timer("soft.pack"):
        return _pack_bodies(bodies, payload_len, found)


def decode_frames_batch(params: FSKParams, samples, payload_len: int,
                        rs_parity: int = 0, body_code=None,
                        device="cuda") -> list:
    """Farm-scale soft decode: [B, T] signals -> list of payloads (None
    per channel that failed).  All channels carry frames of the same
    payload length.  ``samples`` (numpy or a tensor) is moved to
    ``device`` (the card unless the caller asks for the CPU)."""
    return decode_frames_batch_async(params, samples, payload_len,
                                     rs_parity, body_code, device)()


def decode_frames_batch_async(params: FSKParams, samples,
                              payload_len: int, rs_parity: int = 0,
                              body_code=None, device="cuda"):
    """Pipelined form of ``decode_frames_batch``: enqueues the decode,
    starts the copy of the packed plane into pinned host memory, records
    an event, and returns a zero-argument finalizer that waits on that
    event and builds the payload list.  A server draining a stream of
    batches enqueues batch t+1 before finalizing batch t::

        pending = [decode_frames_batch_async(params, s, n) for s in xs]
        results = [p() for p in pending]
    """
    with metrics.timer("soft.dispatch"):
        _check_rs(payload_len, rs_parity, body_code)
        if not isinstance(samples, torch.Tensor):
            samples = torch.tensor(np.asarray(samples, np.float32))
        x = samples.to(device=resolve_device(device), dtype=torch.float32)
        B, T = x.shape
        # the seq stage at phase 0 emits T // 2 downsampled steps
        if T // params.downsample_ratio < \
                HEADER_CODED_BITS * params.ds_samples_per_bit:
            # too short to hold even one coded header span
            return lambda: [None] * B

        packed_dev = _decode_frames_fused(params, x, payload_len)
        with metrics.timer("soft.copy"):
            if packed_dev.is_cuda:
                packed = torch.empty(packed_dev.shape, dtype=torch.uint8,
                                     pin_memory=True)
                packed.copy_(packed_dev, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                packed, done = packed_dev, None

    def finalize():
        with metrics.timer("soft.finalize"):
            with metrics.timer("soft.finalize.wait"):
                if done is not None:
                    done.synchronize()
            plane = packed.numpy()
            results = [None] * B
            ok = np.nonzero(plane[:, payload_len])[0]
            for b in ok:
                results[b] = bytes(plane[b, :payload_len])
            metrics.incr("soft.frames_decoded", len(ok))
            metrics.incr("soft.frames_failed", B - len(ok))
            return results

    return finalize


# ---------------------------------------------------------------------------
# Streaming single-channel decode
# ---------------------------------------------------------------------------

def _bit_llrs(params: FSKParams, softs: np.ndarray, start: int,
              n_bits: int):
    """Windowed-sum LLRs for ``n_bits`` raw bits on the ds grid starting at
    soft-stream index ``start`` (None when the span leaves the stream)."""
    ds = params.ds_samples_per_bit
    end = start + n_bits * ds
    if start < 0 or end > len(softs):
        return None
    win = softs[start:end].reshape(n_bits, ds)
    # polarity: positive discriminator = mark only for mark < space
    return np.float32(params.polarity) * win.sum(axis=1)


def _payload_from_body_llr(b_llr, ln: int, device):
    """Body LLRs -> the CRC-checked payload, or None: the Viterbi (K3 on
    the card), then the CRC16 gate."""
    body = fec.bits_to_bytes(fec.viterbi_decode_soft(
        b_llr, 8 * (ln + 2), device=device))
    payload = body[:ln]
    if CRC16.calculate(payload) == ((body[ln] << 8) | body[ln + 1]):
        return payload
    return None


def _grid_candidates(params: FSKParams, t_peak: int, llrs):
    """The header candidates of a sync peak: (LLRs, grid start) for every
    grid offset whose header span ``llrs(start)`` can read."""
    cand = []
    for off in (t_peak + 1 + _grid_offsets(params)).tolist():
        llr = llrs(off)
        if llr is not None:
            cand.append((llr, off))
    return cand


def _valid_lengths(params: FSKParams, cand, device):
    """Decode the candidates' headers in ONE batched Viterbi; yield
    (grid start, LEN) of each whose header CRC passes, in grid order."""
    headers = fec.viterbi_decode_soft(np.stack([llr for llr, _ in cand]),
                                      8 * HEADER_PLAIN, device=device)
    for k, (_, off) in enumerate(cand):
        header = fec.bits_to_bytes(headers[k])
        if CRC16.calculate(header[:2]) == ((header[2] << 8) | header[3]):
            yield off, (header[0] << 8) | header[1]


def decode_frame_signal(params: FSKParams, samples, rs_parity: int = 0,
                        body_code=None, device="cuda"):
    """The memo's whole receive flow on one signal ([T] samples): soft
    demodulation (K1), sync correlation over the sliced bits, the header
    at every grid offset around the best few peaks (one batched Viterbi
    each), then the body at each CRC-valid header's grid.  Returns the
    CRC-checked payload, or None when no valid frame is found."""
    _check_rs(0, rs_parity, body_code)
    device = resolve_device(device)
    out = fsk_demod.soft_stream(params, np.asarray(samples, np.float32),
                                device=device)
    bits = out.bits[:, 0]
    softs = out.softs[:, 0].astype(np.float64)

    # 相関法: block-sum pattern correlation over the sliced bits
    ds = params.ds_samples_per_bit
    W = params.sync_window
    ext = np.concatenate([np.zeros(W, np.float32), bits])
    ratios = fsk_demod._sync_ratios_cumsum(
        params, torch.from_numpy(ext)[:, None])[:, 0].numpy()
    order = np.argsort(ratios)[::-1]
    threshold = params.config.sync_threshold
    for t_peak in order[:8]:            # a few best sync candidates
        if ratios[t_peak] <= threshold:
            break
        # the bit-grid origin relative to the peak is searched, not
        # assumed: the header CRC selects the right grid
        cand = _grid_candidates(
            params, int(t_peak),
            lambda off: _bit_llrs(params, softs, off, HEADER_CODED_BITS))
        if not cand:
            continue
        for off, ln in _valid_lengths(params, cand, device):
            b_llr = _bit_llrs(params, softs, off + HEADER_CODED_BITS * ds,
                              _body_coded_bits(ln))
            if b_llr is None:
                continue
            payload = _payload_from_body_llr(b_llr, ln, device)
            if payload is not None:
                return payload
    return None


class SoftFrameDecoder:
    """The memo's receive flow, streaming: feed arbitrary sample chunks;
    frames decode as soon as their span has arrived, including frames
    that span chunk boundaries.

    The demod carry goes through ``fsk_demod.soft_stream`` (chunking is
    bit-exact), and the decoder keeps the unconsumed tail of the
    sliced-bit and soft streams.  Sync candidates are tried in temporal
    order; one whose coded span has not fully arrived stays pending, one
    whose span has arrived and failed every grid offset is cached as dead.
    Match ratios are computed once per position: each feed correlates W
    of kept history plus the new bits (``_sync_ratios_cumsum``; the
    ratios are exact integers over W, so the cached values equal a
    whole-signal pass).  Decoded payloads equal ``decode_frame_signal``'s
    on the whole signal.  K1 and the Viterbi (K3) run on ``device``."""

    def __init__(self, params: FSKParams, max_candidates_per_scan: int = 64,
                 rs_parity: int = 0, body_code=None, device="cuda"):
        _check_rs(0, rs_parity, body_code)
        self._params = params
        self._device = resolve_device(device)
        self._state = None
        self._ds_phase = 0
        self._bits = np.zeros((0,), np.float32)
        self._softs = np.zeros((0,), np.float64)
        self._amps = np.zeros((0,), np.float64)
        self._abs0 = 0        # absolute ds index of _bits[0]
        self._scan_from = 0   # absolute ds index: consumed below this
        self._ratio = np.zeros((0,), np.float32)  # cached match ratios
        self._ratio_first = 0  # absolute ds index of _ratio[0]
        self._failed: set = set()  # dead candidate peaks (absolute)
        self._max_cand = max_candidates_per_scan
        self.frames_decoded = 0
        # (peak_ratio, soft_sum, soft_sumsq, count, amp_mean, amp_var)
        # over the sync window of the last decoded frame, for
        # SoftModemCore.get_signal_quality
        self.last_sync_quality = None

    def reset(self) -> None:
        self.__init__(self._params, self._max_cand, device=self._device)

    def feed(self, samples) -> list:
        """Ingest one chunk ([T] float32) and return the payloads it
        completed (possibly none)."""
        samples = np.asarray(samples, np.float32)
        if samples.ndim != 1:
            raise ValueError("SoftFrameDecoder.feed expects a [T] chunk")
        if len(samples):
            out = fsk_demod.soft_stream(self._params, samples, self._state,
                                        self._ds_phase, device=self._device)
            self._state, self._ds_phase = out.state, out.ds_phase
            self._bits = np.concatenate([self._bits, out.bits[:, 0]])
            self._softs = np.concatenate(
                [self._softs, out.softs[:, 0].astype(np.float64)])
            self._amps = np.concatenate(
                [self._amps, out.amps[:, 0].astype(np.float64)])
        self._extend_ratios()
        frames = self._scan()
        self._trim()
        return frames

    # -- internals --------------------------------------------------------

    def _extend_ratios(self) -> None:
        """Correlate the not yet correlated tail of the bit stream and
        append it to the cached ratios.  Position t reads bits [t - W, t]
        only, so positions [s, e) need bits [s - W, e); history below the
        stream start is zero, as in the whole-signal path."""
        W = self._params.sync_window
        s = self._ratio_first + len(self._ratio)
        e = self._abs0 + len(self._bits)
        n = e - s
        if n <= 0:
            return
        lead = max(0, self._abs0 - (s - W))
        assert lead == 0 or self._abs0 == 0, \
            "trim dropped correlation history"
        ext = np.zeros((W + n,), np.float32)
        ext[lead:] = self._bits[s - W + lead - self._abs0:e - self._abs0]
        r = fsk_demod._sync_ratios_cumsum(
            self._params, torch.from_numpy(ext)[:, None])[:, 0].numpy()
        self._ratio = np.concatenate([self._ratio, r])

    def _scan(self) -> list:
        """Try sync candidates in temporal order (earliest first): a
        decoded frame advances ``_scan_from`` past its coded span, and a
        pending candidate ends the pass (every later one is pending too),
        so nothing decodable is ever skipped."""
        threshold = self._params.config.sync_threshold
        frames = []
        while True:
            ratios, first = self._ratio, self._ratio_first
            if not len(ratios):
                return frames
            t_abs = np.arange(first, first + len(ratios))
            ok = (t_abs >= self._scan_from) & (ratios > threshold)
            progressed = False
            tried = 0
            for t_peak in t_abs[ok].tolist():
                if t_peak in self._failed:
                    continue
                if tried >= self._max_cand:
                    break  # per-feed work bound; resumes next feed
                tried += 1
                result, definitive = self._try_candidate(t_peak)
                if result is not None:
                    frames.append(result)
                    progressed = True
                    break  # rescan: scan_from advanced past this frame
                if definitive:
                    self._failed.add(t_peak)
                else:
                    break  # pending span: all later ones pending too
            if not progressed:
                return frames

    def _try_candidate(self, t_peak: int):
        """The full grid-offset search at one correlation peak.  Returns
        (payload | None, definitive): definitive means every offset's span
        was available and failed — never retry."""
        params = self._params
        ds = params.ds_samples_per_bit
        end_abs = self._abs0 + len(self._softs)
        # wait until the whole header grid (every offset) has arrived, so
        # the search equals the whole-signal path's
        if t_peak + 1 + int(_grid_offsets(params)[-1]) \
                + HEADER_CODED_BITS * ds > end_abs:
            return None, False
        cand = _grid_candidates(
            params, t_peak, lambda off: self._llrs(off, HEADER_CODED_BITS))
        if not cand:
            return None, True
        definitive = True
        for off, ln in _valid_lengths(params, cand, self._device):
            body_bits = _body_coded_bits(ln)
            body_start = off + HEADER_CODED_BITS * ds
            if body_start + body_bits * ds > end_abs:
                definitive = False  # body still arriving — retry later
                continue
            b_llr = self._llrs(body_start, body_bits)
            if b_llr is None:
                continue
            payload = _payload_from_body_llr(b_llr, ln, self._device)
            if payload is not None:
                self.frames_decoded += 1
                self._record_sync_quality(t_peak)
                self._scan_from = body_start + body_bits * ds
                self._failed = {t for t in self._failed
                                if t >= self._scan_from}
                return payload, True
        return None, definitive

    def _record_sync_quality(self, t_peak: int) -> None:
        """Sync-window statistics of a decoded frame.  ``t_peak`` is the
        first threshold crossing (temporal order), so re-anchor at the
        ratio argmax within a bit period, as the quality calibration
        does, and take the W soft samples ending there (the known
        preamble + SFD)."""
        ds = self._params.ds_samples_per_bit
        W = self._params.sync_window
        r0 = self._ratio_first
        lo_r = max(t_peak - ds, r0)
        hi_r = min(t_peak + ds + 1, r0 + len(self._ratio))
        q_peak = lo_r + int(np.argmax(self._ratio[lo_r - r0:hi_r - r0]))
        lo = max(q_peak + 1 - W, self._abs0)
        win = self._softs[lo - self._abs0:q_peak + 1 - self._abs0]
        awin = self._amps[lo - self._abs0:q_peak + 1 - self._abs0]
        self.last_sync_quality = (
            float(self._ratio[q_peak - r0]),
            float(win.sum()), float((win ** 2).sum()), float(len(win)),
            float(awin.mean()) if len(awin) else 0.0,
            float(awin.var()) if len(awin) else 0.0)

    def _llrs(self, start_abs: int, n_bits: int):
        return _bit_llrs(self._params, self._softs, start_abs - self._abs0,
                         n_bits)

    def _trim(self) -> None:
        """Bound memory: drop what the scanner can no longer reach (W of
        correlation history + the LLR look-back)."""
        params = self._params
        keep_back = params.sync_window + 2 * params.ds_samples_per_bit
        cut = self._scan_from - keep_back - self._abs0
        if cut > 0:
            self._bits = self._bits[cut:]
            self._softs = self._softs[cut:]
            self._amps = self._amps[cut:]
            self._abs0 += cut
        rcut = self._scan_from - self._ratio_first
        if rcut > 0:
            self._ratio = self._ratio[rcut:]
            self._ratio_first += rcut


def decode_frame_chunks(params: FSKParams, chunks, rs_parity: int = 0,
                        body_code=None, device="cuda") -> list:
    """Run the streaming decoder over an iterable of sample chunks and
    return every decoded payload (the same payloads for any split)."""
    dec = SoftFrameDecoder(params, rs_parity=rs_parity, body_code=body_code,
                           device=device)
    frames = []
    for chunk in chunks:
        frames += dec.feed(chunk)
    return frames
