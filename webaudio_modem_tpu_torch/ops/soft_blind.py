"""Blind batched soft-frame acquisition — PyTorch port.

Counterpart of ``webaudio_modem_tpu/ops/soft_blind.py``: B channels of a
streaming soft-FEC receiver that finds frames with no timing hint.  The
sync correlator scans every position and an event fires wherever the
match ratio crosses the threshold (sync is discovery, not scheduling);
each frame's length comes from its own decoded header.

Per audio quantum, everything on the device:

  * **Detector** (``_detect``): K1 (``ops/kernels/fsk_seq.py``) with the
    amp stream dropped and R; the sync ratios from R and the carried R
    tail (``fsk_demod._sync_ratios_from_r``); the soft plane written
    into a ring of whole quanta [ring_ds, B]; and a per-channel event
    tracker in masked vector ops.  An event opens at the first crossing
    past the refractory point, its peak is the first ratio maximum within
    ``2 ds`` ticks of the crossing, and it closes at most one quantum
    later.  One [4, B] int32 plane (emit_a, pos1, emit_b, pos_b) goes to
    pinned host memory.
  * **Header program**: events that close with peaks in one quantum
    decode together: the K_h ring slots around them, K5's prefix sum
    (``ops/kernels/cumsum0.py``), then the shared candidate machinery of
    ``ops/soft_fsk.py`` — grid offsets around each channel's own peak (K4),
    top-k pruning, one batched Viterbi (K3) — and the CRC / LEN selection
    bounded by ``max_payload``.
  * **Body programs**: found frames group by (window, decoded length);
    each group decodes once its coded span has streamed in: K_b ring
    slots, K5, K4 at stride ds, K3, and the frame CRC gate.  A failed CRC
    is an erasure, never a wrong payload.

The host pipeline (events as struct-of-arrays, per-channel FIFO
delivery, counters) is the reference's.  Every result goes to pinned host
memory with a non-blocking copy and an event, and is read one ``feed``
later, so the host never waits for the device inside ``feed``; the
per-channel arguments of the programs go up through pinned memory too.
Only ``flush`` reads the open-event plane.

``rs_parity`` / ``body_code`` are slice E of the port and raise
``NotImplementedError``; the reference's ``mesh=`` (TPU sharding) has no
counterpart here.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from webaudio_modem_tpu_torch.models.config import FSKParams
from webaudio_modem_tpu_torch.ops import fsk_demod, soft_fsk
from webaudio_modem_tpu_torch.ops.kernels import fsk_seq
from webaudio_modem_tpu_torch.utils.device import resolve_device
from webaudio_modem_tpu_torch.utils.trace import metrics


class _Frame:
    """One detected sync event moving through the decode pipeline.

    Delivery is per-channel FIFO: bodies of different lengths complete at
    different feeds, so completions park here until every earlier frame
    on the channel has resolved."""

    __slots__ = ("ch", "pos", "done", "payload")

    def __init__(self, ch: int, pos: int):
        self.ch = ch
        self.pos = pos
        self.done = False
        self.payload: Optional[bytes] = None


@dataclasses.dataclass
class RxState:
    """The receiver's carried device state, updated in place."""

    demod: fsk_demod.DemodState   # sequential-stage carry [.., B]
    ring: torch.Tensor            # f32 [ring_ds, B] soft-plane ring
    ev_best: torch.Tensor         # f32 [B] best ratio of the open event
    ev_pos: torch.Tensor          # i32 [B] global ds tick of that best
    ev_open: torch.Tensor         # bool [B] an event is open
    refract: torch.Tensor         # i32 [B] first tick eligible to open


def _to_host(t: torch.Tensor):
    """Start the copy of ``t`` to the host: (host tensor, event), the event
    None off the card.  The copy goes to pinned memory without waiting;
    the caching host allocator does not hand the block out again before
    the copy is done."""
    if not t.is_cuda:
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _from_host(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """``arr`` on ``device``: through pinned memory with a non-blocking
    copy (a copy from pageable memory would wait for the whole stream)."""
    host = torch.from_numpy(arr)
    if device.type != "cuda":
        return host
    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    pinned.copy_(host)
    return pinned.to(device, non_blocking=True)


def _host_array(host: torch.Tensor, done) -> np.ndarray:
    if done is not None:
        done.synchronize()
    return host.numpy()


class BlindSoftBatchReceiver:
    """B-channel streaming blind acquisition + soft-FEC frame decode.

    ``feed(samples)`` takes one [B, quantum] chunk (numpy or a tensor; a
    tensor on the device is used in place) and returns the
    ``(channel, payload)`` events that completed on this feed; a frame's
    payload arrives 2-4 feeds after its signal has streamed in — call
    ``flush()`` at the end of the stream.  Frames on one channel must not
    overlap; frames on different channels are independent.

    ``channel_fn`` (optional, ``fn(frame, generator) -> frame``, see
    ``sim.make_device_awgn``) is applied to each quantum on the device
    before demodulation, with a ``torch.Generator`` seeded from ``seed``.
    ``max_payload`` bounds the decoded LEN field and sizes the ring;
    ``ring_quanta`` (default: sized for ``max_payload``) bounds how long a
    frame may keep streaming after its sync peak — an undersized ring
    turns late bodies into counted erasures (``dropped_ring``).
    """

    def __init__(self, params: FSKParams, batch: int, quantum: int,
                 ring_quanta: Optional[int] = None,
                 rs_parity: int = 0, body_code=None,
                 channel_fn: Optional[Callable] = None,
                 top_k: Optional[int] = None,
                 max_payload: int = 255, seed: int = 0, device="cuda"):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        soft_fsk._check_rs(0, rs_parity, body_code)
        if quantum % params.downsample_ratio != 0:
            raise ValueError(
                f"quantum ({quantum}) must be a multiple of the "
                f"downsample ratio ({params.downsample_ratio})")
        if params.ds_samples_per_bit > 256:
            raise ValueError("blind receiver needs the R-fused sync "
                             "path (ds_samples_per_bit <= 256)")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._params = params
        self.batch = batch
        self.quantum = quantum
        self._n_ds = quantum // params.downsample_ratio
        self._chan = channel_fn
        self._top_k = (soft_fsk.HEADER_TOP_K if top_k is None else top_k)
        self._max_payload = max_payload

        ds = params.ds_samples_per_bit
        self._margin = 2 * ds         # plateau search span past a crossing
        # a true peak is followed by at least the header and the shortest
        # body before the next frame's peak; refract is only a lower bound
        # (a false re-open decodes to CRC-failed junk, never corrupts)
        self._refract_span = (soft_fsk.HEADER_CODED_BITS
                              + soft_fsk._body_coded_bits(0)) * ds
        n_ds = self._n_ds
        if n_ds < self._margin + 1:
            raise ValueError(f"quantum too small: {n_ds} ds ticks < "
                             f"event margin {self._margin + 1}")
        # header window: K_h whole quanta anchored one quantum before the
        # group's peak quantum; peaks sit in [n_ds, 2*n_ds) of it
        h_reach = ds // 4 + soft_fsk.HEADER_CODED_BITS * ds
        self._K_h = 2 + -(-h_reach // n_ds)
        kb_max = self._K_b(max_payload)
        if ring_quanta is None:
            ring_quanta = kb_max + 6
        if ring_quanta < kb_max + 3:
            raise ValueError(
                f"ring_quanta ({ring_quanta}) cannot hold a "
                f"max_payload ({max_payload}) body span plus decode "
                f"latency — need >= {kb_max + 3}")
        self._n_slots = ring_quanta
        self._ring_ds = ring_quanta * n_ds

        dev = self.device
        self._rx = RxState(
            demod=fsk_demod.init_state(params, batch, dev),
            ring=torch.zeros((self._ring_ds, batch), dtype=torch.float32,
                             device=dev),
            ev_best=torch.full((batch,), float("-inf"), device=dev),
            ev_pos=torch.zeros((batch,), dtype=torch.int32, device=dev),
            ev_open=torch.zeros((batch,), dtype=torch.bool, device=dev),
            refract=torch.full((batch,), params.sync_window,
                               dtype=torch.int32, device=dev))
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(seed)
        self._ticks = torch.arange(n_ds, dtype=torch.int32, device=dev)
        self._zeros: Optional[torch.Tensor] = None   # flush's silence

        # host pipeline: detected events stay struct-of-arrays until
        # header dispatch; _Frame objects materialize there, where the
        # per-channel FIFO needs them
        self._fed = 0                 # quanta fully fed
        self._pend_detect: deque = deque()   # (qidx, host emits, event)
        # qidx -> ordered [(chs i64[n], poss i32[n])] detected chunks
        self._events: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] \
            = defaultdict(list)
        self._pend_hdr: deque = deque()  # (feed, q0, frames, chs, host, ev)
        # (q0, ln) -> [(frames, chs i64[n], b_rels i32[n])] chunks
        self._body_groups: Dict[Tuple[int, int], List[tuple]] \
            = defaultdict(list)
        self._pend_body: deque = deque()  # (feed, ln, frames, chs, host, ev)
        # per-channel FIFO of unresolved/undelivered frames, plus the
        # channels whose FIFO head may have resolved since the last emit
        self._fifo: List[deque] = [deque() for _ in range(batch)]
        self._dirty: set = set()

        # observability
        self.events_detected = 0
        self.frames_decoded = 0
        self.frames_erased = 0        # valid header, body CRC failed
        self.headers_failed = 0       # event with no validating header
        self.dropped_ring = 0         # span outlived the soft ring
        self.programs = {"header": 0, "body": 0}   # device programs run

    # -- static geometry ----------------------------------------------------

    def _K_b(self, ln: int) -> int:
        """Quanta a body window must span for payload length ``ln``
        (anchored at the header window's q0; worst-case start)."""
        ds = self._params.ds_samples_per_bit
        body_bits = soft_fsk._body_coded_bits(ln)
        reach = (2 * self._n_ds + ds // 4 + 1
                 + (soft_fsk.HEADER_CODED_BITS + body_bits) * ds)
        return -(-reach // self._n_ds)

    # -- carried state ------------------------------------------------------

    def state_from_reference(self, fields: Mapping[str, object],
                             fed_quanta: int) -> None:
        """Continue a reference receiver's stream: replace the carried
        device state with the reference ``_RxState``'s leaves as numpy
        arrays — ``fields["demod"]`` the demod fields by name (see
        ``fsk_demod.state_from_reference``), and ``ring``, ``ev_best``,
        ``ev_pos``, ``ev_open``, ``refract`` — after ``fed_quanta`` quanta
        were fed.  The host pipeline starts empty, so hand over where no
        event is in flight."""
        dev = self.device

        def t(name, dtype):
            return torch.from_numpy(np.array(fields[name])).to(
                device=dev, dtype=dtype)

        ring = t("ring", torch.float32)
        if tuple(ring.shape) != (self._ring_ds, self.batch):
            raise ValueError(f"ring {tuple(ring.shape)} does not fit this "
                             f"receiver's [{self._ring_ds}, {self.batch}]")
        self._rx = RxState(
            demod=fsk_demod.state_from_reference(fields["demod"], dev),
            ring=ring, ev_best=t("ev_best", torch.float32),
            ev_pos=t("ev_pos", torch.int32),
            ev_open=t("ev_open", torch.bool),
            refract=t("refract", torch.int32))
        self._fed = int(fed_quanta)

    # -- device programs ----------------------------------------------------

    def _detect(self, x: torch.Tensor, tick0: int, woff: int) -> torch.Tensor:
        """One quantum x [B, quantum] on the device: the demod carry, the
        ring slot at ``woff`` and the event tracker advance in place.
        Returns (emit_a, pos1, emit_b, pos_b) as an int32 [4, B] plane."""
        params = self._params
        rx = self._rx
        st = rx.demod
        n_ds = self._n_ds
        W = params.sync_window
        ds = params.ds_samples_per_bit
        if self._chan is not None:
            x = self._chan(x, self._gen)
        # the detector reads bits (for the carried tail), softs and R,
        # never the amplitudes
        front, ds_acc, bits, _, softs, rsum = fsk_seq.seq(
            params, 0, st.front, st.ds_acc, st.bit_tail[-ds:],
            x.t().contiguous(), emit_amps=False)
        ratios = fsk_demod._sync_ratios_from_r(params, st.r_tail, rsum)
        r_tail = (rsum[-(W - ds):] if n_ds >= W - ds else
                  torch.cat([st.r_tail, rsum])[-(W - ds):])
        bit_tail = (bits[-W:] if n_ds >= W else
                    torch.cat([st.bit_tail, bits])[-W:])
        st.front.copy_(front)
        st.ds_acc.copy_(ds_acc)
        st.r_tail.copy_(r_tail)
        st.bit_tail.copy_(bit_tail)
        st.bit_fill.add_(n_ds).clamp_max_(2 ** 30)
        # The header and body programs read ring slots that this write
        # recycles.  That is safe because every program and this write
        # run on one stream in dispatch order: a program enqueued earlier
        # reads the slot before it is overwritten.  A copy moved to
        # another stream would have to be ordered by events.
        rx.ring[woff:woff + n_ds].copy_(softs)

        # --- event tracker: masked vector ops over [n_ds, B] ------------
        neg = float("-inf")
        margin = self._margin
        refr_span = self._refract_span
        thr = float(np.float32(params.config.sync_threshold))
        rel = self._ticks                                # [n_ds] i32
        pos = rel + tick0
        # phase 1: every carried-open event closes this quantum; its
        # plateau search extends into the first `margin` ticks
        in_ext = rx.ev_open[None, :] & \
            (pos[:, None] <= rx.ev_pos[None, :] + margin)
        ev = torch.where(in_ext, ratios, neg)
        ext_max = ev.amax(0)
        ext_arg = torch.argmax(ev, 0).to(torch.int32)    # first maximum
        improved = rx.ev_open & (ext_max > rx.ev_best)
        pos1 = torch.where(improved, ext_arg + tick0, rx.ev_pos)
        emit_a = rx.ev_open.to(torch.int32)
        refract = torch.where(rx.ev_open, pos1 + refr_span, rx.refract)
        # phase 2: the first new crossing past the refractory point; its
        # peak is the first plateau maximum within `margin` ticks — if
        # that window runs off the quantum the event stays open and
        # closes in phase 1 of the next feed
        above = (ratios > thr) & (pos[:, None] >= refract[None, :])
        has = above.any(0)
        t0 = torch.argmax(above.to(torch.uint8), 0).to(torch.int32)
        in_new = (rel[:, None] >= t0[None, :]) & \
            (rel[:, None] <= t0[None, :] + margin) & has[None, :]
        nv = torch.where(in_new, ratios, neg)
        nmax = nv.amax(0)
        pos_b = torch.argmax(nv, 0).to(torch.int32) + tick0
        closes = has & (t0 + margin < n_ds)
        opens = has & ~closes
        refract = torch.where(closes, pos_b + refr_span, refract)
        rx.ev_best.copy_(torch.where(opens, nmax, neg))
        rx.ev_pos.copy_(torch.where(opens, pos_b, 0))
        rx.ev_open.copy_(opens)
        rx.refract.copy_(refract)
        return torch.stack([emit_a, pos1, closes.to(torch.int32), pos_b])

    def _window(self, slot0: int, k: int):
        """The soft planes of quanta slot0 .. slot0 + k - 1 of the ring as
        K5 reads them in place: (ring, first row, rows).  The window
        wraps past the ring's last row at most once (k < n_slots)."""
        n_ds = self._n_ds
        return self._rx.ring, (slot0 % self._n_slots) * n_ds, k * n_ds

    def _header_prog(self, slot0: int, t_peak_rel: torch.Tensor,
                     active: torch.Tensor) -> torch.Tensor:
        """Header decode of one group: int64 [3, B] (found, ln, st)."""
        csum = soft_fsk._csum0(*self._window(slot0, self._K_h))
        starts, headers, valid = soft_fsk._candidate_headers(
            self._params, csum[1:], t_peak_rel, active, 0, self._top_k)
        found, ln, st = soft_fsk._select_candidate(
            headers, starts, valid, max_len=self._max_payload)
        return torch.stack([found.to(ln.dtype), ln, st])

    def _body_prog(self, ln: int, slot0: int, b_start_rel: torch.Tensor,
                   active: torch.Tensor) -> torch.Tensor:
        """Body decode of one (window, length) group: uint8 [B, ln + 1]
        (payload bytes + CRC-ok flag)."""
        csum = soft_fsk._csum0(*self._window(slot0, self._K_b(ln)))
        b_starts = torch.where(active, b_start_rel, 0)
        bodies = soft_fsk._batch_body_stage(self._params, csum[1:], b_starts,
                                            ln)
        return soft_fsk._pack_bodies(bodies, ln, active)

    # -- host pipeline --------------------------------------------------------

    def _samples(self, samples) -> torch.Tensor:
        if isinstance(samples, torch.Tensor) and \
                samples.device == self.device:
            x = samples.to(torch.float32)
        else:
            if isinstance(samples, torch.Tensor):
                samples = samples.cpu().numpy()
            x = _from_host(np.ascontiguousarray(samples, np.float32),
                           self.device)
        if tuple(x.shape) != (self.batch, self.quantum):
            raise ValueError(f"feed expects [{self.batch}, "
                             f"{self.quantum}], got {tuple(x.shape)}")
        return x

    def feed(self, samples) -> List[Tuple[int, bytes]]:
        """Ingest one [B, quantum] chunk; return completed decodes."""
        j = self._fed
        out: List[Tuple[int, bytes]] = []
        # 1. events from the detector quanta fetched already (<= j-1)
        with metrics.timer("blind_rx.collect_events"):
            self._collect_events()
        # 2. detector for quantum j (the ring gains quantum j)
        x = self._samples(samples)
        with metrics.timer("blind_rx.detect_dispatch"):
            emits = self._detect(x, j * self._n_ds,
                                 (j % self._n_slots) * self._n_ds)
            self._pend_detect.append((j, *_to_host(emits)))
        self._fed = j + 1
        # 3. finalize header/body results dispatched on earlier feeds
        with metrics.timer("blind_rx.finalize"):
            self._finalize_headers()
            self._finalize_bodies()
        # 4. dispatch due header groups (events complete at q <= j-2,
        # window quanta q-1..q+K_h-2 all written since K_h-2 <= j)
        with metrics.timer("blind_rx.dispatch_headers"):
            self._dispatch_headers()
        # 5. dispatch due body groups
        with metrics.timer("blind_rx.dispatch_bodies"):
            self._dispatch_bodies()
        # 6. deliver resolved frames in per-channel temporal order
        with metrics.timer("blind_rx.emit_ready"):
            out.extend(self._emit_ready())
        return out

    # -- pipeline stages ------------------------------------------------------

    def _collect_events(self) -> None:
        n_ds = self._n_ds
        while self._pend_detect and self._pend_detect[0][0] < self._fed:
            _, host, done = self._pend_detect.popleft()
            emit_a, pos_a, emit_b, pos_b = _host_array(host, done)
            # phase-1 closes carry earlier peaks than phase-2 closes of
            # the same quantum: chunk a before chunk b keeps every
            # channel FIFO temporal
            for ok, pos in ((emit_a, pos_a), (emit_b, pos_b)):
                chs = np.nonzero(ok)[0]
                if chs.size == 0:
                    continue
                poss = pos[chs]
                self.events_detected += int(chs.size)
                qidx = poss // n_ds
                lo = int(qidx.min())
                if int(qidx.max()) == lo:        # common: one quantum
                    self._events[lo].append((chs, poss))
                else:                            # straddles a boundary
                    for q in np.unique(qidx).tolist():
                        m = qidx == q
                        self._events[q].append((chs[m], poss[m]))

    def _dispatch_headers(self) -> None:
        j = self._fed - 1   # newest written quantum = current feed idx
        # a group is complete once detector q+1's emits are collected
        # (during feed q+2): a peak in quantum q can close in phase 1 of
        # quantum q+1
        due = [q for q in self._events
               if q <= j - 2 and q + self._K_h - 2 <= j]
        for q in sorted(due):
            chunks = self._events.pop(q)
            q0 = max(q - 1, 0)
            if q0 <= j - self._n_slots:   # window slot already recycled
                # never materialized: a dropped event emits nothing, so
                # skipping the FIFO cannot reorder later frames
                self.dropped_ring += sum(int(c.size) for c, _ in chunks)
                continue
            if len(chunks) == 1:
                chs, poss = chunks[0]
            else:
                chs = np.concatenate([c for c, _ in chunks])
                poss = np.concatenate([p for _, p in chunks])
            # occurrence index per channel (stable): occ == w -> wave w.
            # One wave per duplicate channel (rare: a false crossing and
            # a true peak landing in the same quantum); chunk order is
            # temporal, so stable numbering keeps each FIFO temporal.
            order = np.argsort(chs, kind="stable")
            sorted_chs = chs[order]
            run_start = np.empty(chs.size, bool)
            run_start[0] = True
            np.not_equal(sorted_chs[1:], sorted_chs[:-1],
                         out=run_start[1:])
            starts = np.nonzero(run_start)[0]
            occ_sorted = np.arange(chs.size, dtype=np.int64) \
                - np.repeat(starts, np.diff(np.append(starts, chs.size)))
            occ = np.empty(chs.size, np.int64)
            occ[order] = occ_sorted
            n_waves = int(occ.max()) + 1 if chs.size else 0
            rel_all = (poss - q0 * self._n_ds).astype(np.int32)
            for w in range(n_waves):
                if n_waves == 1:
                    wchs, wrel, wposs = chs, rel_all, poss
                else:
                    m = occ == w
                    wchs, wrel, wposs = chs[m], rel_all[m], poss[m]
                frames = list(map(_Frame, wchs.tolist(), wposs.tolist()))
                fifo = self._fifo
                for c, f in zip(wchs.tolist(), frames):
                    fifo[c].append(f)
                args = np.zeros((2, self.batch), np.int32)  # t_rel, active
                args[0, wchs] = wrel
                args[1, wchs] = 1
                args = _from_host(args, self.device)
                outs = self._header_prog(q0, args[0], args[1].bool())
                self.programs["header"] += 1
                self._pend_hdr.append((self._fed, q0, frames, wchs,
                                       *_to_host(outs)))

    def _finalize_headers(self) -> None:
        h_span = soft_fsk.HEADER_CODED_BITS \
            * self._params.ds_samples_per_bit
        while self._pend_hdr and self._pend_hdr[0][0] < self._fed:
            _, q0, frames, chs, host, done = self._pend_hdr.popleft()
            found, ln, st = _host_array(host, done)
            okm = found[chs] != 0
            n_bad = int(len(frames) - okm.sum())
            if n_bad:
                self.headers_failed += n_bad
                dirty = self._dirty
                for f, o in zip(frames, okm.tolist()):
                    if not o:
                        f.done = True
                        dirty.add(f.ch)
                ok_idx = np.nonzero(okm)[0]
                frames = [frames[i] for i in ok_idx.tolist()]
                chs = chs[ok_idx]
            if not frames:
                continue
            lns_g = ln[chs]
            b_rels = (st[chs] + h_span).astype(np.int32)
            uniq = np.unique(lns_g)
            for L in uniq.tolist():
                if uniq.size == 1:
                    g_frames, g_chs, g_b = frames, chs, b_rels
                else:
                    m = lns_g == L
                    idx = np.nonzero(m)[0]
                    g_frames = [frames[i] for i in idx.tolist()]
                    g_chs, g_b = chs[m], b_rels[m]
                self._body_groups[(q0, int(L))].append(
                    (g_frames, g_chs, g_b))

    def _dispatch_bodies(self) -> None:
        j = self._fed - 1
        for (q0, ln) in sorted(self._body_groups):
            if q0 + self._K_b(ln) - 1 > j:
                continue              # span still streaming in
            chunks = self._body_groups.pop((q0, ln))
            if q0 <= j - self._n_slots:
                dirty = self._dirty
                for frames, _, _ in chunks:
                    self.dropped_ring += len(frames)
                    for f in frames:
                        f.done = True
                        dirty.add(f.ch)
                continue
            args = np.zeros((2, self.batch), np.int32)   # b_rel, active
            all_frames: List[_Frame] = []
            for frames, chs, b in chunks:
                args[0, chs] = b
                args[1, chs] = 1
                all_frames.extend(frames)
            all_chs = (chunks[0][1] if len(chunks) == 1 else
                       np.concatenate([c for _, c, _ in chunks]))
            args = _from_host(args, self.device)
            packed = self._body_prog(ln, q0, args[0], args[1].bool())
            self.programs["body"] += 1
            self._pend_body.append((self._fed, ln, all_frames, all_chs,
                                    *_to_host(packed)))

    def _finalize_bodies(self) -> None:
        while self._pend_body and self._pend_body[0][0] < self._fed:
            _, ln, frames, chs, host, done = self._pend_body.popleft()
            rows = _host_array(host, done)[chs]       # [n, ln+1] gather
            okb = rows[:, ln] != 0
            n_ok = int(okb.sum())
            self.frames_decoded += n_ok
            self.frames_erased += len(frames) - n_ok
            buf = rows[:, :ln].tobytes()              # one copy-out
            self._dirty.update(chs.tolist())
            for i, (f, ok) in enumerate(zip(frames, okb.tolist())):
                f.done = True
                if ok:
                    f.payload = buf[i * ln:(i + 1) * ln]

    def _emit_ready(self) -> List[Tuple[int, bytes]]:
        out: List[Tuple[int, bytes]] = []
        for ch in sorted(self._dirty):
            q = self._fifo[ch]
            while q and q[0].done:
                f = q.popleft()
                if f.payload is not None:
                    out.append((ch, f.payload))
        self._dirty.clear()
        return out

    # -- draining -------------------------------------------------------------

    def has_work(self) -> bool:
        """Host-visible in-flight decode work, without a device sync (an
        event still open on the device is not counted: it closes within
        two feeds)."""
        return bool(self._events or self._pend_hdr or self._body_groups
                    or self._pend_body or any(self._fifo))

    def _pending(self) -> bool:
        """In-flight work for ``flush`` — call ``_collect_events`` first
        so the newest detector emits are accounted.  Reads the open-event
        plane from the device (the one sync of the receiver)."""
        return self.has_work() or bool(self._rx.ev_open.any())

    def flush(self, max_quanta: Optional[int] = None) \
            -> List[Tuple[int, bytes]]:
        """Feed silence until every in-flight decode resolves and return
        the completed events.  Bodies whose span never arrives (a stream
        cut mid-frame) resolve as erasures once the ring recycles past
        them."""
        if max_quanta is None:
            max_quanta = self._n_slots + self._K_b(self._max_payload) + 8
        if self._zeros is None:
            self._zeros = torch.zeros((self.batch, self.quantum),
                                      dtype=torch.float32, device=self.device)
        out: List[Tuple[int, bytes]] = []
        for _ in range(max_quanta):
            self._collect_events()
            if not self._pending():
                break
            out.extend(self.feed(self._zeros))
        return out

    def get_status(self) -> dict:
        return {
            "fed_quanta": self._fed,
            "events_detected": self.events_detected,
            "frames_decoded": self.frames_decoded,
            "frames_erased": self.frames_erased,
            "headers_failed": self.headers_failed,
            "dropped_ring": self.dropped_ring,
            "ring_quanta": self._n_slots,
            "programs": dict(self.programs),
            "pending": {
                "detect": len(self._pend_detect),
                "event_groups": len(self._events),
                "header": len(self._pend_hdr),
                "body_groups": len(self._body_groups),
                "body": len(self._pend_body),
            },
        }
