"""Soft-FEC farm hubs — the wire on the card, the FEC frame decode as
the receiver.

The port's copy of ``webaudio_modem_tpu/runtime/soft_hub.py``: the FEC
memo's receive pipeline (samples -> soft demodulator -> FEC decoder ->
framer) at the farm topology, thousands of concurrent ARQ sessions over
one hub.  Every ``modulate()`` payload becomes ONE coded frame (sync
pattern + conv header + conv body): ``soft_fsk.frames_synth_device_fn``
frames and synthesizes a cohort on the card from its payload bytes.

  * ``SoftFarmHub``: the wire is ``RingHubBase``'s ring pair (cohort
    synthesis on the device, masked writes on views of the ring, playout
    bookkeeping in host arithmetic).  There is no per-quantum pump: the
    hub schedules a WINDOW DECODE for each written playout region [w,
    w+Lpad), and when the window has played out, one fused decode
    (``soft_fsk._decode_frames_fused``: K1 in its csum mode, K4 twice, K3
    twice) reads it from the ring through the channel function and hands
    back one [B, payload+1] byte plane, copied to pinned host memory
    behind an event and parsed one step later.  Idle quanta cost no
    device work.  Recovery inside the window is blind (the sync peak,
    the header-start grid, the header and body CRCs); a frame that fails
    its CRC is an erasure and the ARQ layer resends.
  * ``BlindSoftFarmHub``: no schedule reaches the receive side.  Every
    quantum the wire plays is fed, as a view of the ring, to one
    ``ops/soft_blind.BlindSoftBatchReceiver`` per direction (K1 per
    quantum; K5, K4 and K3 per header or body program), then cleared.

Decoded payloads ARE wire bytes: they drain through the batched C++
deframer into the ``FarmDataChannel`` queues, so ``XModemTransport``
runs unchanged on top.

``rs_parity`` / ``body_code`` (the RS outer code and the LDPC / turbo
bodies) are slice E of the port (ROADMAP queue 1, item 14) and raise
``NotImplementedError``; ``mesh=`` is refused as in the other hubs.
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from webaudio_modem_tpu_torch.models.config import FSKParams
from webaudio_modem_tpu_torch.ops import soft_fsk
from webaudio_modem_tpu_torch.ops.soft_blind import (BlindSoftBatchReceiver,
                                                     _host_array, _to_host)
from webaudio_modem_tpu_torch.runtime.device_hub import RingHubBase
from webaudio_modem_tpu_torch.runtime.farm_channel import refuse_mesh, upload
from webaudio_modem_tpu_torch.utils.trace import metrics


def _soft_synth(params: FSKParams, datas, rs_parity: int, body_code,
                device: torch.device) -> torch.Tensor:
    """Cohort synthesis for the soft wire: the conv-coded frames framed
    and synthesized on ``device`` from the [B, pl] payload bytes
    (``soft_fsk.frames_synth_device_fn``); a non-integer configuration
    takes ``soft_fsk.encode_frames_batch``, which frames on the host and
    synthesizes on ``device``."""
    if rs_parity == 0 and body_code is None and datas:
        fn = soft_fsk.frames_synth_device_fn(params, len(datas[0]))
        if fn is not None:
            pay = np.frombuffer(bytearray(b"".join(datas)), np.uint8) \
                .reshape(len(datas), len(datas[0]))
            return fn(upload(pay, device), device=device)
    return soft_fsk.encode_frames_batch(
        params, datas, rs_parity=rs_parity, body_code=body_code,
        device=device)


def _check_options(who: str, rs_parity: int, body_code, mesh) -> None:
    refuse_mesh(mesh, who)
    soft_fsk._check_rs(0, rs_parity, body_code)


class _DecodeGroup:
    """One scheduled window decode: the cohort rows whose frames play
    out in [w, w+Lpad), decoded together when the window completes."""

    __slots__ = ("w", "Lpad", "payload_len", "rows", "active", "slot_of")

    def __init__(self, w: int, Lpad: int, payload_len: int, rows):
        self.w = w
        self.Lpad = Lpad
        self.payload_len = payload_len
        self.rows = list(rows)
        self.active = np.ones(len(self.rows), bool)
        self.slot_of = {i: s for s, i in enumerate(self.rows)}


class _DecOut:
    """The shim ``FarmHubBase._drain`` takes in place of a ``_HostOut``:
    the planes are host arrays already, so ``ready()`` waits for
    nothing."""

    __slots__ = ("byte_count", "bytes_out")

    def __init__(self, byte_count: np.ndarray, bytes_out: np.ndarray):
        self.byte_count = byte_count
        self.bytes_out = bytes_out

    def ready(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.byte_count, self.bytes_out


class SoftFarmHub(RingHubBase):
    """B full-duplex FEC-coded wires on the card; scheduled window
    decodes through the fused soft decoder; host traffic bytes-only.

    ``device_channel_fn``: optional ``fn(window, generator) -> window``
    (see ``sim.make_device_awgn``) applied to each decode window before
    the decode; each receiving side draws from its own
    ``torch.Generator`` on ``device``, seeded ``seed`` (side a) and
    ``seed + 1`` (side b), as ``DeviceFarmHub``'s.  Each wire row is
    decoded from exactly one window per transmission, so per-window noise
    is statistically the same as per-quantum noise on that row.  (The
    reference splits a JAX key per decode: the noise sequences differ,
    the statistics do not.)

    ``ring_quanta`` must hold the longest frame signal (a 133-byte
    XModem packet at 1200 baud is ~20 quanta of 4800) plus one quantum
    of slack; undersized rings raise at write time.  ``device``: the
    card unless the caller asks for the CPU.
    """

    def __init__(self, config, batch: int, quantum: int = 4800,
                 ring_quanta: int = 24,
                 device_channel_fn: Optional[Callable] = None,
                 rs_parity: int = 0, body_code=None, seed: int = 0,
                 mesh=None, *, device="cuda"):
        _check_options(type(self).__name__, rs_parity, body_code, mesh)
        super().__init__(config, batch, quantum, ring_quanta, device=device)
        self._params = FSKParams.from_config(self.config)
        if quantum % self._params.downsample_ratio != 0:
            raise ValueError(
                f"quantum ({quantum}) must be a multiple of the "
                f"downsample ratio ({self._params.downsample_ratio})")
        self._chan = device_channel_fn
        self._rs = rs_parity
        self._body = body_code
        self._generators = {}
        for s, sd in (("a", seed), ("b", seed + 1)):
            self._generators[s] = torch.Generator(device=self.device)
            self._generators[s].manual_seed(sd)
        # tx_side -> step index -> [_DecodeGroup] due for dispatch
        self._due: Dict[str, Dict[int, list]] = {
            "a": defaultdict(list), "b": defaultdict(list)}
        # (tx_side, row) -> (group, slot) while the group awaits
        # dispatch (abort marking)
        self._sched: Dict[Tuple[str, int], Tuple[_DecodeGroup, int]] = {}
        # rx_side -> deque[(group, host plane, event, dispatched_at_step)]
        self._pending_dec: Dict[str, deque] = {"a": deque(),
                                               "b": deque()}
        self.frames_decoded = 0
        self.frames_erased = 0

    # -- TX: FEC frame synthesis --------------------------------------------

    def _synth_full(self, side: str, datas) -> torch.Tensor:
        return _soft_synth(self._params, datas, self._rs, self._body,
                           self.device)

    def _on_group_written(self, side: str, w: int, Lpad: int, T: int,
                          rows, entries, length: int) -> None:
        group = _DecodeGroup(w, Lpad, length, rows)
        # the full padded window [w, w+Lpad) has played after step
        # (w+Lpad)/quantum - 1; dispatch the decode at the next step
        self._due[side][(w + Lpad) // self.quantum].append(group)
        for slot, i in enumerate(group.rows):
            self._sched[(side, i)] = (group, slot)

    def _stop_playing(self, side: str, index: int, entry) -> None:
        super()._stop_playing(side, index, entry)
        hit = self._sched.pop((side, index), None)
        if hit is not None:
            group, slot = hit
            group.active[slot] = False

    # -- RX: scheduled window decodes ---------------------------------------

    def _window(self, ring: torch.Tensor, woff: int,
                Lpad: int) -> torch.Tensor:
        """Columns [woff, woff + Lpad) of the ring: a view, or, where the
        window wraps past the ring's end, the two pieces concatenated."""
        n1 = self.ring_len - woff
        if Lpad <= n1:
            return ring.narrow(1, woff, Lpad)
        return torch.cat([ring.narrow(1, woff, n1),
                          ring.narrow(1, 0, Lpad - n1)], dim=1)

    def _decode_window(self, window: torch.Tensor,
                       payload_len: int) -> torch.Tensor:
        """The fused decode of one (channel-applied) window -> packed
        [B, payload_len + 1] uint8 on the device, no host sync."""
        return soft_fsk._decode_frames_fused(self._params, window,
                                             payload_len)

    def _dispatch_group(self, tx_side: str, rx_side: str,
                        group: _DecodeGroup) -> None:
        # snapshot: aborts only mutate `active` before dispatch (playout
        # resolution precedes the due step)
        for i in group.rows:
            hit = self._sched.get((tx_side, i))
            if hit is not None and hit[0] is group:
                del self._sched[(tx_side, i)]
        if not group.active.any():
            return
        window = self._window(self._rings[tx_side],
                              group.w % self.ring_len, group.Lpad)
        # The decode's first op copies the window time-major (the channel
        # function, when set, reads it first), and every later write into
        # these ring columns (this step's TX launch, later revolutions) is
        # enqueued after it on the same stream: the window is read before
        # it is overwritten.
        if self._chan is not None:
            window = self._chan(window, self._generators[rx_side])
        packed = self._decode_window(window, group.payload_len)
        self._pending_dec[rx_side].append(
            (group, *_to_host(packed), self.steps))

    def _finalize(self, rx_side: str, group: _DecodeGroup,
                  packed: np.ndarray) -> None:
        """Count and drain one decoded window: ``packed`` is the host
        [B, pl+1] plane (payload bytes + ok flag)."""
        pl = group.payload_len
        counts = np.zeros((self.batch,), np.int64)
        rows = np.asarray(group.rows)[group.active]
        hits = rows[packed[rows, pl] != 0]
        counts[hits] = pl
        self.frames_decoded += len(hits)
        self.frames_erased += len(rows) - len(hits)
        if len(hits):
            self._drain(rx_side, _DecOut(
                counts, np.ascontiguousarray(packed[:, :pl])))

    def _finalize_ready(self, rx_side: str, all_pending: bool = False) \
            -> None:
        q = self._pending_dec[rx_side]
        while q and (all_pending or q[0][3] < self.steps):
            group, host, done, _ = q.popleft()
            # the wait for the decode's copy to land, timed apart from
            # the host parse; soft_finalize, not host_drain: _finalize
            # calls _drain, whose own host_drain timer would nest inside
            # and count the drain twice in the totals
            with metrics.timer("farm_hub.fetch_wait"):
                packed = _host_array(host, done)
            with metrics.timer("farm_hub.soft_finalize"):
                self._finalize(rx_side, group, packed)

    # -- the pump ------------------------------------------------------------

    def step(self) -> None:
        """One audio quantum for both directions: dispatch the window
        decodes that completed playout and launch new TX writes for BOTH
        directions before finalizing either.  Finalized decodes were
        dispatched on PREVIOUS steps and wait only on their copy's event,
        so the host parse overlaps this step's device work.  Quanta with
        no due window cost no device work."""
        for tx_side, rx_side in (("a", "b"), ("b", "a")):
            with metrics.timer("farm_hub.chunk"):
                for group in self._due[tx_side].pop(self.steps, ()):
                    self._dispatch_group(tx_side, rx_side, group)
            with metrics.timer("farm_hub.host_tx"):
                self._launch(tx_side)
        for rx_side in ("b", "a"):
            self._finalize_ready(rx_side)
        self.steps += 1
        self._resolve_playouts()

    def flush(self) -> None:
        for side in ("a", "b"):
            self._finalize_ready(side, all_pending=True)

    def _tx_active(self) -> bool:
        return (any(self._due[s] or self._pending_dec[s]
                    for s in ("a", "b"))
                or super()._tx_active())

    # -- observability --------------------------------------------------------

    def get_status(self) -> dict:
        return {
            "steps": self.steps,
            "native_deframer": self._deframers["a"].is_native,
            "ring_len": self.ring_len,
            "frames_decoded": self.frames_decoded,
            "frames_erased": self.frames_erased,
            "rs_parity": self._rs,
            "body_code": (type(self._body).__name__
                          if self._body is not None else None),
            "pending_decodes": {s: len(self._pending_dec[s])
                                for s in ("a", "b")},
        }


class BlindSoftFarmHub(RingHubBase):
    """Farm-scale ARQ over the soft-FEC wire with a fully BLIND receive
    path: the receiver never sees the hub's playout bookkeeping.

    ``SoftFarmHub`` schedules one window decode per transmission from its
    own TX records; this hub instead runs one
    ``ops/soft_blind.BlindSoftBatchReceiver`` per direction: every
    quantum the wire plays is fed to it and then cleared (the hard hub's
    pump contract), and the receiver discovers sync peaks, reads payload
    lengths from the decoded headers and delivers payload bytes in
    per-channel temporal order.  It pays a detector (K1) every quantum in
    each direction, plus the header and body programs per frame cohort;
    in exchange TX timing may jitter arbitrarily.  Channel noise is
    applied inside the detector, upstream of acquisition and decode, via
    ``device_channel_fn`` with the receivers' generators (seeded
    ``seed`` for side a, ``seed + 1`` for side b).
    """

    def __init__(self, config, batch: int, quantum: int = 4800,
                 ring_quanta: int = 24,
                 device_channel_fn: Optional[Callable] = None,
                 rs_parity: int = 0, body_code=None,
                 max_payload: int = 160,
                 rx_ring_quanta: Optional[int] = None, seed: int = 0,
                 mesh=None, *, device="cuda"):
        _check_options(type(self).__name__, rs_parity, body_code, mesh)
        super().__init__(config, batch, quantum, ring_quanta, device=device)
        self._params = FSKParams.from_config(self.config)
        if quantum % self._params.downsample_ratio != 0:
            raise ValueError(
                f"quantum ({quantum}) must be a multiple of the "
                f"downsample ratio ({self._params.downsample_ratio})")
        self._rs = rs_parity
        self._body = body_code
        self._rx = {
            side: BlindSoftBatchReceiver(
                self._params, batch, quantum,
                ring_quanta=rx_ring_quanta, rs_parity=rs_parity,
                body_code=body_code, channel_fn=device_channel_fn,
                max_payload=max_payload, seed=seed + k, device=self.device)
            for k, side in enumerate(("a", "b"))}

    # -- TX: FEC frame synthesis (same wire as SoftFarmHub) ------------------

    def _synth_full(self, side: str, datas) -> torch.Tensor:
        return _soft_synth(self._params, datas, self._rs, self._body,
                           self.device)

    # -- the pump -------------------------------------------------------------

    def _consume(self, ring: torch.Tensor, roff: int, rx_side: str):
        """Feed the playing quantum of ``ring`` to ``rx_side``'s receiver,
        then clear it.  ``feed`` takes the view in place: its channel
        function and its detector's time-major copy read it first, and no
        later program of the receiver reads it (the receiver keeps its own
        soft ring), so the clear, enqueued after them on the same stream,
        never races a read."""
        frame = ring.narrow(1, roff, self.quantum)
        events = self._rx[rx_side].feed(frame)
        frame.zero_()
        return events

    def step(self) -> None:
        """One audio quantum per direction: launch TX writes, consume the
        playing quantum from the wire, feed the blind receiver (its own
        pipeline overlaps detector / header / body dispatches with the
        copies of previous quanta), deliver what completed."""
        roff = (self.steps * self.quantum) % self.ring_len
        got = []
        for tx_side, rx_side in (("a", "b"), ("b", "a")):
            with metrics.timer("farm_hub.host_tx"):
                self._launch(tx_side)
            with metrics.timer("farm_hub.chunk"):
                events = self._consume(self._rings[tx_side], roff, rx_side)
            got.append((rx_side, events))
        # deliver AFTER both directions' device work is in flight: the
        # drain's host loops would otherwise serialize ahead of the
        # second direction's dispatches
        for rx_side, events in got:
            self._deliver(rx_side, events)
        self.steps += 1
        self._resolve_playouts()

    def _deliver(self, rx_side: str, events) -> None:
        """Decoded payloads ARE wire bytes: plane them and drain through
        the batched deframer.  Several payloads for one channel in one
        step (rare) drain as ordered waves."""
        while events:
            seen = set()
            wave, rest = [], []
            for ch, pl in events:
                (rest if ch in seen else wave).append((ch, pl))
                seen.add(ch)
            counts = np.zeros((self.batch,), np.int64)
            width = max(len(p) for _, p in wave)
            plane = np.zeros((self.batch, max(width, 1)), np.uint8)
            for ch, p in wave:
                counts[ch] = len(p)
                plane[ch, :len(p)] = np.frombuffer(p, np.uint8)
            self._drain(rx_side, _DecOut(counts, plane))
            events = rest

    def flush(self) -> None:
        for side in ("a", "b"):
            self._deliver(side, self._rx[side].flush())

    def _tx_active(self) -> bool:
        return (any(self._rx[s].has_work() for s in ("a", "b"))
                or super()._tx_active())

    # -- observability --------------------------------------------------------

    def get_status(self) -> dict:
        return {
            "steps": self.steps,
            "native_deframer": self._deframers["a"].is_native,
            "ring_len": self.ring_len,
            "rs_parity": self._rs,
            "body_code": (type(self._body).__name__
                          if self._body is not None else None),
            "rx": {s: self._rx[s].get_status() for s in ("a", "b")},
        }
