"""Farm-scale data channels: N concurrent transports over ONE batched farm.

The port's copy of ``webaudio_modem_tpu/runtime/farm_channel.py``.  The
reference runs one modem per AudioWorkletNode and one transport per
modem.  Here the same IDataChannel surface is served per channel as a
VIEW over a single batched ``ModemFarm`` pair: every audio quantum moves
ONE [B, T] frame per direction through the batched demodulator (K1 and
K2 for FSK, K6 and K2 for DBPSK on the card), and the decoded byte
streams are parsed by the native C++ deframer (``native/deframer.py``)
into per-channel wire events — no per-byte Python on the drain path.

Topology: ``FarmLoopbackHub`` models B independent full-duplex wires
between side "a" and side "b" (a's TX is b's RX and vice versa, like
B loopback GainNode pairs).  ``hub.channel("a", i)`` returns the
IDataChannel for wire i as seen from side a.

Scale design (thousands of concurrent ARQ sessions over one hub):

  * TX is COHORT-BATCHED: messages submitted by any number of channels
    are grouped by length each quantum and synthesized in ONE batched
    ``modulate_batch`` call per group.  A cohort's [G, T] signal matrix
    plays out into the per-quantum [B, T] frame with one vectorized copy
    per cohort, not a per-channel Python loop.
  * RX drain is ONE native call per quantum (``Deframer.drain``):
    every channel's decoded bytes are pushed and every wire event
    polled in a single ctypes crossing.
  * Host and device overlap: right after a quantum's demodulation is
    enqueued, its byte counts and bytes start copying into pinned host
    buffers (``non_blocking``) behind a CUDA event; the host parses them
    one quantum later, after the next demodulation is enqueued, waiting
    on that event only (a plain ``.cpu()`` would wait for every kernel
    enqueued so far).  On the CPU the same code takes the tensors as
    they are.
  * Host time per quantum is measured: ``metrics`` timers
    ``farm_hub.host_tx`` / ``farm_hub.chunk`` (with ``farm_hub.fetch_wait``
    and ``farm_hub.host_drain`` inside it) / ``farm_hub.yield_pump``.

Fast path: a ``FarmDataChannel`` also exposes ``next_frame()`` /
``supports_frames`` — XModemTransport detects this and consumes parsed
PACKET/CONTROL events directly (C++-deframed) instead of re-parsing a
byte stream in Python.

For the device-resident variant (audio never leaves the card, host
traffic is bytes-only) see ``runtime/device_hub.DeviceFarmHub``.
"""

from __future__ import annotations

import asyncio
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from webaudio_modem_tpu_torch.core import IDataChannel
from webaudio_modem_tpu_torch.models.farm import ModemFarm
from webaudio_modem_tpu_torch.native.deframer import Deframer, Frame
from webaudio_modem_tpu_torch.utils.abort import (AbortError, AbortSignal,
                                                  race_abort)
from webaudio_modem_tpu_torch.utils.device import resolve_device
from webaudio_modem_tpu_torch.utils.trace import metrics


def refuse_mesh(mesh, who: str) -> None:
    """The hubs take ``mesh=None`` only, as the port's ``ModemFarm``."""
    if mesh is not None:
        raise NotImplementedError(
            f"{who}(mesh=...): sharding is not ported; ROADMAP queue 1, "
            "slice G (item 18) decides what replaces it")


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``.  To the card through a pinned buffer
    with a ``non_blocking`` copy: a copy from pageable memory would wait
    for every kernel enqueued so far."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class _HostOut:
    """A DemodOut's byte counts and bytes on their way to the host: on
    the card, ``non_blocking`` copies into pinned buffers and an event
    recorded after them (``ready()`` waits on that event only); on the
    CPU the tensors themselves."""

    __slots__ = ("counts", "vals", "event")

    def __init__(self, out) -> None:
        counts, vals = out.byte_count, out.bytes_out
        self.event = None
        if counts.device.type == "cuda":
            counts = torch.empty(counts.shape, dtype=counts.dtype,
                                 pin_memory=True).copy_(counts,
                                                        non_blocking=True)
            vals = torch.empty(vals.shape, dtype=vals.dtype,
                               pin_memory=True).copy_(vals,
                                                      non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        self.counts, self.vals = counts, vals

    def ready(self) -> Tuple[np.ndarray, np.ndarray]:
        """(counts [B], bytes [B, maxb]) as numpy, once copied."""
        if self.event is not None:
            self.event.synchronize()
        return self.counts.numpy(), self.vals.numpy()


class _TxEntry:
    """One submitted transmission: data + playout future + lifecycle."""

    __slots__ = ("data", "fut", "state", "cohort", "row")

    QUEUED = 0
    PLAYING = 1
    DONE = 2

    def __init__(self, data: bytes, fut):
        self.data = data
        self.fut = fut
        self.state = _TxEntry.QUEUED
        self.cohort = None   # host hub: the _Cohort playing this entry
        self.row = -1        # row within the cohort


class _Cohort:
    """A batch of same-length signals launched in one synth dispatch,
    playing out in lockstep (host-hub playout model)."""

    __slots__ = ("rows", "signals", "pos", "entries", "active")

    def __init__(self, rows: np.ndarray, signals: np.ndarray,
                 entries: List[_TxEntry]):
        self.rows = rows                # [G] channel indices
        self.signals = signals          # [G, T] float32 host matrix
        self.pos = 0
        self.entries = entries
        self.active = np.ones(len(entries), bool)


class _LeanQueue:
    """Minimal asyncio.Queue replacement for the per-channel byte and
    frame queues: a deque plus bare waiter Futures.

    ``asyncio.Queue.get()`` is a coroutine, so a blocked protocol wait
    costs a Task allocation plus two extra event-loop hops to resume
    and finish that task before the real awaiter wakes.  At 4096
    concurrent ARQ sessions the queue machinery was one of the largest
    single host costs of a farm quantum in the JAX package's
    measurements (docs/PERFORMANCE.md, round 5).
    Here a blocked get awaits a bare Future resolved directly by
    ``put_nowait`` — one allocation, one hop.  Unbounded like the
    asyncio.Queue() it replaces; only the surface the channels use
    (empty/qsize/get_nowait/put_nowait + waiter futures)."""

    __slots__ = ("_items", "_waiters", "_loop")

    def __init__(self) -> None:
        self._items: deque = deque()
        self._waiters: deque = deque()
        self._loop = None          # cached on first blocked get

    def empty(self) -> bool:
        return not self._items

    def qsize(self) -> int:
        return len(self._items)

    def get_nowait(self):
        return self._items.popleft()

    def put_nowait(self, item) -> None:
        while self._waiters:
            fut = self._waiters.popleft()
            if not fut.done():     # skip cancelled/reset waiters
                fut.set_result(item)
                return
        self._items.append(item)

    def get_future(self) -> "asyncio.Future":
        """A Future resolved with the next put (caller checked empty);
        if the caller abandons it (cancel), put_nowait skips it.
        The loop ref is cached (the reference's, copied: a hub reused
        across two ``asyncio.run`` calls keeps the first loop; ROADMAP
        queue 3)."""
        loop = self._loop
        if loop is None:
            loop = self._loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._waiters.append(fut)
        return fut


class FarmDataChannel(IDataChannel):
    """IDataChannel view of one wire endpoint on a farm hub.

    ``modulate`` resolves when the signal has fully entered the wire
    (played out of this side's transmit path), mirroring the
    reference's modulate-resolves-on-playout contract
    (fsk-processor.ts:89-111).  ``demodulate`` blocks until bytes are
    available (fsk-processor.ts:113-135).  ``next_frame`` blocks until
    the native deframer emits the next wire event.
    """

    supports_frames = True

    # backlog bound while NO consumer is attached: bytes decoded before
    # anyone asks are retained (the hub's auto-created views), but a
    # channel that only ever decodes noise must not grow its queues
    # without bound on a long-running hub — beyond this many queued
    # items the oldest are dropped until a consumer attaches
    UNCONSUMED_BACKLOG = 1024

    def __init__(self, hub, side: str, index: int):
        self._hub = hub
        self.side = side
        self.index = index
        self._bytes_q = _LeanQueue()
        self._frames_q = _LeanQueue()
        # which surface the consumer uses (a transport picks one);
        # the unused queue stops filling so long runs don't leak
        self._byte_consumer = False
        self._frame_consumer = False
        # reset() drops blocked demodulate()/next_frame() waiters (same
        # contract as QueueDataChannel.reset / the reference mock)
        self._pending_gets: list = []
        self._reset_gen = 0

    # -- IDataChannel ---------------------------------------------------

    async def modulate(self, data: bytes,
                       signal: Optional[AbortSignal] = None) -> None:
        if signal is not None:
            signal.throw_if_aborted()
        if self._hub._failed is not None:
            raise self._hub._failed
        data = bytes(data)
        if not data:
            return
        entry = self._hub._submit_tx(self.side, self.index, data)
        try:
            await race_abort(entry.fut, signal)
        except BaseException:
            # halt playout of the aborted transmission — the remainder
            # must not keep feeding the wire (FSKProcessor abort parity)
            self._hub._cancel_tx(self.side, self.index, entry)
            raise

    async def _get(self, queue: _LeanQueue, signal):
        if self._hub._failed is not None:
            raise self._hub._failed
        # sync fast path: after a hub drain the item is usually already
        # queued — popping it here skips waiter creation and the
        # event-loop hop per protocol wait (x 4096 sessions per quantum)
        if not queue.empty():
            if signal is not None:
                signal.throw_if_aborted()
            item = queue.get_nowait()
            if isinstance(item, Exception):
                raise item
            return item
        # blocked path: a bare waiter Future resolved directly by the
        # next put — no Task, one loop hop (see _LeanQueue)
        fut = queue.get_future()
        self._pending_gets.append(fut)
        gen = self._reset_gen
        try:
            item = await race_abort(fut, signal)
        except asyncio.CancelledError:
            if self._reset_gen != gen:
                raise AbortError("DataChannel reset")
            raise  # genuine external cancellation must propagate
        finally:
            if fut in self._pending_gets:
                self._pending_gets.remove(fut)
        if isinstance(item, Exception):
            raise item
        return item

    async def demodulate(self,
                         signal: Optional[AbortSignal] = None) -> bytes:
        self._byte_consumer = True
        return await self._get(self._bytes_q, signal)

    async def next_frame(self,
                         signal: Optional[AbortSignal] = None) -> Frame:
        self._frame_consumer = True
        return await self._get(self._frames_q, signal)

    def flush_frames(self) -> None:
        """Drop queued frames and any partially assembled wire bytes —
        the frame-path analog of the byte path's RX-buffer flush on a
        receive error (xmodem.ts:256-259)."""
        while not self._frames_q.empty():
            self._frames_q.get_nowait()
        self._hub._deframer(self.side).reset(self.index)

    async def reset(self) -> None:
        self._hub._reset_tx(self.side, self.index)
        for q in (self._bytes_q, self._frames_q):
            while not q.empty():
                q.get_nowait()
        # drop blocked demodulate()/next_frame() waiters — they raise
        # AbortError, matching QueueDataChannel.reset and the
        # reference's reset-rejects-pending contract
        # (webaudio-data-channel.ts:164-174)
        self._reset_gen += 1
        pending, self._pending_gets = self._pending_gets, []
        for t in pending:
            if not t.done():
                t.cancel()
        self._hub._deframer(self.side).reset(self.index)

    def is_ready(self) -> bool:
        return True

    # -- hub delivery ----------------------------------------------------

    def _deliver(self, piece: bytes, frames: List[Frame]) -> None:
        # fill both surfaces until the consumer picks one, then stop
        # filling (and drop) the unused queue — otherwise a long-running
        # hub leaks one queue per channel forever
        frame_only = self._frame_consumer and not self._byte_consumer
        byte_only = self._byte_consumer and not self._frame_consumer
        unconsumed = not (self._byte_consumer or self._frame_consumer)
        if piece and not frame_only:
            self._bytes_q.put_nowait(piece)
        elif frame_only:
            while not self._bytes_q.empty():
                self._bytes_q.get_nowait()
        if not byte_only:
            for f in frames:
                self._frames_q.put_nowait(f)
        elif byte_only:
            while not self._frames_q.empty():
                self._frames_q.get_nowait()
        if unconsumed:
            # no consumer yet: retain a bounded backlog, drop oldest
            for q in (self._bytes_q, self._frames_q):
                while q.qsize() > self.UNCONSUMED_BACKLOG:
                    q.get_nowait()


class FarmHubBase:
    """Shared machinery for the host-playout and device-resident hubs:
    channel views, the cohort TX submission model, and the batched
    native drain."""

    def __init__(self, config, batch: int, quantum: int):
        self.config = config
        self.batch = batch
        self.quantum = quantum
        self._deframers = {"a": Deframer(batch), "b": Deframer(batch)}
        self._channels: Dict[Tuple[str, int], FarmDataChannel] = {}
        # per-channel FIFO of queued _TxEntry
        self._pending_tx: Dict[str, List[deque]] = {
            "a": [deque() for _ in range(batch)],
            "b": [deque() for _ in range(batch)]}
        # channels whose head-of-queue can launch next quantum (kept as
        # a set so a 4096-channel hub never scans idle channels)
        self._ready_tx: Dict[str, set] = {"a": set(), "b": set()}
        # the entry currently playing per channel (None when idle)
        self._playing: Dict[str, List[Optional[_TxEntry]]] = {
            "a": [None] * batch, "b": [None] * batch}
        self._running = False
        self.steps = 0
        # set by _fail() when the pump crashes: channel operations
        # re-raise it instead of blocking on queues nobody will fill
        self._failed: Optional[BaseException] = None

    # -- wiring -----------------------------------------------------------

    def channel(self, side: str, index: int) -> FarmDataChannel:
        key = (side, index)
        if key not in self._channels:
            self._channels[key] = FarmDataChannel(self, side, index)
        return self._channels[key]

    def _deframer(self, rx_side: str) -> Deframer:
        return self._deframers[rx_side]

    # -- TX submission (cohort model) --------------------------------------

    def _submit_tx(self, side: str, index: int, data: bytes) -> _TxEntry:
        loop = asyncio.get_running_loop()
        entry = _TxEntry(data, loop.create_future())
        self._pending_tx[side][index].append(entry)
        if self._playing[side][index] is None:
            self._ready_tx[side].add(index)
        return entry

    def _cancel_tx(self, side: str, index: int, entry: _TxEntry) -> None:
        if entry.state == _TxEntry.QUEUED:
            try:
                self._pending_tx[side][index].remove(entry)
            except ValueError:
                pass
        elif entry.state == _TxEntry.PLAYING:
            self._stop_playing(side, index, entry)
            if self._playing[side][index] is entry:
                self._playing[side][index] = None
                if self._pending_tx[side][index]:
                    self._ready_tx[side].add(index)
        entry.state = _TxEntry.DONE

    def _reset_tx(self, side: str, index: int) -> None:
        exc = AbortError("DataChannel reset")
        for e in self._pending_tx[side][index]:
            e.state = _TxEntry.DONE
            if e.fut is not None and not e.fut.done():
                e.fut.set_exception(exc)
        self._pending_tx[side][index].clear()
        self._ready_tx[side].discard(index)
        e = self._playing[side][index]
        if e is not None:
            if e.fut is not None and not e.fut.done():
                e.fut.set_exception(exc)
            self._cancel_tx(side, index, e)

    def tx_pending(self, side: str, index: int) -> bool:
        """True while the channel has queued or playing transmissions."""
        return (self._playing[side][index] is not None
                or bool(self._pending_tx[side][index]))

    def _tx_active(self) -> bool:
        return any(self._ready_tx[s] or any(p is not None
                                            for p in self._playing[s])
                   for s in ("a", "b"))

    def _collect_launchable(self, side: str):
        """Pop one head-of-queue entry per ready channel and group them
        by message length: each group becomes ONE batched synthesis."""
        ready = self._ready_tx[side]
        if not ready:
            return {}
        groups: Dict[int, Tuple[list, list, list]] = {}
        for i in list(ready):
            ready.discard(i)
            dq = self._pending_tx[side][i]
            if not dq or self._playing[side][i] is not None:
                continue
            e = dq.popleft()
            self._playing[side][i] = e
            e.state = _TxEntry.PLAYING
            rows, datas, entries = groups.setdefault(
                len(e.data), ([], [], []))
            rows.append(i)
            datas.append(e.data)
            entries.append(e)
        return groups

    def _stop_playing(self, side: str, index: int,
                      entry: _TxEntry) -> None:
        raise NotImplementedError

    # -- RX drain (ONE native call per quantum) -----------------------------

    def _drain(self, rx_side: str, pending: _HostOut) -> None:
        """Parse one quantum's decoded bytes (a ``_HostOut`` of its
        DemodOut: the small counts / bytes planes only) into per-channel
        byte/frame queues through the native deframer.  The timer
        ``farm_hub.fetch_wait`` reads how long the host waited for the
        device to finish that quantum's copies."""
        with metrics.timer("farm_hub.fetch_wait"):
            counts, vals = pending.ready()
        if not counts.any():
            return
        with metrics.timer("farm_hub.host_drain"):
            events = self._deframers[rx_side].drain(vals, counts)
            frames_by_ch: Dict[int, List[Frame]] = defaultdict(list)
            for ch, frame in events:
                frames_by_ch[ch].append(frame)
            views = self._channels
            for b in np.nonzero(counts)[0]:
                b = int(b)
                # auto-create the view so bytes decoded before anyone
                # asked for the channel are not lost
                view = views.get((rx_side, b)) \
                    or self.channel(rx_side, b)
                frames = frames_by_ch.get(b, ())
                if view._frame_consumer and not view._byte_consumer:
                    # frame-only consumer (the farm ARQ fast path):
                    # the raw byte piece would be dropped by _deliver
                    # anyway — skip building it, and skip the call
                    # entirely on frameless quanta (partial packets
                    # still buffered inside the native deframer)
                    if frames:
                        view._deliver(b"", frames)
                    continue
                view._deliver(bytes(vals[b, :counts[b]]), frames)

    # -- pump loop ----------------------------------------------------------

    def step(self) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        raise NotImplementedError

    async def run(self, max_steps: Optional[int] = None,
                  idle_limit: Optional[int] = None,
                  yields_per_step: int = 32) -> None:
        """Pump until stopped; yields to the event loop each step so
        transport coroutines interleave.  ``idle_limit`` stops after
        that many consecutive silent steps (both directions idle).

        ``yields_per_step``: event-loop iterations granted between
        quanta.  A protocol phase (packet in -> ACK out) is a chain of
        ~30 awaits, and each loop iteration advances every ready chain
        by ONE hop — with a single yield, protocol latency would be
        chain_length x step_wall (at 4096 sessions through a tunnel,
        minutes — enough to trip the ARQ timeouts).  Draining the loop
        between steps keeps protocol latency at ~1 quantum regardless
        of step cost, and batches all concurrent replies into the same
        launch cohort.  Idle iterations cost microseconds."""
        self._running = True
        idle = 0
        n = 0
        try:
            while self._running and (max_steps is None or n < max_steps):
                busy = self._tx_active()
                self.step()
                n += 1
                idle = 0 if busy else idle + 1
                if idle_limit is not None and idle >= idle_limit:
                    break
                # timed: at 4096 sessions the transport coroutines'
                # protocol work all happens inside these yields — it is
                # host cost per quantum exactly like tx/drain
                with metrics.timer("farm_hub.yield_pump"):
                    for _ in range(max(1, yields_per_step)):
                        await asyncio.sleep(0)
        except BaseException as exc:  # the reference's, copied: ROADMAP queue 3
            # fail FAST: callers run the pump as a background task
            # (``ensure_future(hub.run())``) whose exception nobody
            # awaits until the transfers end — without poisoning, a
            # dispatch error here (e.g. a kernel lowering rejection)
            # leaves every ARQ session blocked on queues only this
            # pump can fill
            self._fail(exc)
            raise
        finally:
            self._running = False
            if self._failed is None:
                self.flush()

    def stop(self) -> None:
        self._running = False

    def _fail(self, exc: BaseException) -> None:
        """Poison the hub after a pump crash: every blocked protocol
        wait and queued/playing transmission resolves with ``exc``
        immediately, and later channel operations re-raise it (see
        FarmDataChannel.modulate/_get)."""
        if self._failed is not None:
            return
        self._failed = exc
        for ch in self._channels.values():
            pending, ch._pending_gets = ch._pending_gets, []
            for fut in pending:
                if not fut.done():
                    fut.set_exception(exc)
        for side in ("a", "b"):
            for dq in self._pending_tx[side]:
                for e in dq:
                    if not e.fut.done():
                        e.fut.set_exception(exc)
                dq.clear()
            for e in self._playing[side]:
                if e is not None and not e.fut.done():
                    e.fut.set_exception(exc)


class FarmLoopbackHub(FarmHubBase):
    """B independent full-duplex wires, each direction one ModemFarm on
    ``device`` (the card unless the caller asks for the CPU), with
    host-side playout (signals synthesized in cohort batches on the
    device, staged to the host, mixed into per-quantum [B, T] frames,
    uploaded each quantum).

    ``run()`` pumps audio quanta: per step and per direction it
    launches pending transmissions as synthesis cohorts, assembles the
    [B, T] transmit frame with one vectorized copy per cohort, applies
    ``channel_fn`` (AWGN etc., see sim/channels.py), feeds the
    receiving side's batched demodulator, and drains decoded bytes
    through the native C++ deframer into per-channel queues.
    """

    def __init__(self, config, batch: int, quantum: int = 4800,
                 channel_fn: Optional[Callable] = None,
                 mesh=None, *, device="cuda"):
        refuse_mesh(mesh, type(self).__name__)
        super().__init__(config, batch, quantum)
        self.device = resolve_device(device)
        self.channel_fn = channel_fn
        # direction x->y: modulated by side x, demodulated by farm of y
        self._farms = {"a": ModemFarm(config, batch, device=self.device),
                       "b": ModemFarm(config, batch, device=self.device)}
        self._cohorts: Dict[str, List[_Cohort]] = {"a": [], "b": []}
        # host/device pipelining: the DemodOut of the chunk enqueued at
        # step t is drained at step t+1, so the device computes chunk
        # t+1 while the host parses t
        self._pending: Dict[str, Optional[_HostOut]] = {"a": None,
                                                        "b": None}
        self._params = self._farms["a"].params
        self._ops = self._farms["a"]._ops

    # -- TX playout ---------------------------------------------------------

    def _launch(self, side: str) -> None:
        """Synthesize every launchable message in ONE batched dispatch
        per message length (frame_bits_batch + device synth), brought
        to the host for playout."""
        for _length, (rows, datas, entries) in \
                self._collect_launchable(side).items():
            sig = self._ops.modulate_batch(self._params, datas,
                                           self.device).cpu().numpy()
            cohort = _Cohort(np.asarray(rows, np.int64), sig, entries)
            for g, e in enumerate(entries):
                e.cohort = cohort
                e.row = g
            self._cohorts[side].append(cohort)

    def _stop_playing(self, side: str, index: int,
                      entry: _TxEntry) -> None:
        # deactivate the cohort row: playout of the remainder stops
        if entry.cohort is not None:
            entry.cohort.active[entry.row] = False

    def _assemble(self, side: str) -> Optional[np.ndarray]:
        cohorts = self._cohorts[side]
        if not cohorts:
            return None
        frame = np.zeros((self.batch, self.quantum), np.float32)
        finished = []
        for c in cohorts:
            n = min(self.quantum, c.signals.shape[1] - c.pos)
            if c.active.any():
                frame[c.rows[c.active], :n] += \
                    c.signals[c.active, c.pos:c.pos + n]
            c.pos += n
            if c.pos >= c.signals.shape[1]:
                finished.append(c)
        for c in finished:
            cohorts.remove(c)
            for g, e in enumerate(c.entries):
                if not c.active[g]:
                    continue  # cancelled rows were handled at cancel
                idx = int(c.rows[g])
                e.state = _TxEntry.DONE
                if self._playing[side][idx] is e:
                    self._playing[side][idx] = None
                if e.fut is not None and not e.fut.done():
                    e.fut.set_result(None)
                if self._pending_tx[side][idx]:
                    self._ready_tx[side].add(idx)
        return frame

    def _tx_active(self) -> bool:
        return (bool(self._cohorts["a"] or self._cohorts["b"])
                or super()._tx_active())

    # -- the pump ----------------------------------------------------------

    def step(self) -> None:
        """One audio quantum for both directions.

        Pipelined: enqueue this quantum's demod (asynchronous on the
        card) and THEN drain the previous quantum's outputs, overlapping
        device compute with host-side parsing.  Call ``flush()`` (or one
        extra ``step()``) to force out the last quantum's bytes."""
        for tx_side, rx_side in (("a", "b"), ("b", "a")):
            with metrics.timer("farm_hub.host_tx"):
                self._launch(tx_side)
                frame = self._assemble(tx_side)
            if frame is None:
                # silence still advances the receiver's EOD/silence
                # tracking
                frame = np.zeros((self.batch, self.quantum), np.float32)
            if self.channel_fn is not None:
                frame = np.asarray(self.channel_fn(frame),
                                   dtype=np.float32)
            farm = self._farms[rx_side]
            with metrics.timer("farm_hub.chunk"):
                out = farm.demodulate_chunk(upload(frame, self.device))
                prev, self._pending[rx_side] = \
                    self._pending[rx_side], _HostOut(out)
                if prev is not None:
                    self._drain(rx_side, prev)
        self.steps += 1

    def flush(self) -> None:
        """Drain any pipelined-but-unparsed demod outputs."""
        for side in ("a", "b"):
            out, self._pending[side] = self._pending[side], None
            if out is not None:
                self._drain(side, out)

    def get_status(self) -> dict:
        return {
            "steps": self.steps,
            "native_deframer": self._deframers["a"].is_native,
            "farm_a": self._farms["a"].get_status(),
            "farm_b": self._farms["b"].get_status(),
        }
