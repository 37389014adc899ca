"""Device-resident farm hubs — the WIRE lives on the card.

The port's copy of ``webaudio_modem_tpu/runtime/device_hub.py``.  The
host-playout hub (``runtime/farm_channel.FarmLoopbackHub``) builds a
[B, T] numpy frame per quantum and uploads it.  The hubs here remove
audio from the host path entirely:

  * Each side owns a TX ring ``[B, ring_len]``, a CUDA tensor: the wire.
    Transmissions are synthesized ON THE DEVICE (cohort-batched
    synthesis, one call per message length per quantum) and written into
    the ring at quantum-aligned offsets by in-place ops on views of the
    ring (a masked select, a uniform-row select, a masked clear).  The
    signal matrix never visits the host.
  * ``DeviceFarmHub`` (hard UART path): each ``step()`` runs ONE pump
    per direction — the next quantum of the ring, the device channel
    function (e.g. ``sim.make_device_awgn``) with the side's
    ``torch.Generator``, the batched demodulator (K1 + K2, or K6 + K2
    for DBPSK), then the consumed region cleared.
  * The ONLY per-quantum device->host traffic is the decoded-byte
    aggregates ([B] counts + [B, maxb] bytes, a few tens of KB at
    B=4096), copied behind an event and drained through the batched
    C++ deframer one quantum later.

Playout bookkeeping is pure host arithmetic (write offsets and signal
lengths are data-independent), so ``modulate()`` futures resolve when
the read pointer passes the end of the written signal — the
modulate-resolves-on-playout contract (fsk-processor.ts:89-111) —
without ever inspecting device data.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from webaudio_modem_tpu_torch.models.farm import _resolve_family
from webaudio_modem_tpu_torch.runtime.farm_channel import (FarmHubBase,
                                                           _HostOut,
                                                           _TxEntry,
                                                           refuse_mesh,
                                                           upload)
from webaudio_modem_tpu_torch.utils.device import resolve_device
from webaudio_modem_tpu_torch.utils.trace import metrics


class RingHubBase(FarmHubBase):
    """Ring-wire machinery shared by the device-resident hubs: TX rings
    on the device, cohort-batched synthesis writes at quantum-aligned
    offsets, abort clearing, and playout-resolution bookkeeping.

    Subclasses provide ``_synth_full(side, datas) -> [B, T]`` (a
    device-resident full-batch synthesis of B equal-length messages)
    and may override ``_on_group_written`` to schedule receive-side
    work for the written playout window.
    """

    def __init__(self, config, batch: int, quantum: int,
                 ring_quanta: int, mesh=None, *, device="cuda"):
        refuse_mesh(mesh, type(self).__name__)
        super().__init__(config, batch, quantum)
        self.device = resolve_device(device)
        self.ring_len = ring_quanta * quantum
        self._rings = {
            s: torch.zeros((batch, self.ring_len), dtype=torch.float32,
                           device=self.device) for s in ("a", "b")}
        # host playout bookkeeping, absolute sample clock
        self._busy_until = {"a": [0] * batch, "b": [0] * batch}
        # step index -> [(channel, entry)] resolved when that step's
        # quantum has been consumed
        self._resolve_at: Dict[str, Dict[int, list]] = {
            "a": defaultdict(list), "b": defaultdict(list)}
        # data -> (padded [Lpad] device row, true signal length T) for
        # uniform cohorts; bounded (control bytes dominate: 3 entries)
        self._uniform_rows: Dict[bytes, tuple] = {}

    # -- the ring ops: in place, on views of a ring -------------------------

    @staticmethod
    def _ring_write(ring, sig, mask, woff: int) -> None:
        """Overwrite columns [woff, woff+L) of the masked rows with sig
        (select, not add): rows outside the cohort keep their
        concurrent signals untouched, rows inside drop whatever stale
        audio a previous ring revolution left there."""
        win = ring.narrow(1, woff, sig.shape[1])
        torch.where(mask[:, None], sig, win, out=win)

    @staticmethod
    def _ring_write_row(ring, row, mask, woff: int) -> None:
        """Uniform-cohort write: every masked row carries the SAME [L]
        signal, broadcast in the select.  Control traffic (ACK/NAK/EOT
        floods) re-uses one cached synthesized row, so the write uploads
        nothing but the [B] mask."""
        win = ring.narrow(1, woff, row.shape[0])
        torch.where(mask[:, None], row[None, :], win, out=win)

    @staticmethod
    def _ring_clear(ring, keep, coff: int, width: int) -> None:
        """Zero columns [coff, coff+width) of the rows where keep is
        False (abort: stop feeding the wire)."""
        ring.narrow(1, coff, width).masked_fill_(~keep[:, None], 0.0)

    # -- TX: device-resident playout ----------------------------------------

    def _quanta(self, n: int) -> int:
        return -(-n // self.quantum) * self.quantum

    def _synth_full(self, side: str, datas) -> torch.Tensor:
        """Full-batch synthesis of B equal-length messages -> device
        [B, T].  Subclass hook (UART framing vs FEC frames)."""
        raise NotImplementedError

    def _on_group_written(self, side: str, w: int, Lpad: int, T: int,
                          rows, entries, length: int) -> None:
        """Called after a cohort's signal entered the ring at absolute
        sample offset ``w`` (playout window [w, w+Lpad)).  Base: no-op;
        the soft hub schedules the window decode here."""

    def _launch(self, side: str) -> None:
        t_read = self.steps * self.quantum  # quantum consumed THIS step
        for length, (rows, datas, entries) in \
                self._collect_launchable(side).items():
            # sub-group by write offset (stop-and-wait traffic is idle
            # when it sends, so almost always one group at t_read)
            by_w = defaultdict(lambda: ([], [], []))
            for i, d, e in zip(rows, datas, entries):
                w = self._quanta(max(t_read, self._busy_until[side][i]))
                g = by_w[w]
                g[0].append(i)
                g[1].append(d)
                g[2].append(e)
            for w, (rws, ds, es) in by_w.items():
                self._write_group(side, w, t_read, rws, ds, es, length)

    def _defer(self, side: str, rows, entries) -> None:
        """Ring too full: push the entries back and retry next step."""
        for i, e in zip(rows, entries):
            e.state = _TxEntry.QUEUED
            self._playing[side][i] = None
            self._pending_tx[side][i].appendleft(e)
            self._ready_tx[side].add(i)

    def _uniform_row(self, side: str, data: bytes):
        """Cached padded [Lpad] device row for a uniform cohort (every
        launchable message identical — control floods).  Synthesized at
        B=1 once per distinct message; later launches upload only the
        [B] mask."""
        hit = self._uniform_rows.get(data)
        if hit is None:
            sig = self._synth_full(side, [data])          # [1, T]
            T = int(sig.shape[1])
            Lpad = self._quanta(T)
            row = sig[0]
            if Lpad != T:
                row = F.pad(row, (0, Lpad - T))
            if len(self._uniform_rows) >= 16:
                self._uniform_rows.clear()
            hit = self._uniform_rows[data] = (row, T)
        return hit

    def _write_group(self, side: str, w: int, t_read: int,
                     rows, datas, entries, length: int) -> None:
        # uniform cohorts (control floods: every message identical)
        # reuse one cached synthesized row and upload only the mask
        uniform = all(d == datas[0] for d in datas)
        if uniform:
            row, T = self._uniform_row(side, datas[0])
            sig = None
        else:
            # full-B synthesis with a row mask: in the farm-flood case
            # every row transmits anyway, and the masked form needs no
            # scatter
            msgs_full = [datas[0]] * self.batch
            for i, d in zip(rows, datas):
                msgs_full[i] = d
            sig = self._synth_full(side, msgs_full)       # device
            T = int(sig.shape[1])
        Lpad = self._quanta(T)
        if w + Lpad - t_read > self.ring_len:
            if Lpad + self.quantum > self.ring_len:
                raise ValueError(
                    f"signal of {T} samples ({Lpad // self.quantum} "
                    f"quanta) cannot fit the ring "
                    f"({self.ring_len // self.quantum} quanta) — raise "
                    f"ring_quanta")
            self._defer(side, rows, entries)
            return
        mask = np.zeros((self.batch,), bool)
        mask[rows] = True
        mask = upload(mask, self.device)
        woff = w % self.ring_len
        ring = self._rings[side]
        # a write past the ring's end wraps to its start
        n1 = min(Lpad, self.ring_len - woff)
        if uniform:
            self._ring_write_row(ring, row[:n1], mask, woff)
            if n1 < Lpad:
                self._ring_write_row(ring, row[n1:], mask, 0)
        else:
            if Lpad != T:
                sig = F.pad(sig, (0, Lpad - T))
            self._ring_write(ring, sig[:, :n1], mask, woff)
            if n1 < Lpad:
                self._ring_write(ring, sig[:, n1:], mask, 0)
        s_end = (w + T - 1) // self.quantum
        for i, e in zip(rows, entries):
            self._busy_until[side][i] = w + T
            e.cohort = (w, Lpad)  # device hub: playout region record
            self._resolve_at[side][s_end].append((i, e))
        self._on_group_written(side, w, Lpad, T, rows, entries, length)

    def _stop_playing(self, side: str, index: int,
                      entry: _TxEntry) -> None:
        """Abort: zero this channel's remaining unread ring region so
        the wire stops carrying the transmission."""
        if entry.cohort is None:
            return
        w, Lpad = entry.cohort
        t_next = self.steps * self.quantum
        lo = max(w, t_next)
        hi = w + Lpad
        if hi <= lo:
            return
        keep = np.ones((self.batch,), bool)
        keep[index] = False
        keep = upload(keep, self.device)
        ring = self._rings[side]
        coff = lo % self.ring_len
        width = hi - lo
        n1 = min(width, self.ring_len - coff)
        self._ring_clear(ring, keep, coff, n1)
        if n1 < width:
            self._ring_clear(ring, keep, 0, width - n1)
        self._busy_until[side][index] = t_next

    def _resolve_playouts(self) -> None:
        done_step = self.steps - 1
        for side in ("a", "b"):
            for i, e in self._resolve_at[side].pop(done_step, ()):
                if e.state != _TxEntry.PLAYING:
                    continue  # cancelled / reset
                e.state = _TxEntry.DONE
                if self._playing[side][i] is e:
                    self._playing[side][i] = None
                if e.fut is not None and not e.fut.done():
                    e.fut.set_result(None)
                if self._pending_tx[side][i]:
                    self._ready_tx[side].add(i)


class DeviceFarmHub(RingHubBase):
    """B full-duplex wires held on the device; host traffic bytes-only.

    Same channel surface as FarmLoopbackHub (``channel(side, i)`` ->
    FarmDataChannel with modulate / demodulate / next_frame), same
    cohort TX submission model, same batched native drain.

    ``device_channel_fn``: optional ``fn(frame, generator) -> frame``
    applied inside the pump (see ``sim.make_device_awgn``); each
    receiving side draws from its own ``torch.Generator`` on ``device``,
    seeded ``seed`` (side a) and ``seed + 1`` (side b).
    ``ring_quanta`` sizes the wire: it must hold the longest signal
    (rounded up to whole quanta) plus one quantum of slack.  ``device``:
    the card unless the caller asks for the CPU.
    """

    def __init__(self, config, batch: int, quantum: int = 4800,
                 ring_quanta: int = 16,
                 device_channel_fn: Optional[Callable] = None,
                 seed: int = 0, mesh=None, *, device="cuda"):
        super().__init__(config, batch, quantum, ring_quanta, mesh=mesh,
                         device=device)
        self._ops, self._params = _resolve_family(config)
        if quantum % self._params.downsample_ratio != 0:
            raise ValueError(
                f"quantum ({quantum}) must be a multiple of the "
                f"downsample ratio ({self._params.downsample_ratio})")
        self._states = {
            s: self._ops.init_state(self._params, batch, self.device)
            for s in ("a", "b")}
        self._generators = {}
        for s, sd in (("a", seed), ("b", seed + 1)):
            self._generators[s] = torch.Generator(device=self.device)
            self._generators[s].manual_seed(sd)
        self._pending_out: Dict[str, Optional[_HostOut]] = {
            "a": None, "b": None}
        self._inner = self._ops.make_demod_chunk(self._params, 0,
                                                 donate=False)
        self._chan = device_channel_fn

    def _pump(self, ring, state, roff: int, generator):
        """One quantum of one direction: the ring's columns [roff,
        roff + quantum) through the channel function and the
        demodulator, then cleared.  The demodulator's first op copies
        its [B, T] input time-major, and the clear is enqueued after it
        on the same stream, so the frame is copied once and never read
        after it is zeroed.  Returns (ring, state, DemodOut,
        generator)."""
        frame = ring.narrow(1, roff, self.quantum)
        if self._chan is not None:
            frame = self._chan(frame, generator)
        state, out = self._inner(state, frame)
        ring.narrow(1, roff, self.quantum).zero_()
        return ring, state, out, generator

    def _synth_full(self, side: str, datas) -> torch.Tensor:
        return self._ops.modulate_batch(self._params, datas, self.device)

    # -- the pump ----------------------------------------------------------

    def step(self) -> None:
        """One audio quantum for both directions: launch TX writes into
        the device rings, run the pump (ring quantum -> channel ->
        demod -> clear), start the copy of its bytes to the host, then
        drain the PREVIOUS quantum's bytes while the device computes
        this one."""
        roff = (self.steps * self.quantum) % self.ring_len
        for tx_side, rx_side in (("a", "b"), ("b", "a")):
            with metrics.timer("farm_hub.host_tx"):
                self._launch(tx_side)
            with metrics.timer("farm_hub.chunk"):
                ring, state, out, gen = self._pump(
                    self._rings[tx_side], self._states[rx_side], roff,
                    self._generators[rx_side])
                self._rings[tx_side] = ring
                self._states[rx_side] = state
                self._generators[rx_side] = gen
                prev, self._pending_out[rx_side] = \
                    self._pending_out[rx_side], _HostOut(out)
                if prev is not None:
                    self._drain(rx_side, prev)
        self.steps += 1
        self._resolve_playouts()

    def flush(self) -> None:
        for side in ("a", "b"):
            out, self._pending_out[side] = self._pending_out[side], None
            if out is not None:
                self._drain(side, out)

    # -- observability ------------------------------------------------------

    def get_status(self) -> dict:
        occupied = {
            side: max((bu for bu in self._busy_until[side]), default=0)
            - self.steps * self.quantum
            for side in ("a", "b")}
        return {
            "steps": self.steps,
            "native_deframer": self._deframers["a"].is_native,
            "ring_len": self.ring_len,
            "ring_occupancy_samples": {s: max(v, 0)
                                       for s, v in occupied.items()},
            "sync_detections": {
                s: self._states[s].sync_count.cpu().numpy()
                for s in ("a", "b")},
        }
