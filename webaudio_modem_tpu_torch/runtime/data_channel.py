"""In-memory data channels: the port's copy of
``webaudio_modem_tpu/runtime/data_channel.py``.

``QueueDataChannel`` is the first of the reference's three test-fidelity
levels (SURVEY.md §4): a pure byte-queue IDataChannel equivalent to the
reference MockDataChannel (tests/transports/xmodem/xmodem.node.test.ts:
12-159) — protocol logic is exercised without any audio.

``LoopbackDataChannel`` wires two queue channels back-to-back so two
transports can talk (sender's modulated bytes appear on both sides,
mirroring the loopback hub where every node hears the mix).
"""

from __future__ import annotations

import asyncio
from typing import List, Optional

from webaudio_modem_tpu_torch.core import IDataChannel
from webaudio_modem_tpu_torch.utils.abort import (AbortError, AbortSignal,
                                                  race_abort)


class QueueDataChannel(IDataChannel):
    """Byte-queue channel with injectable RX data (MockDataChannel analog).

    ``byte_by_byte`` mode delivers injected data one byte per
    ``demodulate`` resolution, simulating FSK demod granularity
    (xmodem.node.test.ts:107-122).
    """

    def __init__(self):
        self.sent_data: List[bytes] = []
        self._rx_queue: asyncio.Queue = asyncio.Queue()
        self._pending_gets: List[asyncio.Future] = []
        self._reset_gen = 0
        self.closed = False
        self.peer: Optional["QueueDataChannel"] = None
        self.echo = False  # deliver own TX back to self (loopback hub)

    # -- IDataChannel -------------------------------------------------------

    async def modulate(self, data: bytes,
                       signal: Optional[AbortSignal] = None) -> None:
        if signal is not None:
            signal.throw_if_aborted()
        data = bytes(data)
        self.sent_data.append(data)
        if self.peer is not None:
            self.peer.add_received_data(data)
        if self.echo:
            self.add_received_data(data)

    async def demodulate(self,
                         signal: Optional[AbortSignal] = None) -> bytes:
        if self.closed:
            raise ConnectionError("DataChannel closed")
        if signal is not None:
            signal.throw_if_aborted()
        get_task = asyncio.ensure_future(self._rx_queue.get())
        self._pending_gets.append(get_task)
        gen = self._reset_gen
        try:
            data = await race_abort(get_task, signal)
        except asyncio.CancelledError:
            if self._reset_gen != gen:
                # a reset() dropped this waiter (the reference mock
                # discards its resolvers, xmodem.node.test.ts:143-151)
                raise AbortError("DataChannel reset")
            raise  # genuine external cancellation must propagate
        finally:
            if get_task in self._pending_gets:
                self._pending_gets.remove(get_task)
        if isinstance(data, Exception):
            raise data
        return data

    async def reset(self) -> None:
        # match the reference mock (xmodem.node.test.ts:143-151): keep
        # sent/queued data for inspection; drop pending demodulate
        # waiters (their awaits raise AbortError)
        self.closed = False
        self._reset_gen += 1
        pending, self._pending_gets = self._pending_gets, []
        for t in pending:
            if not t.done():
                t.cancel()

    # -- test/injection helpers --------------------------------------------

    def add_received_data(self, data: bytes) -> None:
        if self.closed:
            return
        self._rx_queue.put_nowait(bytes(data))

    def add_received_data_by_byte(self, data: bytes) -> None:
        if self.closed:
            return
        for b in bytes(data):
            self._rx_queue.put_nowait(bytes([b]))

    def close(self) -> None:
        self.closed = True
        self._rx_queue.put_nowait(ConnectionError("DataChannel closed"))

    def trigger_abort(self, message: str = "Demodulation aborted") -> None:
        self._rx_queue.put_nowait(AbortError(message))

    def get_last_sent_data(self) -> Optional[bytes]:
        return self.sent_data[-1] if self.sent_data else None

    def clear_sent_data(self) -> None:
        self.sent_data = []


def make_loopback_pair(echo: bool = False):
    """Two QueueDataChannels wired as peers.

    ``echo=True`` reproduces the loopback-hub topology where each node
    also hears its own transmission (demo/demo.js:403-413) — the case
    the transport's EOT-echo immunity exists for (xmodem.ts:442-470).
    """
    a, b = QueueDataChannel(), QueueDataChannel()
    a.peer, b.peer = b, a
    a.echo = b.echo = echo
    return a, b


LoopbackDataChannel = make_loopback_pair
