"""Mirror of ``tests/runtime/test_processor.py`` against the port: its
``TestLoopbackGraph`` (the unit tests are in ``test_torch_processor.py``;
the two files let the slow audio tests run on separate workers).

FSKProcessor tests (reference tests/webaudio/fsk-processor.test.ts,
driven through the async IDataChannel surface)."""

import asyncio

from webaudio_modem_tpu_torch.models.config import DEFAULT_FSK_CONFIG
from webaudio_modem_tpu_torch.runtime import AudioGraph, FSKProcessor


class TestLoopbackGraph:
    async def test_processor_to_processor_loopback(self):
        # the end-to-end analog of
        # fsk-processor-integration-browser.test.ts:123-269
        sender = FSKProcessor(name="sender", device="cpu")
        receiver = FSKProcessor(name="receiver", device="cpu")
        sender.configure(DEFAULT_FSK_CONFIG)
        receiver.configure(DEFAULT_FSK_CONFIG)
        graph = AudioGraph(quantum=512)
        graph.connect(sender)
        graph.connect(receiver)

        data = b"Hello, World!"
        drive = asyncio.ensure_future(graph.run())
        try:
            send = asyncio.ensure_future(sender.modulate(data))
            received = b""
            while len(received) < len(data):  # bytes arrive as decoded
                received += await asyncio.wait_for(receiver.demodulate(),
                                                   timeout=60)
            await send
        finally:
            graph.stop()
            await drive
        assert received == data

    async def test_self_reception_suppressed(self):
        # clear-RX-after-TX rule (fsk-processor.ts:207-208)
        proc = FSKProcessor(name="solo", device="cpu")
        proc.configure(DEFAULT_FSK_CONFIG)
        graph = AudioGraph(quantum=512)
        graph.connect(proc)
        drive = asyncio.ensure_future(graph.run())
        try:
            await asyncio.wait_for(proc.modulate(b"\x42"), timeout=60)
        finally:
            graph.stop()
            await drive
        # a short grace period of 50 quanta: buffer must stay empty.  The
        # JAX package's test leaves run() stepping beside these steps
        # (~4 more a step); on the CPU's plain path that quintuples the
        # test's cost, so the graph is stopped first and the period is
        # the 50 quanta the test names (the post-TX guard spans 2)
        for _ in range(50):
            graph.step()
            await asyncio.sleep(0)
        assert len(proc.demodulated_buffer) == 0
