"""Mirror of ``tests/runtime/test_processor.py`` against the port.

FSKProcessor tests (reference tests/webaudio/fsk-processor.test.ts,
driven through the async IDataChannel surface)."""

import asyncio

import numpy as np
import pytest

from webaudio_modem_tpu_torch.models.config import DEFAULT_FSK_CONFIG
from webaudio_modem_tpu_torch.runtime import AudioGraph, FSKProcessor
from webaudio_modem_tpu_torch.utils.abort import AbortController, AbortError


@pytest.fixture
def proc():
    p = FSKProcessor(name="test", device="cpu")
    p.configure(DEFAULT_FSK_CONFIG)
    return p


async def _drive(graph, until, timeout_steps=20000):
    for _ in range(timeout_steps):
        graph.step()
        await asyncio.sleep(0)
        if until():
            return
    raise TimeoutError("graph drive timed out")


class TestProcessorUnit:
    async def test_modulate_resolves_after_playout(self, proc):
        graph = AudioGraph(quantum=512)
        graph.connect(proc)
        done = False

        async def run():
            nonlocal done
            await proc.modulate(b"\x42")
            done = True

        task = asyncio.ensure_future(run())
        await _drive(graph, lambda: done)
        await task
        assert not proc.get_status()["pending_modulation"]

    async def test_modulate_busy_raises(self, proc):
        task = asyncio.ensure_future(proc.modulate(b"\x42"))
        await asyncio.sleep(0.01)
        with pytest.raises(RuntimeError, match="in progress"):
            await proc.modulate(b"\x43")
        task.cancel()
        try:
            await task
        except (asyncio.CancelledError, Exception):
            pass

    async def test_demodulate_blocks_until_data(self, proc):
        # blocking semantics (fsk-processor.ts:113-135)
        result = None

        async def demod():
            nonlocal result
            result = await proc.demodulate()

        task = asyncio.ensure_future(demod())
        await asyncio.sleep(0.01)
        assert result is None
        proc.demodulated_buffer.put(0x42)
        proc._awaiting_data.set_result(None)
        proc._awaiting_data = None
        await task
        assert result == b"\x42"

    async def test_abort_modulation(self, proc):
        controller = AbortController()
        task = asyncio.ensure_future(
            proc.modulate(b"\x42", signal=controller.signal))
        await asyncio.sleep(0.01)
        controller.abort()
        with pytest.raises(AbortError):
            await task
        assert not proc.get_status()["pending_modulation"]

    async def test_abort_demodulation(self, proc):
        controller = AbortController()
        task = asyncio.ensure_future(
            proc.demodulate(signal=controller.signal))
        await asyncio.sleep(0.01)
        controller.abort()
        with pytest.raises(AbortError):
            await task

    async def test_restart_after_abort(self, proc):
        controller = AbortController()
        task = asyncio.ensure_future(
            proc.modulate(b"\x42", signal=controller.signal))
        await asyncio.sleep(0.01)
        controller.abort()
        with pytest.raises(AbortError):
            await task
        # processor usable again
        graph = AudioGraph(quantum=512)
        graph.connect(proc)
        done = False

        async def run():
            nonlocal done
            await proc.modulate(b"\x43")
            done = True

        task = asyncio.ensure_future(run())
        await _drive(graph, lambda: done)
        await task

    async def test_abort_listener_cleanup_after_success(self, proc):
        # reference WebAudioDataChannel listener-cleanup contract
        # (fsk-processor-integration-browser.test.ts:489-797): after an
        # operation COMPLETES, its abort listener must be removed from
        # the caller's signal
        controller = AbortController()
        graph = AudioGraph(quantum=512)
        graph.connect(proc)
        done = False

        async def run():
            nonlocal done
            await proc.modulate(b"\x42", signal=controller.signal)
            done = True

        task = asyncio.ensure_future(run())
        await _drive(graph, lambda: done)
        await task
        assert controller.signal._listeners == []

    async def test_abort_listener_cleanup_after_demodulate(self, proc):
        controller = AbortController()
        task = asyncio.ensure_future(
            proc.demodulate(signal=controller.signal))
        await asyncio.sleep(0)
        assert len(controller.signal._listeners) == 1
        # deliver one byte through the audio path
        sig = proc.fsk_core.modulate_data(b"\x55")
        proc.process(np.asarray(sig), None)
        assert await task == b"\x55"
        assert controller.signal._listeners == []

    async def test_abort_listener_cleanup_after_abort(self, proc):
        controller = AbortController()
        task = asyncio.ensure_future(
            proc.modulate(b"\x42", signal=controller.signal))
        await asyncio.sleep(0.01)
        controller.abort()
        with pytest.raises(AbortError):
            await task
        assert controller.signal._listeners == []

    async def test_reset_clears_state(self, proc):
        proc.demodulated_buffer.put(1)
        await proc.reset()
        assert len(proc.demodulated_buffer) == 0

    async def test_status(self, proc):
        st = proc.get_status()
        assert st["fsk_core_ready"]
        assert st["demodulated_buffer_length"] == 0
        assert not st["pending_modulation"]
