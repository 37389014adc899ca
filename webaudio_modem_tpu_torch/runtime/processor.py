"""FSKProcessor — the realtime streaming harness.

The port's copy of ``webaudio_modem_tpu/runtime/processor.py``, over the
port's modem cores: ``FSKCore`` by default (on the card unless the
caller passes ``device="cpu"``), or any injected core with the same
surface (``PSKCore``, ``SoftModemCore``).  Each ``process()`` call feeds
its quantum to the core's ``demodulate_data``, so the interactive path
runs the core's kernels at B = 1: K1 + K2 for ``FSKCore``, K6 + K2 for
``PSKCore``, K1 (csum mode) + K3 for ``SoftModemCore``.

The analog of the reference's AudioWorklet processor + its RPC client
(src/webaudio/processors/fsk-processor.ts + webaudio-data-channel.ts)
collapsed into one object: since our "audio thread" is the simulated
audio graph driving ``process()`` inside the same asyncio loop, the
MessagePort RPC hop disappears and the IDataChannel surface is served
directly with asyncio futures.

Behavioral contract preserved from the reference:
  * ``process(inputs, outputs)`` runs per fixed sample quantum; input
    feeds the streaming demodulator, output pulls from the pending
    ChunkedModulator (fsk-processor.ts:152-167, 268-290).
  * ``modulate()`` resolves only when the signal has fully played out
    through the graph (fsk-processor.ts:89-111) and then clears the RX
    buffer to suppress self-reception (fsk-processor.ts:207-208).
  * ``demodulate()`` blocks until at least one byte is available
    (fsk-processor.ts:113-135).
  * abort signals cancel pending modulate/demodulate operations
    (fsk-processor.ts:26-61, 191-200).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

import numpy as np

from webaudio_modem_tpu_torch.core import IAudioProcessor, IDataChannel
from webaudio_modem_tpu_torch.models.fsk import FSKCore
from webaudio_modem_tpu_torch.runtime.chunked_modulator import (
    ChunkedModulator)
from webaudio_modem_tpu_torch.utils import RingBuffer
from webaudio_modem_tpu_torch.utils.abort import AbortError, AbortSignal

logger = logging.getLogger("webaudio_modem_tpu_torch.processor")


class FSKProcessor(IAudioProcessor, IDataChannel):
    """``device`` places the default ``FSKCore`` and is used only when
    no ``core`` is given; an injected core keeps its own device."""

    def __init__(self, name: str = "unnamed", core=None, *,
                 device="cuda"):
        self.name = name
        self.fsk_core = core if core is not None else FSKCore(
            device=device)
        self.demodulated_buffer = RingBuffer(np.uint8, 1024)
        self._pending_modulation: Optional[ChunkedModulator] = None
        self._modulation_done: Optional[asyncio.Future] = None
        self._awaiting_data: Optional[asyncio.Future] = None
        self.process_call_count = 0
        self._rx_guard = 0        # post-TX self-RX guard, in SAMPLES
        self._last_quantum = 128  # most recent output quantum size

    # -- configuration ------------------------------------------------------

    def configure(self, config) -> None:
        self.fsk_core.configure(config)

    # -- IDataChannel -------------------------------------------------------

    async def modulate(self, data: bytes,
                       signal: Optional[AbortSignal] = None) -> None:
        if self._pending_modulation is not None:
            raise RuntimeError("Modulation already in progress")
        logger.debug("[%s] modulate() %d bytes", self.name, len(data))
        modulator = ChunkedModulator(self.fsk_core)
        modulator.start_modulation(bytes(data))
        if not modulator.is_modulating():
            return  # empty payload — nothing to play out
        self._pending_modulation = modulator
        loop = asyncio.get_running_loop()
        self._modulation_done = loop.create_future()

        def on_abort():
            logger.warning("[%s] modulation aborted", self.name)
            self._pending_modulation = None
            if self._modulation_done is not None \
                    and not self._modulation_done.done():
                # carry the signal's reason so the transport can tell a
                # retryable timeout from a fatal abort
                self._modulation_done.set_exception(AbortError(
                    "FSK Processor Modulation aborted",
                    reason=signal.reason))

        if signal is not None:
            signal.add_listener(on_abort)
        try:
            await self._modulation_done
        finally:
            if signal is not None:
                signal.remove_listener(on_abort)
            self._modulation_done = None
        # clear RX buffer to avoid self-reception (fsk-processor.ts:207).
        # The clear alone is racy in a loopback graph: the tail of our
        # own signal is still in flight (one feedback quantum + filter
        # group delay) and decodes AFTER this point — if the final CRC
        # byte of our own packet happens to be 0x15/0x06/0x04 the
        # transport would misread it as NAK/ACK/EOT.  Guard in SAMPLES
        # (one feedback quantum + two bit-times of filter delay); the
        # peer cannot answer within that window — it must first finish
        # demodulating our tail and synthesize its reply.
        self.demodulated_buffer.clear()
        margin = 128
        if self.fsk_core.params is not None:
            margin = max(margin, 2 * self.fsk_core.params.samples_per_bit)
        self._rx_guard = self._last_quantum + margin

    async def demodulate(self,
                         signal: Optional[AbortSignal] = None) -> bytes:
        if len(self.demodulated_buffer) == 0:
            loop = asyncio.get_running_loop()
            fut = loop.create_future()
            self._awaiting_data = fut

            def on_abort():
                self._awaiting_data = None
                if not fut.done():
                    # reason distinguishes timeout (retryable) from a
                    # real abort at the transport layer
                    fut.set_exception(AbortError("Demodulation aborted",
                                                 reason=signal.reason))

            if signal is not None:
                signal.add_listener(on_abort)
            try:
                await fut
            finally:
                if signal is not None:
                    signal.remove_listener(on_abort)
        return bytes(self.demodulated_buffer.remove_array(
            len(self.demodulated_buffer)))

    async def reset(self) -> None:
        logger.debug("[%s] reset", self.name)
        self.demodulated_buffer.clear()
        self._pending_modulation = None
        if self._awaiting_data is not None \
                and not self._awaiting_data.done():
            self._awaiting_data.set_exception(AbortError("DataChannel reset"))
        self._awaiting_data = None
        if self._modulation_done is not None \
                and not self._modulation_done.done():
            self._modulation_done.set_exception(AbortError("DataChannel reset"))
        self._modulation_done = None

    def is_ready(self) -> bool:
        return True

    # -- IAudioProcessor (fsk-processor.ts:152-167) --------------------------

    def process(self, inputs: np.ndarray, outputs: np.ndarray) -> bool:
        self.process_call_count += 1
        if inputs is not None and len(inputs):
            self._demodulate_from(inputs)
        if outputs is not None and len(outputs):
            self._modulate_to(outputs)
        return True

    def _demodulate_from(self, samples: np.ndarray) -> None:
        if not self.fsk_core.is_ready():
            return
        if self._rx_guard > 0:
            # process the guarded span separately (state still advances)
            # and drop its bytes; the rest of this quantum is live, so a
            # fast peer reply landing late in the same input survives
            g = min(self._rx_guard, len(samples))
            self._rx_guard -= g
            try:
                dropped = self.fsk_core.demodulate_data(samples[:g])
            except Exception:  # pragma: no cover
                logger.exception("[%s] demodulation error", self.name)
                return
            if dropped:
                logger.debug("[%s] %d self-RX tail byte(s) suppressed",
                             self.name, len(dropped))
            if g == len(samples):
                return
            samples = samples[g:]
        try:
            demodulated = self.fsk_core.demodulate_data(samples)
        except Exception:  # pragma: no cover
            logger.exception("[%s] demodulation error", self.name)
            return
        if demodulated:
            self.demodulated_buffer.write_array(
                np.frombuffer(demodulated, dtype=np.uint8))
            if self._awaiting_data is not None \
                    and not self._awaiting_data.done():
                self._awaiting_data.set_result(None)
                self._awaiting_data = None

    def _modulate_to(self, outputs: np.ndarray) -> None:
        outputs[:] = 0.0
        self._last_quantum = len(outputs)
        if self._pending_modulation is None:
            return
        result = self._pending_modulation.get_next_samples(len(outputs))
        if result is None:
            return
        outputs[:len(result.signal)] = result.signal
        if result.is_complete:
            self._pending_modulation = None
            if self._modulation_done is not None \
                    and not self._modulation_done.done():
                self._modulation_done.set_result(None)

    # -- observability (fsk-processor.ts:222-237) ----------------------------

    def get_status(self) -> dict:
        return {
            "demodulated_buffer_length": len(self.demodulated_buffer),
            "pending_modulation": self._pending_modulation is not None,
            "fsk_core_ready": self.fsk_core.is_ready(),
            "process_call_count": self.process_call_count,
            **self.fsk_core.get_status(),
        }
