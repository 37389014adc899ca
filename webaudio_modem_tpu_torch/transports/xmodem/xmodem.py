"""XModem transport — half-duplex Stop-and-Wait ARQ over an IDataChannel.

The port's copy of ``webaudio_modem_tpu/transports/xmodem/xmodem.py``:
the same protocol state machine, wire behaviour, statistics and events.
The receiver initiates with NAK, the sender tolerates a missing initial
NAK (standalone mode), each fragment is sent with ACK/NAK and retry, EOT
is confirmed by a final ACK while the sender's own EOT echo is ignored,
sequence numbers run 1-255 and wrap 255 -> 1, a duplicate of the
previous sequence is re-ACKed and dropped, an unexpected sequence is
fatal, a CRC failure is NAKed after the RX buffer is flushed, and data
is fragmented at ``max_payload_size`` with one empty fragment for empty
data.

Two receive paths share one state machine: the byte path parses the
raw ``demodulate()`` stream in Python and works over any IDataChannel;
the frame path, taken when the channel advertises ``supports_frames``
(the farm hubs' ``FarmDataChannel``, ``runtime/farm_channel.py``),
consumes the PACKET / CONTROL events that the native deframer
(``native/deframer.py``) parsed, so draining thousands of channels never
touches per-byte Python.

The DOM AbortSignal composition (timeout + external + operation
controller) maps onto utils.abort.
"""

from __future__ import annotations

import enum
import logging
import time
from typing import List, Optional

from webaudio_modem_tpu_torch.core import Event, IDataChannel, ITransport
from webaudio_modem_tpu_torch.transports.xmodem.packet import XModemPacket
from webaudio_modem_tpu_torch.transports.xmodem.types import ControlType
from webaudio_modem_tpu_torch.utils.abort import (AbortController,
                                                  AbortError, AbortSignal)
from webaudio_modem_tpu_torch.utils.crc16 import CRC16
from webaudio_modem_tpu_torch.utils.trace import metrics

logger = logging.getLogger("webaudio_modem_tpu_torch.xmodem")


class State(enum.Enum):
    IDLE = "IDLE"
    SENDING_WAIT_NAK = "SENDING_WAIT_NAK"
    SENDING_WAIT_ACK = "SENDING_WAIT_ACK"
    SENDING_WAIT_FINAL_ACK = "SENDING_WAIT_FINAL_ACK"
    RECEIVING_SEND_NAK = "RECEIVING_SEND_NAK"
    RECEIVING_WAIT_BLOCK = "RECEIVING_WAIT_BLOCK"
    RECEIVING_SEND_ACK = "RECEIVING_SEND_ACK"


class XModemConfig(dict):
    """Config with reference defaults (xmodem.ts:45-49)."""

    def __init__(self, timeout_ms: float = 3000, max_retries: int = 10,
                 max_payload_size: int = 128):
        super().__init__(timeout_ms=timeout_ms, max_retries=max_retries,
                         max_payload_size=max_payload_size)

    timeout_ms = property(lambda self: self["timeout_ms"])
    max_retries = property(lambda self: self["max_retries"])
    max_payload_size = property(lambda self: self["max_payload_size"])


class XModemTransport(ITransport):
    transport_name = "XModem"

    def __init__(self, data_channel: IDataChannel):
        super().__init__(data_channel)
        self.config = XModemConfig()
        self._state = State.IDLE
        self._send_sequence = 1
        self._send_fragments: List[bytes] = []
        self._send_fragment_index = 0
        self._send_retries = 0
        self._recv_expected_sequence = 1
        self._recv_data: List[bytes] = []
        self._recv_buffer: List[int] = []
        self._operation_controller: Optional[AbortController] = None
        self._rtt_sum = 0.0
        self._rtt_count = 0

    # -- configuration -----------------------------------------------------

    def configure(self, config: dict) -> None:
        merged = dict(self.config)
        merged.update(config)
        self.config = XModemConfig(**merged)

    def get_config(self) -> XModemConfig:
        return XModemConfig(**self.config)

    # -- public API --------------------------------------------------------

    async def send_data(self, data: bytes,
                        signal: Optional[AbortSignal] = None) -> None:
        self._ensure_idle("send_data")
        self._operation_controller = AbortController()
        if self._operation_controller.signal.aborted or \
                (signal is not None and signal.aborted):
            raise AbortError("Operation aborted before start")

        data = bytes(data)
        total_sent = 0
        try:
            self._initialize_send(data)
            await self._wait_for_initial_nak(signal)
            await self._send_all_fragments(signal)
            await self._send_eot_and_confirm(signal)
            total_sent = len(data)
        finally:
            self._operation_controller = None
            self._state_changed(
                State.IDLE,
                f"Send completed: {total_sent} bytes" if total_sent
                else "Send failed or aborted")
            if total_sent:
                self.statistics.bytes_transferred += total_sent

    async def receive_data(self,
                           signal: Optional[AbortSignal] = None) -> bytes:
        self._ensure_idle("receive_data")
        self._operation_controller = AbortController()
        if self._operation_controller.signal.aborted or \
                (signal is not None and signal.aborted):
            raise AbortError("Operation aborted before start")

        total_received = 0
        try:
            self._initialize_receive()
            await self._send_initial_nak()
            packets = await self._receive_all_packets(signal)
            result = b"".join(packets)
            total_received = len(result)
            return result
        finally:
            self._operation_controller = None
            self._state_changed(
                State.IDLE,
                f"Receive completed: {total_received} bytes"
                if total_received else "Receive failed or aborted")
            if total_received:
                self.statistics.bytes_transferred += total_received

    async def send_control(self, command: str) -> None:
        if self._op_aborted():
            raise AbortError("Operation aborted at send_control")
        control_type = self._parse_control_command(command)
        serialized = XModemPacket.serialize_control(control_type)
        if self._op_aborted():
            raise AbortError("Operation aborted at send_control")
        await self.data_channel.modulate(serialized)
        if not self._op_aborted():
            self.statistics.packets_sent += 1
            metrics.incr("xmodem.packets_sent")

    def is_ready(self) -> bool:
        return self._state == State.IDLE

    def get_statistics(self):
        # derived fields computed for real (declared-but-stubbed in the
        # reference: errorRate/averageRoundTripTime, core.ts:186-187)
        stats = self.statistics.copy()
        attempts = stats.packets_sent + stats.packets_received
        errors = stats.packets_retransmitted + stats.packets_dropped
        stats.error_rate = errors / attempts if attempts else 0.0
        stats.average_round_trip_time = (
            self._rtt_sum / self._rtt_count if self._rtt_count else 0.0)
        return stats

    def get_current_state(self) -> str:
        return self._state.value

    def reset(self) -> None:
        if self._operation_controller is not None:
            self._operation_controller.abort()
            self._operation_controller = None
        super().reset()
        self._rtt_sum = 0.0
        self._rtt_count = 0
        self._state_changed(State.IDLE, "Reset called - clearing all state")
        self._send_sequence = 1
        self._send_fragments = []
        self._send_fragment_index = 0
        self._send_retries = 0
        self._recv_expected_sequence = 1
        self._recv_data = []
        self._recv_buffer = []

    def dispose(self) -> None:
        self.remove_all_listeners()

    # -- send path (xmodem.ts:103-184) -------------------------------------

    def _initialize_send(self, data: bytes) -> None:
        self._state_changed(State.SENDING_WAIT_NAK,
                            f"Starting transmission of {len(data)} bytes")
        self._send_sequence = 1
        self._send_fragment_index = 0
        self._send_retries = 0
        self._send_fragments = self._create_fragments(data)
        logger.debug("Created %d fragments for %d bytes",
                     len(self._send_fragments), len(data))

    async def _wait_for_initial_nak(self,
                                    external: Optional[AbortSignal]) -> None:
        try:
            await self._with_timeout(
                external,
                lambda sig: self._wait_and_skip_for_control(
                    ControlType.NAK, sig))
            logger.debug("Initial NAK received")
        except AbortError as error:
            if self._externally_aborted(external) or \
                    not self._is_timeout_abort(error):
                raise AbortError("Operation aborted at send_data")
            # timeout — continue without initial NAK (standalone mode)
            logger.warning("No initial NAK received (standalone mode): %s",
                           error)

    async def _send_all_fragments(self,
                                  external: Optional[AbortSignal]) -> None:
        while self._send_fragment_index < len(self._send_fragments):
            async def attempt():
                idx = self._send_fragment_index
                fragment = self._send_fragments[idx]
                packet = XModemPacket.create_data(self._send_sequence,
                                                  fragment)
                serialized = XModemPacket.serialize(packet)
                logger.debug("Sending fragment %d/%d seq=%d", idx + 1,
                             len(self._send_fragments), self._send_sequence)
                t_sent = time.monotonic()
                await self.data_channel.modulate(serialized)
                self.statistics.packets_sent += 1
                metrics.incr("xmodem.packets_sent")

                self._state_changed(
                    State.SENDING_WAIT_ACK,
                    f"Waiting for ACK for fragment {idx + 1}/"
                    f"{len(self._send_fragments)}")
                while True:
                    byte = await self._with_timeout(
                        external, self._wait_for_control_byte)
                    if byte == ControlType.ACK:
                        # packet-send -> ACK round-trip (the reference
                        # declares averageRoundTripTime but never
                        # computes it, core.ts:187/xmodem stats)
                        rtt_ms = (time.monotonic() - t_sent) * 1000
                        self._rtt_sum += rtt_ms
                        self._rtt_count += 1
                        metrics.incr("xmodem.acks")
                        metrics.incr("xmodem.rtt_ms_total", rtt_ms)
                        self._send_retries = 0
                        self._send_fragment_index += 1
                        self._send_sequence = (self._send_sequence % 255) + 1
                        return
                    if byte == ControlType.NAK:
                        self.statistics.packets_retransmitted += 1
                        metrics.incr("xmodem.retransmits")
                        logger.warning("Retransmitting fragment %d", idx + 1)
                        raise TimeoutError("NAK received, retry fragment")
                    # ignore other bytes

            def on_retry(count):
                self.statistics.packets_retransmitted += 1
                metrics.incr("xmodem.retransmits")
                logger.warning("Timeout, retrying fragment %d, retries=%d",
                               self._send_fragment_index + 1, count)

            await self._with_retry(attempt, self.config.max_retries,
                                   on_retry, external)

    async def _send_eot_and_confirm(self,
                                    external: Optional[AbortSignal]) -> None:
        self._send_retries = 0

        async def attempt():
            self._state_changed(State.SENDING_WAIT_FINAL_ACK,
                                "Sending EOT, waiting for final ACK")
            await self.send_control("EOT")
            await self._with_timeout(external, self._wait_for_ack)
            logger.debug("Final ACK received")

        def on_retry(count):
            logger.warning("Final ACK timeout, retrying EOT, retries=%d",
                           count)

        await self._with_retry(attempt, self.config.max_retries, on_retry,
                               external)

    async def _with_timeout(self, external, op):
        """Run ``op(signal)`` under a fresh composite timeout signal,
        detaching it afterwards so listeners/timers never accumulate on
        the long-lived external/operation signals."""
        signal = self._create_timeout_signal(external)
        try:
            return await op(signal)
        finally:
            signal.detach()

    def _frames_supported(self) -> bool:
        return bool(getattr(self.data_channel, "supports_frames", False))

    # -- receive path (xmodem.ts:221-335) -----------------------------------

    def _initialize_receive(self) -> None:
        self._state_changed(State.RECEIVING_SEND_NAK,
                            "Starting receive, sending initial NAK")
        self._recv_expected_sequence = 1
        self._recv_data = []
        self._recv_buffer = []
        self._send_retries = 0

    async def _send_initial_nak(self) -> None:
        await self.send_control("NAK")
        self._state_changed(State.RECEIVING_WAIT_BLOCK,
                            "Waiting for data blocks")

    async def _receive_all_packets(
            self, external: Optional[AbortSignal]) -> List[bytes]:
        if self._frames_supported():
            return await self._receive_all_packets_framed(external)
        while True:
            self._check_abort(external)
            try:
                first = await self._with_timeout(
                    external, self._wait_for_byte)
                if first == ControlType.EOT:
                    logger.debug("EOT received")
                    await self.send_control("ACK")
                    break
                if first == ControlType.SOH:
                    await self._receive_and_process_packet(external)
                else:
                    logger.debug("received byte ignored: %d", first)
                    continue
            except AbortError as error:
                if self._externally_aborted(external) or \
                        self._op_aborted() or \
                        not self._is_timeout_abort(error):
                    raise
                # local timeout — NAK and retry
                self._send_retries += 1
                if self._send_retries > self.config.max_retries:
                    raise TimeoutError(
                        f"Receive failed after max retries: {error}")
                self._flush_rx()
                await self.send_control("NAK")
            except (TimeoutError, ValueError) as error:
                logger.debug("Error during receive_data: %s", error)
                self._send_retries += 1
                if self._send_retries > self.config.max_retries:
                    raise TimeoutError(
                        f"Receive failed after max retries: {error}")
                # flush RX buffer so payload bytes are not misread as
                # control bytes (xmodem.ts:256-259)
                self._flush_rx()
                await self.send_control("NAK")
        return self._recv_data

    async def _receive_and_process_packet(
            self, external: Optional[AbortSignal]) -> None:
        header = await self._with_timeout(
            external, lambda sig: self._wait_for_bytes(3, sig))
        seq, nseq, length = header[0], header[1], header[2]

        if (seq + nseq) != 255:
            self.statistics.packets_dropped += 1
            self.emit("error", Event({"error": "Invalid sequence number",
                                      "seq": seq, "nseq": nseq}))
            raise ValueError("Invalid sequence number")

        logger.debug("Received packet: seq=%d nseq=%d len=%d",
                     seq, nseq, length)

        if seq == self._recv_expected_sequence:
            payload_crc = await self._with_timeout(
                external,
                lambda sig: self._wait_for_bytes(length + 2, sig))
            self.statistics.packets_received += 1
            metrics.incr("xmodem.packets_received")
            payload = bytes(payload_crc[:length])
            crc = (payload_crc[length] << 8) | payload_crc[length + 1]

            if CRC16.calculate(payload) != crc:
                self.statistics.packets_dropped += 1
                self.emit("error", Event({
                    "error": "Invalid CRC", "seq": seq, "crc": crc,
                    "calculated_crc": CRC16.calculate(payload)}))
                raise ValueError("Invalid CRC")

            self._recv_data.append(payload)
            self.emit("fragmentReceived", Event({
                "seq_num": seq,
                "fragment": payload,
                "total_fragments": len(self._recv_data),
                "total_bytes_received": sum(len(d) for d in self._recv_data),
                "timestamp": time.time(),
            }))
            self._recv_expected_sequence = \
                (self._recv_expected_sequence % 255) + 1
            self._send_retries = 0
            self._state_changed(State.RECEIVING_SEND_ACK,
                                f"Sending ACK for sequence {seq}")
            await self.send_control("ACK")
            self._state_changed(State.RECEIVING_WAIT_BLOCK,
                                "Waiting for next block")
        elif self._is_previous_sequence(seq, self._recv_expected_sequence):
            # duplicate — consume payload, ACK, drop (xmodem.ts:309-314)
            await self._with_timeout(
                external,
                lambda sig: self._wait_for_bytes(length + 2, sig))
            self.statistics.packets_dropped += 1
            logger.debug("Duplicate packet ignored: seq=%d (expected=%d)",
                         seq, self._recv_expected_sequence)
            await self.send_control("ACK")
        else:
            self.statistics.packets_dropped += 1
            self.emit("error", Event({
                "error": "Unexpected sequence number",
                "expected": self._recv_expected_sequence, "received": seq}))
            raise ValueError(
                f"Unexpected sequence number: expected "
                f"{self._recv_expected_sequence}, got {seq}")

    # -- frame fast path (native deframer events) ----------------------------

    async def _receive_all_packets_framed(
            self, external: Optional[AbortSignal]) -> List[bytes]:
        """Same state machine as the byte path, driven by parsed wire
        events instead of raw bytes."""
        from webaudio_modem_tpu_torch.native import deframer as df

        while True:
            self._check_abort(external)
            try:
                frame = await self._with_timeout(
                    external,
                    lambda sig: self.data_channel.next_frame(signal=sig))
                if frame.kind == df.CONTROL and \
                        frame.byte == ControlType.EOT:
                    logger.debug("EOT frame received")
                    await self.send_control("ACK")
                    break
                if frame.kind == df.PACKET:
                    await self._accept_frame_packet(frame)
                elif frame.kind == df.BAD_SEQ:
                    self.statistics.packets_dropped += 1
                    self.emit("error", Event(
                        {"error": "Invalid sequence number"}))
                    raise ValueError("Invalid sequence number")
                elif frame.kind == df.BAD_CRC:
                    self.statistics.packets_received += 1
                    self.statistics.packets_dropped += 1
                    metrics.incr("xmodem.packets_received")
                    self.emit("error", Event({"error": "Invalid CRC"}))
                    raise ValueError("Invalid CRC")
                else:
                    logger.debug("frame ignored: %s", frame.kind)
                    continue
            except AbortError as error:
                if self._externally_aborted(external) or \
                        self._op_aborted() or \
                        not self._is_timeout_abort(error):
                    raise
                self._send_retries += 1
                if self._send_retries > self.config.max_retries:
                    raise TimeoutError(
                        f"Receive failed after max retries: {error}")
                self._flush_rx()
                await self.send_control("NAK")
            except (TimeoutError, ValueError) as error:
                logger.debug("Error during framed receive: %s", error)
                self._send_retries += 1
                if self._send_retries > self.config.max_retries:
                    raise TimeoutError(
                        f"Receive failed after max retries: {error}")
                self._flush_rx()
                await self.send_control("NAK")
        return self._recv_data

    async def _accept_frame_packet(self, frame) -> None:
        """Sequence handling for a CRC-valid parsed packet — identical
        rules to _receive_and_process_packet (accept / re-ACK duplicate
        previous / fatal on unexpected)."""
        seq = frame.seq
        if seq == self._recv_expected_sequence:
            self.statistics.packets_received += 1
            metrics.incr("xmodem.packets_received")
            self._recv_data.append(frame.payload)
            self.emit("fragmentReceived", Event({
                "seq_num": seq,
                "fragment": frame.payload,
                "total_fragments": len(self._recv_data),
                "total_bytes_received": sum(len(d)
                                            for d in self._recv_data),
                "timestamp": time.time(),
            }))
            self._recv_expected_sequence = \
                (self._recv_expected_sequence % 255) + 1
            self._send_retries = 0
            self._state_changed(State.RECEIVING_SEND_ACK,
                                f"Sending ACK for sequence {seq}")
            await self.send_control("ACK")
            self._state_changed(State.RECEIVING_WAIT_BLOCK,
                                "Waiting for next block")
        elif self._is_previous_sequence(seq, self._recv_expected_sequence):
            self.statistics.packets_dropped += 1
            logger.debug("Duplicate frame ignored: seq=%d (expected=%d)",
                         seq, self._recv_expected_sequence)
            await self.send_control("ACK")
        else:
            self.statistics.packets_dropped += 1
            self.emit("error", Event({
                "error": "Unexpected sequence number",
                "expected": self._recv_expected_sequence,
                "received": seq}))
            raise ValueError(
                f"Unexpected sequence number: expected "
                f"{self._recv_expected_sequence}, got {seq}")

    def _flush_rx(self) -> None:
        """Discard partial RX state before NAK-retry (xmodem.ts:256-259):
        byte buffer on the byte path, queued frames + deframer buffer on
        the frame path."""
        self._recv_buffer = []
        if self._frames_supported():
            self.data_channel.flush_frames()

    # -- byte-level helpers (xmodem.ts:389-502) ------------------------------

    async def _wait_and_skip_for_control(self, control_type: ControlType,
                                         signal: AbortSignal) -> None:
        while True:
            signal.throw_if_aborted()
            byte = await self._wait_for_control_byte(signal)
            if byte == control_type:
                return

    async def _wait_for_control_byte(self, signal: AbortSignal) -> int:
        if self._frames_supported():
            from webaudio_modem_tpu_torch.native import deframer as df

            while True:
                signal.throw_if_aborted()
                frame = await self.data_channel.next_frame(signal=signal)
                if frame.kind == df.CONTROL:
                    logger.debug("Control frame received: %d", frame.byte)
                    return frame.byte
                logger.debug("Non-control frame ignored: %s", frame.kind)
        while True:
            signal.throw_if_aborted()
            data = await self.data_channel.demodulate(signal=signal)
            for byte in data:
                if byte in (ControlType.ACK, ControlType.NAK,
                            ControlType.EOT):
                    logger.debug("Control byte received: %d", byte)
                    return byte
                logger.debug("Non-control byte ignored: %d", byte)

    async def _wait_for_ack(self, signal: AbortSignal) -> None:
        """Wait specifically for ACK, ignoring everything else including
        the echo of our own EOT (xmodem.ts:442-470)."""
        if self._frames_supported():
            from webaudio_modem_tpu_torch.native import deframer as df

            while True:
                signal.throw_if_aborted()
                frame = await self.data_channel.next_frame(signal=signal)
                if frame.kind == df.CONTROL and \
                        frame.byte == ControlType.ACK:
                    logger.debug("ACK frame received")
                    return
                logger.debug("Non-ACK frame ignored while waiting: %s",
                             frame.kind)
        while True:
            signal.throw_if_aborted()
            data = await self.data_channel.demodulate(signal=signal)
            for byte in data:
                if byte == ControlType.ACK:
                    logger.debug("ACK received")
                    return
                logger.debug("Non-ACK byte ignored while waiting: %d", byte)

    async def _wait_for_byte(self, signal: AbortSignal) -> int:
        return (await self._wait_for_bytes(1, signal))[0]

    async def _wait_for_bytes(self, count: int,
                              signal: AbortSignal) -> bytes:
        while len(self._recv_buffer) < count:
            data = await self.data_channel.demodulate(signal=signal)
            signal.throw_if_aborted()
            self._recv_buffer.extend(data)
        result = bytes(self._recv_buffer[:count])
        self._recv_buffer = self._recv_buffer[count:]
        return result

    # -- internals ----------------------------------------------------------

    def _create_fragments(self, data: bytes) -> List[bytes]:
        size = self.config.max_payload_size
        fragments = [data[i:i + size] for i in range(0, len(data), size)]
        return fragments if fragments else [b""]

    @staticmethod
    def _parse_control_command(command: str) -> ControlType:
        try:
            return {"ACK": ControlType.ACK, "NAK": ControlType.NAK,
                    "EOT": ControlType.EOT}[command.upper()]
        except KeyError:
            raise ValueError(f"Unknown control command: {command}")

    @staticmethod
    def _is_previous_sequence(received: int, expected: int) -> bool:
        prev = 255 if expected == 1 else expected - 1
        return received == prev

    def _create_timeout_signal(
            self, external: Optional[AbortSignal]) -> AbortSignal:
        # single-allocation composite (timeout + external + operation)
        # — semantically any([timeout(ms), ...]) but ~4x cheaper; this
        # runs once per protocol wait across every concurrent session
        parents = ()
        if external is not None:
            parents = (external,)
        if self._operation_controller is not None:
            parents += (self._operation_controller.signal,)
        return AbortSignal.timeout_any(self.config.timeout_ms, parents)

    def _state_changed(self, new_state: State,
                       context: str = "") -> None:
        old_state = self._state
        self._state = new_state
        logger.debug("State: %s -> %s (%s)", old_state.value,
                     new_state.value, context)
        # build the event payload only when someone listens — the dict
        # + time.time() per transition is pure overhead for the
        # listener-less farm sessions (observable behavior unchanged:
        # with a listener attached, the emitted payload is identical)
        if self._listeners.get("statechange"):
            self.emit("statechange", Event({
                "old_state": old_state.value,
                "new_state": new_state.value,
                "context": context,
                "timestamp": time.time(),
            }))

    def _ensure_idle(self, operation: str) -> None:
        if self._state != State.IDLE:
            raise RuntimeError(
                f"Transport busy: {operation} cannot start while in "
                f"{self._state.value} state")

    @staticmethod
    def _is_timeout_abort(error: AbortError) -> bool:
        """True when an AbortError came from a composite-timeout signal
        (reason TimeoutError) — retryable; every other abort (external
        signal, reset, channel-level abort) is fatal, matching the
        reference's isAbortError/withRetry split (xmodem.ts:580-628)."""
        return isinstance(getattr(error, "reason", None), TimeoutError)

    def _op_aborted(self) -> bool:
        return (self._operation_controller is not None
                and self._operation_controller.signal.aborted)

    def _externally_aborted(self,
                            external: Optional[AbortSignal]) -> bool:
        return ((external is not None and external.aborted)
                or self._op_aborted())

    def _check_abort(self, external: Optional[AbortSignal]) -> None:
        if self._externally_aborted(external):
            raise AbortError("Operation aborted")

    async def _with_retry(self, operation, max_retries: int,
                          on_retry=None,
                          external: Optional[AbortSignal] = None):
        retries = 0
        while True:
            self._check_abort(external)
            try:
                return await operation()
            except AbortError as error:
                # distinguish a pure timeout (retryable) from a real
                # abort: external signal, reset, or a channel-level
                # abort are all fatal (reference isAbortError split)
                if self._externally_aborted(external) or \
                        not self._is_timeout_abort(error):
                    raise AbortError("Operation aborted")
                retries += 1
                if retries > max_retries:
                    raise TimeoutError("Timeout - max retries exceeded")
                if on_retry:
                    on_retry(retries)
            except TimeoutError:
                retries += 1
                if retries > max_retries:
                    raise TimeoutError("Timeout - max retries exceeded")
                if on_retry:
                    on_retry(retries)
