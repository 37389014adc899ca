"""Core contracts of the port: signal quality, events, the modulator,
data-channel, audio-processor and transport ABCs.

The port's own copy of ``webaudio_modem_tpu/core.py`` (``SignalQuality``,
``TransportStatistics``, ``Event``, ``EventEmitter``, ``IModulator``,
``IDataChannel``, ``IAudioProcessor``, ``ITransport`` and
``AUDIO_CHUNK_SIZE``), with the same fields, defaults, abstract methods
and semantics.  Async surfaces use asyncio and ``utils.abort``; samples
cross the host boundary as numpy arrays.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, Dict, Generic, List, Optional, TypeVar

import numpy as np

from webaudio_modem_tpu_torch.utils.abort import AbortSignal

# The WebAudio render quantum: the smallest streaming granularity of the
# simulated audio graph.
AUDIO_CHUNK_SIZE = 128


@dataclasses.dataclass(frozen=True)
class SignalQuality:
    """Signal quality metrics, computed by the demodulator."""

    snr: float = 0.0              # Signal-to-Noise Ratio (dB)
    ber: float = 0.0              # Bit Error Rate estimate
    eye_opening: float = 0.0      # Eye pattern opening (0-1)
    phase_jitter: float = 0.0     # Phase jitter (radians)
    frequency_offset: float = 0.0  # Frequency offset (Hz)


@dataclasses.dataclass
class TransportStatistics:
    """Transport statistics."""

    packets_sent: int = 0
    packets_received: int = 0
    packets_retransmitted: int = 0
    packets_dropped: int = 0
    bytes_transferred: int = 0
    error_rate: float = 0.0
    average_round_trip_time: float = 0.0

    def copy(self) -> "TransportStatistics":
        return dataclasses.replace(self)


class Event:
    """Minimal event object."""

    __slots__ = ("data",)

    def __init__(self, data: Any = None):
        self.data = data


class EventEmitter:
    """Synchronous pub/sub."""

    def __init__(self) -> None:
        self._listeners: Dict[str, List[Callable[[Event], None]]] = {}

    def on(self, event_name: str, callback: Callable[[Event], None]) -> None:
        self._listeners.setdefault(event_name, []).append(callback)

    def off(self, event_name: str, callback: Callable[[Event], None]) -> None:
        listeners = self._listeners.get(event_name)
        if listeners and callback in listeners:
            listeners.remove(callback)

    def emit(self, event_name: str, event: Optional[Event] = None) -> None:
        if event is None:
            event = Event()
        # Copy: a listener may mutate the list while we iterate.
        for callback in list(self._listeners.get(event_name, ())):
            callback(event)

    def remove_all_listeners(self, event_name: Optional[str] = None) -> None:
        if event_name is not None:
            self._listeners.pop(event_name, None)
        else:
            self._listeners.clear()


TConfig = TypeVar("TConfig")


class IModulator(EventEmitter, Generic[TConfig], metaclass=abc.ABCMeta):
    """Signal-processing engine contract.

    ``demodulate_data`` is stream-stateful: it may be called with
    arbitrary chunk sizes and carries all DSP state across calls,
    returning whatever bytes completed.
    """

    name: str = "modulator"

    def __init__(self) -> None:
        super().__init__()
        self._ready = False

    @abc.abstractmethod
    def configure(self, config: TConfig) -> None:
        ...

    @abc.abstractmethod
    def get_config(self) -> TConfig:
        ...

    @abc.abstractmethod
    def modulate_data(self, data: bytes | np.ndarray) -> np.ndarray:
        """data bytes -> float32 sample array."""

    @abc.abstractmethod
    def demodulate_data(self, samples: np.ndarray) -> bytes:
        """float32 samples -> decoded bytes (possibly empty)."""

    def reset(self) -> None:
        self._ready = False
        self.emit("reset")

    def is_ready(self) -> bool:
        return self._ready

    def get_signal_quality(self) -> SignalQuality:
        return SignalQuality()


class IDataChannel(metaclass=abc.ABCMeta):
    """Async data channel contract.  The transport layer talks only to
    this interface; it never sees audio samples."""

    @abc.abstractmethod
    async def modulate(self, data: bytes,
                       signal: Optional[AbortSignal] = None) -> None:
        """Modulate ``data`` into the outgoing audio stream; resolves
        once the signal has fully played out."""

    @abc.abstractmethod
    async def demodulate(self,
                         signal: Optional[AbortSignal] = None) -> bytes:
        """Return buffered demodulated bytes, waiting until at least one
        byte is available."""

    @abc.abstractmethod
    async def reset(self) -> None:
        ...


class IAudioProcessor(metaclass=abc.ABCMeta):
    """Realtime processor contract.  ``process`` is driven with
    fixed-size sample quanta by the simulated audio graph
    (runtime/audio_graph.py)."""

    @abc.abstractmethod
    def process(self, inputs: np.ndarray, outputs: np.ndarray) -> bool:
        ...


class ITransport(EventEmitter, metaclass=abc.ABCMeta):
    """Reliable transport contract."""

    transport_name: str = "transport"

    def __init__(self, data_channel: IDataChannel) -> None:
        super().__init__()
        self.data_channel = data_channel
        self.statistics = TransportStatistics()

    @abc.abstractmethod
    async def send_data(self, data: bytes,
                        signal: Optional[AbortSignal] = None) -> None:
        ...

    @abc.abstractmethod
    async def receive_data(self,
                           signal: Optional[AbortSignal] = None) -> bytes:
        ...

    @abc.abstractmethod
    async def send_control(self, command: str) -> None:
        ...

    @abc.abstractmethod
    def is_ready(self) -> bool:
        ...

    def get_statistics(self) -> TransportStatistics:
        return self.statistics.copy()

    def reset(self) -> None:
        self.statistics = TransportStatistics()
        self.emit("reset")
