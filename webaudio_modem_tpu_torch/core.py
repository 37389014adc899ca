"""Core contracts of the port: signal quality, events, the modulator ABC.

The port's own copy of the parts of ``webaudio_modem_tpu/core.py`` it
uses (``SignalQuality``, ``Event``, ``EventEmitter``, ``IModulator``),
with the same fields and semantics.  The transport interfaces and
``AbortSignal`` arrive with the runtimes (ROADMAP queue 1, slice B).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, Dict, Generic, List, Optional, TypeVar

import numpy as np


@dataclasses.dataclass(frozen=True)
class SignalQuality:
    """Signal quality metrics, computed by the demodulator."""

    snr: float = 0.0              # Signal-to-Noise Ratio (dB)
    ber: float = 0.0              # Bit Error Rate estimate
    eye_opening: float = 0.0      # Eye pattern opening (0-1)
    phase_jitter: float = 0.0     # Phase jitter (radians)
    frequency_offset: float = 0.0  # Frequency offset (Hz)


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
