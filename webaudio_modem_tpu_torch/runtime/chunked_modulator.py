"""ChunkedModulator — one-shot modulation to pull-based fixed chunks.

The port's copy of ``webaudio_modem_tpu/runtime/chunked_modulator.py``,
with the same contract as the reference (src/webaudio/chunked-modulator.ts):
the full signal is synthesized once, then drained in fixed-size chunks
by the realtime callback; empty input resets without modulating
(chunked-modulator.ts:31-39).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class ChunkResult:
    signal: np.ndarray
    is_complete: bool
    samples_consumed: int
    total_samples: int


class ChunkedModulator:
    def __init__(self, modulator):
        self._modulator = modulator
        self._pending_signal: Optional[np.ndarray] = None
        self._sample_position = 0

    def start_modulation(self, data: bytes) -> None:
        if not len(data):
            self._reset()
            return
        self._pending_signal = np.asarray(
            self._modulator.modulate_data(data), dtype=np.float32)
        self._sample_position = 0

    def get_next_samples(self, sample_count: int) -> Optional[ChunkResult]:
        if self._pending_signal is None:
            return None
        remaining = len(self._pending_signal) - self._sample_position
        if remaining <= 0:
            return None
        n = min(sample_count, remaining)
        signal = self._pending_signal[
            self._sample_position:self._sample_position + n].copy()
        self._sample_position += n
        if self._sample_position >= len(self._pending_signal):
            total = len(self._pending_signal)
            self._reset()
            return ChunkResult(signal, True, total, total)
        return ChunkResult(signal, False, self._sample_position,
                           len(self._pending_signal))

    def is_modulating(self) -> bool:
        return self._pending_signal is not None

    def get_progress(self) -> float:
        if self._pending_signal is None:
            return 0.0
        return self._sample_position / len(self._pending_signal)

    def cancel(self) -> None:
        self._reset()

    def _reset(self) -> None:
        self._pending_signal = None
        self._sample_position = 0
