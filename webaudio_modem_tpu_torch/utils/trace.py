"""Counters, gauges and timers: the port's copy of the ``metrics``
registry of ``webaudio_modem_tpu/utils/trace.py``.

Wired call sites: ``FSKCore.demodulate_data`` (fsk.bytes_decoded /
fsk.syncs / fsk.eods / fsk.demodulate_calls), ``ModemFarm.demodulate``
(farm.bytes_decoded and the farm.chunk timer) and the soft farm decode
(soft.frames_decoded, soft.frames_failed).  ``snapshot()`` dumps them.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator


class Metrics:
    """Thread-safe counter/gauge/timer registry."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}
        # name -> [count, total_s, min_s, max_s]
        self._timings: Dict[str, list] = {}

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    @contextlib.contextmanager
    def timer(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - start
            with self._lock:
                agg = self._timings.get(name)
                if agg is None:
                    self._timings[name] = [1, dt, dt, dt]
                else:
                    agg[0] += 1
                    agg[1] += dt
                    agg[2] = min(agg[2], dt)
                    agg[3] = max(agg[3], dt)

    def snapshot(self) -> dict:
        with self._lock:
            timings = {
                k: {"count": v[0], "total_s": v[1],
                    "mean_ms": 1000 * v[1] / v[0],
                    "min_ms": 1000 * v[2], "max_ms": 1000 * v[3]}
                for k, v in self._timings.items()}
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges),
                    "timings": timings}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timings.clear()


metrics = Metrics()  # process-wide default registry
