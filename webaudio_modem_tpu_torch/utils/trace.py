"""Counters and timers: the port's copy of the ``metrics`` registry of
``webaudio_modem_tpu/utils/trace.py``, whose timers are also profiler
spans.

A timer aggregates its calls (count, total, min, max in ``snapshot()``)
whatever runs.  While a ``torch.profiler`` records (checked at the
timer's entry with ``torch._C._autograd._profiler_enabled()``, ~0.2 us),
it also opens ``torch.profiler.record_function(name)``, so the span lands
in the profiler's trace, as a ``user_annotation`` event, on the clock of
the kernel, copy and memset events it launched.  With no profiler
recording, a timer does no more than aggregate: there is no switch.

Wired call sites:

- counters: ``FSKCore.demodulate_data`` (fsk.bytes_decoded / fsk.syncs /
  fsk.eods / fsk.demodulate_calls), ``ModemFarm.demodulate``
  (farm.bytes_decoded), the XModem transport (xmodem.packets_sent /
  packets_received / acks / retransmits / rtt_ms_total) and the soft
  farm decode's finalizer (soft.frames_decoded, soft.frames_failed);
- timers: ``ModemFarm.demodulate`` (farm.chunk), the farm hubs
  (farm_hub.host_tx / chunk / fetch_wait / host_drain / yield_pump /
  soft_finalize), the blind receiver's ``feed`` (blind_rx.*) and the
  soft farm decode (``ops/soft_fsk.py``): soft.dispatch around
  ``decode_frames_batch_async``'s enqueue, with its stages soft.k1 /
  sync / header / select / body / pack (``_decode_frames_fused``, which
  ``SoftFarmHub``'s window decodes run too) and soft.copy, and
  soft.finalize around its finalizer, soft.finalize.wait around the
  event wait inside it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled


class Metrics:
    """Thread-safe counter/timer registry."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        # name -> [count, total_s, min_s, max_s]
        self._timings: Dict[str, list] = {}

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    @contextlib.contextmanager
    def timer(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            if _profiler_enabled():
                with torch.profiler.record_function(name):
                    yield
            else:
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
                    "timings": timings}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timings.clear()


metrics = Metrics()  # process-wide default registry
