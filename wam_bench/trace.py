"""The traced window: ``torch.profiler`` over the device and the host,
reduced to device time by kernel, the device's busy time, and where it
idled.

The trace is exported as Chrome JSON to ``build/wam_bench/trace.json``
inside the checkout, read back and deleted.  Device activity is every
event of category ``kernel``, ``gpu_memcpy`` or ``gpu_memset``; busy
time is the union of their intervals; the window runs from the first to
the last event of any kind.  Idle time is attributed to the harness's
own host span (``wam.*``, a ``record_function``) that holds the middle
of each gap, or to ``host`` outside them.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    n = name.replace("(anonymous namespace)::", "")
    n = re.sub(r"^void ", "", n)
    return n.split("(")[0].strip() or name


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce_events(events: List[dict]) -> dict:
    """Chrome-trace events -> {kernels: {name: [count, seconds]}, busy_s,
    window_s, device_ops, idle_gaps}."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if not xs:
        return {"kernels": {}, "busy_s": 0.0, "window_s": 0.0,
                "device_ops": [], "idle_gaps": []}
    lo = min(float(e["ts"]) for e in xs)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in xs)
    kernels: Dict[str, list] = defaultdict(lambda: [0, 0.0])
    ops: Dict[str, float] = defaultdict(float)
    dev = []
    spans = []
    for e in xs:
        ts, dur = float(e["ts"]), float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            ops[short_name(e["name"]) if cat == "kernel"
                else cat] += dur * 1e-6
            if cat == "kernel":
                k = kernels[e["name"]]
                k[0] += 1
                k[1] += dur * 1e-6
        elif cat == "user_annotation" and e["name"].startswith("wam."):
            spans.append((ts, ts + dur, e["name"]))
    busy = _merge(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps, prev = [], lo
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((prev, hi))
    spans.sort()
    starts = [s[0] for s in spans]
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        owner = "host"
        # the innermost span holding mid starts last; spans nest shallowly
        i = bisect.bisect_right(starts, mid) - 1
        for s0, s1, name in reversed(spans[max(0, i - 7):i + 1]):
            if s1 >= mid:
                owner = name
                break
        idle[owner] += (b - a) * 1e-6
    top = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                           key=lambda kv: -kv[1])[:TOP]
    return {"kernels": {k: list(v) for k, v in kernels.items()},
            "busy_s": busy_s, "window_s": (hi - lo) * 1e-6,
            "device_ops": top(ops), "idle_gaps": top(idle)}


def kernel_seconds(trace: dict, pattern: str) -> Tuple[int, float]:
    """(launches, seconds) of the kernels whose full name matches the
    regular expression ``pattern``."""
    rx = re.compile(pattern)
    n, s = 0, 0.0
    for name, (count, secs) in trace["kernels"].items():
        if rx.search(name):
            n += count
            s += secs
    return n, s


class Tracer:
    """Start and stop ``torch.profiler`` around part of a window; the
    reduced trace is ``result`` after ``stop``."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self.prof = None
        self.result = None

    @property
    def active(self) -> bool:
        return self.prof is not None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> None:
        import torch

        if self.prof is None:
            return
        torch.cuda.synchronize()
        self.prof.stop()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        self.prof = None
        try:
            events = json.loads(self.path.read_text())["traceEvents"]
        finally:
            self.path.unlink(missing_ok=True)
        self.result = reduce_events(events)

    def span(self, name: str):
        """A host span ``name`` (``wam.*``) while tracing, else nothing."""
        if self.prof is None:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)


class NoTracer:
    """The untraced run's stand-in: spans cost nothing."""

    active = False
    result = None

    def span(self, name: str):
        return contextlib.nullcontext()

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass


def idle_pct(trace) -> "float | None":
    """Share (%) of a reduced trace's window with no device activity."""
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
