"""The program's own spans in a traced window, and a run of a cell that
reports them.

The port's ``metrics.timer`` opens ``torch.profiler.record_function``
while a profiler records, so its spans (``soft.dispatch`` and its
stages, ``soft.finalize``, the hubs' ``farm_hub.*``) land in the same
Chrome trace as the kernel, copy and memset events, as
``user_annotation`` events.  ``reduce_spans`` reads them beside the
device events:

- a kernel-launch API event (``cudaLaunchKernel*``, ``cuLaunchKernel*``)
  and every other runtime or driver API event belongs to the innermost
  span of its thread that holds its start;
- a device event belongs to the span of the API event with its
  ``correlation`` id; a kernel with no API event of its own (a launch
  the profiler did not record) goes to the innermost span that holds the
  API events of both neighbouring correlation ids (ids rise with every
  call), and counts as a launch there;
- an idle gap of the device belongs to the innermost span, of any
  thread, that holds its midpoint: the program's spans and the
  harness's ``wam.*`` spans, or ``host`` outside them all.

For each span name that is not ``wam.*``: ``count``, ``host_s`` (the sum
of its durations), ``self_s`` (``host_s`` less its child spans on the
same thread), ``launches``, ``device_s`` (the device time of what it
launched itself, children apart), ``idle_s``, ``parent`` (the name of
the span that holds it, None at the top) and ``kernels`` (launches by
short kernel name).  Beside them ``unattributed_kernels``, the kernel
events that reach no span, ``kernels_by_neighbours``, those placed by
their neighbours' ids, and ``idle_gaps``, every owner's idle seconds.

``python3 -m wam_bench.spans --workload <cell> --seed <n> --seconds <s>
[--trace 0|1]`` runs a cell as ``python3 -m wam_bench.run`` does, and
traced (the default) adds this reduction to the trace: the result line
gains the readers named in ``span_metrics.json``, its breakdown names
the program's spans among the idle gaps, and standard error gets one
``traced span:`` line per span.  Either way standard error also gets
the program's timers over the untraced part of the window (``timer:``
lines: the spans' host times with no profiler running, from the
profiler's stop to the window's end, or the whole window untraced) and
the step rate of the traced head of the window, or of the whole window.

The host-time readers (``decode.dispatch_ms``, ``decode.finalize_ms``)
read those untraced timers: the profiler's own cost per op is a third
of a traced enqueue, and grows with the launches.  The traced host and
self times stay on the ``traced span:`` lines beside them.
"""

from __future__ import annotations

import argparse
import bisect
import json
import re
import sys
import time
from collections import Counter, defaultdict
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

from wam_bench import harness, trace

API_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel)")
SPAN_METRICS = harness.ROOT / "span_metrics.json"


def _corr(e: dict) -> Optional[int]:
    c = (e.get("args") or {}).get("correlation")
    return None if c is None else int(c)


class _Spans:
    """The ``user_annotation`` spans of a trace, nested per thread."""

    def __init__(self, events: List[dict]):
        sp = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
               (e.get("pid"), e.get("tid")))
              for e in events if e.get("cat") == "user_annotation"]
        # parents before their children: earlier start, then longer
        sp.sort(key=lambda s: (s[0], -s[1]))
        self.start = [s[0] for s in sp]
        self.end = [s[1] for s in sp]
        self.name = [s[2] for s in sp]
        self.thread = [s[3] for s in sp]
        self.parent = [-1] * len(sp)
        stacks: Dict[tuple, List[int]] = defaultdict(list)
        for i in range(len(sp)):
            st = stacks[self.thread[i]]
            while st and self.end[st[-1]] <= self.start[i] \
                    and self.start[st[-1]] < self.start[i]:
                st.pop()
            self.parent[i] = st[-1] if st else -1
            st.append(i)

    def __len__(self) -> int:
        return len(self.start)

    def innermost(self, points: List[Tuple[float, Optional[tuple]]]
                  ) -> List[int]:
        """For each (time, thread) the innermost span of that thread
        holding the time (thread None: of any thread, the latest
        started), or -1.  One sweep over the spans in start order with a
        stack per thread: no span is looked at more than twice."""
        out = [-1] * len(points)
        stacks: Dict[tuple, List[int]] = defaultdict(list)
        k, n = 0, len(self)
        for j in sorted(range(len(points)), key=lambda j: points[j][0]):
            t, thread = points[j]
            while k < n and self.start[k] <= t:
                st = stacks[self.thread[k]]
                while st and self.end[st[-1]] <= self.start[k] \
                        and self.start[st[-1]] < self.start[k]:
                    st.pop()
                st.append(k)
                k += 1
            best = -1
            for st in (stacks.values() if thread is None
                       else [stacks.get(thread, [])]):
                while st and self.end[st[-1]] < t:
                    st.pop()
                if st and (best < 0 or self.start[st[-1]] > self.start[best]):
                    best = st[-1]
            out[j] = best
        return out

    def chain(self, i: int) -> List[int]:
        """Span ``i`` and its ancestors, innermost first."""
        out = []
        while i >= 0:
            out.append(i)
            i = self.parent[i]
        return out

    def common(self, a: int, b: int) -> int:
        """The innermost span holding spans ``a`` and ``b`` (or -1)."""
        if a < 0 or b < 0:
            return -1
        up = set(self.chain(a))
        for i in self.chain(b):
            if i in up:
                return i
        return -1


def _gaps(events: List[dict]) -> List[Tuple[float, float]]:
    """The window's device idle gaps (µs), as ``trace.reduce_events``
    finds them."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if not xs:
        return []
    lo = min(float(e["ts"]) for e in xs)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in xs)
    busy = trace._merge([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                         for e in xs if e.get("cat") in trace.DEVICE_CATS])
    gaps, prev = [], lo
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((prev, hi))
    return gaps


def reduce_spans(events: List[dict]) -> dict:
    """Chrome-trace events -> {spans, unattributed_kernels, idle_gaps}
    (module docstring)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    sp = _Spans(xs)
    api = [e for e in xs if e.get("cat") in API_CATS
           and _corr(e) is not None]
    api_owner = sp.innermost([(float(e["ts"]), (e.get("pid"), e.get("tid")))
                              for e in api])
    by_corr = {_corr(e): o for e, o in zip(api, api_owner)}
    corrs = sorted(by_corr)

    launches: Dict[int, int] = defaultdict(int)
    device, idle = defaultdict(float), defaultdict(float)
    kernels: Dict[int, Counter] = defaultdict(Counter)
    for e, o in zip(api, api_owner):
        if o >= 0 and LAUNCH.match(e["name"]):
            launches[o] += 1
    unattributed = by_neighbours = 0
    for e in xs:
        cat = e.get("cat")
        if cat not in trace.DEVICE_CATS:
            continue
        c = _corr(e)
        if c in by_corr:
            o = by_corr[c]
        else:
            # no API event of its own: the span holding both neighbours
            i = bisect.bisect_left(corrs, c) if c is not None else 0
            o = (sp.common(by_corr[corrs[i - 1]], by_corr[corrs[i]])
                 if c is not None and 0 < i < len(corrs) else -1)
            if o >= 0 and cat == "kernel":
                launches[o] += 1
                by_neighbours += 1
        if o < 0:
            unattributed += cat == "kernel"
            continue
        device[o] += float(e["dur"]) * 1e-6
        if cat == "kernel":
            kernels[o][trace.short_name(e["name"])] += 1

    gaps = _gaps(xs)
    owner = sp.innermost([(0.5 * (a + b), None) for a, b in gaps])
    by_owner: Dict[str, float] = defaultdict(float)
    for (a, b), o in zip(gaps, owner):
        if o >= 0:
            idle[o] += (b - a) * 1e-6
        by_owner[sp.name[o] if o >= 0 else "host"] += (b - a) * 1e-6

    child = [0.0] * len(sp)
    for i in range(len(sp)):
        if sp.parent[i] >= 0:
            child[sp.parent[i]] += sp.end[i] - sp.start[i]
    spans: Dict[str, dict] = {}
    for i in range(len(sp)):
        name = sp.name[i]
        if name.startswith("wam."):
            continue
        s = spans.setdefault(name, {
            "count": 0, "host_s": 0.0, "self_s": 0.0, "launches": 0,
            "device_s": 0.0, "idle_s": 0.0,
            "parent": (sp.name[sp.parent[i]] if sp.parent[i] >= 0
                       and not sp.name[sp.parent[i]].startswith("wam.")
                       else None),
            "kernels": Counter()})
        dur = sp.end[i] - sp.start[i]
        s["count"] += 1
        s["host_s"] += dur * 1e-6
        s["self_s"] += (dur - child[i]) * 1e-6
        s["launches"] += launches[i]
        s["device_s"] += device[i]
        s["idle_s"] += idle[i]
        s["kernels"].update(kernels[i])
    for s in spans.values():
        s["kernels"] = dict(s["kernels"].most_common())
    return {"spans": spans, "unattributed_kernels": unattributed,
            "kernels_by_neighbours": by_neighbours,
            "idle_gaps": sorted(([k, v] for k, v in by_owner.items()),
                                key=lambda kv: -kv[1])}


def span(rec: dict, name: str) -> Optional[dict]:
    """The reduced span ``name`` of a run's trace, None where the trace
    has no spans or no such span."""
    s = ((rec.get("trace") or {}).get("spans") or {}).get(name)
    return s if s and s["count"] else None


def descendants(spans: dict, name: str) -> List[str]:
    """``name`` and every span name nested under it, by ``parent``."""
    out = [name]
    for n in out:
        out.extend(k for k, s in spans.items() if s["parent"] == n)
    return out


class SpanTracer(trace.Tracer):
    """``trace.Tracer`` whose reduced trace also holds ``reduce_spans``'
    keys (its ``idle_gaps`` name the program's spans)."""

    def stop(self) -> None:
        import torch

        from webaudio_modem_tpu_torch.utils.trace import metrics

        if self.prof is None:
            return
        # the program's timers up to here ran traced
        self.timers_at_stop = metrics.snapshot()["timings"]
        torch.cuda.synchronize()
        self.prof.stop()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        self.prof = None
        try:
            events = json.loads(self.path.read_text())["traceEvents"]
        finally:
            self.path.unlink(missing_ok=True)
        self.result = trace.reduce_events(events)
        self.result.update(reduce_spans(events))


def untraced_timers(end: dict, at_stop: dict) -> Dict[str, dict]:
    """Count and seconds of each timer from the profiler's stop
    (``at_stop``, a ``metrics.snapshot()["timings"]``) to ``end``."""
    out = {}
    for name, v in end.items():
        a = at_stop.get(name, {"count": 0, "total_s": 0.0})
        if v["count"] > a["count"]:
            out[name] = {"count": v["count"] - a["count"],
                         "total_s": v["total_s"] - a["total_s"]}
    return out


def timer_ms(rec: dict, name: str, less: Optional[str] = None
             ) -> Optional[float]:
    """Mean ms of the program's timer ``name`` over the untraced part of
    the window, less the mean of ``less`` (a timer inside it, one call a
    call), None where the run has no such timer."""
    t = rec.get("timers_untraced") or {}
    if not t.get(name, {}).get("count"):
        return None
    less_s = t[less]["total_s"] if less in t else 0.0
    return 1e3 * (t[name]["total_s"] - less_s) / t[name]["count"]


def span_spec(spec: dict) -> dict:
    """``spec`` with the per-layer entries of ``span_metrics.json``."""
    extra = json.loads(SPAN_METRICS.read_text())
    return dict(spec, per_layer=spec["per_layer"] + extra)


def step_rates(rec: dict) -> Optional[dict]:
    """Steps a second and the median step (ms) of the traced head of the
    window, or of the whole window when untraced.  (The rest of a traced
    window holds the profiler's stop and export, seconds long.)"""
    lat = rec.get("step_latency_s") or []
    n, t = rec.get("decodes_traced"), rec.get("trace")
    lat, secs = (lat[:n], t["window_s"]) if n and t else \
        (lat, rec.get("window_s"))
    if not lat or not secs:
        return None
    return {"steps_per_s": len(lat) / secs,
            "median_ms": 1e3 * sorted(lat)[len(lat) // 2]}


def run(workload: str, seed: int, seconds: float, traced: bool,
        t0: float) -> dict:
    """One run of ``workload`` as ``harness.run_cell`` makes it, traced
    with ``SpanTracer`` in ``trace.Tracer``'s place and the readers of
    ``span_metrics.json`` (or untraced); the result gains ``spans``,
    ``unattributed_kernels``, ``kernels_by_neighbours``,
    ``decodes_traced``, ``step_rates`` and ``timers``, the program's
    timers over the untraced part of the window (``untraced_timers``),
    which the driver's record holds as ``timers_untraced``."""
    from webaudio_modem_tpu_torch.utils.trace import metrics

    drivers = []
    load = harness.load_driver

    def loading(name):
        cls = load(name).Driver

        def make(*a, **kw):
            drv = cls(*a, **kw)
            window = drv.window

            def timed(seconds):
                metrics.reset()
                window(seconds)
                drv.rec["timers_untraced"] = untraced_timers(
                    metrics.snapshot()["timings"],
                    getattr(drv.tracer, "timers_at_stop", {}))
            drv.window = timed
            drivers.append(drv)
            return drv
        return SimpleNamespace(Driver=make)

    harness.set_cache_dirs()
    saved = trace.Tracer
    trace.Tracer, harness.load_driver = SpanTracer, loading
    try:
        result = harness.run_cell(workload, seed, seconds, traced, t0=t0,
                                  spec=span_spec(harness.load_spec()))
    finally:
        trace.Tracer, harness.load_driver = saved, load
    rec = drivers[0].rec
    t = rec.get("trace") or {}
    result.update(spans=t.get("spans", {}),
                  unattributed_kernels=t.get("unattributed_kernels"),
                  kernels_by_neighbours=t.get("kernels_by_neighbours"),
                  decodes_traced=rec.get("decodes_traced"),
                  step_rates=step_rates(rec),
                  timers=rec.get("timers_untraced", {}))
    return result


def main(argv=None) -> int:
    t0 = time.perf_counter()
    p = argparse.ArgumentParser(prog="python3 -m wam_bench.spans",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), t0)
    except harness.RunError as exc:
        print(f"wam_bench: {exc}", file=sys.stderr)
        return 2
    for name, s in sorted(result["spans"].items(),
                          key=lambda kv: -kv[1]["host_s"]):
        print(f"traced span: {name} {s['count']} x host "
              f"{1e3 * s['host_s']:.3f} ms self {1e3 * s['self_s']:.3f} ms "
              f"launches {s['launches']} device {1e3 * s['device_s']:.3f} "
              f"ms idle {1e3 * s['idle_s']:.3f} ms", file=sys.stderr)
    if args.trace:
        print(f"unattributed kernels: {result['unattributed_kernels']}, "
              f"placed by their neighbours' ids: "
              f"{result['kernels_by_neighbours']}", file=sys.stderr)
    for name, v in sorted(result["timers"].items()):
        print(f"timer: {name} {v['count']} x mean "
              f"{1e3 * v['total_s'] / v['count']:.4f} ms untraced",
              file=sys.stderr)
    print(f"step rates: {json.dumps(result['step_rates'])}",
          file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
