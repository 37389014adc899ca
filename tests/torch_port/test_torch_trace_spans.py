"""The port's ``metrics`` registry: a timer is a profiler span while a
``torch.profiler`` records, and nothing more than a timer otherwise; the
soft farm decode's stage spans, nested, once per decode, with the
decode's answers unchanged.

A profiler over K1's plain version (~10^6 small ops a frame) takes half
a minute and half a gigabyte of trace, so the traced decode replays the
outputs that K1 gave the untraced decode of the same samples: every
other stage runs as it does on the card's path."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_port_helpers import configs
from webaudio_modem_tpu_torch.ops import soft_fsk
from webaudio_modem_tpu_torch.ops.kernels import fsk_seq
from webaudio_modem_tpu_torch.utils import trace
from webaudio_modem_tpu_torch.utils.trace import Metrics, metrics

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
import chip_smoke as cs  # noqa: E402  (its profile readings)

PAYLOAD = 4
B = 3
DISPATCH_STAGES = ("soft.k1", "soft.sync", "soft.header", "soft.select",
                   "soft.body", "soft.pack", "soft.copy")
SPANS = ("soft.dispatch",) + DISPATCH_STAGES + ("soft.finalize",
                                                "soft.finalize.wait")


def _annotations(prof, path):
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("cat") == "user_annotation"]


def test_timer_is_a_span_under_the_profiler(tmp_path):
    m = Metrics()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with m.timer("x"):
            with m.timer("x.inner"):
                torch.ones(4).sum()
    ev = {e["name"]: e for e in _annotations(prof, tmp_path / "t.json")}
    assert {"x", "x.inner"} <= set(ev)
    outer, inner = ev["x"], ev["x.inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert m.snapshot()["timings"]["x"]["count"] == 1


def test_no_profiler_no_record_function(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered without a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    m = Metrics()
    for _ in range(3):
        with m.timer("x"):
            pass
    assert m.snapshot()["timings"]["x"]["count"] == 3


def test_timer_aggregation(monkeypatch):
    clock = iter([1.0, 1.5, 2.0, 2.25, 3.0, 4.0])
    monkeypatch.setattr(trace, "time",
                        SimpleNamespace(perf_counter=lambda: next(clock)))
    m = Metrics()
    with m.timer("t"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with m.timer("t"):
            pass
    with pytest.raises(ValueError):
        with m.timer("t"):
            raise ValueError
    m.incr("c")
    m.incr("c", 2.5)
    snap = m.snapshot()
    assert set(snap) == {"counters", "timings"}
    assert snap["counters"] == {"c": 3.5}
    t = snap["timings"]["t"]
    assert t["count"] == 3
    assert t["total_s"] == pytest.approx(1.75)
    assert t["mean_ms"] == pytest.approx(1750 / 3)
    assert t["min_ms"] == pytest.approx(250.0)
    assert t["max_ms"] == pytest.approx(1000.0)
    m.reset()
    assert m.snapshot() == {"counters": {}, "timings": {}}


def test_registry_has_no_gauges():
    assert not hasattr(Metrics, "gauge")
    assert "gauges" not in metrics.snapshot()


def test_chip_smoke_profiles_leave_spans_out(capsys):
    # a span is neither an operator nor a kernel: chip_smoke's profile
    # readings count what they counted before the timers became spans
    def run():
        for _ in range(2):
            with metrics.timer("soft.dispatch"):
                with metrics.timer("soft.pack"):
                    torch.ones(64).cumsum(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    spans = {e.key for e in prof.key_averages() if cs._is_span(e)}
    assert spans == {"soft.dispatch", "soft.pack"}
    assert not any(cs._is_span(e) for e in prof.key_averages()
                   if e.key.startswith("aten::"))
    out = cs._host_ops("spans", run, calls=2, top=50)
    keys = {key for key, _, _ in out["top"]}
    assert "aten::cumsum" in keys
    assert not keys & {"soft.dispatch", "soft.pack"}
    assert "soft." not in capsys.readouterr().out


@pytest.fixture(scope="module")
def soft_pair():
    """Two batches decoded untraced, K1's outputs kept for the replay."""
    _, _, pp, _ = configs()
    rng = np.random.default_rng(14)
    xs = []
    for _ in range(2):
        payloads = [bytes(rng.integers(0, 256, PAYLOAD, dtype=np.uint8))
                    for _ in range(B)]
        xs.append(soft_fsk.encode_frames_batch(pp, payloads, device="cpu"))
    seq, k1 = fsk_seq.seq, []

    def recording(*a, **kw):
        k1.append((a[5].clone(), seq(*a, **kw)))
        return k1[-1][1]
    fsk_seq.seq = recording
    try:
        want = [soft_fsk.decode_frames_batch(pp, x, PAYLOAD, device="cpu")
                for x in xs]
    finally:
        fsk_seq.seq = seq
    return pp, xs, k1, want


def test_soft_decode_spans_nested_once_per_decode(soft_pair, monkeypatch,
                                                  tmp_path):
    pp, xs, k1, want = soft_pair
    replay = iter(k1)

    def replayed(*a, **kw):
        x, out = next(replay)
        assert torch.equal(a[5], x)
        return out
    monkeypatch.setattr(fsk_seq, "seq", replayed)
    before = metrics.snapshot()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # pipelined as a server drains batches: both enqueued, then both
        # finalized
        pending = [soft_fsk.decode_frames_batch_async(pp, x, PAYLOAD,
                                                      device="cpu")
                   for x in xs]
        got = [fin() for fin in pending]
    assert got == want
    assert all(r is not None for res in got for r in res)

    ev = sorted(_annotations(prof, tmp_path / "t.json"),
                key=lambda e: (e["ts"], -e["dur"]))
    ev = [e for e in ev if e["name"].startswith("soft.")]
    names = [e["name"] for e in ev]
    for name in SPANS:
        assert names.count(name) == 2, name
    inside = lambda c, p: (p["ts"] <= c["ts"] and  # noqa: E731
                           c["ts"] + c["dur"] <= p["ts"] + p["dur"])
    dispatches = [e for e in ev if e["name"] == "soft.dispatch"]
    finals = [e for e in ev if e["name"] == "soft.finalize"]
    for d in dispatches:
        kids = [e["name"] for e in ev if e is not d and inside(e, d)]
        assert kids == list(DISPATCH_STAGES)
    for f in finals:
        assert [e["name"] for e in ev if e is not f and inside(e, f)] == \
            ["soft.finalize.wait"]
        assert not any(inside(f, d) for d in dispatches)

    after = metrics.snapshot()
    for name in SPANS:
        n0 = before["timings"].get(name, {"count": 0})["count"]
        assert after["timings"][name]["count"] == n0 + 2
    n0 = before["counters"].get("soft.frames_decoded", 0)
    assert after["counters"]["soft.frames_decoded"] == n0 + 2 * B
