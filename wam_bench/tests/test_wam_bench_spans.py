"""The reduction of the program's spans (``spans.reduce_spans``) on
synthetic Chrome events, its readers, and on the card the frames cell
traced with them."""

import time

import pytest

from wam_bench import harness, spans, trace

READERS = ("decode.dispatch_ms", "decode.finalize_ms", "decode.launches",
           "decode.sync_device_ms")


def span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid}


def api(name, ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": 1.0, "pid": 1, "tid": tid, "args": {"correlation": corr}}


def dev(cat, name, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7, "args": {"correlation": corr}}


def test_self_time_of_nested_spans():
    ev = [span("soft.dispatch", 0, 100), span("soft.k1", 10, 20),
          span("soft.sync", 40, 30), span("soft.inner", 45, 10),
          span("soft.finalize", 120, 50), span("soft.finalize.wait", 120, 40)]
    s = spans.reduce_spans(ev)["spans"]
    assert s["soft.dispatch"]["self_s"] == pytest.approx(50e-6)
    assert s["soft.dispatch"]["host_s"] == pytest.approx(100e-6)
    assert s["soft.sync"]["self_s"] == pytest.approx(20e-6)
    assert s["soft.inner"]["self_s"] == pytest.approx(10e-6)
    # a child starting with its parent is still its child
    assert s["soft.finalize"]["self_s"] == pytest.approx(10e-6)
    assert s["soft.finalize.wait"]["parent"] == "soft.finalize"
    assert s["soft.inner"]["parent"] == "soft.sync"
    assert s["soft.k1"]["parent"] == "soft.dispatch"
    assert s["soft.dispatch"]["parent"] is None
    assert spans.descendants(s, "soft.dispatch") == [
        "soft.dispatch", "soft.k1", "soft.sync", "soft.inner"]


def test_siblings_back_to_back_are_not_nested():
    ev = [span("a", 0, 10), span("b", 10, 10)]
    s = spans.reduce_spans(ev)["spans"]
    assert s["b"]["parent"] is None and s["a"]["self_s"] == \
        pytest.approx(10e-6)


def test_spans_on_other_threads_do_not_nest():
    ev = [span("a", 0, 100, tid=1), span("b", 10, 10, tid=2)]
    s = spans.reduce_spans(ev)["spans"]
    assert s["b"]["parent"] is None
    assert s["a"]["self_s"] == pytest.approx(100e-6)


def test_launches_and_device_time_by_correlation():
    ev = [span("wam.dispatch", 0, 200),
          span("soft.dispatch", 5, 190), span("soft.k1", 10, 30),
          span("soft.sync", 50, 40),
          api("cudaLaunchKernel", 15, 101),           # soft.k1
          api("cudaLaunchKernel", 55, 102),           # soft.sync
          api("cuLaunchKernelEx", 60, 103),           # soft.sync
          api("cudaMemcpyAsync", 100, 104),           # soft.dispatch
          api("cudaLaunchKernel", 198, 105),          # wam.dispatch only
          dev("kernel", "void (anonymous namespace)::fsk_seq_kernel<false, "
              "false, true, true>(float const*, int)", 20, 50, 101),
          dev("kernel", "void gemm(int)", 70, 30, 102),
          dev("kernel", "void argmax(int)", 100, 5, 103),
          dev("gpu_memcpy", "Memcpy DtoH", 110, 4, 104),
          dev("kernel", "void late(int)", 200, 3, 105)]
    r = spans.reduce_spans(ev)
    s = r["spans"]
    assert s["soft.k1"]["launches"] == 1
    assert s["soft.k1"]["device_s"] == pytest.approx(50e-6)
    assert s["soft.k1"]["kernels"] == {
        "fsk_seq_kernel<false, false, true, true>": 1}
    assert s["soft.sync"]["launches"] == 2
    assert s["soft.sync"]["device_s"] == pytest.approx(35e-6)
    # the copy is device time of the span that enqueued it, no launch
    assert s["soft.dispatch"]["launches"] == 0
    assert s["soft.dispatch"]["device_s"] == pytest.approx(4e-6)
    # the harness's own spans are not reported, but hold what they launch
    assert "wam.dispatch" not in s and r["unattributed_kernels"] == 0


def test_kernel_without_launch_record_goes_between_its_neighbours():
    ev = [span("soft.dispatch", 0, 100), span("soft.body", 10, 40),
          span("soft.pack", 60, 30),
          api("cudaLaunchKernel", 12, 10),
          # 11: a kernel launched through a library the profiler's API
          # records miss, between two launches of soft.body
          api("cudaLaunchKernel", 30, 12),
          api("cudaLaunchKernel", 65, 14),
          dev("kernel", "void a(int)", 20, 5, 10),
          dev("kernel", "void viterbi_kernel<8, true>(float const*)", 30,
              10, 11),
          dev("kernel", "void b(int)", 45, 5, 12),
          # 13: between soft.body and soft.pack -> their parent
          dev("kernel", "void c(int)", 60, 2, 13),
          dev("kernel", "void d(int)", 70, 2, 14)]
    r = spans.reduce_spans(ev)
    s = r["spans"]
    assert s["soft.body"]["launches"] == 3
    assert s["soft.body"]["device_s"] == pytest.approx(20e-6)
    assert s["soft.body"]["kernels"]["viterbi_kernel<8, true>"] == 1
    assert s["soft.dispatch"]["launches"] == 1
    assert s["soft.dispatch"]["kernels"] == {"c": 1}
    assert s["soft.pack"]["launches"] == 1
    assert r["unattributed_kernels"] == 0


def test_unattributed_kernels():
    ev = [span("soft.k1", 0, 10),
          api("cudaLaunchKernel", 2, 1),
          api("cudaLaunchKernel", 20, 3),             # outside every span
          dev("kernel", "void a(int)", 5, 5, 1),
          dev("kernel", "void b(int)", 25, 5, 3),
          dev("kernel", "void c(int)", 31, 5, 2),     # neighbours 1 and 3
          dev("kernel", "void d(int)", 40, 5, 9)]     # past the last id
    r = spans.reduce_spans(ev)
    assert r["unattributed_kernels"] == 3
    assert r["spans"]["soft.k1"]["launches"] == 1


def test_idle_after_the_ninth_child_is_not_the_hosts():
    # one dispatch with ten children; in each child's time a device gap
    # of 20 us, after each child one of 60 us (59 after the last): the
    # first belongs to the child, the second to the dispatch, the gap
    # after the 9th child (c8) and those after it too
    ev = [span("wam.dispatch", 0, 1000), span("soft.dispatch", 1, 998),
          dev("kernel", "void k(int)", 999, 1, 999)]
    for i in range(10):
        ev += [span(f"soft.c{i}", 100 * i + 10, 50),
               dev("kernel", "void k(int)", 100 * i, 15, 2 * i),
               dev("kernel", "void k(int)", 100 * i + 35, 5, 2 * i + 1)]
    r = spans.reduce_spans(ev)
    idle = dict(r["idle_gaps"])
    assert set(idle) == {"soft.dispatch"} | {f"soft.c{i}"
                                             for i in range(10)}
    for i in range(10):
        assert r["spans"][f"soft.c{i}"]["idle_s"] == pytest.approx(20e-6)
    assert idle["soft.dispatch"] == pytest.approx((9 * 60 + 59) * 1e-6)
    assert r["spans"]["soft.dispatch"]["idle_s"] == idle["soft.dispatch"]


def test_idle_total_is_window_less_busy():
    ev = [span("wam.dispatch", 0, 50), span("soft.dispatch", 0, 40),
          span("soft.pack", 20, 10), span("wam.finalize", 60, 40),
          span("soft.finalize", 62, 30), span("soft.finalize.wait", 62, 5),
          dev("kernel", "void a(int)", 3, 5, 1),
          dev("kernel", "void b(int)", 35, 10, 2),
          dev("gpu_memcpy", "Memcpy DtoH", 64, 2, 3),
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 100,
           "dur": 20, "pid": 1, "tid": 1}]
    r = spans.reduce_spans(ev)
    base = trace.reduce_events(ev)
    idle = dict(r["idle_gaps"])
    assert sum(idle.values()) == pytest.approx(base["window_s"]
                                               - base["busy_s"])
    # 0-3 (dispatch), 8-35 (mid 21.5: pack), 45-64 (mid 54.5: neither
    # span holds it: host), 66-120 (mid 93: wam.finalize)
    assert idle["soft.dispatch"] == pytest.approx(3e-6)
    assert idle["soft.pack"] == pytest.approx(27e-6)
    assert idle["host"] == pytest.approx(19e-6)
    assert idle["wam.finalize"] == pytest.approx(54e-6)
    assert r["spans"]["soft.pack"]["idle_s"] == pytest.approx(27e-6)


def test_reduce_events_keys_unchanged_beside_spans():
    # the trace test's events: the span reduction leaves every key of
    # reduce_events as it was and finds the same idle owners
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "wam.collect_bytes",
         "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "void k1<true>(int)",
         "ts": 10.0, "dur": 30.0},
        {"ph": "X", "cat": "kernel", "name": "void k2(int)",
         "ts": 20.0, "dur": 30.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "ts": 80.0, "dur": 10.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 150.0,
         "dur": 50.0},
    ]
    base = trace.reduce_events(ev)
    r = spans.reduce_spans(ev)
    assert dict(r["idle_gaps"]) == pytest.approx(dict(base["idle_gaps"]))
    assert r["spans"] == {}
    assert r["unattributed_kernels"] == 2
    assert trace.reduce_events(ev) == base


@pytest.mark.parametrize("name", READERS)
def test_readers_none_without_spans(name):
    reader = harness.load_reader(name)
    assert reader.read({"window_s": 1.0}) is None
    t = {"kernels": {}, "busy_s": 1.0, "window_s": 2.0, "device_ops": [],
         "idle_gaps": []}
    assert reader.read({"trace": t, "decodes_traced": 3}) is None
    assert reader.read({"trace": dict(t, spans={})}) is None
    assert reader.read({"timers_untraced": {}}) is None


def test_readers_on_spans():
    def s(count, host, self_, launches, device, parent=None):
        return {"count": count, "host_s": host, "self_s": self_,
                "launches": launches, "device_s": device, "idle_s": 0.0,
                "parent": parent, "kernels": {}}
    t = {"spans": {
        "soft.dispatch": s(4, 0.040, 0.004, 0, 0.001),
        "soft.k1": s(4, 0.004, 0.004, 4, 0.008, "soft.dispatch"),
        "soft.sync": s(4, 0.002, 0.002, 8, 0.018, "soft.dispatch"),
        "soft.pack": s(4, 0.020, 0.020, 400, 0.002, "soft.dispatch"),
        "soft.finalize": s(4, 0.030, 0.012, 0, 0.0),
        "soft.finalize.wait": s(4, 0.018, 0.018, 0, 0.0, "soft.finalize"),
        "farm_hub.chunk": s(2, 0.1, 0.1, 50, 0.0)}}
    # the host times come from the timers with no profiler running,
    # not from the traced spans
    untraced = {"soft.dispatch": {"count": 10, "total_s": 0.070},
                "soft.finalize": {"count": 10, "total_s": 0.060},
                "soft.finalize.wait": {"count": 10, "total_s": 0.035}}
    rec = {"trace": t, "timers_untraced": untraced}
    read = lambda n: harness.load_reader(n).read(rec)  # noqa: E731
    assert read("decode.dispatch_ms") == pytest.approx(7.0)
    assert read("decode.finalize_ms") == pytest.approx(2.5)
    assert read("decode.launches") == pytest.approx(103.0)
    assert read("decode.sync_device_ms") == pytest.approx(4.5)
    rec = {"trace": t}
    assert read("decode.dispatch_ms") is None
    assert read("decode.launches") == pytest.approx(103.0)


def test_untraced_timers_are_the_window_after_the_profilers_stop():
    at_stop = {"soft.dispatch": {"count": 3, "total_s": 0.06},
               "soft.k1": {"count": 3, "total_s": 0.01}}
    end = {"soft.dispatch": {"count": 8, "total_s": 0.11},
           "soft.k1": {"count": 3, "total_s": 0.01},
           "soft.copy": {"count": 5, "total_s": 0.002}}
    got = spans.untraced_timers(end, at_stop)
    assert set(got) == {"soft.dispatch", "soft.copy"}
    assert got["soft.dispatch"]["count"] == 5
    assert got["soft.dispatch"]["total_s"] == pytest.approx(0.05)
    assert spans.untraced_timers(end, {}) == {
        k: {"count": v["count"], "total_s": v["total_s"]}
        for k, v in end.items()}
    assert spans.timer_ms({"timers_untraced": got}, "soft.dispatch") == \
        pytest.approx(10.0)


def test_step_rates():
    rec = {"step_latency_s": [0.02, 0.03, 0.01, 0.5, 0.02],
           "window_s": 2.0}
    assert spans.step_rates(rec) == {"steps_per_s": 2.5,
                                     "median_ms": pytest.approx(20.0)}
    rec.update(decodes_traced=3, trace={"window_s": 0.5})
    assert spans.step_rates(rec) == {"steps_per_s": 6.0,
                                     "median_ms": pytest.approx(20.0)}
    assert spans.step_rates({"window_s": 1.0}) is None


def test_span_metrics_fit_the_spec():
    spec = spans.span_spec(harness.load_spec())
    names = [m["name"] for m in spec["per_layer"]]
    assert len(names) == len(set(names))
    extra = spec["per_layer"][-len(READERS):]
    assert [m["name"] for m in extra] == list(READERS)
    for m in extra:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["layer"] == "soft entry" and m["better"] == "lower"
        for cell in m["workloads"]:
            harness.find_cell(spec, cell)


@pytest.mark.card
def test_frames_spans_on_the_card(cuda_device):
    # the cell's window: past the 3 s trace and the profiler's stop and
    # export (~13 s on the card), the untraced timers hold decodes too
    r = spans.run("wam1200_softfec.frames", 2 ** 31 + 4242, 25.0, True,
                  time.perf_counter())
    s = r["spans"]
    assert r["correct"] and r["unattributed_kernels"] == 0
    n = s["soft.dispatch"]["count"]
    assert n == r["decodes_traced"]
    for name in ("soft.k1", "soft.sync", "soft.header", "soft.select",
                 "soft.body", "soft.pack", "soft.copy"):
        assert s[name]["count"] == n and s[name]["parent"] == \
            "soft.dispatch"
    assert s["soft.finalize.wait"]["parent"] == "soft.finalize"

    def launched(span, prefix):
        return sum(c for k, c in s[span]["kernels"].items()
                   if k.startswith(prefix))
    assert launched("soft.k1", "fsk_seq_kernel") == n
    for stage in ("soft.header", "soft.body"):
        assert launched(stage, "align_kernel") == n
        assert launched(stage, "viterbi_kernel") == n
    for prefix in ("fsk_seq_kernel", "align_kernel", "viterbi_kernel"):
        assert sum(launched(k, prefix) for k in s) == \
            {"fsk_seq_kernel": 1}.get(prefix, 2) * n
    for name in READERS:
        assert r["metrics"][name]["value"] > 0
    # the untraced timers count the decodes after the trace alone; the
    # window's last batch is resolved after it
    t = r["timers"]
    assert t["soft.dispatch"]["count"] == t["soft.finalize"]["count"] + 1
    assert t["soft.finalize"]["count"] > 0
