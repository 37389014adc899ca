"""The metric arithmetic on synthetic records: rates over the whole
window, tails over every sample, rooflines from the frozen counts, and
the trace reduction."""

import statistics

import numpy as np
import pytest

from wam_bench import harness, stats, trace


def read(name, rec):
    return harness.load_reader(name).read(rec)


def test_realtime_channels_is_over_the_whole_window():
    # 10 steps of 0.1 s audio at 4096 exact channels in a 2 s window
    rec = {"window_s": 2.0, "step_channel_audio_s": [4096 * 0.1] * 10}
    assert read("realtime_channels", rec) == pytest.approx(2048.0)
    # the same steps in a longer window (idle time counts) read less
    rec["window_s"] = 4.0
    assert read("realtime_channels", rec) == pytest.approx(1024.0)


def test_p95_is_over_all_samples():
    # 1000 samples: 940 of 1 ms, 60 of 50 ms -> the tail sits in the slow
    values = [0.001] * 940 + [0.050] * 60
    got = read("step_p95_ms", {"step_latency_s": values, "window_s": 1.0})
    assert got == pytest.approx(1e3 * float(np.percentile(values, 95)))
    assert got == pytest.approx(50.0)
    # a p95 of the first 900 samples alone would read 1 ms
    assert read("step_p95_ms", {"step_latency_s": values[:900],
                                "window_s": 1.0}) == pytest.approx(1.0)


def test_means_of_spans():
    assert read("chunk.device_ms", {"chunk_device_ms": [1.0, 2.0, 3.0]}) \
        == pytest.approx(2.0)
    assert read("chunk.collect_ms", {"collect_ms": [2.0, 4.0]}) == \
        pytest.approx(3.0)


def _trace(kernels, busy, window):
    return {"kernels": kernels, "busy_s": busy, "window_s": window,
            "device_ops": [], "idle_gaps": []}


def test_roofline_share_from_frozen_counts():
    table = stats.kernel_table("k1")
    shape = table["shapes"]["T4800_B4096"]
    bound = stats.bound_s(shape, stats.peaks())
    # 100 launches that each took ten times their bound -> 10 %
    name = "void (anonymous namespace)::fsk_seq_kernel<true, true, false, " \
           "true>(float const*, int)"
    rec = {"launches": {"k1": {"T4800_B4096": 100}},
           "trace": _trace({name: [100, 100 * 10 * bound]}, 1.0, 2.0)}
    assert read("k1_roofline", rec) == pytest.approx(10.0)
    # the csum instantiation does not match K1's R mode
    rec["trace"]["kernels"] = {name.replace("true, true, false",
                                            "false, false, true"):
                               [100, 1.0]}
    assert read("k1_roofline", rec) is None


def test_roofline_mixed_shapes():
    table = stats.kernel_table("k3")
    peak = stats.peaks()
    launches = {"L32768_T38": 3, "L4096_T1086": 1}
    need = 3 * stats.bound_s(table["shapes"]["L32768_T38"], peak) + \
        stats.bound_s(table["shapes"]["L4096_T1086"], peak)
    rec = {"launches": {"k3": launches},
           "trace": _trace({"void viterbi_kernel<8, true>(float const*)":
                            [4, 4 * need]}, 1.0, 2.0)}
    assert read("k3_roofline", rec) == pytest.approx(25.0)


def test_idle_share():
    rec = {"trace": _trace({}, 0.25, 1.0)}
    assert read("device.idle_pct.farm", rec) == pytest.approx(75.0)


def test_decode_device_ms():
    rec = {"decodes_traced": 4,
           "trace": _trace({"a": [4, 0.004], "b": [8, 0.016]}, 1.0, 2.0)}
    assert read("decode.device_ms", rec) == pytest.approx(5.0)


def test_reduce_events_busy_union_and_idle_owner():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "wam.collect_bytes",
         "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "void k1<true>(int)",
         "ts": 10.0, "dur": 30.0},
        {"ph": "X", "cat": "kernel", "name": "void k2(int)",
         "ts": 20.0, "dur": 30.0},           # overlaps k1: union 10..50
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "ts": 80.0, "dur": 10.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 150.0,
         "dur": 50.0},
    ]
    r = trace.reduce_events(ev)
    assert r["window_s"] == pytest.approx(200e-6)
    assert r["busy_s"] == pytest.approx(50e-6)
    idle = dict(r["idle_gaps"])
    # gaps 0-10, 50-80 inside the span; 90-200 after it (mid 145)
    assert idle["wam.collect_bytes"] == pytest.approx(40e-6)
    assert idle["host"] == pytest.approx(110e-6)
    assert r["kernels"]["void k2(int)"] == [1, pytest.approx(30e-6)]
    assert dict(r["device_ops"])["k1<true>"] == pytest.approx(30e-6)
    assert trace.kernel_seconds(r, r"^void k") == (2, pytest.approx(60e-6))


def test_spread_matches_statistics_quantiles():
    v = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)
