"""A run with the timed path broken underneath reads ``correct``
false: the harness's look for a card is skipped (the program's plain
versions run on the CPU at a small size), everything else is a run.

The stream runs B = 4 channels over a 1 s cycle; the frames run
batches of B = 64 frames of 16 bytes (half of them erased is past the
erasure limit).  Each run takes 15-40 s of CPU.

``BENCHMARK.json`` holds no hard stream cell while the program loses
messages on a noisy idle line (PERF.md, Open questions); the stream's
driver and check are held here on a cell added to a copy of the spec,
over a clean line, so that what is lost is the fault's alone."""

import copy
import time

import pytest

from wam_bench import harness

STREAM_CELL = "bell103_hard.stream"
STREAM = dict(config={"batch": 4}, mix={"cycle_seconds": 1.0,
                                        "snr_db": None})
FRAMES = dict(config={"batch": 64}, mix={"block": [16], "copies": 1})
SEED = 2 ** 31 + 4242


def spec_with_stream():
    spec = copy.deepcopy(harness.load_spec())
    spec["workloads"].append({"name": STREAM_CELL, "config": "bell103_hard",
                              "traffic": "stream", "chips": 1})
    for m in spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(STREAM_CELL)
    return spec


def run(cell, overrides, seconds, fault=None, control=None):
    return harness.run_cell(cell, SEED, seconds, False,
                            t0=time.perf_counter(), device="cpu",
                            overrides=overrides, fault=fault,
                            control=control, spec=spec_with_stream())


def test_stream_sound_run_is_correct():
    r = run(STREAM_CELL, STREAM, 1.0)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 2
    assert r["checks"] == {"lost_messages": {"value": 0, "limit": 0},
                           "stray_bytes": {"value": 0, "limit": 0}}
    assert set(r["metrics"]) == {"realtime_channels", "step_p95_ms",
                                 "setup_s"}


@pytest.mark.parametrize("fault,control", [
    ("state_unchanged", None), ("half_batch", None),
    ("altered_answer", None), (None, "state_reset")])
def test_stream_broken_run_is_not_correct(fault, control):
    r = run(STREAM_CELL, STREAM, 1.0, fault, control)
    assert not r["correct"]
    assert r["checks"]["lost_messages"]["value"] > 0


def test_frames_sound_run_is_correct():
    r = run("wam1200_softfec.frames", FRAMES, 6.0)
    assert r["correct"] and r["attempted"] >= 8


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer"])
def test_frames_broken_run_is_not_correct(fault):
    r = run("wam1200_softfec.frames", FRAMES, 1.0, fault)
    assert not r["correct"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())
