"""The controls on the card: each cell's control, put in the program's
place, reads ``correct`` false, at the cell's own size over a short
window; the readings over many seeds are in PERF.md."""

import time

import pytest

from wam_bench import harness

SEED = 2 ** 31 + 9001


def run(cell, overrides, seconds, control):
    return harness.run_cell(cell, SEED, seconds, False,
                            t0=time.perf_counter(), overrides=overrides,
                            control=control)


@pytest.mark.card
def test_frames_control_fails(cuda_device):
    r = run("wam1200_softfec.frames", None, 3.0, "csum_bf16")
    assert not r["correct"]
    assert r["checks"]["erased_frames"]["value"] > \
        r["checks"]["erased_frames"]["limit"]
