"""Host-bookkeeping cost of the blind receiver at farm scale, device
stubbed.

The blind receiver's device programs are timed by ``chip_smoke.py``
(phases 13, 14 and 20); this harness times ONLY the host pipeline stages
of ``ops/soft_blind.BlindSoftBatchReceiver`` (``_collect_events`` /
``_dispatch_headers`` / ``_finalize_headers`` / ``_dispatch_bodies`` /
``_finalize_bodies`` / ``_emit_ready``) under the WORST-CASE arrival
pattern: cohort-aligned frames, all B channels closing a sync event in
the same quantum (what a farm ARQ flood produces).

Device work is stubbed out on the port's receiver (on the CPU):

  * the detector's emits are injected into ``_pend_detect`` as an int32
    [4, B] plane (emit_a, pos1, emit_b, pos_b) with no event;
  * ``_header_prog`` returns a constant int64 [3, B] plane (found, LEN,
    grid start) and ``_body_prog`` a constant uint8 [B, LEN + 1] plane
    (payload bytes + CRC flag), both CPU tensors, so the finalize stages
    read them as they read a program's pinned copy.

    python -m webaudio_modem_tpu_torch.examples.blind_host_cost \\
        --batch 4096 --reps 12
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def run(B: int, reps: int) -> dict:
    from webaudio_modem_tpu_torch.models.config import (DEFAULT_FSK_CONFIG,
                                                        FSKParams)
    from webaudio_modem_tpu_torch.ops.soft_blind import \
        BlindSoftBatchReceiver

    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    quantum = 4800
    rx = BlindSoftBatchReceiver(params, B, quantum, max_payload=160,
                                device="cpu")
    n_ds = rx._n_ds
    ln = 133                               # XModem packet

    # program stubs: every channel found, length ln, start ds // 4
    hdr = torch.zeros((3, B), dtype=torch.int64)
    hdr[0] = 1
    hdr[1] = ln
    hdr[2] = params.ds_samples_per_bit // 4
    packed = torch.zeros((B, ln + 1), dtype=torch.uint8)
    packed[:, ln] = 1
    rx._header_prog = lambda *a, **k: hdr
    rx._body_prog = lambda *a, **k: packed

    timings: dict = {k: [] for k in
                     ("collect", "disp_hdr", "fin_hdr", "disp_body",
                      "fin_body", "emit", "total")}
    K_b = rx._K_b(ln)
    for rep in range(reps):
        # one cohort per ring cycle, so slots never recycle mid-decode:
        # ALL B channels close an event in quantum q (phase-2 closes),
        # peaks mid-quantum
        q = rx._fed + 2
        emits = torch.zeros((4, B), dtype=torch.int32)
        emits[2] = 1
        emits[3] = torch.from_numpy(q * n_ds + n_ds // 2
                                    + np.arange(B, dtype=np.int32) % 3)
        rx._pend_detect.append((q, emits, None))
        rx._fed = q + 1

        t0 = time.perf_counter()
        rx._collect_events()
        t1 = time.perf_counter()
        # make the group due: fed past q + K_h - 2 and q + 2
        rx._fed = q + max(rx._K_h, 4)
        rx._dispatch_headers()
        t2 = time.perf_counter()
        rx._fed += 1
        rx._finalize_headers()
        t3 = time.perf_counter()
        rx._fed = q + K_b + 2
        rx._dispatch_bodies()
        t4 = time.perf_counter()
        rx._fed += 1
        rx._finalize_bodies()
        t5 = time.perf_counter()
        got = rx._emit_ready()
        t6 = time.perf_counter()
        assert len(got) == B, (rep, len(got))

        if rep >= 2:                       # skip the warm-up reps
            for k, a, b in (("collect", t0, t1), ("disp_hdr", t1, t2),
                            ("fin_hdr", t2, t3), ("disp_body", t3, t4),
                            ("fin_body", t4, t5), ("emit", t5, t6),
                            ("total", t0, t6)):
                timings[k].append((b - a) * 1e3)

    means = {k: float(np.mean(v)) for k, v in timings.items()}
    print(f"B={B} cohort-aligned (all {B} channels close an event in "
          f"one quantum), payload={ln} B, {reps - 2} timed reps")
    for k in ("collect", "disp_hdr", "fin_hdr", "disp_body",
              "fin_body", "emit", "total"):
        print(f"  {k:10s} {means[k]:8.2f} ms/cohort-quantum "
              f"({means[k] / B * 1e3:6.2f} us/event)")
    assert rx.frames_decoded == reps * B
    return means


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--reps", type=int, default=12)
    args = p.parse_args(argv)
    run(args.batch, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
