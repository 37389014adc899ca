#!/usr/bin/env python3
"""Time the farm soft-FEC decode of several checkouts in turns, on one card.

    python3 tools/soft_decode_turns.py parent=DIR change=. change=. parent=DIR

Each LABEL=DIR turn runs in its own process, importing that checkout's
``webaudio_modem_tpu_torch`` and ``chip_smoke.py`` (each builds its own
kernels): 2048 and 4096 distinct 16-byte payloads at 8 dB, as
``chip_smoke.py`` phase 8 makes them, decoded exactly three times over as
ten pipelined ``decode_frames_batch_async`` calls (host wall per decode),
then ten ``_decode_frames_fused`` calls between two CUDA events.  Turns
in one call on one card are what two versions may be compared by.
"""

import os
import subprocess
import sys

TURN = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import chip_smoke as cs
from webaudio_modem_tpu_torch.ops import soft_fsk
assert soft_fsk.__file__.startswith(sys.argv[1]), soft_fsk.__file__
dev = torch.device("cuda", 0)
params = cs._soft_params()
rng = np.random.default_rng(8)
for B in (2048, 4096):
    payloads, noisy = cs._soft_batch(params, rng, B, dev)
    for _ in range(3):
        soft_fsk.decode_frames_batch(params, noisy, 16, device=dev)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        pending = [soft_fsk.decode_frames_batch_async(params, noisy, 16,
                                                      device=dev)
                   for _ in range(10)]
        outs = [p() for p in pending]
        walls.append((time.perf_counter() - t0) * 1e3 / 10)
        if any(o != payloads for o in outs):
            raise RuntimeError("a timed decode was not exact")
    ev = cs._cuda_ms(lambda: soft_fsk._decode_frames_fused(params, noisy, 16),
                     10)
    print(f"turn {sys.argv[2]} B={B}: host wall per pipelined decode "
          f"{', '.join(f'{w:.3f}' for w in walls)} ms; CUDA events "
          f"{ev:.3f} ms per decode", flush=True)
"""


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for turn in argv:
        label, _, tree = turn.partition("=")
        tree = os.path.abspath(tree)
        proc = subprocess.run([sys.executable, "-c", TURN, tree, label],
                              capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
