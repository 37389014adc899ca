#!/usr/bin/env python3
"""Time one piece of several checkouts in turns, on one card.

    python3 tools/turns.py WHAT parent=DIR change=. change=. parent=DIR

It first prints the card's name, power limit and top SM clock.

Each LABEL=DIR turn runs in its own process, importing that checkout's
``webaudio_modem_tpu_torch`` and ``chip_smoke.py`` (each builds its own
kernels).  Turns in one call on one card are what two versions may be
compared by.  WHAT is one of:

* ``framing`` — on the second 0.1 s chunk of 4096 distinct 13-byte
  messages at the hard bench configuration (300 baud, n_ds = 2400), as
  ``chip_smoke.py`` phase 5 times K2: K2 (``stage_d_compact``) five
  times over 20 launches between two CUDA events, and K8 (``stage_d``)
  where the checkout has it.  It prints a hash of K2's outputs, so the
  turns also show whether two checkouts' K2 compute the same bytes.
* ``seq`` — the sequential-DSP kernels and the hard chunk step, on the
  inputs ``chip_smoke.py`` times them on: K1 with all streams on the
  second 0.1 s chunk of 4096 distinct 13-byte messages at the hard bench
  configuration (T = 4800), K1 in csum mode on the soft decode's 16-byte
  frames at 8 dB (T = 16,720, B = 4096), K7 (K1 without R) at 50 baud
  (ds = 480, T = 4800, B = 2048), K6 at ``PSKConfig()`` (D = 20,
  T = 4800, B = 4096), each five times over 20 launches (5 for the csum
  mode) between two CUDA events, and the hard ``demod_chunk`` at
  B = 4096 over 25 chunks.  It prints a hash of each one's outputs.
* ``soft_decode`` — the farm soft-FEC decode of 2048 and 4096 distinct
  16-byte payloads at 8 dB, as ``chip_smoke.py`` phase 8 makes them,
  decoded exactly three times over as ten pipelined
  ``decode_frames_batch_async`` calls (host wall per decode), then ten
  ``_decode_frames_fused`` calls between two CUDA events.
"""

import os
import subprocess
import sys

PRELUDE = r"""
import hashlib, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import chip_smoke as cs
from webaudio_modem_tpu_torch.ops import fsk_demod
assert fsk_demod.__file__.startswith(sys.argv[1]), fsk_demod.__file__
dev = torch.device("cuda", 0)
"""

TURNS = {
    "framing": r"""
from webaudio_modem_tpu_torch.models.config import FSKParams
from webaudio_modem_tpu_torch.ops import fsk_mod
from webaudio_modem_tpu_torch.ops.kernels import fsk_framing, fsk_seq
params = FSKParams.from_config(cs._bench_config())
B = 4096
sig = fsk_mod.modulate_batch(
    params, cs._messages(np.random.default_rng(5), B, 13), dev)
state, _ = fsk_demod.demod_chunk(
    params, 0, fsk_demod.init_state(params, B, dev), sig[:, :cs.CHUNK])
ds = params.ds_samples_per_bit
_, _, bits, amps, _, rsum = fsk_seq.seq(
    params, 0, state.front, state.ds_acc, state.bit_tail[-ds:],
    sig[:, cs.CHUNK:2 * cs.CHUNK].t().contiguous())
ratios = fsk_demod._sync_ratios_from_r(params, state.r_tail, rsum)
ints, flts = fsk_demod._framing_carry(params, state)
n = bits.shape[0]
planes = (bits, amps, ratios, torch.cat([state.amp_tail, amps]))
args = (params, ints, flts, state.bit_fill, *planes,
        fsk_demod.max_bytes(params, n))
out = fsk_framing.stage_d_compact(*args)
digest = hashlib.sha256(b"".join(t.cpu().numpy().tobytes()
                                 for t in out)).hexdigest()[:16]
kernels = {"K2": lambda: fsk_framing.stage_d_compact(*args)}
if hasattr(fsk_framing, "stage_d"):
    kernels["K8"] = lambda: fsk_demod.stage_d(params, state, *planes)
for name, fn in kernels.items():
    for _ in range(3):
        fn()
    ms = [cs._cuda_ms(fn, 20) for _ in range(5)]
    print(f"turn {sys.argv[2]} {name} n_ds={n} B={B}: "
          f"{', '.join(f'{m:.4f}' for m in ms)} ms per launch"
          + (f"; K2 outputs sha256 {digest}" if name == "K2" else ""),
          flush=True)
""",
    "seq": r"""
from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams
from webaudio_modem_tpu_torch.ops import fsk_mod, psk
from webaudio_modem_tpu_torch.ops.kernels import fsk_seq, psk_seq


def digest(out, h=None):
    # sha256 of the tensors in ``out`` (tuples, dataclasses, None)
    top = h is None
    h = h or hashlib.sha256()
    if out is None:
        h.update(b"-")
    elif isinstance(out, torch.Tensor):
        h.update(out.cpu().contiguous().view(torch.uint8).numpy().tobytes())
    else:
        for t in out if isinstance(out, tuple) else vars(out).values():
            digest(t, h)
    return h.hexdigest()[:16] if top else None


rng = np.random.default_rng(5)
B = 4096
params = FSKParams.from_config(cs._bench_config())
ds = params.ds_samples_per_bit
sig = fsk_mod.modulate_batch(params, cs._messages(rng, B, 13), dev)
state, _ = fsk_demod.demod_chunk(
    params, 0, fsk_demod.init_state(params, B, dev), sig[:, :cs.CHUNK])
x = sig[:, cs.CHUNK:2 * cs.CHUNK].t().contiguous()
k1 = (params, 0, state.front, state.ds_acc, state.bit_tail[-ds:], x)
soft = cs._soft_params()
_, noisy = cs._soft_batch(soft, rng, B, dev)
csum = cs._soft_planes(soft, noisy)["seq_args"]
p50 = FSKParams.from_config(FSKConfig(baud_rate=50, mark_frequency=1270,
                                      space_frequency=1070))
sig50 = fsk_mod.modulate_batch(p50, cs._messages(rng, 2048, 4), dev)
x50 = cs._awgn(sig50[:, cs.CHUNK:2 * cs.CHUNK], 20.0, rng,
               dev).t().contiguous()
st50 = fsk_demod.init_state(p50, 2048, dev)
k7 = (p50, 0, st50.front, st50.ds_acc, None, x50)
pp = cs._psk_params()
psig = psk.modulate_batch(pp, cs._messages(rng, B, 13), dev)
pstate, _ = psk.demod_chunk(pp, 0, psk.init_state(pp, B, dev),
                            psig[:, :cs.CHUNK])
k6 = (pp, *cs._psk_args(pstate, 0, psig[:, cs.CHUNK:2 * cs.CHUNK]
                        .t().contiguous(), True))
chunks = [sig[:, i * cs.CHUNK:(i + 1) * cs.CHUNK]
          for i in range(sig.shape[1] // cs.CHUNK)]
run = [fsk_demod.init_state(params, B, dev), 0]


def chunk_step():
    run[0], _ = fsk_demod.demod_chunk(params, 0, run[0],
                                      chunks[run[1] % len(chunks)])
    run[1] += 1


cases = (
    ("K1 all streams T=4800 B=4096", lambda: fsk_seq.seq(*k1), 20),
    (f"K1 csum T={csum[-1].shape[0]} B=4096",
     lambda: fsk_seq.seq(*csum, **cs.CSUM_FLAGS), 5),
    ("K7 ds=480 T=4800 B=2048",
     lambda: fsk_seq.seq(*k7, emit_rsum=False), 20),
    ("K6 D=20 T=4800 B=4096", lambda: psk_seq.seq(*k6), 20),
    ("demod_chunk hard B=4096",
     lambda: fsk_demod.demod_chunk(params, 0, state, chunks[1]), 0),
)
for name, fn, reps in cases:
    out = fn()
    digest_s = digest(out)
    if reps == 0:      # the chunk step: a carried stream, as phase 5
        fn, reps = chunk_step, 25
    for _ in range(3):
        fn()
    ms = [cs._cuda_ms(fn, reps) for _ in range(5)]
    print(f"turn {sys.argv[2]} {name}: "
          f"{', '.join(f'{m:.4f}' for m in ms)} ms per call; outputs "
          f"sha256 {digest_s}", flush=True)
""",
    "soft_decode": r"""
from webaudio_modem_tpu_torch.ops import soft_fsk
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
""",
}


def main(argv) -> int:
    if len(argv) < 2 or argv[0] not in TURNS:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        end="", flush=True)
    for turn in argv[1:]:
        label, _, tree = turn.partition("=")
        tree = os.path.abspath(tree)
        proc = subprocess.run(
            [sys.executable, "-c", PRELUDE + TURNS[argv[0]], tree, label],
            capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
