#!/usr/bin/env python3
"""Variants of one kernel source, built side by side and timed in turns.

    python3 tools/variants.py k5|k6 LABEL=DIR [LABEL=DIR ...]

For each checkout DIR it builds copies of one kernel (with the ``csrc/``
headers beside it), each with a few lines of its source replaced or
with extra nvcc flags, and times every build on the same inputs, in
turns (the as-built one first and last), each the best of three runs of
20 launches between two CUDA events.  It first prints the card's name,
power limit and top SM clock.  Every checkout is driven through this
checkout's wrapper, so the C interface must be this one's.

* ``k6`` — knockouts of K6 (``csrc/psk_seq.cu``): one operation
  replaced by a cheap one on the same operands (outputs wrong, the time
  says what the operation costs), or ``-ftz=true`` (subnormals flushed).
  Inputs as ``tools/turns.py seq`` times K6 (``PSKConfig()``: D = 20,
  with R, B = 4096): ``turns``, the second 0.1 s chunk of 4096 distinct
  13-byte messages after the first (T = 2080: the messages end there),
  and ``phase 11``, the first chunk after 28 chunk steps cycling the
  messages' chunks (T = 4800), as ``chip_smoke.py`` phase 11 times it.
  It also prints the share of zero and of subnormal values in each
  input's planes and in K6's amplitudes and soft values, and times the
  as-built builds again after a ``torch.profiler`` run.
* ``k5`` — design variants of K5 (``csrc/cumsum0.cu``): the number of
  stages and rows per stage, an L2 prefetch size on the 16-byte copies,
  streaming stores, the consumer's unrolling.  Inputs: normal random
  planes at ``chip_smoke.CSUM_SHAPES``, with the byte bound (one read of
  x, one write of the output at 3.35 TB/s) and the outputs' equality
  with the as-built build.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# kernel: (source name, {variant: ([(file, pattern, replacement)], extra
# nvcc flags)}); each pattern is a regular expression that must match
K6_VARIANTS = {
    "as built": ([], []),
    "AGC divide -> product": (
        [("seq_front.cuh", r"c\.agc_target / fmaxf",
          "c.agc_target * fmaxf")], []),
    "AGC off (y = x)": (
        [("seq_front.cuh", r"if \(c\.agc_enabled\)", "if (false)")], []),
    "average divides -> products": (
        [("psk_seq.cu", r" / ratio_f", " * ratio_f")], []),
    "atan2f -> im + re": (
        [("psk_seq.cu", r"atan2f\(im, re\)", "(im + re)")], []),
    "sqrtf -> its operand": (
        [("psk_seq.cu", r"sqrtf\(avg_i \* avg_i \+ avg_q \* avg_q\)",
          "(avg_i * avg_i + avg_q * avg_q)")], []),
    "-ftz=true": ([], ["-ftz=true"]),
}
_CP16 = (r"cp\.async\.cg\.shared\.global \[",
         "cp.async.cg.shared.global.L2::{} [")


def _k5(stages=None, rows=None, prefetch=None, streaming=False,
        unroll=None):
    """K5's substitutions: stages, rows per stage, an L2 prefetch size on
    the 16-byte copies, streaming (evict-first) stores, the consumer's
    unrolling."""
    subs = []
    if unroll:
        subs.append(("cumsum0.cu", r"#pragma unroll 8",
                     f"#pragma unroll {unroll}"))
    if stages:
        subs.append(("cumsum0.cu", r"kStages = \d+;",
                     f"kStages = {stages};"))
    if rows:
        subs.append(("cumsum0.cu", r"kRows = \d+;", f"kRows = {rows};"))
    if prefetch:
        subs.append(("warp_pipe.cuh", _CP16[0], _CP16[1].format(prefetch)))
    if streaming:
        subs.append(("cumsum0.cu", r"dst\[u \* Bs\] = acc;",
                     "__stcs(dst + u * Bs, acc);"))
    return subs, []


K5_VARIANTS = {
    "as built": ([], []),
    "kStages 4": _k5(4),
    "kStages 4, kRows 256": _k5(4, 256),
    "kStages 4, L2::128B prefetch": _k5(4, prefetch="128B"),
    "kStages 4, L2::256B prefetch": _k5(4, prefetch="256B"),
    "kStages 4, kRows 256, L2::256B prefetch": _k5(4, 256, "256B"),
    "kStages 4, streaming stores": _k5(4, streaming=True),
    "kStages 5": _k5(5),
    "kStages 6, L2::256B prefetch": _k5(6, prefetch="256B"),
    "kStages 6, kRows 192": _k5(6, 192),
    "kStages 6, kRows 64": _k5(6, 64),
    "kStages 7": _k5(7),
    "kStages 7, kRows 96": _k5(7, 96),
    "kStages 7, kRows 64": _k5(7, 64),
    "consumer unrolled by 2": _k5(unroll=2),
    "consumer unrolled by 32": _k5(unroll=32),
}
KERNELS = {"k6": ("psk_seq", K6_VARIANTS), "k5": ("cumsum0", K5_VARIANTS)}
REPS, RUNS = 20, 3


def build_all(trees, name, variants):
    """{(label, variant): library path}, every nvcc started together."""
    from webaudio_modem_tpu_torch.ops.kernels import _build

    root = _build.BUILD_DIR / "variants" / name
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for label, tree in trees:
        for i, (variant, (subs, flags)) in enumerate(variants.items()):
            src = root / label / str(i)
            shutil.copytree(Path(tree) / "webaudio_modem_tpu_torch" / "csrc",
                            src)
            for file, pattern, repl in subs:
                path = src / file
                text, count = re.subn(pattern, repl, path.read_text())
                if count == 0:
                    raise RuntimeError(f"{label} {variant}: {pattern!r} not "
                                       f"in {file}")
                path.write_text(text)
            lib = src / f"lib{name}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
                   str(lib), str(src / f"{name}.cu")]
            procs[label, variant] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = lib
    return libs


def k6_inputs(dev):
    import numpy as np

    import chip_smoke as cs
    from webaudio_modem_tpu_torch.ops import psk

    rng = np.random.default_rng(5)
    B = 4096
    pp = cs._psk_params()
    sig = psk.modulate_batch(pp, cs._messages(rng, B, 13), dev)
    chunks = [sig[:, i * cs.CHUNK:(i + 1) * cs.CHUNK]
              for i in range(sig.shape[1] // cs.CHUNK)]
    st1, _ = psk.demod_chunk(pp, 0, psk.init_state(pp, B, dev), chunks[0])
    cycled = psk.init_state(pp, B, dev)
    for i in range(28):
        cycled, _ = psk.demod_chunk(pp, 0, cycled, chunks[i % len(chunks)])
    return {
        "turns": (pp, *cs._psk_args(
            st1, 0, sig[:, cs.CHUNK:2 * cs.CHUNK].t().contiguous(), True)),
        "phase 11": (pp, *cs._psk_args(cycled, 0,
                                       chunks[0].t().contiguous(), True)),
    }


def shares(planes):
    """Zero and subnormal shares of each plane."""
    import torch

    tiny = torch.finfo(torch.float32).tiny
    parts = []
    for name, t in planes.items():
        a = t.float().abs()
        zero = float((a == 0).float().mean())
        sub = float(((a > 0) & (a < tiny)).float().mean())
        parts.append(f"{name} {100 * zero:.2f} % zero, "
                     f"{100 * sub:.4f} % subnormal")
    return "; ".join(parts)


def main(argv) -> int:
    trees = [t.partition("=")[::2] for t in argv[1:]]
    if not argv or argv[0] not in KERNELS or not trees or \
            any(not d for _, d in trees):
        print(__doc__, file=sys.stderr)
        return 2
    name, variants = KERNELS[argv[0]]
    trees = [(label, os.path.abspath(d)) for label, d in trees]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        end="", flush=True)
    import ctypes

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from webaudio_modem_tpu_torch.ops.kernels import _build, cumsum0, psk_seq

    dev = torch.device("cuda", 0)
    libs = {k: ctypes.CDLL(str(v))
            for k, v in build_all(trees, name, variants).items()}
    if name == "psk_seq":
        data = {k: (lambda a=a: psk_seq.seq(*a), a)
                for k, a in k6_inputs(dev).items()}
        for k, (_, a) in data.items():
            out = psk_seq.seq(*a)
            print(f"input {k}: T={a[6].shape[0]}; " + shares(
                {"x": a[6], "front": a[2], "ds_acc": a[3], "ring": a[4],
                 "amps": out[4], "softs": out[5]}), flush=True)
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(14)
        data = {}
        for n, B in cs.CSUM_SHAPES:
            x = torch.randn((n, B), generator=gen, device=dev)
            data[f"[{n}, {B}]"] = (lambda x=x: cumsum0.csum0(x), x)

    def timed(lib, fn):
        _build._libs[name] = lib
        for _ in range(3):
            fn()
        return min(cs._cuda_ms(fn, REPS) for _ in range(RUNS))

    order = [(label, v) for label, _ in trees for v in variants]
    order.append(order[0])
    for k, (fn, a) in data.items():
        ref = None
        for key in order:
            ms = timed(libs[key], fn)
            extra = ""
            if name == "cumsum0":
                out = fn()
                ref = out if ref is None else ref
                n_bytes = cs._csum_bound(*a.shape)[0]
                extra = (f" ({n_bytes / ms / 1e6:.1f} GB/s, "
                         f"{100 * n_bytes / cs.HBM_BYTES_PER_S * 1e3 / ms:.1f}"
                         f" % of the byte bound; output equal to the first: "
                         f"{torch.equal(out, ref)})")
                del out
            print(f"{k}, {key[0]}, {key[1]}: {ms:.4f} ms per launch{extra}",
                  flush=True)
    if name == "psk_seq":
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            for _ in range(REPS):
                data["phase 11"][0]()
            torch.cuda.synchronize()
        for k, (fn, _) in data.items():
            for label, _ in trees:
                print(f"after a profiler run: {k}, {label}, as built: "
                      f"{timed(libs[label, 'as built'], fn):.4f} ms per "
                      "launch", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
