#!/usr/bin/env python3
"""Variants of one kernel source, built side by side and timed in turns.

    python3 tools/variants.py k3|k4|k5|k6 LABEL=DIR [LABEL=DIR ...]

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
* ``k3`` — K3's ladder of group widths: every (threads a trellis,
  records in shared or device memory) for widths 1, 2, 4, 8, 16 and 32
  (the source substitutions ``K3_LADDER`` add the widths that the
  shipped source leaves out), timed in turns (the ladder, then again in
  reverse) on the soft decode's header and body trellises (B = 4096:
  L = 32,768, T = 38; L = 4096, T = 150) and on 2048 payload-100 bodies
  (T = 822) for every variant, then on the as-built build at
  ``K3_MORE_SHAPES`` (the streaming decoder's 61 header candidates and
  single bodies, 128 to 16,384 bodies, 4096 to 16,384 header
  candidates), each the best of three runs of 20 launches in a CUDA
  graph (``chip_smoke._graph_ms``), with the wrapper's own pick marked
  and every output equal to the pick's.  Before it, each checkout's
  ``csrc/viterbi.cu`` is built once and its ``ptxas`` report (registers,
  spills, shared memory) printed; only this checkout's builds are
  timed.
* ``k4`` — K4's run length: ``kRun`` outputs a thread (2 to 32), and a
  build that never chains (two loads an output, the reuse left to L1),
  on the header (1532 x 4096, stride 1) and body (300 x 4096, stride ds)
  windows of the soft decode, each the best of three runs of 20 launches
  in a CUDA graph, with the byte bound (``_align_bytes`` at 3.35 TB/s)
  and the outputs' equality with the as-built build.
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
K4_VARIANTS = {
    "as built": ([], []),
    **{f"kRun {j}": ([("align.cu", r"kRun = \d+;", f"kRun = {j};")], [])
       for j in (2, 4, 16, 32)},
    "never chained (L1 alone)": (
        [("align.cu", r"const bool chain = ds % stride == 0;",
          "const bool chain = false;")], []),
}
# K3's ladder: the shipped source instantiates the widths the wrapper
# picks (1, 8, 32); these substitutions add 2, 4 and 16 (the pieces of a
# record for 2 and 4, ballots masked to a half warp for 16, the steps
# loaded ahead for 2), leaving the shipped widths' code as it is
K3_WIDTHS = (1, 2, 4, 8, 16, 32)
K3_LADDER = [
    ("viterbi.cu", r"template <> struct Piece<8>",
     "template <> struct Piece<2> { typedef uint32_t type; };\n"
     "template <> struct Piece<4> { typedef uint16_t type; };\n"
     "template <> struct Piece<8>"),
    ("viterbi.cu", r"return G == 1 \? 2 : 16;",
     "return G == 1 ? 2 : G == 2 ? 8 : 16;"),
    ("viterbi.cu", r"return G < 32 \? s :", "return G <= 8 ? s :"),
    ("viterbi.cu", r"if constexpr \(G == 32\) \{", "if constexpr (G >= 16) {"),
    ("viterbi.cu", r"const uint32_t w = (__ballot_sync\(kFull, \(dec >> o\) "
     r"& 1u\));",
     "uint32_t w = \\1;\n"
     "        if constexpr (G == 16) w = (w >> (threadIdx.x & 16)) & 0xffffu;"),
    ("viterbi.cu", r"(    default:\n      return static_cast<int>"
     r"\(cudaErrorInvalidValue\);)",
     "".join(f"    case {g}:\n      return launch_g<{g}>(shared, soft, T, L, "
             "s_lane, s_step, s_pair, dec, bits, s);\n" for g in (2, 4, 16))
     + "\\1"),
]


def _k3(ahead=None, min_blocks=None):
    """K3's substitutions: the steps loaded ahead for G = 1, 2 and wider;
    a minimum of blocks an SM in the launch bounds (a register cap)."""
    subs = []
    if ahead:
        subs.append(("viterbi.cu",
                     r"return G == 1 \? \d+ : G == 2 \? \d+ : \d+;",
                     "return G == 1 ? {} : G == 2 ? {} : {};".format(*ahead)))
    if min_blocks:
        subs.append(("viterbi.cu", r"__launch_bounds__\(kThreads\)\n"
                     r"viterbi_kernel",
                     f"__launch_bounds__(kThreads, {min_blocks})\n"
                     "viterbi_kernel"))
    return subs, []


K3_VARIANTS = {
    "as built": ([], []),
    "ahead 2, 4, 8": _k3((2, 4, 8)),
    "blocks of 32 threads": (
        [("viterbi.cu", r"kThreads = 128;", "kThreads = 32;")], []),
    "compare and select, not sign and max": (
        [("viterbi.cu", r"nw\[2 \* i\] = fmaxf\(c00, c01\);",
          "nw[2 * i] = c01 > c00 ? c01 : c00;"),
         ("viterbi.cu", r"nw\[2 \* i \+ 1\] = fmaxf\(c10, c11\);",
          "nw[2 * i + 1] = c11 > c10 ? c11 : c10;")], []),
    # knockouts: bits wrong, the time says what the part costs
    "knockout: no traceback": (
        [("viterbi.cu", r"if \(!active \|\| k != 0\) return;", "return;")],
        []),
    "knockout: inputs not loaded": (
        [("viterbi.cu", r"  if \(pair_vec\) \{",
          "  if (true) {\n    x0 = 0.5f;\n    x1 = -0.25f;\n    return;")],
        []),
    "knockout: no record stores": (
        [("viterbi.cu", r"bool store,\s+unsigned long long\* rec\) \{",
          "bool, unsigned long long* rec) {\n  const bool store = false;")],
        []),
}
K3_VARIANTS = {k: (K3_LADDER + subs, flags)
               for k, (subs, flags) in K3_VARIANTS.items()}
# K3's shapes beyond the soft decode's three, timed on the as-built
# ladder only: (name, L, T, soft-view layout)
K3_MORE_SHAPES = (
    ("SoftFrameDecoder header candidates", 61, 38, "header"),
    ("SoftFrameDecoder 16-byte body", 1, 150, "header"),
    ("SoftFrameDecoder 255-byte body", 1, 2062, "header"),
    *((f"{L} bodies", L, 150, "body")
      for L in (128, 256, 512, 768, 1024, 6144, 8192, 16384)),
    *((f"{L} payload-100 bodies", L, 822, "body") for L in (256, 768, 1024)),
    *((f"{L} header candidates", L, 38, "header")
      for L in (4096, 6144, 8192, 16384)),
)
KERNELS = {"k6": ("psk_seq", K6_VARIANTS), "k5": ("cumsum0", K5_VARIANTS),
           "k4": ("align", K4_VARIANTS), "k3": ("viterbi", K3_VARIANTS)}
REPS, RUNS = 20, 3


def build_all(trees, name, variants, logs=None):
    """{(label, variant): library path}, every nvcc started together;
    ``logs`` (a dict) receives each build's compiler output."""
    from webaudio_modem_tpu_torch.ops.kernels import _build

    root = _build.BUILD_DIR / "variants" / name
    procs = {}
    for label, tree in trees:
        shutil.rmtree(root / label, ignore_errors=True)
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
        if logs is not None:
            logs[key] = log
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


def soft_inputs(dev):
    """The soft decode's planes at B = 4096 (``chip_smoke._soft_planes``)
    and 2048 payload-100 bodies."""
    import numpy as np

    import chip_smoke as cs

    rng = np.random.default_rng(8)
    params = cs._soft_params()
    _, noisy = cs._soft_batch(params, rng, 4096, dev)
    planes = cs._soft_planes(params, noisy)
    planes["payload-100"] = cs._long_trellis(rng, 2048, dev)[:2]
    return planes


def k3_ladder(dev, libs, label):
    """Every width of ``K3_WIDTHS`` and record placement, in turns, at the
    soft decode's three trellis shapes for each variant built from
    checkout ``label``, then at ``K3_MORE_SHAPES`` for the as-built one."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from webaudio_modem_tpu_torch.ops.kernels import _build, viterbi

    planes = soft_inputs(dev)
    rng = np.random.default_rng(9)
    builds = [key for key in libs if key[0] == label]
    shapes = [(name, *planes[name], builds)
              for name in ("header", "body", "payload-100")]
    for name, L, T, layout in K3_MORE_SHAPES:
        shapes.append((f"{name}", cs._k3_soft(rng, L, T, layout, False, dev),
                       T - 6, builds[:1]))
    for name, soft, n, keys in shapes:
        L, T = soft.shape[:2]
        pick = viterbi.pick(L, T)
        _build._libs["viterbi"] = libs[builds[0]]
        ref = viterbi.decode(soft, n)
        order = [(key, (g, sh)) for key in keys for g in K3_WIDTHS
                 for sh in (True, False)
                 if not sh or T <= viterbi.shared_max_steps(g)]
        best = {}
        for key, inst in order + order[::-1]:
            _build._libs["viterbi"] = libs[key]
            fn = (lambda g=inst[0], sh=inst[1]:
                  viterbi._launch(soft, g, sh))
            if not key[1].startswith("knockout") and \
                    not torch.equal(fn()[:n].t(), ref):
                raise RuntimeError(f"K3 {name} {key} {inst}: bits differ")
            for _ in range(3):
                fn()
            ms = min(cs._graph_ms(fn, REPS) for _ in range(RUNS))
            best[key, inst] = min(best.get((key, inst), ms), ms)
        for key, inst in sorted(best, key=best.get):
            print(f"K3 {name} L={L} T={T}, {key[1]}, threads {inst[0]}, "
                  f"records in {'shared' if inst[1] else 'device'} memory: "
                  f"best {best[key, inst]:.4f} ms"
                  f"{' (the pick)' if inst == pick else ''}", flush=True)


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
    from webaudio_modem_tpu_torch.ops.kernels import (_build, align, cumsum0,
                                                      psk_seq)

    dev = torch.device("cuda", 0)
    logs = {}
    if name == "viterbi":     # the variants of this checkout, the others'
        built = build_all(trees[:-1], name, {"as built": ([], [])}, logs)
        built.update(build_all(trees[-1:], name, variants, logs))
    else:
        built = build_all(trees, name, variants, logs)
    libs = {k: ctypes.CDLL(str(v)) for k, v in built.items()}
    if name == "viterbi":
        for (label, variant), log in logs.items():
            if variant != "as built":
                continue
            for line in log.splitlines():
                if "ptxas info" in line and ("Used" in line or
                                             "Compiling" in line or
                                             "spill" in line):
                    print(f"{label} {line.strip()}", flush=True)
                elif "bytes stack frame" in line:
                    print(f"{label} {line.strip()}", flush=True)
        k3_ladder(dev, {k: v for k, v in libs.items()
                        if k[0] == trees[-1][0]}, trees[-1][0])
        return 0
    if name == "psk_seq":
        data = {k: (lambda a=a: psk_seq.seq(*a), a)
                for k, a in k6_inputs(dev).items()}
        for k, (_, a) in data.items():
            out = psk_seq.seq(*a)
            print(f"input {k}: T={a[6].shape[0]}; " + shares(
                {"x": a[6], "front": a[2], "ds_acc": a[3], "ring": a[4],
                 "amps": out[4], "softs": out[5]}), flush=True)
    elif name == "align":
        planes = soft_inputs(dev)
        csum = planes["csum"]
        data = {}
        for k, (base, _, kw) in planes["align_calls"].items():
            data[f"{k} {kw['n_out']} x 4096, stride {kw['stride']}"] = (
                lambda base=base, kw=kw: align.aligned_wsum(csum, base,
                                                            **kw),
                cs._align_bytes(csum, base, **kw))
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
        if name == "align":     # device time, no host gaps
            return min(cs._graph_ms(fn, REPS) for _ in range(RUNS))
        return min(cs._cuda_ms(fn, REPS) for _ in range(RUNS))

    order = [(label, v) for label, _ in trees for v in variants]
    order.append(order[0])
    for k, (fn, a) in data.items():
        ref = None
        for key in order:
            ms = timed(libs[key], fn)
            extra = ""
            if name == "align":
                out = fn()
                ref = out if ref is None else ref
                extra = (f" ({100 * a / cs.HBM_BYTES_PER_S * 1e3 / ms:.1f}"
                         f" % of the byte bound; output equal to the first: "
                         f"{torch.equal(out, ref)})")
                del out
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
