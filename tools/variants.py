#!/usr/bin/env python3
"""Variants of one kernel source, built side by side and timed in turns.

    python3 tools/variants.py k3|k4|k5|k6|k8 LABEL=DIR [LABEL=DIR ...]

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
* ``k8`` — the framing kernels, K2 and K8 (the two output modes of
  ``csrc/fsk_framing.cu``), on the bench chunk's planes (``tools/turns.py
  framing``'s: n_ds = 2400, B = 4096): the step's changes reverted one by
  one (the counter's remainder by quarter in place of the carried phase,
  the float EOD compare in place of the integer one, both: the parent's
  step), a copy warp a block (K5's producer) in place of each lane's
  copies, the copies issued inside the step loop, the copy depth
  ``kAhead``, the step loop's unrolling, K8's planes staged in shared
  memory a tile at a time and drained with 16-byte stores, and
  knockouts (no plane stores, no input copies, neither),
  each the best of three runs of 20 launches in a CUDA graph, with a
  hash of its outputs; every build also in a twin whose threads read
  ``clock64()`` around the time loop, for the cycles a step (median and
  largest over the channels).  The last checkout's source is varied;
  each earlier checkout is one of the parent's layout (K2 in
  ``fsk_framing.cu`` and K8 in ``fsk_stage_d.cu`` with the packed word,
  the EOD compare's float in the coefficients), timed and profiled
  alike through its own C entries.
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
# K8 / K2: the step's changes reverted, copy depth, unrolling, staged
# plane stores, knockouts; "clock64" adds the time loop's cycles of each
# thread to ints_out[0] (started: outputs wrong, the profile's twin)
K8_CLOCK = [
    ("fsk_framing.cu",
     r"(\n  const int n_tiles = \(n_ds \+ kTile - 1\) / kTile;)",
     "\\1\n  const long long wam_t0 = clock64();"),
    ("fsk_framing.cu", r"(\n\s*sink\.close\(out, b\);)",
     "\\1\n  ints_out[b] = static_cast<int>(clock64() - wam_t0);"),
]
K8_REVERT_PHASE = ("framing_step.cuh", r"phase1 == 0 &&",
                   "counter1 % c.quarter == 0 &&")
# exact where eod_after is an integer (the bench's 560.0): the parent's
# conversion and float compare on the chain
K8_REVERT_EOD = ("framing_step.cuh", r"sil1 >= c\.eod_steps;",
                 "static_cast<float>(sil1) >= "
                 "static_cast<float>(c.eod_steps);")
# K8's planes staged in shared memory a tile at a time, drained after it
# by the stepping warp with 16-byte stores where B allows (a multiple of
# 16 and a whole block), else a lane's own column
K8_STAGED = [
    ("fsk_framing.cu", r"(      sink\.put\(out, t, i, ev\);\n    \})",
     """      if constexpr (kStaged<Sink>) {
        st_vals[u][lane] = ev.byte_val;
        st_flags[0][u][lane] = ev.emit;
        st_flags[1][u][lane] = ev.eod;
        st_flags[2][u][lane] = ev.fire;
      } else {
        sink.put(out, t, i, ev);
      }
    }
    if constexpr (kStaged<Sink>) {
      __syncwarp(__activemask());
      const int b0 = blockIdx.x * kThreads;
      const size_t row0 = static_cast<size_t>(k * kTile) * Bs + b0;
      if (B % 16 == 0 && b0 + kThreads <= B) {
        for (int q = lane; q < m * 8; q += kThreads) {
          const int u = q / 8, c4 = q % 8;
          *reinterpret_cast<uint4*>(sink.byte_vals + row0 + u * Bs + 4 * c4) =
              *reinterpret_cast<const uint4*>(&st_vals[u][4 * c4]);
        }
        for (int q = lane; q < 3 * m * 2; q += kThreads) {
          const int f = q / (2 * m), u = (q / 2) % m, h = q % 2;
          bool* plane = f == 0 ? sink.emits : f == 1 ? sink.eods : sink.fires;
          *reinterpret_cast<uint4*>(plane + row0 + u * Bs + 16 * h) =
              *reinterpret_cast<const uint4*>(&st_flags[f][u][16 * h]);
        }
      } else {
        for (int u = 0; u < m; ++u) {
          const size_t i = row0 + u * Bs + lane;
          sink.byte_vals[i] = st_vals[u][lane];
          sink.emits[i] = st_flags[0][u][lane];
          sink.eods[i] = st_flags[1][u][lane];
          sink.fires[i] = st_flags[2][u][lane];
        }
      }
      __syncwarp(__activemask());
    }"""),
    ("fsk_framing.cu", r"(  extern __shared__ unsigned char smem\[\];)",
     """\\1
  __shared__ __align__(16) int st_vals[kTile][kThreads];
  __shared__ __align__(16) unsigned char st_flags[3][kTile][kThreads];"""),
    ("fsk_framing.cu", r"(template <class Sink>\n__global__)",
     """template <class Sink>
constexpr bool kStaged = sizeof(Sink) == sizeof(Planes);

\\1"""),
]
# a copy warp a block (K5's producer): warp 1 copies the next tiles with
# 16-byte cp.async (4-byte where a row is not aligned; the bits' words
# at any offset), warp 0 steps; tiles handed over through named barriers
K8_COPYWARP_CONSTS = """\
constexpr int kLanes = 32;    // channels a block, one stepping lane each
constexpr int kThreads = 64;  // warp 0 runs the steps, warp 1 copies
constexpr int kTile = 16;     // steps per tile
constexpr int kAhead = 2;     // tiles copied ahead of the one stepped
constexpr int kSlots = kAhead + 1;
// the 4-byte words that hold a row's 32 bf16 bits at any offset
constexpr int kBitWords = kLanes / 2 + 1;
// a slot: amps, ratios, delayed amps f32 [3][kTile][kLanes], then the
// bits' words [kTile][kBitWords]; 7232 bytes, a multiple of 16
constexpr int kSlotWords = 3 * kTile * kLanes + kTile * kBitWords;
constexpr size_t kSmem = sizeof(unsigned) * kSlots * kSlotWords;

// named barriers 1 .. 2 * kSlots
__device__ __forceinline__ int full(int s) { return 1 + s; }
__device__ __forceinline__ int empty(int s) { return 1 + kSlots + s; }
static_assert(2 * kSlots <= 15, "named barrier ids");

"""
K8_COPYWARP_KERNEL = """\
template <class Sink>
__global__ void __launch_bounds__(kThreads)
fsk_framing_kernel(const __nv_bfloat16* __restrict__ bits,
                   const float* __restrict__ amps,
                   const float* __restrict__ ratios,
                   const float* __restrict__ sub_amps, int n_ds, int B,
                   const int* __restrict__ ints_in,
                   const float* __restrict__ flts_in,
                   const int* __restrict__ bit_fill,
                   int* __restrict__ ints_out, float* __restrict__ flts_out,
                   const Sink sink, const FskFramingCoef c) {
  // [kSlots][kSlotWords]; the dynamic shared memory base is 16-byte
  // aligned, so is every 4-channel piece of an f32 row
  extern __shared__ unsigned char smem[];
  unsigned* const sm = reinterpret_cast<unsigned*>(smem);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b0 = blockIdx.x * kLanes;
  const int n_live = min(kLanes, B - b0);
  const size_t Bs = static_cast<size_t>(B);
  const int n_tiles = (n_ds + kTile - 1) / kTile;

  if (warp == 1) {
    // lane: f32 piece lane % 8 (4 channels, 16 bytes) of every 4th row
    // from lane / 8; bit words flattened over the tile's rows
    const int piece = lane % 8;
    const int cp = b0 + 4 * piece;
    auto copy_tile = [&](int k) {
      if (k < n_tiles) {
        unsigned* slot = sm + (k % kSlots) * kSlotWords;
        const int t0 = k * kTile;
        const int m = min(kTile, n_ds - t0);
        for (int p = 0; p < 3; ++p) {
          const float* plane = p == 0 ? amps : p == 1 ? ratios : sub_amps;
          for (int u = lane / 8; u < m && cp < B; u += 4) {
            const float* src = plane + static_cast<size_t>(t0 + u) * Bs + cp;
            unsigned* dst = slot + (p * kTile + u) * kLanes + 4 * piece;
            if (cp + 4 <= B && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
              wam::cp_async16(dst, src);
            } else {
              for (int e = 0; e < 4 && cp + e < B; ++e)
                wam::cp_async4(dst + e, src + e);
            }
          }
        }
        unsigned* words = slot + 3 * kTile * kLanes;
        for (int q = lane; q < m * kBitWords; q += 32) {
          const int u = q / kBitWords, w = q % kBitWords;
          const char* row = reinterpret_cast<const char*>(
              bits + static_cast<size_t>(t0 + u) * Bs + b0);
          const int odd = static_cast<int>(
              (reinterpret_cast<uintptr_t>(row) >> 1) & 1);
          if (2 * w < odd + n_live)   // word w holds a live channel's bit
            wam::cp_async4(words + u * kBitWords + w, row - 2 * odd + 4 * w);
        }
      }
      wam::cp_async_commit();
    };
    for (int k = 0; k < kAhead; ++k) copy_tile(k);
    for (int k = 0; k < n_tiles; ++k) {
      // groups 0..k have landed once at most kAhead - 1 are pending
      wam::cp_async_wait<kAhead - 1>();
      wam::bar_arrive(full(k % kSlots), kThreads);
      // tile k + kAhead goes into the slot tile k - 1 held
      const int ahead = k + kAhead;
      if (ahead < n_tiles && ahead >= kSlots)
        wam::bar_sync(empty(ahead % kSlots), kThreads);
      copy_tile(ahead);
    }
    return;
  }

  // lanes past B step on whatever the slots hold and store nothing, so
  // that every barrier sees the whole warp
  const int b = b0 + lane;
  const bool live = lane < n_live;
  wam::FramingCarry s = {};
  int fill0 = 0;
  typename Sink::Lane out = {};
  if (live) {
    s = wam::framing_load(ints_in, flts_in, Bs, b, c);
    fill0 = bit_fill[b];
    out = sink.open(b);
  }
  // the element offset of bits[0] within its 4-byte word (0 or 1)
  const size_t bits_odd = (reinterpret_cast<size_t>(bits) >> 1) & 1;

  for (int k = 0; k < n_tiles; ++k) {
    const int sl = k % kSlots;
    wam::bar_sync(full(sl), kThreads);
    const unsigned* src = sm + sl * kSlotWords + lane;
    const unsigned short* halves = reinterpret_cast<const unsigned short*>(
        sm + sl * kSlotWords + 3 * kTile * kLanes);
    const int m = min(kTile, n_ds - k * kTile);
    // unrolled, so that a step's shared-memory loads go out under the
    // steps before it (PERF.md)
#pragma unroll 8
    for (int u = 0; u < m; ++u) {
      const int t = k * kTile + u;
      const size_t i = static_cast<size_t>(t) * Bs + b;
      const int odd = static_cast<int>((bits_odd + i - lane) & 1);
      // a bf16's bits are the top half of its f32
      const float bit_f = __uint_as_float(
          static_cast<unsigned>(halves[2 * u * kBitWords + odd + lane]) << 16);
      const bool gate = fill0 + (t + 1) >= c.sync_window;
      const wam::FramingEvents ev = wam::framing_step(
          s, __uint_as_float(src[(0 * kTile + u) * kLanes]),
          __uint_as_float(src[(2 * kTile + u) * kLanes]),
          __uint_as_float(src[(1 * kTile + u) * kLanes]),
          static_cast<int>(bit_f), gate, c);
      if (live) sink.put(out, t, i, ev);
    }
    if (k + kSlots < n_tiles) wam::bar_arrive(empty(sl), kThreads);
  }

  if (live) {
    wam::framing_store(s, ints_out, flts_out, Bs, b);
    sink.close(out, b);
  }
}

"""
K8_COPYWARP = [
    ("fsk_framing.cu", r"(?s)constexpr int kThreads = 32;.*?"
     r"constexpr int kSlotWords = 4 \* kTile \* kThreads;\n\n",
     K8_COPYWARP_CONSTS),
    ("fsk_framing.cu",
     r"(?s)template <class Sink>\n__global__.*?\n\}\n\n"
     r"(?=template <class Sink>\nint launch)", K8_COPYWARP_KERNEL),
    ("fsk_framing.cu", r"const int blocks = \(B \+ kThreads - 1\) / kThreads;"
     r"\n  const size_t smem = [^;]+;[^\n]*",
     "const int blocks = (B + kLanes - 1) / kLanes;\n"
     "  const size_t smem = kSmem;"),
    ("fsk_framing.cu", r"#include <cuda_bf16.h>\n",
     "#include <cuda_bf16.h>\n#include <stdint.h>\n"),
]
# the next tiles' copies issued inside the step loop, a step's four
# under each step's chain, in place of a tile's at once before it
K8_INLOOP = ("fsk_framing.cu",
             r"(?s)  const int n_tiles = .*?\n(?=\n  wam::framing_store)",
             """  const int n_tiles = (n_ds + kTile - 1) / kTile;
  // step t's four words into slot (t / kTile) % kSlots
  auto copy_step = [&](int t, size_t i) {
    unsigned* dst = sm + ((t / kTile) % kSlots) * kSlotWords +
                    (t % kTile) * kThreads + lane;
    wam::cp_async4(dst + 0 * kTile * kThreads, amps + i);
    wam::cp_async4(dst + 1 * kTile * kThreads, ratios + i);
    wam::cp_async4(dst + 2 * kTile * kThreads, sub_amps + i);
    wam::cp_async4(dst + 3 * kTile * kThreads,
                   bits + i - ((bits_odd + i) & 1));
  };
  for (int k = 0; k < kAhead; ++k) {
    for (int t = k * kTile; t < min(n_ds, (k + 1) * kTile); ++t)
      copy_step(t, static_cast<size_t>(t) * Bs + b);
    wam::cp_async_commit();
  }
  const size_t ahead = static_cast<size_t>(kAhead * kTile) * Bs;
  for (int k = 0; k < n_tiles; ++k) {
    wam::cp_async_wait<kAhead - 1>();
    const unsigned* src = sm + (k % kSlots) * kSlotWords + lane;
    const int m = min(kTile, n_ds - k * kTile);
#pragma unroll 4
    for (int u = 0; u < m; ++u) {
      const int t = k * kTile + u;
      const size_t i = static_cast<size_t>(t) * Bs + b;
      if (t + kAhead * kTile < n_ds) copy_step(t + kAhead * kTile, i + ahead);
      const unsigned word = src[(3 * kTile + u) * kThreads];
      const float bit_f = __uint_as_float(
          ((bits_odd + i) & 1 ? word >> 16 : word & 0xFFFFu) << 16);
      const bool gate = fill0 + (t + 1) >= c.sync_window;
      const wam::FramingEvents ev = wam::framing_step(
          s, __uint_as_float(src[(0 * kTile + u) * kThreads]),
          __uint_as_float(src[(2 * kTile + u) * kThreads]),
          __uint_as_float(src[(1 * kTile + u) * kThreads]),
          static_cast<int>(bit_f), gate, c);
      sink.put(out, t, i, ev);
    }
    wam::cp_async_commit();
  }
""")


def _unroll(u):
    return ("fsk_framing.cu",
            r"#pragma unroll \d+(?=\n    for \(int u = 0; u < m; \+\+u\) "
            r"\{\n      const int t)", f"#pragma unroll {u}")


# the copy loop of a tile (as built: its pointers step a row, unrolled by
# 4): each row's index computed, that loop unrolled whole for a full
# tile, or another unrolling
_K8_COPY_LOOP = (r"(?s)      const size_t i0 = static_cast<size_t>\(k \* kTile\)"
                 r" \* Bs \+ b;\n.*?\n      \}\n(?=    \}\n)")
# the copy loop before: each row's index a 64-bit product
K8_COPY_INDEXED = ("fsk_framing.cu", _K8_COPY_LOOP, """\
      for (int u = 0; u < m; ++u) {
        const size_t i = static_cast<size_t>(k * kTile + u) * Bs + b;
        wam::cp_async4(dst + (0 * kTile + u) * kThreads, amps + i);
        wam::cp_async4(dst + (1 * kTile + u) * kThreads, ratios + i);
        wam::cp_async4(dst + (2 * kTile + u) * kThreads, sub_amps + i);
        wam::cp_async4(dst + (3 * kTile + u) * kThreads,
                       bits + i - ((bits_odd + i) & 1));
      }
""")
K8_COPY_FULL = ("fsk_framing.cu", _K8_COPY_LOOP, """\
      auto copy_step = [&](int u) {
        const size_t i = static_cast<size_t>(k * kTile + u) * Bs + b;
        wam::cp_async4(dst + (0 * kTile + u) * kThreads, amps + i);
        wam::cp_async4(dst + (1 * kTile + u) * kThreads, ratios + i);
        wam::cp_async4(dst + (2 * kTile + u) * kThreads, sub_amps + i);
        wam::cp_async4(dst + (3 * kTile + u) * kThreads,
                       bits + i - ((bits_odd + i) & 1));
      };
      if (m == kTile) {
#pragma unroll
        for (int u = 0; u < kTile; ++u) copy_step(u);
      } else {
        for (int u = 0; u < m; ++u) copy_step(u);
      }
""")
def _copy_strided(unroll):
    return ("fsk_framing.cu", _K8_COPY_LOOP, """\
      const size_t i0 = static_cast<size_t>(k * kTile) * Bs + b;
      const float* a = amps + i0;
      const float* r = ratios + i0;
      const float* sa = sub_amps + i0;
      size_t odd = (bits_odd + i0) & 1;
      const __nv_bfloat16* bw = bits + i0 - odd;
      const size_t flip = Bs & 1;
#pragma unroll %d
      for (int u = 0; u < m; ++u) {
        wam::cp_async4(dst + (0 * kTile + u) * kThreads, a);
        wam::cp_async4(dst + (1 * kTile + u) * kThreads, r);
        wam::cp_async4(dst + (2 * kTile + u) * kThreads, sa);
        wam::cp_async4(dst + (3 * kTile + u) * kThreads, bw);
        a += Bs;
        r += Bs;
        sa += Bs;
        bw += Bs + odd - (odd ^ flip);
        odd ^= flip;
      }
""" % unroll)


# knockouts: outputs wrong, the time says what the part costs
K8_NO_STORES = ("fsk_framing.cu", r"    byte_vals\[i\] = ev\.byte_val;\n"
                r"    emits\[i\] = ev\.emit;\n    eods\[i\] = ev\.eod;\n"
                r"    fires\[i\] = ev\.fire;\n", "")
K8_NO_COPIES = ("fsk_framing.cu",
                r"        wam::cp_async4\(dst \+ \(\d \* kTile \+ u\) "
                r"\* kThreads,\s+[^;]+;", "")
K8_VARIANTS = {
    "as built": ([], []),
    "copy warp": (K8_COPYWARP, []),
    "copies in the step loop": ([K8_INLOOP], []),
    "copy loop indexing each row": ([K8_COPY_INDEXED], []),
    "copy loop indexing each row, unrolled for a full tile": (
        [K8_COPY_FULL], []),
    **{f"copy loop unrolled by {u}": ([_copy_strided(u)], [])
       for u in (1, 2, 8)},
    "revert: remainder by quarter": ([K8_REVERT_PHASE], []),
    "revert: float EOD compare": ([K8_REVERT_EOD], []),
    "revert both (the parent's step)": ([K8_REVERT_PHASE, K8_REVERT_EOD],
                                        []),
    **{f"kAhead {a}": ([("fsk_framing.cu", r"kAhead = \d+;",
                         f"kAhead = {a};")], []) for a in (1, 3, 4)},
    **{f"step loop unrolled by {u}": ([_unroll(u)], [])
       for u in (1, 2, 4, 16)},
    "K8 staged stores": (K8_STAGED, []),
    "knockout: no plane stores": ([K8_NO_STORES], []),
    "knockout: no input copies": ([K8_NO_COPIES], []),
    "knockout: no input copies, no plane stores": (
        [K8_NO_COPIES, K8_NO_STORES], []),
}
K8_VARIANTS.update({f"{k} + clock64": (subs + K8_CLOCK, flags)
                    for k, (subs, flags) in list(K8_VARIANTS.items())})
# the parent's layout: K8's packed word from fsk_stage_d.cu, its time
# loop profiled alike
K8_PARENT_VARIANTS = {
    "as built": ([], []),
    "as built + clock64": ([
        ("fsk_framing.cu", r"(  const int fill0 = bit_fill\[b\];)",
         "\\1\n  const long long wam_t0 = clock64();"),
        ("fsk_framing.cu", r"(  fire_t\[b\] = last_fire;)",
         "\\1\n  ints_out[b] = static_cast<int>(clock64() - wam_t0);"),
        ("fsk_stage_d.cu", r"(  const int fill0 = bit_fill\[b\];)",
         "\\1\n  const long long wam_t0 = clock64();"),
        ("fsk_stage_d.cu", r"(  wam::framing_store\(s, ints_out, flts_out, "
         r"Bs, b\);)",
         "\\1\n  ints_out[b] = static_cast<int>(clock64() - wam_t0);")],
        []),
}
KERNELS = {"k6": ("psk_seq", K6_VARIANTS), "k5": ("cumsum0", K5_VARIANTS),
           "k4": ("align", K4_VARIANTS), "k3": ("viterbi", K3_VARIANTS),
           "k8": ("fsk_framing", K8_VARIANTS)}
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


def k8_inputs(dev):
    """(params, (ints, flts, bit_fill, bits, amps, ratios, sub_amps)): the
    bench chunk's stage-D operands at B = 4096, as ``tools/turns.py
    framing`` makes them."""
    import numpy as np

    import chip_smoke as cs
    from webaudio_modem_tpu_torch.models.config import FSKParams
    from webaudio_modem_tpu_torch.ops import fsk_demod, fsk_mod

    B = 4096
    params = FSKParams.from_config(cs._bench_config())
    sig = fsk_mod.modulate_batch(
        params, cs._messages(np.random.default_rng(5), B, 13), dev)
    state, _ = fsk_demod.demod_chunk(
        params, 0, fsk_demod.init_state(params, B, dev), sig[:, :cs.CHUNK])
    planes = cs._stage_d_inputs(
        params, state, sig[:, cs.CHUNK:2 * cs.CHUNK].t().contiguous())
    ints, flts = fsk_demod._framing_carry(params, state)
    return params, (ints, flts, state.bit_fill, *planes)


def k8_launchers(k2_lib, k8_lib, parent, params, args):
    """{"K2": launch, "K8": launch}, each launching one build's kernel on
    ``args`` into outputs made once and returning them; ``parent``: the
    parent's C entries (K8's packed word, the float EOD in the
    coefficients)."""
    import ctypes

    import numpy as np
    import torch

    from webaudio_modem_tpu_torch.ops import fsk_demod
    from webaudio_modem_tpu_torch.ops.kernels import _build, fsk_framing

    ints, flts, bit_fill, bits, amps, ratios, sub = args
    n, B = bits.shape
    maxb = fsk_demod.max_bytes(params, n)
    new = dict(device=bits.device)
    c = fsk_framing._kernel_coef(params)
    if parent:
        class Coef(ctypes.Structure):
            _fields_ = [(name, ctypes.c_int) for name in (
                "ds_per_bit", "quarter", "stop_pos", "parity_on",
                "amp_window", "sync_window", "wrap")] + [
                ("eod_after", ctypes.c_float), ("sync_thr", ctypes.c_float)]
        coef = Coef(c.ds_per_bit, c.quarter, c.stop_pos, c.parity_on,
                    c.amp_window, c.sync_window, c.wrap,
                    float(np.float32(params.samples_for_eod)), c.sync_thr)
        planes = [torch.empty((n, B), dtype=torch.int32, **new)]
    else:
        coef = c
        planes = [torch.empty((n, B), dtype=torch.int32, **new),
                  *torch.empty((3, n, B), dtype=torch.bool, **new)]

    def carry():
        return [torch.empty((10, B), dtype=torch.int32, **new),
                torch.empty((2, B), dtype=torch.float32, **new)]
    k2_out = carry() + [torch.empty((B, maxb), dtype=torch.uint8, **new),
                        *torch.empty((4, B), dtype=torch.int32, **new)]
    k8_out = carry() + planes
    vp, ci = ctypes.c_void_p, ctypes.c_int
    f2, f8 = k2_lib.wam_fsk_framing, k8_lib.wam_fsk_stage_d
    f2.argtypes = [vp] * 4 + [ci, ci] + [vp] * 6 + [ci] + [vp] * 6
    f8.argtypes = [vp] * 4 + [ci, ci] + [vp] * (7 + len(planes))
    f2.restype = f8.restype = ci
    p = _build.ptr
    ins = [p(x) for x in (bits, amps, ratios, sub)]
    carry_in = [p(x) for x in (ints, flts, bit_fill)]
    coef_p = ctypes.c_void_p(ctypes.addressof(coef))

    def k2():
        _build.raise_on_error(f2(
            *ins, n, B, *carry_in, *map(p, k2_out[:3]), maxb,
            *map(p, k2_out[3:]), coef_p, _build.stream()), "K2")
        return k2_out

    def k8():
        _build.raise_on_error(f8(
            *ins, n, B, *carry_in, *map(p, k8_out), coef_p,
            _build.stream()), "K8")
        return k8_out
    k2.coef = k8.coef = coef      # kept alive with the launchers
    return {"K2": k2, "K8": k8}


def k8_run(dev, trees):
    """Build and time ``K8_VARIANTS`` of the last checkout and
    ``K8_PARENT_VARIANTS`` of the others, in turns, with each clock64
    twin's cycles a step."""
    import ctypes
    import hashlib

    import torch

    import chip_smoke as cs

    params, args = k8_inputs(dev)
    n = args[3].shape[0]
    libs = {}
    for label, tree in trees[:-1]:
        for name in ("fsk_framing", "fsk_stage_d"):
            for (lb, variant), path in build_all(
                    [(label, tree)], name, K8_PARENT_VARIANTS).items():
                libs.setdefault((lb, variant), {})[name] = \
                    ctypes.CDLL(str(path))
    for key, path in build_all(trees[-1:], "fsk_framing",
                               K8_VARIANTS).items():
        lib = ctypes.CDLL(str(path))
        libs[key] = {"fsk_framing": lib, "fsk_stage_d": lib}
    parents = {label for label, _ in trees[:-1]}
    launchers = {key: k8_launchers(lib["fsk_framing"], lib["fsk_stage_d"],
                                   key[0] in parents, params, args)
                 for key, lib in libs.items()}

    def digest(outs):
        h = hashlib.sha256()
        for o in outs:
            h.update(o.cpu().contiguous().view(torch.uint8).numpy()
                     .tobytes())
        return h.hexdigest()[:16]

    timed = [k for k in libs if not k[1].endswith("clock64")]
    best = {}
    for key in timed + timed[::-1]:
        for kernel, fn in launchers[key].items():
            for _ in range(3):
                fn()
            ms = min(cs._graph_ms(fn, REPS) for _ in range(RUNS))
            best[key, kernel] = min(best.get((key, kernel), ms), ms)
    for key in timed:
        for kernel, fn in launchers[key].items():
            if kernel == "K8" and key[0] in parents:
                outs = fn()
                packed = outs[2]
                outs = outs[:2] + [packed & 0xFF, *((packed >> s & 1).bool()
                                                  for s in (8, 9, 10))]
            else:
                outs = fn()
            print(f"{kernel} n_ds={n} B={args[3].shape[1]}, {key[0]}, "
                  f"{key[1]}: best {best[key, kernel]:.4f} ms; outputs "
                  f"sha256 {digest(outs)}", flush=True)
    for key in libs:
        if not key[1].endswith("clock64"):
            continue
        for kernel, fn in launchers[key].items():
            cycles = fn()[0][0].double() / max(n, 1)
            print(f"{kernel}, {key[0]}, {key[1]}: the time loop's cycles a "
                  f"step over the channels: median "
                  f"{float(cycles.median()):.1f}, largest "
                  f"{float(cycles.max()):.1f}", flush=True)


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
    if name == "fsk_framing":
        k8_run(dev, trees)
        return 0
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
