// K2 and K8 — the framing state machine (stage D) in two output modes of
// one kernel body.
//
// Replaces webaudio_modem_tpu/ops/pallas/fsk_framing.py `_kernel_compact`
// (K2, through `_stage_d_compact_call` / `stage_d_compact`) and `_kernel`
// (K8, through `_stage_d_call` / `stage_d`).  Each step runs
// ops/fsk_demod.py `_d_step` (framing_step.cuh): silence EOD, sync firing
// gated on the bit-window fill, majority-vote bit decisions, UART byte
// assembly and the fused rolling amplitude-window mean.  The output mode
// is a template parameter, the sink:
//
// * Compact (K2): the decoded bytes, packed per channel from slot 0 and
//   stored straight to bytes_out[b][cursor] (no slot bound: the TPU
//   kernel's MAX_SLOTS has no counterpart), the counts of bytes, EODs and
//   fires, and the step of the last fire (-1 for none).
// * Planes (K8): the four planes of `stage_d_plain`'s contract, byte_vals
//   i32 and emits / eods / fires bool [n_ds, B]: each step's byte register
//   before the step (the decoded byte where emit is set) and its events,
//   stored from the step loop (a warp writes 128 B and three 32 B rows a
//   step; the TPU's packed word existed because Mosaic could not write the
//   planes, and unpacking it took a third of the old wrapper's time).
//
// Design.  One thread per channel; the 10 int and 2 float carries (and
// the counter's quarter phase) live in registers and the time loop runs
// inside the thread.  Inputs are time-major [n_ds, B].  The thread copies
// its own column of the four input planes into shared memory with
// cp.async (warp_pipe.cuh), kAhead tiles of kTile steps ahead of the step
// it computes, so no load's round trip lands on the state machine's
// chain.  A bf16 bit sits in a 4-byte word with its neighbour: the thread
// copies the aligned word that holds it and takes its half, so rows of
// the bits plane need no alignment and every B and base offset is taken;
// a thread reads only what it copied, so no barrier is needed and lanes
// past B return at once.
//
// What bounds it on an H100.  A step is ~40 dependent integer/compare ops
// per channel, and a channel's steps are sequential, so it is
// latency-bound with one warp per SM at B=4096: the step's chain and the
// memory instructions issued beside it set the time, ~280 clock64()
// cycles a step in either mode (tools/variants.py k8; PERF.md).  Its
// bytes: 14 B in per step and channel (bits bf16, amps, ratios, delayed
// amps f32), and in planes mode 7 B out (i32 + 3 bools) — 0.21 GB for the
// 0.1 s bench chunk at B=4096, 0.06 ms at 3.35 TB/s; compact mode writes
// O(maxb) bytes per channel.  The window mean's IEEE divide runs only on
// a firing step.  Measured and not kept (PERF.md): a copy warp a block
// (K5's producer), the copies issued inside the step loop, the planes
// staged in shared memory and drained with 16-byte stores, unrolling by
// 4 or 16; each was slower.
//
// Built with -fmad=false and IEEE division, both modes match the plain
// versions (ops/kernels/fsk_framing.py: stage_d_plain,
// stage_d_compact_plain) bit for bit on identical inputs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "framing_step.cuh"
#include "warp_pipe.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kTile = 16;     // steps per tile
constexpr int kAhead = 2;     // tiles copied ahead of the step computed
constexpr int kSlots = kAhead + 1;
// per slot: amps, ratios, delayed amps (f32) and the words holding the
// bits, [4][kTile][kThreads]
constexpr int kSlotWords = 4 * kTile * kThreads;

// K2's sink: bytes compacted per channel, four counts
struct Compact {
  unsigned char* bytes_out;
  int maxb;
  int *byte_count, *eod_fired, *sync_fired, *fire_t;

  struct Lane {
    unsigned char* row;
    int cursor, eods, fires, last_fire;
  };

  __device__ __forceinline__ Lane open(int b) const {
    Lane l = {bytes_out + static_cast<size_t>(b) * maxb, 0, 0, 0, -1};
    for (int j = 0; j < maxb; ++j) l.row[j] = 0;
    return l;
  }
  __device__ __forceinline__ void put(Lane& l, int t, size_t,
                                      const wam::FramingEvents& ev) const {
    if (ev.emit) {
      if (l.cursor < maxb) l.row[l.cursor] =
          static_cast<unsigned char>(ev.byte_val);
      ++l.cursor;
    }
    l.eods += ev.eod;
    l.fires += ev.fire;
    if (ev.fire) l.last_fire = t;
  }
  __device__ __forceinline__ void close(const Lane& l, int b) const {
    byte_count[b] = l.cursor;
    eod_fired[b] = l.eods;
    sync_fired[b] = l.fires;
    fire_t[b] = l.last_fire;
  }
};

// K8's sink: the per-step planes, element i = t * B + b
struct Planes {
  int* byte_vals;
  bool *emits, *eods, *fires;

  struct Lane {};

  __device__ __forceinline__ Lane open(int) const { return {}; }
  __device__ __forceinline__ void put(Lane&, int, size_t i,
                                      const wam::FramingEvents& ev) const {
    byte_vals[i] = ev.byte_val;
    emits[i] = ev.emit;
    eods[i] = ev.eod;
    fires[i] = ev.fire;
  }
  __device__ __forceinline__ void close(const Lane&, int) const {}
};

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
  extern __shared__ unsigned char smem[];
  unsigned* const sm = reinterpret_cast<unsigned*>(smem);
  // [kSlots][4][kTile][kThreads]
  const int lane = threadIdx.x;
  const int b = blockIdx.x * blockDim.x + lane;
  if (b >= B) return;
  const size_t Bs = static_cast<size_t>(B);
  // the element offset of bits[0] within its 4-byte word (0 or 1)
  const size_t bits_odd = (reinterpret_cast<size_t>(bits) >> 1) & 1;

  wam::FramingCarry s = wam::framing_load(ints_in, flts_in, Bs, b, c);
  const int fill0 = bit_fill[b];
  typename Sink::Lane out = sink.open(b);

  const int n_tiles = (n_ds + kTile - 1) / kTile;
  auto copy_tile = [&](int k) {
    if (k < n_tiles) {
      unsigned* dst = sm + (k % kSlots) * kSlotWords + lane;
      const int m = min(kTile, n_ds - k * kTile);
      // the columns' pointers step a row at a time (an add each, not a
      // 64-bit product a row; PERF.md); the bits' word is the aligned one
      // holding this lane's bit, its half flipping each row where B is odd
      const size_t i0 = static_cast<size_t>(k * kTile) * Bs + b;
      const float* a = amps + i0;
      const float* r = ratios + i0;
      const float* sa = sub_amps + i0;
      size_t odd = (bits_odd + i0) & 1;
      const __nv_bfloat16* bw = bits + i0 - odd;
      const size_t flip = Bs & 1;
#pragma unroll 4
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
    }
    wam::cp_async_commit();
  };
  for (int k = 0; k < kAhead; ++k) copy_tile(k);
  for (int k = 0; k < n_tiles; ++k) {
    copy_tile(k + kAhead);
    wam::cp_async_wait<kAhead>();
    const unsigned* src = sm + (k % kSlots) * kSlotWords + lane;
    const int m = min(kTile, n_ds - k * kTile);
    // unrolled, so that a step's shared-memory loads go out under the
    // steps before it (by 8: 0.91-0.92 x K2's time by 4 on an H100;
    // PERF.md)
#pragma unroll 8
    for (int u = 0; u < m; ++u) {
      const int t = k * kTile + u;
      const size_t i = static_cast<size_t>(t) * Bs + b;
      const unsigned word = src[(3 * kTile + u) * kThreads];
      // a bf16's bits are the top half of its f32
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
  }

  wam::framing_store(s, ints_out, flts_out, Bs, b);
  sink.close(out, b);
}

template <class Sink>
int launch(const void* bits, const float* amps, const float* ratios,
           const float* sub_amps, int n_ds, int B, const int* ints_in,
           const float* flts_in, const int* bit_fill, int* ints_out,
           float* flts_out, const Sink& sink, const FskFramingCoef* coef,
           void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(kSlots) * kSlotWords * 4;  // 24 KB
  fsk_framing_kernel<Sink><<<blocks, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(bits), amps, ratios, sub_amps, n_ds,
      B, ints_in, flts_in, bit_fill, ints_out, flts_out, sink, *coef);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entries: bits bf16, amps/ratios f32 [n_ds, B]; sub_amps f32
// [>= n_ds, B]; ints i32 [10, B]; flts f32 [2, B]; bit_fill i32 [B];
// `coef` is a host pointer.  Each launches on `stream` and returns
// cudaGetLastError().

// K2: bytes_out u8 [B, maxb]; counts i32 [B] each.
extern "C" int wam_fsk_framing(const void* bits, const float* amps,
                               const float* ratios, const float* sub_amps,
                               int n_ds, int B, const int* ints_in,
                               const float* flts_in, const int* bit_fill,
                               int* ints_out, float* flts_out,
                               unsigned char* bytes_out, int maxb,
                               int* byte_count, int* eod_fired,
                               int* sync_fired, int* fire_t,
                               const FskFramingCoef* coef, void* stream) {
  const Compact sink = {bytes_out, maxb, byte_count, eod_fired, sync_fired,
                        fire_t};
  return launch(bits, amps, ratios, sub_amps, n_ds, B, ints_in, flts_in,
                bit_fill, ints_out, flts_out, sink, coef, stream);
}

// K8: byte_vals i32, emits / eods / fires bool [n_ds, B].
extern "C" int wam_fsk_stage_d(const void* bits, const float* amps,
                               const float* ratios, const float* sub_amps,
                               int n_ds, int B, const int* ints_in,
                               const float* flts_in, const int* bit_fill,
                               int* ints_out, float* flts_out,
                               int* byte_vals, bool* emits, bool* eods,
                               bool* fires, const FskFramingCoef* coef,
                               void* stream) {
  const Planes sink = {byte_vals, emits, eods, fires};
  return launch(bits, amps, ratios, sub_amps, n_ds, B, ints_in, flts_in,
                bit_fill, ints_out, flts_out, sink, coef, stream);
}
