// K2 — the framing state machine (stage D) with in-kernel byte compaction.
//
// Replaces webaudio_modem_tpu/ops/pallas/fsk_framing.py `_kernel_compact`
// (through `_stage_d_compact_call` / `stage_d_compact`).  Each step runs
// ops/fsk_demod.py `_d_step`: silence EOD, sync firing gated on the
// bit-window fill, majority-vote bit decisions, UART byte assembly and
// the fused rolling amplitude-window mean.  Out come the decoded bytes,
// packed per channel from slot 0, the counts of bytes, EODs and fires,
// and the step of the last fire (-1 for none).
//
// Design.  One thread per channel; the 10 int and 2 float carries live
// in registers and the time loop runs inside the thread.  Inputs are
// time-major [n_ds, B].  The thread copies its own column of the four
// input planes into shared memory with cp.async (warp_pipe.cuh), kAhead
// tiles of kTile steps ahead of the step it computes, so no load's round
// trip lands on the state machine's chain.  A bf16 bit sits in a 4-byte
// word with its neighbour: the thread copies the aligned word that holds
// it and takes its half, so rows of the bits plane need no alignment and
// every B is taken; a thread reads only what it copied, so no barrier is
// needed and lanes past B return at once.
// Each emitted byte is stored straight to bytes_out[b][cursor] in device
// memory: there is no register-resident slot array, hence no bound on
// the bytes per chunk (the TPU kernel's MAX_SLOTS) and no fallback path.
//
// What bounds it on an H100.  A step is ~60 dependent integer/compare
// ops per channel, and a channel's steps are sequential, so like K1 it
// is latency-bound with one warp per SM at B=4096; it reads 14 B per
// step and channel (bits bf16, amps, ratios, delayed amps f32) — 0.14 GB
// per 0.1 s chunk at B=4096 — and writes only O(maxb) bytes per channel.
// The window mean's IEEE divide runs only on a firing step (the one step
// that reads it), not on every step's chain.
//
// The step itself (framing_step.cuh) is shared with K8 (fsk_stage_d.cu);
// built with -fmad=false and IEEE division, the kernel matches the plain
// version (ops/kernels/fsk_framing.py: stage_d_plain) bit for bit on
// identical inputs.

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

__global__ void __launch_bounds__(kThreads)
fsk_framing_kernel(const __nv_bfloat16* __restrict__ bits,
                   const float* __restrict__ amps,
                   const float* __restrict__ ratios,
                   const float* __restrict__ sub_amps, int n_ds, int B,
                   const int* __restrict__ ints_in,
                   const float* __restrict__ flts_in,
                   const int* __restrict__ bit_fill,
                   int* __restrict__ ints_out, float* __restrict__ flts_out,
                   unsigned char* __restrict__ bytes_out, int maxb,
                   int* __restrict__ byte_count, int* __restrict__ eod_fired,
                   int* __restrict__ sync_fired, int* __restrict__ fire_t,
                   const FskFramingCoef c) {
  extern __shared__ unsigned char smem[];
  unsigned* const sm = reinterpret_cast<unsigned*>(smem);
  // [kSlots][4][kTile][kThreads]
  const int lane = threadIdx.x;
  const int b = blockIdx.x * blockDim.x + lane;
  if (b >= B) return;
  const size_t Bs = static_cast<size_t>(B);
  // the element offset of bits[0] within its 4-byte word (0 or 1)
  const size_t bits_odd = (reinterpret_cast<size_t>(bits) >> 1) & 1;

  wam::FramingCarry s = wam::framing_load(ints_in, flts_in, Bs, b);
  const int fill0 = bit_fill[b];

  unsigned char* row = bytes_out + static_cast<size_t>(b) * maxb;
  for (int j = 0; j < maxb; ++j) row[j] = 0;
  int cursor = 0, eods = 0, fires = 0, last_fire = -1;

  const int n_tiles = (n_ds + kTile - 1) / kTile;
  auto copy_tile = [&](int k) {
    if (k < n_tiles) {
      unsigned* dst = sm + (k % kSlots) * kSlotWords + lane;
      const int m = min(kTile, n_ds - k * kTile);
      for (int u = 0; u < m; ++u) {
        const size_t i = static_cast<size_t>(k * kTile + u) * Bs + b;
        wam::cp_async4(dst + (0 * kTile + u) * kThreads, amps + i);
        wam::cp_async4(dst + (1 * kTile + u) * kThreads, ratios + i);
        wam::cp_async4(dst + (2 * kTile + u) * kThreads, sub_amps + i);
        wam::cp_async4(dst + (3 * kTile + u) * kThreads,
                       bits + i - ((bits_odd + i) & 1));
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
    // steps before it (a fifth faster on an H100; PERF.md)
#pragma unroll 4
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
      if (ev.emit) {
        if (cursor < maxb) row[cursor] = static_cast<unsigned char>(ev.byte_val);
        ++cursor;
      }
      eods += ev.eod;
      fires += ev.fire;
      if (ev.fire) last_fire = t;
    }
  }

  wam::framing_store(s, ints_out, flts_out, Bs, b);
  byte_count[b] = cursor;
  eod_fired[b] = eods;
  sync_fired[b] = fires;
  fire_t[b] = last_fire;
}

}  // namespace

// bits bf16, amps/ratios f32 [n_ds, B]; sub_amps f32 [>= n_ds, B];
// ints i32 [10, B]; flts f32 [2, B]; bit_fill i32 [B]; bytes_out u8
// [B, maxb]; counts i32 [B] each; `coef` is a host pointer.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int wam_fsk_framing(const void* bits, const float* amps,
                               const float* ratios, const float* sub_amps,
                               int n_ds, int B, const int* ints_in,
                               const float* flts_in, const int* bit_fill,
                               int* ints_out, float* flts_out,
                               unsigned char* bytes_out, int maxb,
                               int* byte_count, int* eod_fired,
                               int* sync_fired, int* fire_t,
                               const FskFramingCoef* coef, void* stream) {
  const FskFramingCoef c = *coef;
  const int blocks = (B + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(kSlots) * kSlotWords * 4;  // 24 KB
  fsk_framing_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(bits), amps, ratios, sub_amps, n_ds,
      B, ints_in, flts_in, bit_fill, ints_out, flts_out, bytes_out, maxb,
      byte_count, eod_fired, sync_fired, fire_t, c);
  return static_cast<int>(cudaGetLastError());
}
