// K1 — the FSK demodulator's sequential stage, with the R stream, and
// K7 — the same stage without R.
//
// Replaces webaudio_modem_tpu/ops/pallas/fsk_seq.py `_kernel_r` (through
// `_seq_main_call_r` / `seq_main(ring0=...)`) and `_kernel` (K7, through
// `_seq_main_call`), together with the lax prefix and leftover code of
// ops/fsk_demod.py `_sequential_stage`: this kernel takes the whole
// chunk, any length, any downsample phase.
//
// Stream flags (the reference's emit_bits / emit_amps / emit_csum, and
// the R-less K7): a null `bits` or `amps` pointer stores nothing for
// that stream (and a null `amps` skips the sqrtf); `emit_rsum` = 0 skips
// the ring and R (K7); `emit_csum` = 1 stores in the softs slot the
// INCLUSIVE f32 running sum of the softs, `cs = cs + soft` in decision
// order from cs = 0 (the add sequence of ops/pallas/cumsum0.py).
// Retained streams are bit-identical to the full run.  The flags are
// template parameters, one instantiation per combination, so the
// all-streams kernel of the hard path carries no test for them.
//
// Per full-rate sample: AGC, band-pass biquad, NCO rotation with
// first-order renormalization, I/Q low-pass biquads (seq_front.cuh, the
// front end K6 shares).  Per downsample group: 2x average, atan2f,
// wrapped phase difference, post low-pass biquad, polarity slicer, and
// R — the rolling ds-wide sum of the sliced bits — through a ds-deep ring
// seeded from the previous chunk's bits.
//
// What bounds it on an H100.  Each channel is one ordered chain of
// recurrences: the AGC gain (an IEEE divide on the chain), the band-pass,
// NCO and I/Q biquads, then per group atan2f, the post biquad and R.
// Memory traffic is ~10 B per sample (4 B in; 2+4+4+2 B out per group of
// two samples), ~0.2 GB per 0.1 s chunk at B=4096, under 0.1 ms at
// 3.35 TB/s, so the chain's latency bounds it.  A clock64() profile of
// the one-thread-per-channel design this one replaced (T=4800, B=4096, NVIDIA
// H100 80GB HBM3, 700 W, 1980 MHz; PERF.md) read 736 cycles a sample:
// load waits 135, AGC + band-pass 285, NCO + mix + I/Q + sums 87, the
// group decision 317 (633 a group), each stage waiting on the one before
// on a single warp per SM, so one of the SM's four schedulers worked.
// Run alone on a warp, the AGC takes 217 cycles a sample (the chain
// floor no single-thread-per-channel design beats), the band-pass 55,
// NCO + mix + I/Q + sums 109, the decision's feed-forward part (average,
// atan2f, amplitude) 484 a group and its tail (difference, post biquad,
// slicer, R, stores) 133 a group.
//
// Design: a warp-specialised pipeline per block of 32 channels.  Each
// lane is one channel in every warp, and each channel's arithmetic stays
// the one ordered chain of the plain version; the stages of that chain
// run on five warps, so all four schedulers of an SM work and the pace
// is the slowest stage's (the AGC), not the sum of the stages:
//   warp 0  copies the input kAhead tiles ahead (cp.async, each lane its
//           own column) and runs the AGC, writing y to the Y ring;
//   warp 1  band-pass, NCO, mix, I/Q low-pass and the group sums, writing
//           (sum_i, sum_q) per group to the G ring;
//   warps 2-3  the feed-forward part of each decision (average, atan2f,
//           amplitude, which no recurrence links), half of each G tile
//           each: the phase goes back into the slot, the amplitude to
//           `amps`;
//   warp 4  the recurrent tail in decision order: wrapped difference,
//           post biquad, slicer, the R ring and running sum, the csum,
//           and the stores of bits, softs and R.
// In this pipeline the AGC warp sets the pace, ~233 cycles a sample on
// the same card (PERF.md).
// The rings hand tiles over through named barriers (warp_pipe.cuh); a
// G slot passes warp 1 -> warps 2-3 (FULL) -> warp 4 (MID) -> warp 1
// (EMPTY).  Lanes past B load the last channel's column and store
// nothing, so every lane of every warp keeps arriving at the barriers.
// The ds-deep bit ring is per-lane bytes in shared memory, [ds][32].
//
// Numerics.  Built without fast math and with -fmad=false: every
// operation rounds exactly as the plain PyTorch version
// (ops/kernels/fsk_seq.py:seq_plain) does, in the same order, and the
// downsample sums start as `fi` for a group inside the chunk and as
// `0 + fi` for a leftover group, as the reference does (signed zeros
// reach atan2f).  R is an exact integer in f32 (<= ds), stored as bf16,
// exact for ds <= 256.

#include <cuda_bf16.h>

#include "seq_front.cuh"
#include "warp_pipe.cuh"

namespace {

constexpr int kLanes = 32;            // channels per block
constexpr int kWarps = 5;
constexpr int kThreads = kWarps * kLanes;
constexpr int kTile = 32;             // samples per x / y tile
constexpr int kAhead = 2;             // x tiles copied ahead of the AGC
constexpr int kXSlots = kAhead + 1;
constexpr int kYSlots = 3;
constexpr int kGTile = 16;            // groups per G tile
constexpr int kGSlots = 3;
constexpr int kFront = 20;   // the shared 15 rows, last_phase, post (4)
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 2.0f * kPi;

// named barriers: 1..15
__device__ __forceinline__ int y_full(int s) { return 1 + s; }
__device__ __forceinline__ int y_empty(int s) { return 1 + kYSlots + s; }
__device__ __forceinline__ int g_full(int s) { return 1 + 2 * kYSlots + s; }
__device__ __forceinline__ int g_mid(int s) {
  return 1 + 2 * kYSlots + kGSlots + s;
}
__device__ __forceinline__ int g_empty(int s) {
  return 1 + 2 * kYSlots + 2 * kGSlots + s;
}
static_assert(2 * kYSlots + 3 * kGSlots <= 15, "named barrier ids");

constexpr int kXFloats = kXSlots * kTile * kLanes;
constexpr int kYFloats = kYSlots * kTile * kLanes;
constexpr int kGFloats = kGSlots * 2 * kGTile * kLanes;
constexpr size_t kRingOffset = (kXFloats + kYFloats + kGFloats) * 4;

using wam::bar_arrive;
using wam::bar_sync;
using wam::biquad;

template <bool kBits, bool kAmps, bool kCsum, bool kRsum>
__global__ void __launch_bounds__(kThreads)
fsk_seq_kernel(const float* __restrict__ x, int T, int B,
               const float* __restrict__ front_in,
               float* __restrict__ front_out,
               const float* __restrict__ acc_in, float* __restrict__ acc_out,
               const __nv_bfloat16* __restrict__ ring0, int ds_phase,
               __nv_bfloat16* __restrict__ bits, float* __restrict__ amps,
               float* __restrict__ softs, __nv_bfloat16* __restrict__ rsum,
               const FskSeqCoef c) {
  extern __shared__ unsigned char smem[];
  float* const xr = reinterpret_cast<float*>(smem);   // [kXSlots][kTile][32]
  float* const yr = xr + kXFloats;                     // [kYSlots][kTile][32]
  float* const gr = yr + kYFloats;     // [kGSlots][2][kGTile][32]: I, Q
  unsigned char* const ring = smem + kRingOffset;      // [ds][32]
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int b = blockIdx.x * kLanes + lane;
  const bool store = b < B;
  const int bl = store ? b : B - 1;     // the column this lane reads
  const size_t Bs = static_cast<size_t>(B);
  const int n_tiles = (T + kTile - 1) / kTile;
  const int n = (ds_phase + T) / c.ratio;          // decisions
  const int n_gtiles = (n + kGTile - 1) / kGTile;

  if (warp == 0) {
    // copies kAhead tiles ahead, and the AGC
    wam::Front fr;
    fr.g = front_in[bl];
    auto copy_tile = [&](int k) {
      if (k < n_tiles) {
        float* dst = xr + (k % kXSlots) * kTile * kLanes + lane;
        const float* src = x + static_cast<size_t>(k) * kTile * Bs + bl;
        const int m = min(kTile, T - k * kTile);
        for (int u = 0; u < m; ++u)
          wam::cp_async4(dst + u * kLanes, src + u * Bs);
      }
      wam::cp_async_commit();
    };
    for (int k = 0; k < kAhead; ++k) copy_tile(k);
    for (int k = 0; k < n_tiles; ++k) {
      copy_tile(k + kAhead);
      wam::cp_async_wait<kAhead>();
      const int s = k % kYSlots;
      if (k >= kYSlots) bar_sync(y_empty(s), 2 * kLanes);
      const float* xs = xr + (k % kXSlots) * kTile * kLanes + lane;
      float* ys = yr + s * kTile * kLanes + lane;
      const int m = min(kTile, T - k * kTile);
#pragma unroll 4
      for (int u = 0; u < m; ++u) ys[u * kLanes] = fr.agc(c, xs[u * kLanes]);
      bar_arrive(y_full(s), 2 * kLanes);
    }
    if (store) front_out[b] = fr.g;
  } else if (warp == 1) {
    // band-pass, NCO, mix, I/Q low-pass, group sums
    wam::Front fr;
    fr.load(front_in, Bs, bl);
    float acc_i = ds_phase > 0 ? acc_in[bl] : 0.0f;
    float acc_q = ds_phase > 0 ? acc_in[Bs + bl] : 0.0f;
    int phase = ds_phase;
    int gpos = 0, gt = 0;   // groups in the open G tile; G tiles handed on
    for (int k = 0; k < n_tiles; ++k) {
      const int s = k % kYSlots;
      bar_sync(y_full(s), 2 * kLanes);
      const float* ys = yr + s * kTile * kLanes + lane;
      const int t0 = k * kTile;
      const int m = min(kTile, T - t0);
      for (int u = 0; u < m; ++u) {
        fr.filter_mix(c, ys[u * kLanes]);
        const float fi = fr.iy1, fq = fr.qy1;   // the I/Q low-pass outputs
        if (phase == 0 && t0 + u + c.ratio <= T) {  // a whole group
          acc_i = fi;
          acc_q = fq;
        } else if (phase == 0) {                     // the leftover
          acc_i = 0.0f + fi;
          acc_q = 0.0f + fq;
        } else {
          acc_i = acc_i + fi;
          acc_q = acc_q + fq;
        }
        if (++phase < c.ratio) continue;
        phase = 0;
        const int gs = gt % kGSlots;
        if (gpos == 0 && gt >= kGSlots) bar_sync(g_empty(gs), 2 * kLanes);
        float* g = gr + gs * 2 * kGTile * kLanes + gpos * kLanes + lane;
        g[0] = acc_i;
        g[kGTile * kLanes] = acc_q;
        if (++gpos == kGTile) {
          bar_arrive(g_full(gs), 3 * kLanes);
          gpos = 0;
          ++gt;
        }
      }
      if (k + kYSlots < n_tiles) bar_arrive(y_empty(s), 2 * kLanes);
    }
    if (gpos > 0) bar_arrive(g_full(gt % kGSlots), 3 * kLanes);
    if (store) {
      fr.store(front_out, Bs, b, 1);
      // pending sums only while a group is open (the reference returns 0
      // when the chunk ends on a group boundary)
      acc_out[b] = phase != 0 ? acc_i : 0.0f;
      acc_out[Bs + b] = phase != 0 ? acc_q : 0.0f;
    }
  } else if (warp < 4) {
    // the decisions' feed-forward part, half of every G tile each
    const int lo = (warp - 2) * (kGTile / 2);
    const float ratio_f = static_cast<float>(c.ratio);
    for (int j = 0; j < n_gtiles; ++j) {
      const int gs = j % kGSlots;
      bar_sync(g_full(gs), 3 * kLanes);
      float* g = gr + gs * 2 * kGTile * kLanes + lane;
      const int hi = min(lo + kGTile / 2, n - j * kGTile);
      for (int v = lo; v < hi; ++v) {
        const float si = g[v * kLanes], sq = g[(kGTile + v) * kLanes];
        const float avg_i = si / ratio_f;
        const float avg_q = sq / ratio_f;
        g[v * kLanes] = atan2f(avg_q, avg_i);
        if (kAmps && store)
          amps[static_cast<size_t>(j * kGTile + v) * Bs + b] =
              sqrtf(avg_i * avg_i + avg_q * avg_q);
      }
      bar_arrive(g_mid(gs), 3 * kLanes);
    }
  } else {
    // the recurrent tail, in decision order, and the stores
    float last_phase = front_in[15 * Bs + bl];
    float ox1 = front_in[16 * Bs + bl], ox2 = front_in[17 * Bs + bl];
    float oy1 = front_in[18 * Bs + bl], oy2 = front_in[19 * Bs + bl];
    float run = 0.0f;
    if constexpr (kRsum) {
      for (int k = 0; k < c.ds; ++k) {
        const float v = __bfloat162float(ring0[k * Bs + bl]);
        ring[k * kLanes + lane] = static_cast<unsigned char>(v);
        run = run + v;
      }
    }
    float cs = 0.0f;   // running sum of the softs (emit_csum)
    int rp = 0;        // ring slot of the bit leaving the window
    for (int j = 0; j < n_gtiles; ++j) {
      const int gs = j % kGSlots;
      bar_sync(g_mid(gs), 3 * kLanes);
      const float* g = gr + gs * 2 * kGTile * kLanes + lane;
      const int cnt = min(kGTile, n - j * kGTile);
      for (int v = 0; v < cnt; ++v) {
        const float cur = g[v * kLanes];
        float diff = cur - last_phase;
        diff = diff > kPi ? diff - kTwoPi
                          : (diff < -kPi ? diff + kTwoPi : diff);
        const float filt = biquad(c.post, diff, ox1, ox2, oy1, oy2);
        ox2 = ox1; ox1 = diff; oy2 = oy1; oy1 = filt;
        last_phase = cur;
        const float bit = (c.polarity * filt > 0.0f) ? 1.0f : 0.0f;
        const size_t o = static_cast<size_t>(j * kGTile + v) * Bs + b;
        if constexpr (kRsum) {
          unsigned char* slot = &ring[rp * kLanes + lane];
          run = run + bit - static_cast<float>(*slot);
          *slot = static_cast<unsigned char>(bit);
          if (++rp == c.ds) rp = 0;
          if (store) rsum[o] = __float2bfloat16(run);
        }
        if constexpr (kCsum) cs = cs + filt;
        if (store) {
          if constexpr (kBits) bits[o] = __float2bfloat16(bit);
          softs[o] = kCsum ? cs : filt;
        }
      }
      if (j + kGSlots < n_gtiles) bar_arrive(g_empty(gs), 2 * kLanes);
    }
    if (store) {
      const float r[kFront - wam::kFrontRows] = {last_phase, ox1, ox2, oy1,
                                                 oy2};
#pragma unroll
      for (int k = wam::kFrontRows; k < kFront; ++k)
        front_out[k * Bs + b] = r[k - wam::kFrontRows];
    }
  }
}

using FskSeqKernel = void (*)(const float*, int, int, const float*, float*,
                              const float*, float*, const __nv_bfloat16*, int,
                              __nv_bfloat16*, float*, float*, __nv_bfloat16*,
                              const FskSeqCoef);

// every combination of the stream flags, indexed by
// bits | amps << 1 | csum << 2 | rsum << 3
#define WAM_FSK_SEQ(m)                                                  \
  fsk_seq_kernel<((m) & 1) != 0, ((m) & 2) != 0, ((m) & 4) != 0,        \
                 ((m) & 8) != 0>
const FskSeqKernel kKernels[16] = {
    WAM_FSK_SEQ(0),  WAM_FSK_SEQ(1),  WAM_FSK_SEQ(2),  WAM_FSK_SEQ(3),
    WAM_FSK_SEQ(4),  WAM_FSK_SEQ(5),  WAM_FSK_SEQ(6),  WAM_FSK_SEQ(7),
    WAM_FSK_SEQ(8),  WAM_FSK_SEQ(9),  WAM_FSK_SEQ(10), WAM_FSK_SEQ(11),
    WAM_FSK_SEQ(12), WAM_FSK_SEQ(13), WAM_FSK_SEQ(14), WAM_FSK_SEQ(15)};
#undef WAM_FSK_SEQ

}  // namespace

// x f32 [T, B]; front f32 [20, B]; acc f32 [2, B]; ring0 bf16 [ds, B]
// (null with emit_rsum = 0); bits/rsum bf16 and amps/softs f32
// [(ds_phase + T) / ratio, B], bits/amps null when dropped, rsum null
// with emit_rsum = 0; `coef` is a host pointer (ctypes passes structs
// holding arrays by value unreliably).  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int wam_fsk_seq(const float* x, int T, int B,
                           const float* front_in, float* front_out,
                           const float* acc_in, float* acc_out,
                           const void* ring0, int ds_phase, void* bits,
                           float* amps, float* softs, void* rsum,
                           int emit_csum, int emit_rsum,
                           const FskSeqCoef* coef, void* stream) {
  const FskSeqCoef c = *coef;
  const int blocks = (B + kLanes - 1) / kLanes;
  // 36 KB of rings and 32 B per bit-ring row: 44 KB at ds = 256; beyond
  // 48 KB (R at ds > 372) the kernel opts in
  const size_t smem =
      kRingOffset + (emit_rsum ? static_cast<size_t>(c.ds) * kLanes : 0);
  const int m = (bits != nullptr ? 1 : 0) | (amps != nullptr ? 2 : 0) |
                (emit_csum ? 4 : 0) | (emit_rsum ? 8 : 0);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kKernels[m],
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  kKernels[m]<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, T, B, front_in, front_out, acc_in, acc_out,
      static_cast<const __nv_bfloat16*>(ring0), ds_phase,
      static_cast<__nv_bfloat16*>(bits), amps, softs,
      static_cast<__nv_bfloat16*>(rsum), c);
  return static_cast<int>(cudaGetLastError());
}
