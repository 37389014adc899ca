// K6 — the DBPSK demodulator's sequential stage, with and without the R
// stream.
//
// Replaces webaudio_modem_tpu/ops/pallas/psk_seq.py `_kernel` (through
// `_psk_main_call` / `seq_main`, with and without `ring0`), together with
// the lax prefix and leftover code of ops/psk.py `_sequential_stage`:
// this kernel takes the whole chunk, any length, any downsample phase.
//
// Per full-rate sample: the front end K1 shares (seq_front.cuh).  Per
// downsample group: the 2x average z_k = (avg_i, avg_q), then the DBPSK
// decision against z_{k-D}, the sample one bit period (D = ds decisions)
// earlier, as ops/psk.py `_psk_soft`: re = ai*di + aq*dq,
// im = aq*di - ai*dq, bit = re > 0, amp = sqrt(ai^2 + aq^2),
// soft = re > 0 ? atan2(im, re) : atan2(im, re) - sign(.)*pi; and R, the
// rolling D-wide sum of the sliced bits, through a D-deep bit ring seeded
// from the previous chunk's bits (`emit_rsum`, D <= 256).
//
// Design: K1's warp pipeline (seq_pipe.cuh) per block of 32 channels,
// each lane one channel in every warp, each channel's arithmetic the one
// ordered chain of the plain version:
//   warp 0  copies the input ahead (cp.async) and runs the AGC;
//   warp 1  band-pass, NCO, mix, I/Q low-pass and the group sums, to the
//           G ring (warps 0 and 1 are K1's own, shared through
//           seq_pipe.cuh);
//   warp 2  the ring warp, decisions in order: the average
//           avg_k = sum_k / ratio, z_{k-D} read from the delay ring and
//           avg_k written in its place, re and im, the bit, the R ring
//           and running sum, the amplitude (sqrtf), and the stores of
//           bits, amps and R; re and im go back into the G slot;
//   warps 3-4  atan2f and the wrapped soft value of each decision, half
//           of every G tile each, and the stores of softs.
// A G slot passes warp 1 -> warp 2 (FULL) -> warps 3-4 (MID) -> warp 1
// (EMPTY).
//
// The delayed sample crosses decisions, G tiles and (at D < kGTile, any
// baud rate above PSKConfig()'s) the decisions of one tile, so one warp
// owns the delay ring: warp 2 reads z_{k-D} and writes avg_k in decision
// order, and hands only re and im on.  No other warp touches the ring,
// so no barrier orders it.
//
// The ring contract.  `ring_in` f32 [2D, B] holds the last D averaged I
// then Q samples, oldest first; `ring_out` is the same after the chunk,
// oldest first again, so the caller never rolls.  The chunk's k-th
// decision (the prefix decision counted) reads and overwrites the entry
// D decisions old.  The ring warp keeps that entry at working slot
// (shift + k) mod D with shift = -n mod D for the chunk's n decisions:
// slot 0 then holds the oldest entry at the end, and the rotation is
// paid once when the input is laid in, not at the end.
//
// RING PLACEMENT (kSmemRing), from D alone in `wam_psk_seq`: the I/Q
// rings, [slot][32] per lane, sit in shared memory beside the pipeline's
// tiles (36 KB) where they fit kSharedLimit (D <= 764 without R, 679
// with R's [D][32] bit bytes), and in the ring_out plane in device memory
// beyond (coalesced across the warp, in L1/L2); lanes past B then touch
// no ring, since their column is lane B - 1's.  chip_smoke.py times the
// two placements against a copy built with -DWAM_PSK_SHARED_LIMIT=0,
// which keeps the rings in device memory at every D.
//
// What bounds it on an H100: as K1, each channel is one long dependency
// chain, and the pipeline's pace is its slowest stage, the AGC (217
// cycles a sample alone on a warp, 0.527 ms for T = 4800 at 1980 MHz;
// PERF.md).  Memory traffic is ~12 B per decision plus 4 B per sample
// in, ~0.2 GB per 0.1 s chunk at B = 4096, 0.06 ms at 3.35 TB/s.
//
// Numerics.  Built without fast math and with -fmad=false: every
// operation rounds as the plain PyTorch version
// (ops/kernels/psk_seq.py:seq_plain) does, in its order (two products,
// then the add or subtract), sign(0) = 0, and the downsample sums start
// as `fi` for a group inside the chunk and as `0 + fi` for a leftover
// group.  R is an exact integer in f32 (<= D), stored as bf16.

#include <cuda_bf16.h>

#include "seq_pipe.cuh"

namespace {

using namespace wam::pipe;

constexpr int kWarps = 5;
constexpr int kThreads = kWarps * kLanes;
constexpr float kPi = 3.14159265358979323846f;
#ifndef WAM_PSK_SHARED_LIMIT
#define WAM_PSK_SHARED_LIMIT (227 * 1024)
#endif
// bytes of shared memory a block may opt in to on an H100
constexpr size_t kSharedLimit = WAM_PSK_SHARED_LIMIT;

using wam::bar_arrive;
using wam::bar_sync;

template <bool kRsum, bool kSmemRing>
__global__ void __launch_bounds__(kThreads)
psk_seq_kernel(const float* __restrict__ x, int T, int B,
               const float* __restrict__ front_in,
               float* __restrict__ front_out,
               const float* __restrict__ acc_in, float* __restrict__ acc_out,
               const float* __restrict__ ring_in, float* ring_out,
               const __nv_bfloat16* __restrict__ ring0, int ds_phase,
               int shift, __nv_bfloat16* __restrict__ bits,
               float* __restrict__ amps, float* __restrict__ softs,
               __nv_bfloat16* __restrict__ rsum, const FskSeqCoef c) {
  extern __shared__ unsigned char smem[];
  const Rings rings(smem);
  const int D = c.ds;
  // the I/Q rings [2][D][32] (shared placement), then R's bit ring
  // [D][32] bytes
  float* const zring = reinterpret_cast<float*>(smem + kTileBytes);
  unsigned char* const rbits =
      smem + kTileBytes +
      (kSmemRing ? 2 * sizeof(float) * static_cast<size_t>(D) * kLanes : 0);
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int b = blockIdx.x * kLanes + lane;
  const bool store = b < B;
  const int bl = store ? b : B - 1;     // the column this lane reads
  const size_t Bs = static_cast<size_t>(B);
  const int n = (ds_phase + T) / c.ratio;          // decisions
  const int n_gtiles = (n + kGTile - 1) / kGTile;

  if (warp == 0) {
    copy_agc(rings, x, T, Bs, lane, b, bl, store, front_in, front_out, c);
  } else if (warp == 1) {
    // G slots: FULL to warp 2, EMPTY from warps 3-4
    front_sums<2 * kLanes, 3 * kLanes>(rings, T, Bs, lane, b, bl, store,
                                       front_in, front_out, acc_in, acc_out,
                                       ds_phase, c);
  } else if (warp == 2) {
    // the ring warp: this lane's I and Q rings, slot s at zi[s * zs]
    float* zi;
    float* zq;
    size_t zs;
    if constexpr (kSmemRing) {
      zi = zring + lane;
      zq = zring + static_cast<size_t>(D) * kLanes + lane;
      zs = kLanes;
    } else {
      zi = ring_out + b;
      zq = ring_out + D * Bs + b;
      zs = Bs;
    }
    const bool own = kSmemRing || store;   // a lane that holds a ring
    float run = 0.0f;
    int slot = shift;
    for (int j = 0; j < D; ++j) {    // oldest first
      if (own) {
        zi[slot * zs] = ring_in[j * Bs + bl];
        zq[slot * zs] = ring_in[(D + j) * Bs + bl];
      }
      if constexpr (kRsum) {
        const float v = __bfloat162float(ring0[j * Bs + bl]);
        rbits[slot * kLanes + lane] = static_cast<unsigned char>(v);
        run = run + v;
      }
      if (++slot == D) slot = 0;
    }
    const float ratio_f = static_cast<float>(c.ratio);
    for (int j = 0; j < n_gtiles; ++j) {
      const int gs = j % kGSlots;
      bar_sync(g_full(gs), 2 * kLanes);
      float* g = rings.gr + gs * 2 * kGTile * kLanes + lane;
      const int cnt = min(kGTile, n - j * kGTile);
      for (int v = 0; v < cnt; ++v) {
        // the decision against the sample one bit period earlier
        const float avg_i = g[v * kLanes] / ratio_f;
        const float avg_q = g[(kGTile + v) * kLanes] / ratio_f;
        float di = 0.0f, dq = 0.0f;
        if (own) {
          di = zi[slot * zs];
          dq = zq[slot * zs];
          zi[slot * zs] = avg_i;
          zq[slot * zs] = avg_q;
        }
        const float re = avg_i * di + avg_q * dq;
        const float im = avg_q * di - avg_i * dq;
        g[v * kLanes] = re;
        g[(kGTile + v) * kLanes] = im;
        const float bit = re > 0.0f ? 1.0f : 0.0f;
        const size_t o = static_cast<size_t>(j * kGTile + v) * Bs + b;
        if constexpr (kRsum) {
          unsigned char* rb = &rbits[slot * kLanes + lane];
          run = run + bit - static_cast<float>(*rb);
          *rb = static_cast<unsigned char>(bit);
          if (store) rsum[o] = __float2bfloat16(run);
        }
        if (++slot == D) slot = 0;
        if (store) {
          bits[o] = __float2bfloat16(bit);
          amps[o] = sqrtf(avg_i * avg_i + avg_q * avg_q);
        }
      }
      bar_arrive(g_mid(gs), 3 * kLanes);
    }
    if constexpr (kSmemRing) {       // slot 0 holds the oldest entry now
      if (store) {
        for (int j = 0; j < D; ++j) {
          ring_out[j * Bs + b] = zi[j * zs];
          ring_out[(D + j) * Bs + b] = zq[j * zs];
        }
      }
    }
  } else {
    // atan2f and the soft value, half of every G tile each
    const int lo = (warp - 3) * (kGTile / 2);
    for (int j = 0; j < n_gtiles; ++j) {
      const int gs = j % kGSlots;
      bar_sync(g_mid(gs), 3 * kLanes);
      const float* g = rings.gr + gs * 2 * kGTile * kLanes + lane;
      const int hi = min(lo + kGTile / 2, n - j * kGTile);
      for (int v = lo; v < hi; ++v) {
        const float re = g[v * kLanes], im = g[(kGTile + v) * kLanes];
        const float ang = atan2f(im, re);
        const float sg = ang > 0.0f ? 1.0f : (ang < 0.0f ? -1.0f : 0.0f);
        if (store)
          softs[static_cast<size_t>(j * kGTile + v) * Bs + b] =
              re > 0.0f ? ang : ang - sg * kPi;
      }
      if (j + kGSlots < n_gtiles) bar_arrive(g_empty(gs), 3 * kLanes);
    }
  }
}

using PskSeqKernel = void (*)(const float*, int, int, const float*, float*,
                              const float*, float*, const float*, float*,
                              const __nv_bfloat16*, int, int, __nv_bfloat16*,
                              float*, float*, __nv_bfloat16*,
                              const FskSeqCoef);

// indexed by rsum | smem_ring << 1
const PskSeqKernel kKernels[4] = {
    psk_seq_kernel<false, false>, psk_seq_kernel<true, false>,
    psk_seq_kernel<false, true>, psk_seq_kernel<true, true>};

}  // namespace

// x f32 [T, B]; front f32 [15, B]; acc f32 [2, B]; ring_in / ring_out f32
// [2D, B], oldest first; ring0 bf16 [D, B] (null with emit_rsum = 0);
// bits/rsum bf16 and amps/softs f32 [(ds_phase + T) / ratio, B], rsum null
// with emit_rsum = 0; `coef` is a host pointer (ctypes passes structs
// holding arrays by value unreliably).  The I/Q rings go in shared memory
// where they fit kSharedLimit beside the pipeline's tiles, else in
// ring_out.  Launches on `stream` and returns the first CUDA error
// (opting in to the shared memory, or the launch).
extern "C" int wam_psk_seq(const float* x, int T, int B,
                           const float* front_in, float* front_out,
                           const float* acc_in, float* acc_out,
                           const float* ring_in, float* ring_out,
                           const void* ring0, int ds_phase, void* bits,
                           float* amps, float* softs, void* rsum,
                           int emit_rsum, const FskSeqCoef* coef,
                           void* stream) {
  const FskSeqCoef c = *coef;
  const int D = c.ds;
  const int n = (ds_phase + T) / c.ratio;
  const int shift = (D - n % D) % D;
  const int blocks = (B + kLanes - 1) / kLanes;
  const size_t ring_bytes = 2 * sizeof(float) * static_cast<size_t>(D) *
                            kLanes;
  const size_t bit_bytes = emit_rsum ? static_cast<size_t>(D) * kLanes : 0;
  const bool smem_ring = kTileBytes + ring_bytes + bit_bytes <= kSharedLimit;
  const size_t smem = kTileBytes + (smem_ring ? ring_bytes : 0) + bit_bytes;
  const PskSeqKernel kernel =
      kKernels[(emit_rsum ? 1 : 0) | (smem_ring ? 2 : 0)];
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, T, B, front_in, front_out, acc_in, acc_out, ring_in, ring_out,
      static_cast<const __nv_bfloat16*>(ring0), ds_phase, shift,
      static_cast<__nv_bfloat16*>(bits), amps, softs,
      static_cast<__nv_bfloat16*>(rsum), c);
  return static_cast<int>(cudaGetLastError());
}
