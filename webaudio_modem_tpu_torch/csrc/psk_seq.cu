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
// The delay ring contract.  `ring_in` f32 [2D, B] holds the last D
// averaged I then Q samples, oldest first; `ring_out` is the same after
// the chunk, oldest first again, so the caller never rolls.  The chunk's
// k-th decision (the prefix decision counted) reads and overwrites the
// entry D decisions old.  The kernel keeps that entry at working slot
// (shift + k) mod D with shift = -n mod D for the chunk's n decisions:
// slot 0 then holds the oldest entry at the end, and the rotation is
// paid once when the input is laid in, not at the end.
//
// Design.  One thread per channel; the 15 front-end floats, the pending
// downsample sums and the running R sum live in registers and the time
// loop runs inside the thread.  Input and outputs are time-major [T, B],
// so a warp's loads and stores at one step are 32 consecutive words; each
// thread loads kBlock samples before computing them, as K1 does.  The
// ring index depends on the decision count, so the rings cannot sit in
// registers.  RING PLACEMENT (kSmemRing), chosen by measuring on an
// H100 80GB HBM3 at 700 W (chip_smoke.py phase 11): in shared memory,
// laid out [slot][blockDim] as K1's bit ring (2*D floats + D bit bytes
// per thread, opted in beyond 48 KB), K6 took 1.84 ms at D = 20,
// B = 4096 and 1.84 ms at D = 480 (no R), B = 2048; with the I/Q rings
// in the ring_out plane in device memory (coalesced across the warp, in
// L1/L2) it took 1.88 and 2.05 ms.  So the rings live in shared memory
// whenever they fit the kSharedLimit bytes a block may use (D <= 908 at
// 32 threads), and in the device plane beyond: `wam_psk_seq` chooses
// from D alone.  chip_smoke.py repeats the comparison with a copy built
// with -DWAM_PSK_SHARED_LIMIT=0, which keeps the rings in device memory
// at every D.
//
// What bounds it on an H100: as K1, each channel is one long dependency
// chain (~54 dependent flops per full-rate sample, an atan2f and a sqrtf
// per decision), so throughput comes from the number of channels in
// flight, about one warp per SM at B = 4096.  Memory traffic is ~12 B
// per decision plus 4 B per sample in, ~0.2 GB per 0.1 s chunk at
// B = 4096, far below the chain's latency-bound time.
//
// Numerics.  Built without fast math and with -fmad=false: every
// operation rounds as the plain PyTorch version
// (ops/kernels/psk_seq.py:seq_plain) does, in its order (two products,
// then the add or subtract), sign(0) = 0, and the downsample sums start
// as `fi` for a group inside the chunk and as `0 + fi` for a leftover
// group.  R is an exact integer in f32 (<= D), stored as bf16.

#include <cuda_bf16.h>

#include "seq_front.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kBlock = 8;   // samples loaded ahead per thread
constexpr float kPi = 3.14159265358979323846f;
#ifndef WAM_PSK_SHARED_LIMIT
#define WAM_PSK_SHARED_LIMIT (227 * 1024)
#endif
// bytes of shared memory a block may opt in to on an H100, for the rings
constexpr size_t kSharedLimit = WAM_PSK_SHARED_LIMIT;

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
  extern __shared__ float smem[];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = static_cast<size_t>(B);
  const int lane = threadIdx.x;
  const int stride = blockDim.x;
  const int D = c.ds;

  // this channel's I and Q rings: slot s at zi[s * zs], zq[s * zs]
  float* zi;
  float* zq;
  size_t zs;
  if constexpr (kSmemRing) {
    zi = smem + lane;
    zq = smem + static_cast<size_t>(D) * stride + lane;
    zs = stride;
  } else {
    zi = ring_out + b;
    zq = ring_out + D * Bs + b;
    zs = Bs;
  }
  // the bit ring for R, [D][blockDim] bytes after the float rings
  unsigned char* rbits = reinterpret_cast<unsigned char*>(
      smem + (kSmemRing ? 2 * static_cast<size_t>(D) * stride : 0));

  wam::Front fr;
  fr.load(front_in, Bs, b);

  float run = 0.0f;
  int slot = shift;
  for (int j = 0; j < D; ++j) {    // oldest first
    zi[slot * zs] = ring_in[j * Bs + b];
    zq[slot * zs] = ring_in[(D + j) * Bs + b];
    if constexpr (kRsum) {
      const float v = __bfloat162float(ring0[j * Bs + b]);
      rbits[slot * stride + lane] = static_cast<unsigned char>(v);
      run = run + v;
    }
    if (++slot == D) slot = 0;
  }

  float acc_i = ds_phase > 0 ? acc_in[b] : 0.0f;
  float acc_q = ds_phase > 0 ? acc_in[Bs + b] : 0.0f;
  int phase = ds_phase;
  size_t out = 0;    // decisions written
  const float ratio_f = static_cast<float>(c.ratio);

  for (int t0 = 0; t0 < T; t0 += kBlock) {
    // load a block of samples first, so their latencies overlap
    float xs[kBlock];
#pragma unroll
    for (int u = 0; u < kBlock; ++u)
      xs[u] = t0 + u < T ? x[(t0 + u) * Bs + b] : 0.0f;
#pragma unroll
    for (int u = 0; u < kBlock; ++u) {
      const int t = t0 + u;
      if (t >= T) break;
      fr.step(c, xs[u]);
      const float fi = fr.iy1, fq = fr.qy1;   // the I/Q low-pass outputs

      if (phase == 0 && t + c.ratio <= T) {  // first sample of a whole group
        acc_i = fi;
        acc_q = fq;
      } else if (phase == 0) {                // first sample of the leftover
        acc_i = 0.0f + fi;
        acc_q = 0.0f + fq;
      } else {
        acc_i = acc_i + fi;
        acc_q = acc_q + fq;
      }
      if (++phase < c.ratio) continue;
      phase = 0;

      // downsampled decision against the sample one bit period earlier
      const float avg_i = acc_i / ratio_f;
      const float avg_q = acc_q / ratio_f;
      const float di = zi[slot * zs];
      const float dq = zq[slot * zs];
      zi[slot * zs] = avg_i;
      zq[slot * zs] = avg_q;
      const float re = avg_i * di + avg_q * dq;
      const float im = avg_q * di - avg_i * dq;
      const float ang = atan2f(im, re);
      const float sg = ang > 0.0f ? 1.0f : (ang < 0.0f ? -1.0f : 0.0f);
      const float soft = re > 0.0f ? ang : ang - sg * kPi;
      const float bit = re > 0.0f ? 1.0f : 0.0f;

      const size_t o = out * Bs + b;
      if constexpr (kRsum) {
        unsigned char* rb = &rbits[slot * stride + lane];
        run = run + bit - static_cast<float>(*rb);
        *rb = static_cast<unsigned char>(bit);
        rsum[o] = __float2bfloat16(run);
      }
      if (++slot == D) slot = 0;
      bits[o] = __float2bfloat16(bit);
      amps[o] = sqrtf(avg_i * avg_i + avg_q * avg_q);
      softs[o] = soft;
      ++out;
    }
  }

  fr.store(front_out, Bs, b);
  // pending sums only while a group is open (the reference returns 0
  // when the chunk ends on a group boundary)
  acc_out[b] = phase != 0 ? acc_i : 0.0f;
  acc_out[Bs + b] = phase != 0 ? acc_q : 0.0f;
  if constexpr (kSmemRing) {       // slot 0 holds the oldest entry now
    for (int j = 0; j < D; ++j) {
      ring_out[j * Bs + b] = zi[j * zs];
      ring_out[(D + j) * Bs + b] = zq[j * zs];
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
// where they fit kSharedLimit, else in ring_out.  Launches on `stream`
// and returns the first CUDA error (opting in to the shared memory, or
// the launch).
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
  const int blocks = (B + kThreads - 1) / kThreads;
  const size_t ring_bytes = 2 * sizeof(float) * static_cast<size_t>(D) *
                            kThreads;
  const size_t bit_bytes = emit_rsum ? static_cast<size_t>(D) * kThreads : 0;
  const bool smem_ring = ring_bytes + bit_bytes <= kSharedLimit;
  const size_t smem = (smem_ring ? ring_bytes : 0) + bit_bytes;
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
