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
// all-streams kernel of the hard path carries no test for them (as
// runtime arguments they cost it 13 % on an H100).
//
// Per full-rate sample: AGC, band-pass biquad, NCO rotation with
// first-order renormalization, I/Q low-pass biquads (seq_front.cuh, the
// front end K6 shares).  Per downsample group: 2x average, atan2f,
// wrapped phase difference, post low-pass biquad, polarity slicer, and
// R — the rolling ds-wide sum of the sliced bits — through a ds-deep ring
// seeded from the previous chunk's bits.
//
// Design.  One thread per channel; the 20 state floats, the pending
// downsample sums and the running R sum live in registers and the time
// loop runs inside the thread.  Input and outputs are time-major [T, B],
// so a warp's loads and stores at one step are 32 consecutive words.
// The ds-deep bit ring is per-thread bytes in shared memory, laid out
// [ds][blockDim] so a warp's ring accesses fall in distinct words.
// With about one warp per SM nothing hides a load's latency, so each
// thread loads a block of kBlock samples before computing them.
//
// What bounds it on an H100.  Each channel is one long dependency chain
// (the AGC gain and every biquad feed back), about 60 dependent flops per
// sample plus an atan2f and a sqrtf per group, so a thread cannot run
// ahead; throughput comes only from the number of channels in flight.
// Memory traffic is ~10 B per sample (4 B in; 2+4+4+2 B out per group of
// two samples), ~0.2 GB per 0.1 s chunk at B=4096 — under 0.1 ms at
// 3.35 TB/s, far below the latency-bound time of the chain.  Blocks are
// 32 threads so that B=2048..4096 channels spread over up to 128 of the
// 132 SMs; filling the card beyond one warp per SM (more channels, or
// splitting time) is later work.
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

namespace {

constexpr int kThreads = 32;
constexpr int kBlock = 8;   // samples loaded ahead per thread
constexpr int kFront = 20;  // the shared 15 rows, last_phase, post (4)
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 2.0f * kPi;

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
  extern __shared__ unsigned char ring[];  // [ds][blockDim.x]
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = static_cast<size_t>(B);
  const int lane = threadIdx.x;
  const int stride = blockDim.x;

  wam::Front fr;
  fr.load(front_in, Bs, b);
  float last_phase = front_in[15 * Bs + b];
  float ox1 = front_in[16 * Bs + b], ox2 = front_in[17 * Bs + b];
  float oy1 = front_in[18 * Bs + b], oy2 = front_in[19 * Bs + b];

  float run = 0.0f;
  if constexpr (kRsum) {
    for (int k = 0; k < c.ds; ++k) {
      const float v = __bfloat162float(ring0[k * Bs + b]);
      ring[k * stride + lane] = static_cast<unsigned char>(v);
      run = run + v;
    }
  }
  float cs = 0.0f;   // running sum of the softs (emit_csum)

  float acc_i = ds_phase > 0 ? acc_in[b] : 0.0f;
  float acc_q = ds_phase > 0 ? acc_in[Bs + b] : 0.0f;
  int phase = ds_phase;
  int rp = 0;        // ring slot of the bit leaving the window
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

      // downsampled decision
      const float avg_i = acc_i / ratio_f;
      const float avg_q = acc_q / ratio_f;
      const float cur = atan2f(avg_q, avg_i);
      float diff = cur - last_phase;
      diff = diff > kPi ? diff - kTwoPi : (diff < -kPi ? diff + kTwoPi : diff);
      const float filt = biquad(c.post, diff, ox1, ox2, oy1, oy2);
      ox2 = ox1; ox1 = diff; oy2 = oy1; oy1 = filt;
      last_phase = cur;
      const float bit = (c.polarity * filt > 0.0f) ? 1.0f : 0.0f;

      const size_t o = out * Bs + b;
      if constexpr (kRsum) {
        unsigned char* slot = &ring[rp * stride + lane];
        run = run + bit - static_cast<float>(*slot);
        *slot = static_cast<unsigned char>(bit);
        if (++rp == c.ds) rp = 0;
        rsum[o] = __float2bfloat16(run);
      }
      if constexpr (kBits) bits[o] = __float2bfloat16(bit);
      if constexpr (kAmps) amps[o] = sqrtf(avg_i * avg_i + avg_q * avg_q);
      if constexpr (kCsum) {
        cs = cs + filt;
        softs[o] = cs;
      } else {
        softs[o] = filt;
      }
      ++out;
    }
  }

  fr.store(front_out, Bs, b);
  const float r[kFront - wam::kFrontRows] = {last_phase, ox1, ox2, oy1, oy2};
#pragma unroll
  for (int k = wam::kFrontRows; k < kFront; ++k)
    front_out[k * Bs + b] = r[k - wam::kFrontRows];
  // pending sums only while a group is open (the reference returns 0
  // when the chunk ends on a group boundary)
  acc_out[b] = phase != 0 ? acc_i : 0.0f;
  acc_out[Bs + b] = phase != 0 ? acc_q : 0.0f;
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
  const int blocks = (B + kThreads - 1) / kThreads;
  const size_t smem = emit_rsum ? static_cast<size_t>(c.ds) * kThreads : 0;
  const int m = (bits != nullptr ? 1 : 0) | (amps != nullptr ? 2 : 0) |
                (emit_csum ? 4 : 0) | (emit_rsum ? 8 : 0);
  kKernels[m]<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, T, B, front_in, front_out, acc_in, acc_out,
      static_cast<const __nv_bfloat16*>(ring0), ds_phase,
      static_cast<__nv_bfloat16*>(bits), amps, softs,
      static_cast<__nv_bfloat16*>(rsum), c);
  return static_cast<int>(cudaGetLastError());
}
