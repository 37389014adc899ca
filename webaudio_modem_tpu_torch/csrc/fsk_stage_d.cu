// K8 — the framing state machine (stage D) with per-step packed events.
//
// Replaces webaudio_modem_tpu/ops/pallas/fsk_framing.py `_kernel`
// (through `_stage_d_call` / `stage_d`).  Each step runs ops/fsk_demod.py
// `_d_step` (framing_step.cuh, shared with K2) and stores one int32 word
// per step and channel: byte | emit << 8 | eod << 9 | fire << 10, where
// byte is the byte register before the step (the decoded byte where emit
// is set).  The carry goes out as K2's does.
//
// Design.  One thread per channel; the 10 int and 2 float carries live
// in registers and the time loop runs inside the thread, over the whole
// [n_ds, B] plane in one launch (no time blocks, no carry through
// scratch between grid steps).  Inputs are time-major, so a warp reads
// 32 consecutive words per step and stores 32 consecutive words of the
// packed plane; each thread loads a block of kBlock steps before
// computing them, so the loads' latencies overlap.  The sync gate is
// bit_fill + t + 1 >= sync_window, as in K2, so no gate plane is read.
//
// What bounds it on an H100.  It moves 18 B per step and channel (bits
// bf16, amps, ratios and delayed amps f32 in, the packed word out): 1.95
// GB for a 128-byte Bell-202 message at B=4096 (n_ds = 26,440), 0.58 ms
// at 3.35 TB/s.  Like K2 it runs ~60 dependent integer/compare ops per
// step on one thread per channel, ~1 warp per SM at B=4096, so it is
// latency-bound well above that.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "framing_step.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kBlock = 8;   // steps loaded ahead per thread

__global__ void __launch_bounds__(kThreads)
fsk_stage_d_kernel(const __nv_bfloat16* __restrict__ bits,
                   const float* __restrict__ amps,
                   const float* __restrict__ ratios,
                   const float* __restrict__ sub_amps, int n_ds, int B,
                   const int* __restrict__ ints_in,
                   const float* __restrict__ flts_in,
                   const int* __restrict__ bit_fill,
                   int* __restrict__ ints_out, float* __restrict__ flts_out,
                   int* __restrict__ packed, const FskFramingCoef c) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = static_cast<size_t>(B);

  wam::FramingCarry s = wam::framing_load(ints_in, flts_in, Bs, b);
  const int fill0 = bit_fill[b];

  for (int t0 = 0; t0 < n_ds; t0 += kBlock) {
    float amp_s[kBlock], sub_s[kBlock], ratio_s[kBlock];
    int bit_s[kBlock];
#pragma unroll
    for (int u = 0; u < kBlock; ++u) {
      const bool in = t0 + u < n_ds;
      const size_t i = (t0 + u) * Bs + b;
      amp_s[u] = in ? amps[i] : 0.0f;
      sub_s[u] = in ? sub_amps[i] : 0.0f;
      ratio_s[u] = in ? ratios[i] : 0.0f;
      bit_s[u] = in ? static_cast<int>(__bfloat162float(bits[i])) : 0;
    }
#pragma unroll
    for (int u = 0; u < kBlock; ++u) {
      const int t = t0 + u;
      if (t >= n_ds) break;
      const bool gate = fill0 + (t + 1) >= c.sync_window;
      const wam::FramingEvents ev = wam::framing_step(
          s, amp_s[u], sub_s[u], ratio_s[u], bit_s[u], gate, c);
      packed[t * Bs + b] = (ev.byte_val & 0xFF) | (int(ev.emit) << 8) |
                           (int(ev.eod) << 9) | (int(ev.fire) << 10);
    }
  }

  wam::framing_store(s, ints_out, flts_out, Bs, b);
}

}  // namespace

// bits bf16, amps/ratios f32 [n_ds, B]; sub_amps f32 [>= n_ds, B];
// ints i32 [10, B]; flts f32 [2, B]; bit_fill i32 [B]; packed i32
// [n_ds, B]; `coef` is a host pointer.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int wam_fsk_stage_d(const void* bits, const float* amps,
                               const float* ratios, const float* sub_amps,
                               int n_ds, int B, const int* ints_in,
                               const float* flts_in, const int* bit_fill,
                               int* ints_out, float* flts_out, int* packed,
                               const FskFramingCoef* coef, void* stream) {
  const FskFramingCoef c = *coef;
  const int blocks = (B + kThreads - 1) / kThreads;
  fsk_stage_d_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(bits), amps, ratios, sub_amps, n_ds,
      B, ints_in, flts_in, bit_fill, ints_out, flts_out, packed, c);
  return static_cast<int>(cudaGetLastError());
}
