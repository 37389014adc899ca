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
// time-major [n_ds, B], so a warp reads 32 consecutive words per step;
// each thread loads a block of kBlock steps before computing them, so
// the loads' latencies overlap.
// Each emitted byte is stored straight to bytes_out[b][cursor] in device
// memory: there is no register-resident slot array, hence no bound on
// the bytes per chunk (the TPU kernel's MAX_SLOTS) and no fallback path.
//
// What bounds it on an H100.  A step is ~60 dependent integer/compare
// ops per channel, and a channel's steps are sequential, so like K1 it
// is latency-bound with one warp per SM at B=4096; it reads 14 B per
// step and channel (bits bf16, amps, ratios, delayed amps f32) — 0.14 GB
// per 0.1 s chunk at B=4096 — and writes only O(maxb) bytes per channel.
//
// The step itself (framing_step.cuh) is shared with K8 (fsk_stage_d.cu);
// built with -fmad=false and IEEE division, the kernel matches the plain
// version (ops/kernels/fsk_framing.py: stage_d_plain) bit for bit on
// identical inputs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "framing_step.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kBlock = 8;   // steps loaded ahead per thread

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
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = static_cast<size_t>(B);

  wam::FramingCarry s = wam::framing_load(ints_in, flts_in, Bs, b);
  const int fill0 = bit_fill[b];

  unsigned char* row = bytes_out + static_cast<size_t>(b) * maxb;
  for (int j = 0; j < maxb; ++j) row[j] = 0;
  int cursor = 0, eods = 0, fires = 0, last_fire = -1;

  for (int t0 = 0; t0 < n_ds; t0 += kBlock) {
    // load a block of steps first, so their latencies overlap
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
  fsk_framing_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(bits), amps, ratios, sub_amps, n_ds,
      B, ints_in, flts_in, bit_fill, ints_out, flts_out, bytes_out, maxb,
      byte_count, eod_fired, sync_fired, fire_t, c);
  return static_cast<int>(cudaGetLastError());
}
