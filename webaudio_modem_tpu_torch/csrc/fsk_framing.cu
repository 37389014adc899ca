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
// Numerics.  The float carries (rolling amp sum, threshold) use the same
// op order as the plain version (ops/kernels/fsk_framing.py:
// stage_d_plain); built with -fmad=false and IEEE division, the kernel
// matches it bit for bit on identical inputs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

struct FskFramingCoef {
  int ds_per_bit, quarter, stop_pos, parity_on, amp_window, sync_window,
      wrap;
  float eod_after, sync_thr;
};

namespace {

constexpr int kThreads = 32;
constexpr int kBlock = 8;   // steps loaded ahead per thread
constexpr int kInts = 10;

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

  int started = ints_in[0 * Bs + b];
  int counter = ints_in[1 * Bs + b];
  int sil = ints_in[2 * Bs + b];
  int accum = ints_in[3 * Bs + b];
  int count = ints_in[4 * Bs + b];
  int bsc = ints_in[5 * Bs + b];
  int nxt = ints_in[6 * Bs + b];
  int byte_cur = ints_in[7 * Bs + b];
  int pos = ints_in[8 * Bs + b];
  int fillv = ints_in[9 * Bs + b];
  float thr = flts_in[b];
  float run_sum = flts_in[Bs + b];
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
      const float amp = amp_s[u];
      const int bit = bit_s[u];
      const bool gate = fill0 + (t + 1) >= c.sync_window;

      // rolling mean over the last amp_window amplitudes
      run_sum = run_sum + amp - sub_s[u];
      fillv = min(fillv + 1, c.amp_window);
      const float mean = run_sum / static_cast<float>(fillv);

      int counter1 = counter + 1;
      if (counter1 >= c.wrap) counter1 -= c.wrap;
      // silence EOD
      const bool is_sil = amp < thr;
      const int sil1 = is_sil ? sil + 1 : 0;
      const bool eod = is_sil && static_cast<float>(sil1) >= c.eod_after;
      const bool alive = !eod;
      const bool st = started > 0;
      // pre-sync pattern check
      const bool fire = alive && !st && gate &&
                        counter1 % c.quarter == 0 && ratio_s[u] > c.sync_thr;
      // post-sync majority-vote bit accumulation
      const bool post = alive && st;
      const int accum1 = accum + bit;
      const int count1 = count + 1;
      const int bsc1 = bsc + 1;
      const bool decide = post && bsc1 >= nxt;
      const bool bv = 2 * accum1 > count1;
      // UART byte assembly
      const bool start_fail = decide && pos == 0 && bv;
      const bool is_data = pos >= 1 && pos <= 8;
      const bool is_parity = c.parity_on && pos == 9;
      const bool is_stop = pos == c.stop_pos;
      const bool stop_fail = decide && is_stop && !bv;
      const bool emit = decide && is_stop && bv;
      const bool bad = decide && !(pos == 0 || is_data || is_parity || is_stop);
      const bool data_write = decide && is_data;
      const int shift = min(max(8 - pos, 0), 8);
      const int byte1 = data_write ? (byte_cur | (int(bv) << shift)) : byte_cur;

      const bool reset_full = eod || start_fail;
      const bool drop_frame = stop_fail || bad;
      const bool clear = reset_full || fire;
      const bool post_keep = post && !reset_full;
      const bool ok_advance = decide && !(start_fail || stop_fail || bad);

      if (emit) {
        if (cursor < maxb) row[cursor] = static_cast<unsigned char>(byte_cur);
        ++cursor;
      }
      eods += eod;
      fires += fire;
      if (fire) last_fire = t;

      started = (reset_full || drop_frame) ? 0 : (fire ? 1 : started);
      counter = reset_full ? 0 : counter1;
      sil = reset_full ? 0 : sil1;
      if (fire) thr = mean * 0.1f;
      accum = clear ? 0 : (post_keep ? (decide ? 0 : accum1) : accum);
      count = clear ? 0 : (post_keep ? (decide ? 0 : count1) : count);
      bsc = clear ? 0 : (post_keep ? bsc1 : bsc);
      nxt = clear ? 0 : ((post_keep && decide) ? nxt + c.ds_per_bit : nxt);
      byte_cur = (clear || emit) ? 0 : (data_write ? byte1 : byte_cur);
      pos = (clear || emit) ? 0 : (ok_advance ? pos + 1 : pos);
    }
  }

  const int r[kInts] = {started, counter, sil,      accum, count,
                        bsc,     nxt,     byte_cur, pos,   fillv};
#pragma unroll
  for (int k = 0; k < kInts; ++k) ints_out[k * Bs + b] = r[k];
  flts_out[b] = thr;
  flts_out[Bs + b] = run_sum;
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
