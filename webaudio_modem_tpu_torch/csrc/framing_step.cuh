// One step of the framing state machine (stage D), shared by K2 and K8
// (the two output modes of fsk_framing.cu: bytes compacted per channel,
// or the per-step event planes): the reference's ops/fsk_demod.py
// `_d_step` — silence EOD, sync firing gated on the bit-window fill,
// majority-vote bit decisions, UART byte assembly and the fused rolling
// amplitude-window mean.
//
// Carry layout (the reference's `pack_carry`): ints i32 [10, B] =
// started, counter, sil, accum, count, bsc, next_idx, byte_cur, pos,
// amp-window fill; flts f32 [2, B] = silence threshold, rolling
// amp-window sum.  In registers the carry also holds `phase` = counter
// mod quarter, derived once at load and advanced beside the counter (a
// compare and a select in place of a remainder by a run-time divisor on
// the step's chain); it stays exact because the counter wraps at `wrap`,
// a multiple of quarter (ops/kernels/fsk_framing.py `_wrap`), and is not
// stored.
//
// The EOD compares integers: sil1 >= eod_steps, with eod_steps =
// ceil(eod_after) from the host, which equals the reference's
// float(sil1) >= eod_after for every int32 sil1 while |eod_steps| < 2^24
// (int-to-float rounding is monotone, and exact below 2^24; the wrapper
// checks the bound).
//
// Numerics: the float carries use the same op order as the plain version
// (ops/kernels/fsk_framing.py `stage_d_plain`); built with -fmad=false and
// IEEE division, a kernel matches it bit for bit on identical inputs.

#pragma once

#include <cuda_runtime.h>

struct FskFramingCoef {
  int ds_per_bit, quarter, stop_pos, parity_on, amp_window, sync_window,
      wrap, eod_steps;
  float sync_thr;
};

namespace wam {

constexpr int kFramingInts = 10;

struct FramingCarry {
  int started, counter, sil, accum, count, bsc, nxt, byte_cur, pos, fillv;
  float thr, run_sum;
  int phase;  // counter mod quarter, in [0, quarter)
};

// what one step emits: the byte register before the step (the decoded
// byte where `emit`), and the three events
struct FramingEvents {
  int byte_val;
  bool emit, eod, fire;
};

__device__ __forceinline__ FramingCarry framing_load(
    const int* __restrict__ ints, const float* __restrict__ flts, size_t Bs,
    int b, const FskFramingCoef& c) {
  FramingCarry s;
  s.started = ints[0 * Bs + b];
  s.counter = ints[1 * Bs + b];
  s.sil = ints[2 * Bs + b];
  s.accum = ints[3 * Bs + b];
  s.count = ints[4 * Bs + b];
  s.bsc = ints[5 * Bs + b];
  s.nxt = ints[6 * Bs + b];
  s.byte_cur = ints[7 * Bs + b];
  s.pos = ints[8 * Bs + b];
  s.fillv = ints[9 * Bs + b];
  s.thr = flts[b];
  s.run_sum = flts[Bs + b];
  s.phase = s.counter % c.quarter;
  if (s.phase < 0) s.phase += c.quarter;
  return s;
}

__device__ __forceinline__ void framing_store(const FramingCarry& s,
                                              int* __restrict__ ints,
                                              float* __restrict__ flts,
                                              size_t Bs, int b) {
  const int r[kFramingInts] = {s.started, s.counter, s.sil,      s.accum,
                               s.count,   s.bsc,     s.nxt,      s.byte_cur,
                               s.pos,     s.fillv};
#pragma unroll
  for (int k = 0; k < kFramingInts; ++k) ints[k * Bs + b] = r[k];
  flts[b] = s.thr;
  flts[Bs + b] = s.run_sum;
}

// `sub` is the amplitude leaving the window (the stream delayed by
// amp_window); `gate` is bit_fill + t + 1 >= sync_window.
__device__ __forceinline__ FramingEvents framing_step(
    FramingCarry& s, float amp, float sub, float ratio, int bit, bool gate,
    const FskFramingCoef& c) {
  // rolling mean over the last amp_window amplitudes
  s.run_sum = s.run_sum + amp - sub;
  s.fillv = min(s.fillv + 1, c.amp_window);

  int counter1 = s.counter + 1;
  if (counter1 >= c.wrap) counter1 -= c.wrap;
  int phase1 = s.phase + 1;
  if (phase1 == c.quarter) phase1 = 0;
  // silence EOD
  const bool is_sil = amp < s.thr;
  const int sil1 = is_sil ? s.sil + 1 : 0;
  const bool eod = is_sil && sil1 >= c.eod_steps;
  const bool alive = !eod;
  const bool st = s.started > 0;
  // pre-sync pattern check
  const bool fire = alive && !st && gate && phase1 == 0 &&
                    ratio > c.sync_thr;
  // post-sync majority-vote bit accumulation
  const bool post = alive && st;
  const int accum1 = s.accum + bit;
  const int count1 = s.count + 1;
  const int bsc1 = s.bsc + 1;
  const bool decide = post && bsc1 >= s.nxt;
  const bool bv = 2 * accum1 > count1;
  // UART byte assembly
  const int pos = s.pos;
  const bool start_fail = decide && pos == 0 && bv;
  const bool is_data = pos >= 1 && pos <= 8;
  const bool is_parity = c.parity_on && pos == 9;
  const bool is_stop = pos == c.stop_pos;
  const bool stop_fail = decide && is_stop && !bv;
  const bool emit = decide && is_stop && bv;
  const bool bad = decide && !(pos == 0 || is_data || is_parity || is_stop);
  const bool data_write = decide && is_data;
  const int shift = min(max(8 - pos, 0), 8);
  const int byte1 = data_write ? (s.byte_cur | (int(bv) << shift))
                               : s.byte_cur;

  const bool reset_full = eod || start_fail;
  const bool drop_frame = stop_fail || bad;
  const bool clear = reset_full || fire;
  const bool post_keep = post && !reset_full;
  const bool ok_advance = decide && !(start_fail || stop_fail || bad);

  const FramingEvents ev = {s.byte_cur, emit, eod, fire};

  s.started = (reset_full || drop_frame) ? 0 : (fire ? 1 : s.started);
  s.counter = reset_full ? 0 : counter1;
  s.phase = reset_full ? 0 : phase1;
  s.sil = reset_full ? 0 : sil1;
  // the window mean only where a fire reads it: the same IEEE quotient
  // of the updated sum and fill, with its divide off the step's chain
  if (fire) s.thr = (s.run_sum / static_cast<float>(s.fillv)) * 0.1f;
  s.accum = clear ? 0 : (post_keep ? (decide ? 0 : accum1) : s.accum);
  s.count = clear ? 0 : (post_keep ? (decide ? 0 : count1) : s.count);
  s.bsc = clear ? 0 : (post_keep ? bsc1 : s.bsc);
  s.nxt = clear ? 0 : ((post_keep && decide) ? s.nxt + c.ds_per_bit : s.nxt);
  s.byte_cur = (clear || emit) ? 0 : (data_write ? byte1 : s.byte_cur);
  s.pos = (clear || emit) ? 0 : (ok_advance ? pos + 1 : pos);
  return ev;
}

}  // namespace wam
