// The first two warps of the sequential-DSP pipelines, K1 (fsk_seq.cu)
// and K6 (psk_seq.cu): one block of kLanes channels, each lane one
// channel in every warp, each channel's arithmetic the one ordered chain
// of the plain versions.
//
//   warp 0  `copy_agc`: copies the input kAhead tiles ahead (cp.async,
//           each lane its own column) and runs the AGC, writing y to the
//           Y ring, kTile samples a slot;
//   warp 1  `front_sums`: band-pass, NCO, mix, I/Q low-pass and the
//           downsample group sums, writing (sum_i, sum_q) per group to
//           the G ring, kGTile groups a slot.
//
// The kernel's own warps take each G slot from there: a slot is FULL
// once warp 1 has written it (arriving with the threads of the warps
// that sync on FULL), MID is the kernel's own hand-over inside the slot,
// and warp 1 syncs on the slot's EMPTY (with the threads of the warps
// that arrive on it) before it fills the slot again.  The counts of FULL
// and EMPTY are template parameters of `front_sums`.  Lanes past B read
// the last channel's column and store nothing, so every lane of every
// warp keeps arriving at the barriers.
//
// Shared memory, from the dynamic base: the X ring [kXSlots][kTile][32],
// the Y ring [kYSlots][kTile][32], the G ring [kGSlots][2][kGTile][32]
// (I, then Q); kTileBytes in all.  Named barriers 1..15 (warp_pipe.cuh).

#pragma once

#include "seq_front.cuh"
#include "warp_pipe.cuh"

namespace wam {
namespace pipe {

constexpr int kLanes = 32;            // channels per block
constexpr int kTile = 32;             // samples per x / y tile
constexpr int kAhead = 2;             // x tiles copied ahead of the AGC
constexpr int kXSlots = kAhead + 1;
constexpr int kYSlots = 3;
constexpr int kGTile = 16;            // groups per G tile
constexpr int kGSlots = 3;

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
constexpr size_t kTileBytes = (kXFloats + kYFloats + kGFloats) * 4;

// the rings, from the dynamic shared memory base
struct Rings {
  float* xr;   // [kXSlots][kTile][32]
  float* yr;   // [kYSlots][kTile][32]
  float* gr;   // [kGSlots][2][kGTile][32]: I, Q
  __device__ __forceinline__ explicit Rings(unsigned char* smem)
      : xr(reinterpret_cast<float*>(smem)),
        yr(reinterpret_cast<float*>(smem) + kXFloats),
        gr(reinterpret_cast<float*>(smem) + kXFloats + kYFloats) {}
};

// Warp 0: copies kAhead tiles ahead, and the AGC; stores the gain (row 0
// of the front plane).
__device__ __forceinline__ void copy_agc(const Rings& r,
                                         const float* __restrict__ x, int T,
                                         size_t Bs, int lane, int b, int bl,
                                         bool store,
                                         const float* __restrict__ front_in,
                                         float* __restrict__ front_out,
                                         const FskSeqCoef& c) {
  const int n_tiles = (T + kTile - 1) / kTile;
  Front fr;
  fr.g = front_in[bl];
  auto copy_tile = [&](int k) {
    if (k < n_tiles) {
      float* dst = r.xr + (k % kXSlots) * kTile * kLanes + lane;
      const float* src = x + static_cast<size_t>(k) * kTile * Bs + bl;
      const int m = min(kTile, T - k * kTile);
      for (int u = 0; u < m; ++u) cp_async4(dst + u * kLanes, src + u * Bs);
    }
    cp_async_commit();
  };
  for (int k = 0; k < kAhead; ++k) copy_tile(k);
  for (int k = 0; k < n_tiles; ++k) {
    copy_tile(k + kAhead);
    cp_async_wait<kAhead>();
    const int s = k % kYSlots;
    if (k >= kYSlots) bar_sync(y_empty(s), 2 * kLanes);
    const float* xs = r.xr + (k % kXSlots) * kTile * kLanes + lane;
    float* ys = r.yr + s * kTile * kLanes + lane;
    const int m = min(kTile, T - k * kTile);
#pragma unroll 4
    for (int u = 0; u < m; ++u) ys[u * kLanes] = fr.agc(c, xs[u * kLanes]);
    bar_arrive(y_full(s), 2 * kLanes);
  }
  if (store) front_out[b] = fr.g;
}

// Warp 1: band-pass, NCO, mix, I/Q low-pass, group sums; stores rows
// 1..14 of the front plane and the pending sums.  kFull threads meet on
// each G slot's FULL barrier, kEmpty on its EMPTY barrier.
template <int kFull, int kEmpty>
__device__ __forceinline__ void front_sums(
    const Rings& r, int T, size_t Bs, int lane, int b, int bl, bool store,
    const float* __restrict__ front_in, float* __restrict__ front_out,
    const float* __restrict__ acc_in, float* __restrict__ acc_out,
    int ds_phase, const FskSeqCoef& c) {
  const int n_tiles = (T + kTile - 1) / kTile;
  Front fr;
  fr.load(front_in, Bs, bl);
  float acc_i = ds_phase > 0 ? acc_in[bl] : 0.0f;
  float acc_q = ds_phase > 0 ? acc_in[Bs + bl] : 0.0f;
  int phase = ds_phase;
  int gpos = 0, gt = 0;   // groups in the open G tile; G tiles handed on
  for (int k = 0; k < n_tiles; ++k) {
    const int s = k % kYSlots;
    bar_sync(y_full(s), 2 * kLanes);
    const float* ys = r.yr + s * kTile * kLanes + lane;
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
      if (gpos == 0 && gt >= kGSlots) bar_sync(g_empty(gs), kEmpty);
      float* g = r.gr + gs * 2 * kGTile * kLanes + gpos * kLanes + lane;
      g[0] = acc_i;
      g[kGTile * kLanes] = acc_q;
      if (++gpos == kGTile) {
        bar_arrive(g_full(gs), kFull);
        gpos = 0;
        ++gt;
      }
    }
    if (k + kYSlots < n_tiles) bar_arrive(y_empty(s), 2 * kLanes);
  }
  if (gpos > 0) bar_arrive(g_full(gt % kGSlots), kFull);
  if (store) {
    fr.store(front_out, Bs, b, 1);
    // pending sums only while a group is open (the reference returns 0
    // when the chunk ends on a group boundary)
    acc_out[b] = phase != 0 ? acc_i : 0.0f;
    acc_out[Bs + b] = phase != 0 ? acc_q : 0.0f;
  }
}

}  // namespace pipe
}  // namespace wam
