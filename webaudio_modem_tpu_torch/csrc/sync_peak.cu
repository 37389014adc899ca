// The soft decode's sync peak (stage C): for every channel the first
// maximum over t of the sync match ratio, and its gate, in one pass over R.
//
// Replaces no TPU kernel.  The JAX package leaves this correlation to XLA
// (webaudio_modem_tpu/ops/fsk_demod.py `_sync_ratios_from_r`, a product
// with a ±1 band matrix, then an argmax); the port ran it the same way, as
// dense f32 GEMMs whose band rows hold 29 nonzeros in n_tau + 28 columns
// (98.7 % of the multiply-adds by zero at 133-byte frames, the work growing
// as T^2), then four passes of glue over the [n_ds, B] ratio plane, of
// which only t_peak and the gate are read.
//
// What it computes.  R bf16 [n_ds, B] (K1's ds-wide rolling bit sums,
// R(t, b) at t B + b), R(t) = 0 for t < 0 (a one-shot decode's zero tail):
//
//   m(t)       = sum_{j=1..taps} s_j R(t - j ds)      s_j = ±1, the pattern
//   ratio(t)   = (m(t) + n_zero ds) / W               t in [0, n_ds)
//   t_peak     = the first t of the largest ratio,    peak_ok = peak > thr
//
// as `_sync_ratios_from_r` with an all-zero tail, then argmax.  Every R is
// an integer in [0, ds], so every partial sum is an integer of magnitude
// at most a few taps ds: exact in f32, in any order, and exact in fp16
// while it stays within 2048 (the host checks the bound).  The maximum is
// taken over m (the ratio rises with it, and integers stay distinct over
// W); the peak's ratio alone is formed, by an IEEE division (no
// reciprocal, no fast math).
//
// What bounds it on an H100: reading R once, 2 bytes an element (375 MB at
// B = 4096 and 133-byte frames, 0.112 ms at 3.35 TB/s); nothing of size
// [n_ds, B] is written.  Summed directly, a count is `taps` adds an
// element, whose issue time (29 FFMAs, or 31 HFMA2s for two channels, and
// the loads' addressing) lies at 2-3 x the byte bound.  So the fast lane
// takes the reference's pattern as a compile-time constant and steps the
// count along a column by a recurrence, with sigma = ±1:
//
//   m(tau + 1) = sigma m(tau) + s_1 x(tau) + sum_{i=1..taps-1}
//                (s_(i+1) - sigma s_i) x(tau - i) - sigma s_taps x(tau - taps)
//
// (x the column's values, one a bit apart) whose coefficients are 0 or ±2
// but where the pattern changes its rhythm: 11 terms of 30 for the
// reference's, two channels at once in fp16.
//
// Design.  A thread owns a column: a phase phi = t mod ds and two adjacent
// channels (LaneRef, fp16, one 4-byte load a step, 128 B a warp) or one
// (LaneF32, f32, any pattern of up to 63 taps summed directly with the
// signs from the kernel's parameters), and walks tau = t div ds down it,
// holding the column's last kRing - 1 values in a register ring; the walk
// is unrolled over the ring, so every ring index is static.  Steps go in
// sub-chunks of kSub: the loads run kAhead sub-chunks ahead of the sums, in
// a register buffer of raw words (converted where summed: a conversion at
// the load would wait for it); a sub-chunk's counts are taken, then their
// maximum, and a sub-chunk whose maximum beats the column's best finds its
// first step of it.  The columns split into time segments over grid z,
// each re-reading the kRing - 1 steps before it (its halo), so that enough
// blocks run to keep the loads coming.  Each thread folds its best into a
// 64-bit key per channel, (m ordered as unsigned) << 32 | ~t, by atomicMax:
// the largest m wins, then the smallest t.  The last block to finish (a
// counter after __threadfence) turns every channel's key into t_peak and
// the gate, in place of the keys.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kThreads = 128;   // columns a block
constexpr int kSub = 8;         // steps a sub-chunk
constexpr int kAhead = 3;       // sub-chunks of loads in flight past the sums
constexpr int kMaxTaps = 63;    // the f32 lane's ring less one
// The reference's pattern (fsk.ts: preamble 0x55 0x55, SFD 0x7E, 8N1, 30
// bits) as its taps' signs: bit j set where s_j = +1, j = 1..29.
constexpr int kRefTaps = 29;
constexpr uint64_t kRefPlus = 0x156559faull;

// Filled by the host (ops/kernels/sync_peak.py `_plan`), passed by value.
struct SyncPlan {
  int32_t n_ds;                   // rows of R
  int32_t B;                      // channels
  int32_t ds;                     // samples a bit, the phases
  int32_t seg_steps;              // steps of tau a segment (grid z)
  int32_t taps;                   // the pattern's bits less one
  float n_zero_ds;                // taps of sign -1, times ds
  float window;                   // W
  float threshold;                // the sync gate
  uint64_t plus;                  // bit j set where s_j = +1
  float sign[kMaxTaps + 1];       // s_j at [j], 0 at [0] and past taps
};

namespace {

// One channel a thread in f32, any pattern: a step's count is the signed
// sum of its taps.
struct LaneF32 {
  typedef float T;
  static constexpr int kChannels = 1;
  static constexpr int kRing = kMaxTaps + 1;
  static constexpr int kMinBlocks = 2;
  __device__ __forceinline__ static T zero() { return 0.0f; }
  __device__ __forceinline__ static T lowest() { return -INFINITY; }
  __device__ __forceinline__ static uint32_t load(const uint16_t* p) {
    return *p;
  }
  __device__ __forceinline__ static T value(uint32_t w) {
    return __uint_as_float(w << 16);
  }
  __device__ __forceinline__ static T max(T a, T b) { return fmaxf(a, b); }
  __device__ __forceinline__ static float get(T v, int) { return v; }
  // the count before the segment's first step: not carried here
  __device__ __forceinline__ static T start(const SyncPlan&, const T*) {
    return 0.0f;
  }
  // m(tau) with x(tau - d) at ring[(k - d) mod kRing]
  __device__ __forceinline__ static T step(const SyncPlan& pl,
                                           const T* ring, int k, T) {
    T acc = 0.0f;               // from +0: no -0 reaches the key
#pragma unroll
    for (int j = 1; j < kRing; ++j) {
      acc = fmaf(pl.sign[j], ring[(k - j + kRing) % kRing], acc);
    }
    return acc;
  }
};

__host__ __device__ constexpr int ref_sign(int j) {
  return (kRefPlus >> j) & 1 ? 1 : -1;
}
// coefficient i = 0..taps of the recurrence, at sigma
__host__ __device__ constexpr int ref_coef(int sigma, int i) {
  return i == 0          ? ref_sign(1)
         : i == kRefTaps ? -sigma * ref_sign(kRefTaps)
                         : ref_sign(i + 1) - sigma * ref_sign(i);
}
__host__ __device__ constexpr int ref_terms(int sigma) {
  int n = 0;
  for (int i = 0; i <= kRefTaps; ++i) n += ref_coef(sigma, i) != 0;
  return n;
}
// sigma of the fewer terms
constexpr int kRefSigma = ref_terms(-1) <= ref_terms(1) ? -1 : 1;

// Two adjacent channels a thread in fp16, the reference's pattern: a
// step's count by the recurrence above.
struct LaneRef {
  typedef __half2 T;
  static constexpr int kChannels = 2;
  static constexpr int kRing = 32;        // x(tau - 31) .. x(tau)
  static constexpr int kMinBlocks = 4;
  static_assert(kRefTaps + 2 <= kRing, "the recurrence reads taps + 1 back");
  __device__ __forceinline__ static T zero() {
    return __floats2half2_rn(0.0f, 0.0f);
  }
  __device__ __forceinline__ static T lowest() {
    return __floats2half2_rn(-INFINITY, -INFINITY);
  }
  __device__ __forceinline__ static uint32_t load(const uint16_t* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  __device__ __forceinline__ static T value(uint32_t w) {
    return __floats2half2_rn(__uint_as_float(w << 16),
                             __uint_as_float(w & 0xffff0000u));
  }
  __device__ __forceinline__ static T max(T a, T b) { return __hmax2(a, b); }
  __device__ __forceinline__ static float get(T v, int c) {
    return c ? __high2float(v) : __low2float(v);
  }
  // acc + c x for a constant c of -2, -1, 1 or 2
  __device__ __forceinline__ static T term(T acc, int c, T x) {
    if (c == 1) return __hadd2(acc, x);
    if (c == -1) return __hsub2(acc, x);
    return __hfma2(__floats2half2_rn(c, c), x, acc);
  }
  // m(tau0 - 1) of the segment at tau0, from the halo (x(tau0 - d) at
  // ring[kRing - d]), summed directly
  __device__ __forceinline__ static T start(const SyncPlan&, const T* ring) {
    T acc = zero();
#pragma unroll
    for (int j = 1; j <= kRefTaps; ++j) {
      acc = term(acc, ref_sign(j), ring[kRing - 1 - j]);
    }
    return acc;
  }
  // m(tau) from m(tau - 1), x(tau - 1 - i) at ring[(k - 1 - i) mod kRing]
  __device__ __forceinline__ static T step(const SyncPlan&, const T* ring,
                                           int k, T prev) {
    T acc = zero();
#pragma unroll
    for (int i = 0; i <= kRefTaps; ++i) {
      const int c = ref_coef(kRefSigma, i);
      if (c != 0) acc = term(acc, c, ring[(k - 1 - i + 2 * kRing) % kRing]);
    }
    return kRefSigma < 0 ? __hsub2(acc, prev) : __hadd2(acc, prev);
  }
};

// f32 bits -> an unsigned that orders as the floats do, and back
__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float unordered(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// the raw words of kSub steps of a column from `q` (one step `stride`
// elements on), 0 from the step `left` on; `q` moves past them
template <class L>
__device__ __forceinline__ void fetch(const uint16_t*& q, long long stride,
                                      int left, uint32_t* dst) {
  if (left >= kSub) {
#pragma unroll
    for (int i = 0; i < kSub; ++i, q += stride) dst[i] = L::load(q);
  } else {
#pragma unroll
    for (int i = 0; i < kSub; ++i, q += stride) {
      dst[i] = i < left ? L::load(q) : 0u;
    }
  }
}

template <class L>
__global__ void __launch_bounds__(kThreads, L::kMinBlocks)
sync_kernel(const uint16_t* __restrict__ r, SyncPlan pl,
            unsigned long long* __restrict__ keys,
            uint8_t* __restrict__ peak_ok) {
  typedef typename L::T T;
  constexpr int kRing = L::kRing;
  constexpr int kBufs = kAhead + 1;
  static_assert(kRing % (kSub * kBufs) == 0, "buffers rotate in a body");
  extern __shared__ uint32_t smem[];            // the last block's flag
  const int b0 = (blockIdx.x * kThreads + threadIdx.x) * L::kChannels;
  const int phi = blockIdx.y;
  const int tau0 = blockIdx.z * pl.seg_steps;
  // this phase's steps with t = tau ds + phi < n_ds, cut at the segment
  const int tau_end = min(tau0 + pl.seg_steps,
                          (pl.n_ds - phi + pl.ds - 1) / pl.ds);
  if (b0 < pl.B && tau0 < tau_end) {
    const long long stride = static_cast<long long>(pl.ds) * pl.B;
    const uint16_t* p = r + phi * pl.B + b0;      // the column at tau = 0
    // ring[k] holds step tb + k of the body at tb; before the first body,
    // the halo: step tau0 - d at ring[kRing - d], 0 before t = 0
    T ring[kRing];
    ring[0] = L::zero();
#pragma unroll
    for (int d = 1; d < kRing; ++d) {
      const int tau = tau0 - d;
      ring[kRing - d] = tau >= 0 ? L::value(L::load(p + tau * stride))
                                 : L::zero();
    }
    T prev = L::start(pl, ring);
    // the loads run kAhead sub-chunks ahead of the sums, in a register
    // buffer of kBufs sub-chunks that rotates kRing / (kSub kBufs) times a
    // body, so its indices are static too
    uint32_t buf[kBufs][kSub];
    const uint16_t* q = p + tau0 * stride;        // the next fetch
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      fetch<L>(q, stride, tau_end - tau0 - a * kSub, buf[a]);
    }
    float best[L::kChannels];
    int best_tau[L::kChannels];
#pragma unroll
    for (int c = 0; c < L::kChannels; ++c) {
      best[c] = -INFINITY;
      best_tau[c] = 0;
    }
    for (int tb = tau0; tb < tau_end; tb += kRing) {
#pragma unroll
      for (int s = 0; s < kRing / kSub; ++s) {
        const int tau = tb + s * kSub;            // the sub-chunk's first
        if (tau >= tau_end) break;
        fetch<L>(q, stride, tau_end - tau - kAhead * kSub,
                 buf[(s + kAhead) % kBufs]);
        const uint32_t* x = buf[s % kBufs];
        T m[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int k = s * kSub + i;
          m[i] = prev = L::step(pl, ring, k, prev);
          ring[k] = L::value(x[i]);
        }
        if (tau + kSub > tau_end) {             // past the column's end
#pragma unroll
          for (int i = 0; i < kSub; ++i) {
            if (tau + i >= tau_end) m[i] = L::lowest();
          }
        }
        T top = m[0];
#pragma unroll
        for (int i = 1; i < kSub; ++i) top = L::max(top, m[i]);
#pragma unroll
        for (int c = 0; c < L::kChannels; ++c) {
          const float v = L::get(top, c);
          if (v > best[c]) {          // strictly: earlier steps keep ties
            int first = kSub - 1;
#pragma unroll
            for (int i = kSub - 2; i >= 0; --i) {
              if (L::get(m[i], c) == v) first = i;
            }
            best[c] = v;
            best_tau[c] = tau + first;
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < L::kChannels; ++c) {
      if (b0 + c < pl.B) {
        const uint32_t t = static_cast<uint32_t>(best_tau[c] * pl.ds + phi);
        atomicMax(&keys[b0 + c],
                  (static_cast<unsigned long long>(ordered(best[c])) << 32) |
                      (0xffffffffu - t));
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned n_blocks = gridDim.x * gridDim.y * gridDim.z;
    unsigned* done = reinterpret_cast<unsigned*>(keys + pl.B);
    smem[0] = atomicAdd(done, 1u) == n_blocks - 1;
  }
  __syncthreads();
  if (smem[0]) {                  // the last block: keys -> t_peak, gate
    __threadfence();
    volatile unsigned long long* vkeys = keys;
    for (int b = threadIdx.x; b < pl.B; b += kThreads) {
      const unsigned long long key = vkeys[b];
      const float matched =
          unordered(static_cast<uint32_t>(key >> 32)) + pl.n_zero_ds;
      peak_ok[b] = matched / pl.window > pl.threshold;
      keys[b] = 0xffffffffu - static_cast<uint32_t>(key);
    }
  }
}

template <class L>
int launch(const uint16_t* r, const SyncPlan* plan, int n_seg,
           unsigned long long* keys, uint8_t* peak_ok, void* stream) {
  const int cols = (plan->B + L::kChannels - 1) / L::kChannels;
  const dim3 grid((cols + kThreads - 1) / kThreads, plan->ds, n_seg);
  auto kernel = sync_kernel<L>;
  kernel<<<grid, kThreads, sizeof(uint32_t),
           static_cast<cudaStream_t>(stream)>>>(r, *plan, keys, peak_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r bf16 [n_ds, B] (as uint16), keys [B + 1] zeroed (t_peak int64 [B] on
// return, then the blocks' counter), peak_ok u8 [B].  fast != 0 takes the
// fp16 lane of the reference's pattern (refused, cudaErrorInvalidValue,
// for another; B even, r 4-byte aligned and the fp16 bound: the host
// checks), else the f32 lane (taps <= 63).  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int wam_sync_peak(const uint16_t* r, const SyncPlan* plan,
                             int n_seg, int fast, long long* keys,
                             uint8_t* peak_ok, void* stream) {
  unsigned long long* k = reinterpret_cast<unsigned long long*>(keys);
  if (!fast) return launch<LaneF32>(r, plan, n_seg, k, peak_ok, stream);
  if (plan->taps != kRefTaps || plan->plus != kRefPlus) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<LaneRef>(r, plan, n_seg, k, peak_ok, stream);
}
