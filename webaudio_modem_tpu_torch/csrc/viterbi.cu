// K3 — batched soft-decision Viterbi decoder, K=7 rate 1/2, 64 states.
//
// Replaces webaudio_modem_tpu/ops/pallas/viterbi.py `_kernel` (through
// `decode(soft, n_bits)`), which ops/fec.py `_viterbi_core` dispatches
// at farm widths.  Same arithmetic as the reference's lax scan and its
// Pallas kernel, op for op:
//   * path metrics start at -1e9 except state 0 (0);
//   * a = x0 + x1 and d = x0 - x1, one f32 add each, from the coded
//     pair (x0, x1) of a step, read in place from the soft view;
//   * each branch term is ONE of +a, -a, +d, -d (the static selection
//     of the reference's `_branch_terms`, derived here at compile time
//     from the generator taps G0 = 0o171, G1 = 0o133);
//   * candidate c_h = pm[(s2 >> 1) | (h << 5)] + term, decision
//     c1 > c0 (strict: ties keep h = 0);
//   * after every 16 steps (never after a remainder of fewer than 16)
//     subtract the max over the 64 states (max is exact);
//   * traceback from state 0: the input bit is the state's LSB, the
//     predecessor (s >> 1) | (h << 5).
// So the decoded bits equal the plain PyTorch version
// (ops/kernels/viterbi.py:decode_plain) bit for bit.
//
// Design.  Both generators tap the register's first and last bit, so
// the transitions form 32 butterflies: predecessors j and j + 32 feed
// new states 2j and 2j + 1 with the terms +t / -t and -t / +t, t the
// term of (2j, h = 0).  A trellis runs on a group of G threads (G a
// template parameter: 1, 8 or 32); thread k holds P = 32 / G
// butterflies, j = kP .. kP + P - 1, and computes new states 2kP ..
// 2kP + 2P - 1.
// Next step it needs states kP + i and 32 + kP + i, which threads
// k / 2 and G / 2 + k / 2 made: four warp shuffles a butterfly carry
// them over (G = 1 renames registers).  A decision c1 > c0 is the sign
// bit of c0 - c1 and the survivor fmaxf(c0, c1), exactly (see
// `butterflies`); shuffles and maxes only move values, so each
// candidate stays one f32 add.  The normalization is a max in the
// thread, then across the group by shuffles.  A step's 64 decisions
// form one 64-bit record: for G = 1 and 8 each thread stores its 2P
// bits as one 8- or 1-byte piece (record bit = state); for G = 32, two
// `__ballot_sync` words (record bit (s % 2) * 32 + s / 2).  The records
// live in shared memory, [T][trellises of the block], while the
// block's T x 8 bytes a trellis fit kSmemBudget, else
// in a device-memory scratch [T][L]; the two are instantiations of one
// kernel and the wrapper picks by T.  The traceback (thread 0 of a
// group) loads 4 records ahead (16 from device memory): their addresses
// do not depend on the state, so only a shift and a mask remain on its
// chain.  The soft view is read with its three strides (lane, step,
// pair) a few steps ahead of the trellis (`ahead`).
//
// What bounds it on an H100.  Per trellis and step 128 f32 adds, 64
// subtractions, 64 maxes and 64 funnel shifts (~320 operations on 8
// input bytes): the operations bound it (the bound of chip_smoke.py
// counts the parent's 256 a step, at 67 TFLOP/s).  The maxes and shifts
// run at half the adds' rate.  G trades issue efficiency (G = 1: no
// exchange, one warp per 32 trellises) against warps in flight (G = 32:
// one warp per trellis, 4 shuffles and 2 ballots a step); the wrapper
// picks G from L (ops/kernels/viterbi.py `pick`, from a ladder of the
// widths measured on an H100, PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStates = 64;
constexpr int kNormPeriod = 16;   // normalization period (steps)
constexpr int kThreads = 128;
constexpr int kSmemBudget = 112 * 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kG0 = 0171;         // generator taps, octal
constexpr int kG1 = 0133;

__host__ __device__ constexpr int parity8(int x) {
  x ^= x >> 4;
  x ^= x >> 2;
  x ^= x >> 1;
  return x & 1;
}

// The branch term of pred(s2, h) -> s2 as an index into (+a, -a, +d,
// -d): the coded bits emitted from state (s2 >> 1) | (h << 5) on input
// bit s2 & 1 are (o0, o1); their +-1 correlation with (x0, x1) is +-a
// when o0 == o1, else +-d, with the sign of o0.
__host__ __device__ constexpr int term_index(int s2, int h) {
  const int reg = s2 | (h << 6);
  const int o0 = parity8(reg & kG0);
  const int o1 = parity8(reg & kG1);
  return (o0 == o1 ? 0 : 2) + (o0 ? 0 : 1);
}

__host__ __device__ constexpr bool butterflies() {
  for (int j = 0; j < kStates / 2; ++j) {
    const int t = term_index(2 * j, 0);
    if (term_index(2 * j, 1) != (t ^ 1) ||
        term_index(2 * j + 1, 0) != (t ^ 1) ||
        term_index(2 * j + 1, 1) != t)
      return false;
  }
  return true;
}
static_assert(butterflies(), "the code's transitions are not butterflies");

// bit j: butterfly j's term t is +-d (else +-a); is negative
__host__ __device__ constexpr uint32_t term_mask(int bit) {
  uint32_t m = 0;
  for (int j = 0; j < kStates / 2; ++j)
    m |= static_cast<uint32_t>((term_index(2 * j, 0) >> bit) & 1) << j;
  return m;
}
constexpr uint32_t kKindD = term_mask(1);
constexpr uint32_t kNegative = term_mask(0);

// Steps of the soft view loaded ahead of the trellis, a divisor of the
// normalization period: few for G = 1, whose unrolled steps are long (it
// holds 64 metrics in registers).
template <int G>
__host__ __device__ constexpr int ahead() {
  return G == 1 ? 2 : 16;
}

template <int G>
__host__ __device__ constexpr int record_bit(int s) {
  return G < 32 ? s : (s % (64 / G)) * G + s / (64 / G);
}

// the piece of a record that each thread of a group of 1 < G < 32 stores
template <int G> struct Piece;
template <> struct Piece<8> { typedef uint8_t type; };

// The P butterflies of one thread in one step: lo[i] / hi[i] are the
// metrics of states kP + i and 32 + kP + i; nw[o] receives new state
// 2kP + o, and bit o of the result its decision.  c1 > c0 is the sign
// of c0 - c1: a metric is never -0 (it starts +0 or -1e9, and an RN sum
// is -0 only of two -0), so equal candidates give +0, and without
// flush-to-zero a nonzero difference keeps its sign; the larger
// candidate is fmaxf of the two.  One subtraction, a funnel shift and a
// max a state instead of a compare, a select and the packing.
template <int P>
__device__ __forceinline__ unsigned long long butterflies(
    const float (&lo)[P], const float (&hi)[P], float (&nw)[2 * P],
    float x0, float x1, uint32_t kind_d, uint32_t negative) {
  const float a = x0 + x1;
  const float d = x0 - x1;
  const float na = -a;
  const float nd = -d;
  uint32_t w0 = 0, w1 = 0;   // decisions of new states 0-31, 32-63
#pragma unroll
  for (int i = P - 1; i >= 0; --i) {
    const bool is_d = (kind_d >> i) & 1u;
    const bool neg = (negative >> i) & 1u;
    const float t = is_d ? (neg ? nd : d) : (neg ? na : a);
    const float c00 = lo[i] + t;   // new state 2j, h = 0
    const float c01 = hi[i] - t;   //               h = 1
    const float c10 = lo[i] - t;   // new state 2j + 1
    const float c11 = hi[i] + t;
    nw[2 * i] = fmaxf(c00, c01);
    nw[2 * i + 1] = fmaxf(c10, c11);
    // state 2i + 1, then 2i: state o ends at bit o % 32
    uint32_t& w = 2 * i >= 32 ? w1 : w0;
    w = __funnelshift_l(__float_as_uint(c10 - c11), w, 1);
    w = __funnelshift_l(__float_as_uint(c00 - c01), w, 1);
  }
  return static_cast<unsigned long long>(w0) |
         (static_cast<unsigned long long>(w1) << 32);
}

// Hands a group of G >= 2 threads its next step's states: kP + i and
// 32 + kP + i come from threads k / 2 and G / 2 + k / 2, at offset
// (k & 1) * P + i of their new states.
template <int G>
__device__ __forceinline__ void exchange(const float (&nw)[64 / G],
                                         float (&lo)[32 / G],
                                         float (&hi)[32 / G], int k) {
  constexpr int P = 32 / G;
  const int src_lo = k >> 1;
  const int src_hi = G / 2 + (k >> 1);
  const bool odd = k & 1;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const float e0 = __shfl_sync(kFull, nw[i], src_lo, G);
    const float e1 = __shfl_sync(kFull, nw[P + i], src_lo, G);
    const float f0 = __shfl_sync(kFull, nw[i], src_hi, G);
    const float f1 = __shfl_sync(kFull, nw[P + i], src_hi, G);
    lo[i] = odd ? e1 : e0;
    hi[i] = odd ? f1 : f0;
  }
}

template <int G>
__device__ __forceinline__ void normalize(float (&lo)[32 / G],
                                          float (&hi)[32 / G]) {
  constexpr int P = 32 / G;
  float m = lo[0];
#pragma unroll
  for (int i = 0; i < P; ++i) m = fmaxf(m, fmaxf(lo[i], hi[i]));
#pragma unroll
  for (int off = G / 2; off >= 1; off /= 2)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off, G));
#pragma unroll
  for (int i = 0; i < P; ++i) {
    lo[i] = lo[i] - m;
    hi[i] = hi[i] - m;
  }
}

// One step and its record.  G = 1 holds all 64 states in one thread:
// no exchange, the new metrics are the old arrays renamed.
template <int G>
__device__ __forceinline__ void step(float (&lo)[32 / G],
                                     float (&hi)[32 / G], float x0,
                                     float x1, uint32_t kind_d,
                                     uint32_t negative, int k,
                                     bool store, unsigned long long* rec) {
  constexpr int P = 32 / G;
  float nw[2 * P];
  const unsigned long long dec =
      butterflies<P>(lo, hi, nw, x0, x1, kind_d, negative);
  if constexpr (G == 1) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      lo[i] = nw[i];
      hi[i] = nw[P + i];
    }
    if (store) *rec = dec;
  } else {
    exchange<G>(nw, lo, hi, k);
    if constexpr (G == 32) {
      // the 2P decisions of each thread, gathered over the warp by
      // ballots: record bit o * G + k
      unsigned long long r = 0;
#pragma unroll
      for (int o = 0; o < 2 * P; ++o) {
        const uint32_t w = __ballot_sync(kFull, (dec >> o) & 1u);
        r |= static_cast<unsigned long long>(w) << (o * G);
      }
      if (store && k == 0) *rec = r;
    } else {
      if (store)
        reinterpret_cast<typename Piece<G>::type*>(rec)[k] =
            static_cast<typename Piece<G>::type>(dec);
    }
  }
}

__device__ __forceinline__ void load_pair(const float* p, long long s_pair,
                                          bool pair_vec, float& x0,
                                          float& x1) {
  if (pair_vec) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x0 = v.x;
    x1 = v.y;
  } else {
    x0 = p[0];
    x1 = p[s_pair];
  }
}

template <int G, bool kShared>
__global__ void __launch_bounds__(kThreads)
viterbi_kernel(const float* __restrict__ soft, int T, int L,
               long long s_lane, long long s_step, long long s_pair,
               unsigned long long* __restrict__ dec,
               uint8_t* __restrict__ bits) {
  constexpr int P = 32 / G;
  constexpr int kTrellises = kThreads / G;
  extern __shared__ unsigned long long records[];
  const int tid = threadIdx.x;
  const int k = tid % G;
  const int tb = tid / G;
  const long long l_raw = static_cast<long long>(blockIdx.x) * kTrellises +
                          tb;
  const bool active = l_raw < L;
  // lanes past L run the steps on lane L - 1's inputs for the shuffles,
  // and store nothing
  const long long l = active ? l_raw : L - 1;
  const float* src = soft + l * s_lane;
  unsigned long long* rec = kShared ? records + tb : dec + l;
  const size_t rec_stride = kShared ? kTrellises : static_cast<size_t>(L);

  // a coded pair adjacent and 8-byte aligned at every (lane, step): one
  // 8-byte load a step
  const bool pair_vec = s_pair == 1 && s_step % 2 == 0 && s_lane % 2 == 0 &&
                        reinterpret_cast<uintptr_t>(soft) % 8 == 0;
  {
    constexpr int kAhead = ahead<G>();
    static_assert(kNormPeriod % kAhead == 0, "a block of steps ends a "
                  "period only where the period does");
    const uint32_t kind_d = static_cast<uint32_t>(
        (static_cast<unsigned long long>(kKindD) >> (k * P)) &
        ((1ull << P) - 1));
    const uint32_t negative = static_cast<uint32_t>(
        (static_cast<unsigned long long>(kNegative) >> (k * P)) &
        ((1ull << P) - 1));
    float lo[P];
    float hi[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      lo[i] = k * P + i == 0 ? 0.0f : -1e9f;
      hi[i] = -1e9f;
    }
    float c0[kAhead], c1[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (u < T) load_pair(src + u * s_step, s_pair, pair_vec, c0[u], c1[u]);
    }
    for (int t0 = 0; t0 < T; t0 += kAhead) {
      float n0[kAhead], n1[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const long long tn = t0 + kAhead + u;
        if (tn < T)
          load_pair(src + tn * s_step, s_pair, pair_vec, n0[u], n1[u]);
      }
      if (t0 + kAhead <= T) {
#pragma unroll
        for (int u = 0; u < kAhead; ++u)
          step<G>(lo, hi, c0[u], c1[u], kind_d, negative, k, active,
                  rec + (t0 + u) * rec_stride);
        if ((t0 + kAhead) % kNormPeriod == 0) normalize<G>(lo, hi);
      } else {
        // the remainder, fewer than kAhead steps from a multiple of
        // kAhead: it ends before the next multiple of 16, so it is never
        // normalized
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (u < T - t0)
            step<G>(lo, hi, c0[u], c1[u], kind_d, negative, k, active,
                    rec + (t0 + u) * rec_stride);
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        c0[u] = n0[u];
        c1[u] = n1[u];
      }
    }
  }
  if constexpr (G > 1) __syncwarp();

  // traceback from state 0 (the trellis is flushed)
  if (!active || k != 0) return;
  const size_t Ls = static_cast<size_t>(L);
  int st = 0;
  int t = T - 1;
  // records loaded ahead of the state chain: more from device memory
  constexpr int kBack = kShared ? 4 : 16;
  for (; t >= kBack - 1; t -= kBack) {
    unsigned long long w[kBack];
#pragma unroll
    for (int u = 0; u < kBack; ++u) w[u] = rec[(t - u) * rec_stride];
#pragma unroll
    for (int u = 0; u < kBack; ++u) {
      const int h = static_cast<int>((w[u] >> record_bit<G>(st)) & 1ull);
      bits[static_cast<size_t>(t - u) * Ls + l] =
          static_cast<uint8_t>(st & 1);
      st = (st >> 1) | (h << 5);
    }
  }
  for (; t >= 0; --t) {
    const unsigned long long w = rec[t * rec_stride];
    const int h = static_cast<int>((w >> record_bit<G>(st)) & 1ull);
    bits[static_cast<size_t>(t) * Ls + l] = static_cast<uint8_t>(st & 1);
    st = (st >> 1) | (h << 5);
  }
}

template <int G, bool kShared>
int launch(const float* soft, int T, int L, long long s_lane,
           long long s_step, long long s_pair, void* dec, void* bits,
           cudaStream_t stream) {
  constexpr int kTrellises = kThreads / G;
  const size_t smem =
      kShared ? static_cast<size_t>(kTrellises) * T * 8 : 0;
  if (smem > kSmemBudget) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    static bool raised = false;
    if (!raised) {
      const int err = static_cast<int>(cudaFuncSetAttribute(
          viterbi_kernel<G, kShared>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget));
      if (err) return err;
      raised = true;
    }
  }
  const int blocks = (L + kTrellises - 1) / kTrellises;
  viterbi_kernel<G, kShared><<<blocks, kThreads, smem, stream>>>(
      soft, T, L, s_lane, s_step, s_pair,
      static_cast<unsigned long long*>(dec), static_cast<uint8_t*>(bits));
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_g(int shared, const float* soft, int T, int L, long long s_lane,
             long long s_step, long long s_pair, void* dec, void* bits,
             cudaStream_t stream) {
  return shared ? launch<G, true>(soft, T, L, s_lane, s_step, s_pair, dec,
                                  bits, stream)
                : launch<G, false>(soft, T, L, s_lane, s_step, s_pair, dec,
                                   bits, stream);
}

}  // namespace

// soft f32: element (l, t, c) of the soft view at
// soft[l * s_lane + t * s_step + c * s_pair] (strides in elements),
// l < L, t < T, c < 2; group: threads per trellis (1, 8, 32);
// shared: decision records in shared memory (needs (128 / group) * T * 8
// <= 112 KiB), else in dec, u64 [T, L] scratch; bits u8 [T, L] (the input
// bit of each step).  T >= 1, L >= 1.  Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a group or shared
// placement it does not take.
extern "C" int wam_viterbi(const float* soft, int T, int L, long long s_lane,
                           long long s_step, long long s_pair, int group,
                           int shared, void* dec, void* bits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1:
      return launch_g<1>(shared, soft, T, L, s_lane, s_step, s_pair, dec,
                         bits, s);
    case 8:
      return launch_g<8>(shared, soft, T, L, s_lane, s_step, s_pair, dec,
                         bits, s);
    case 32:
      return launch_g<32>(shared, soft, T, L, s_lane, s_step, s_pair, dec,
                          bits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
