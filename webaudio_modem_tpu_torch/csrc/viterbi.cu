// K3 — batched soft-decision Viterbi decoder, K=7 rate 1/2, 64 states.
//
// Replaces webaudio_modem_tpu/ops/pallas/viterbi.py `_kernel` (through
// `decode(soft, n_bits)`), which ops/fec.py `_viterbi_core` dispatches
// at farm widths.  Same arithmetic as the reference's lax scan and its
// Pallas kernel, op for op:
//   * path metrics start at -1e9 except state 0 (0);
//   * each branch term is ONE of +a, -a, +d, -d with a = x0 + x1 and
//     d = x0 - x1 (the static selection of the reference's
//     `_branch_terms`, derived here at compile time from the generator
//     taps G0 = 0o171, G1 = 0o133);
//   * candidate c_h = pm[(s2 >> 1) | (h << 5)] + term, decision
//     c1 > c0 (strict: ties keep h = 0);
//   * after every 16 steps (never after a remainder of fewer than 16)
//     subtract the max over the 64 states (max is exact);
//   * traceback from state 0: the input bit is the state's LSB, the
//     predecessor (s >> 1) | (h << 5).
// So the decoded bits equal the plain PyTorch version
// (ops/kernels/viterbi.py:decode_plain) bit for bit.
//
// Design.  One thread per lane (channel x candidate); its 64 path
// metrics and the 64 new ones live in registers (the butterfly is fully
// unrolled with compile-time state indices; steps alternate the two
// arrays).  a and d are read time-major [T, L], so a warp's loads at one
// step are 32 consecutive words; the next step's pair is loaded before
// the current step's 64 ACS run.  The decision bits of a step pack into
// two u32 words (bit s2 of word s2 / 32) stored to a global [T, 2, L]
// scratch, which the same thread reads back for the traceback, both
// words of a step at once so the loads do not wait on the state.  Bits
// come out as u8 [T, L].
//
// What bounds it on an H100.  Per lane and step: 128 f32 adds, 64
// compares, 64 selects — ~256 operations on ~8 input bytes and 9 output
// bytes, so the operations bound it (f32 at 67 TFLOP/s), not memory.
// The header decode (L = 16,384, T = 38) is ~160 M operations, a few
// microseconds at that rate; with one warp per 32 lanes the kernel is
// latency-bound well above it.  Filling the card better (several lanes
// per thread, or the 64 states split over threads) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStates = 64;
constexpr int kHalf = kStates / 2;
constexpr int kGroup = 16;        // normalization period (steps)
constexpr int kThreads = 32;
constexpr int kG0 = 0171;         // generator taps, octal
constexpr int kG1 = 0133;

__host__ __device__ constexpr int parity8(int x) {
  x ^= x >> 4;
  x ^= x >> 2;
  x ^= x >> 1;
  return x & 1;
}

// The branch term of the transition pred(s2, h) -> s2: the two coded
// bits emitted from state s = (s2 >> 1) | (h << 5) on input bit s2 & 1
// are (o0, o1); their ±1 correlation with (x0, x1) is ±a when o0 == o1,
// else ±d, with the sign of o0.
__device__ __forceinline__ float branch(int s2, int h, float a, float na,
                                        float d, float nd) {
  const int s = (s2 >> 1) | (h << 5);
  const int reg = (s << 1) | (s2 & 1);
  const int o0 = parity8(reg & kG0);
  const int o1 = parity8(reg & kG1);
  return o0 == o1 ? (o0 ? a : na) : (o0 ? d : nd);
}

// One add-compare-select step: pm -> nw, decisions packed in (w0, w1).
__device__ __forceinline__ void acs(const float (&pm)[kStates],
                                    float (&nw)[kStates], float a, float d,
                                    uint32_t& w0, uint32_t& w1) {
  const float na = -a;
  const float nd = -d;
  w0 = 0u;
  w1 = 0u;
#pragma unroll
  for (int s2 = 0; s2 < kStates; ++s2) {
    const int j = s2 >> 1;
    const float c0 = pm[j] + branch(s2, 0, a, na, d, nd);
    const float c1 = pm[j + kHalf] + branch(s2, 1, a, na, d, nd);
    const bool dec = c1 > c0;
    nw[s2] = dec ? c1 : c0;
    if (s2 < 32) {
      w0 |= static_cast<uint32_t>(dec) << s2;
    } else {
      w1 |= static_cast<uint32_t>(dec) << (s2 - 32);
    }
  }
}

__device__ __forceinline__ void normalize(float (&pm)[kStates]) {
  float m = pm[0];
#pragma unroll
  for (int s = 1; s < kStates; ++s) m = fmaxf(m, pm[s]);
#pragma unroll
  for (int s = 0; s < kStates; ++s) pm[s] = pm[s] - m;
}

__global__ void __launch_bounds__(kThreads)
viterbi_kernel(const float* __restrict__ a, const float* __restrict__ d,
               int T, int L, uint32_t* __restrict__ dec,
               uint8_t* __restrict__ bits) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const size_t Ls = static_cast<size_t>(L);

  float pm[kStates];
  float nw[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) pm[s] = s == 0 ? 0.0f : -1e9f;

  float an = a[l];
  float dn = d[l];
  for (int t = 0; t < T; t += 2) {
    // step t: pm -> nw
    float at = an, dt = dn;
    if (t + 1 < T) {
      an = a[(t + 1) * Ls + l];
      dn = d[(t + 1) * Ls + l];
    }
    uint32_t w0, w1;
    acs(pm, nw, at, dt, w0, w1);
    dec[(2 * static_cast<size_t>(t)) * Ls + l] = w0;
    dec[(2 * static_cast<size_t>(t) + 1) * Ls + l] = w1;
    if (t + 1 >= T) break;
    // step t + 1: nw -> pm
    at = an;
    dt = dn;
    if (t + 2 < T) {
      an = a[(t + 2) * Ls + l];
      dn = d[(t + 2) * Ls + l];
    }
    acs(nw, pm, at, dt, w0, w1);
    dec[(2 * static_cast<size_t>(t + 1)) * Ls + l] = w0;
    dec[(2 * static_cast<size_t>(t + 1) + 1) * Ls + l] = w1;
    // t + 2 steps are done; groups of 16 end on even counts
    if ((t + 2) % kGroup == 0) normalize(pm);
  }

  // traceback from state 0 (the trellis is flushed)
  int st = 0;
  for (int t = T - 1; t >= 0; --t) {
    const uint32_t lo = dec[(2 * static_cast<size_t>(t)) * Ls + l];
    const uint32_t hi = dec[(2 * static_cast<size_t>(t) + 1) * Ls + l];
    const uint32_t w = st < 32 ? lo : hi;
    const int h = static_cast<int>((w >> (st & 31)) & 1u);
    bits[static_cast<size_t>(t) * Ls + l] = static_cast<uint8_t>(st & 1);
    st = (st >> 1) | (h << 5);
  }
}

}  // namespace

// a, d f32 [T, L] time-major (a = x0 + x1, d = x0 - x1 per coded pair);
// dec u32 [T, 2, L] scratch; bits u8 [T, L] (the input bit of each
// step).  T >= 1, L >= 1.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int wam_viterbi(const float* a, const float* d, int T, int L,
                           void* dec, void* bits, void* stream) {
  const int blocks = (L + kThreads - 1) / kThreads;
  viterbi_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, d, T, L, static_cast<uint32_t*>(dec), static_cast<uint8_t*>(bits));
  return static_cast<int>(cudaGetLastError());
}
