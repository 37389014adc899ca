// K4 — per-channel aligned LLR windows of the soft decode.
//
// Replaces webaudio_modem_tpu/ops/pallas/align.py `_kernel` (through
// `aligned_wsum`) and the lax barrel shifters it is bit-identical to
// (ops/soft_fsk.py `_aligned_rows` / `_aligned_strided`):
//
//   out[j, b] = wsumpad[base[b] + j * stride, b]
//   wsumpad   = pad_lo zero rows ++ pol * (csum[i + ds] - csum[i]),
//               i < n_wsum, then zeros
//
// With `virt0` the plane is the INCLUSIVE cumsum (K1's csum stream):
// csum[i] reads x[i - 1] and csum[0] is an exact zero, as if a zero row
// were prepended.  Each output is the same single f32 subtraction of
// the same two rows, then the +-1 multiply, as the reference; rows
// outside the plane are exact zeros.
//
// Design.  The TPU needed a select ladder because a per-lane gather
// serializes there; a GPU gathers per lane natively.  A 2-D grid:
// channels on x, so that a warp holds 32 consecutive channels and its
// stores at one j are 128 contiguous bytes; runs of outputs on y (and
// the run's phase on z), so no thread divides.  Where ds is a multiple
// of the stride (both calls of the soft decode: stride 1 and stride
// ds), output j's high row is output j + ds / stride's low row: a
// thread walks a chain j0, j0 + ds / stride, ... of kRun outputs and
// loads its kRun + 1 rows once each, all issued before the first
// subtraction.  Other strides load two rows an output.
//
// What bounds it on an H100.  One read of each needed row and one write
// of each output, one subtraction and one multiply an output: memory.
// At the header window (1,532 x 4,096 outputs) that is ~50 MB, 15 us at
// 3.35 TB/s.  The chains reload one row in kRun + 1 at their ends, and a
// warp's loads cover 32 channels at their own rows: one 128-byte line
// where the channels' bases agree, up to 32 sectors where they do not.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRun = 8;           // outputs a thread

template <bool kChain>
__global__ void __launch_bounds__(kThreads)
align_kernel(const float* __restrict__ csum, int n_rows, int B,
             const int32_t* __restrict__ base, int n_out, int ds, int stride,
             int pad_lo, float pol, int virt0, float* __restrict__ out) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = static_cast<size_t>(B);
  // rows of the csum as read: with virt0 a zero row comes first
  const long long n_virt = static_cast<long long>(n_rows) + virt0;
  const long long n_wsum = n_virt - ds;
  // virtual row i (virt0 <= i < n_virt) is csum row i - virt0
  const float* col = csum + b;
  const long long shift = virt0;
  // the chain's step in j (kChain) and its first output
  const int step = kChain ? ds / stride : 1;
  const long long j0 = static_cast<long long>(blockIdx.y) * step * kRun +
                       blockIdx.z;
  const long long r0 = static_cast<long long>(base[b]) + j0 * stride -
                       pad_lo;
  const long long r_step = static_cast<long long>(step) * stride;
  if (kChain) {
    // rows r0 + m * ds, m <= kRun: row m is output m's low row and
    // output m - 1's high row
    float v[kRun + 1];
#pragma unroll
    for (int m = 0; m <= kRun; ++m) {
      const long long i = r0 + m * r_step;
      const bool used = j0 + (m > 0 ? m - 1 : 0) * static_cast<long long>(
                                                       step) < n_out;
      v[m] = used && i >= shift && i < n_virt ? col[(i - shift) * Bs]
                                              : 0.0f;
    }
#pragma unroll
    for (int m = 0; m < kRun; ++m) {
      const long long j = j0 + static_cast<long long>(m) * step;
      if (j >= n_out) break;
      const long long r = r0 + m * r_step;
      out[j * Bs + b] = r >= 0 && r < n_wsum ? pol * (v[m + 1] - v[m])
                                             : 0.0f;
    }
  } else {
#pragma unroll
    for (int m = 0; m < kRun; ++m) {
      const long long j = j0 + m;
      if (j >= n_out) break;
      const long long r = r0 + m * static_cast<long long>(stride);
      float o = 0.0f;
      if (r >= 0 && r < n_wsum) {
        const float hi = col[(r + ds - shift) * Bs];
        const float lo = r < shift ? 0.0f : col[(r - shift) * Bs];
        o = pol * (hi - lo);
      }
      out[j * Bs + b] = o;
    }
  }
}

}  // namespace

// csum f32 [n_rows, B]; base i32 [B]; out f32 [n_out, B].  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int wam_align(const float* csum, int n_rows, int B,
                         const int32_t* base, int n_out, int ds, int stride,
                         int pad_lo, float pol, int virt0, float* out,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool chain = ds % stride == 0;
  const int step = chain ? ds / stride : 1;
  const long long run = static_cast<long long>(step) * kRun;
  dim3 grid((B + kThreads - 1) / kThreads,
            static_cast<unsigned>((n_out + run - 1) / run),
            static_cast<unsigned>(step < n_out ? step : n_out));
  if (chain) {
    align_kernel<true><<<grid, kThreads, 0, s>>>(
        csum, n_rows, B, base, n_out, ds, stride, pad_lo, pol, virt0, out);
  } else {
    align_kernel<false><<<grid, kThreads, 0, s>>>(
        csum, n_rows, B, base, n_out, ds, stride, pad_lo, pol, virt0, out);
  }
  return static_cast<int>(cudaGetLastError());
}
