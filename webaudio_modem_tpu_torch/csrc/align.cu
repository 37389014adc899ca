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
// serializes there; a GPU gathers per lane natively, so the barrel is
// gone: one thread per output element (j, b), b fastest, so a warp's
// stores are 32 consecutive words.  Its two loads hit row r and r + ds
// of its own channel; neighbouring channels sit at other rows, so a
// warp's load touches up to 32 sectors — the windows of consecutive j
// reuse them through L2.
//
// What bounds it on an H100.  Two reads and one write of 4 bytes per
// output, one subtraction and one multiply: memory.  At the header
// window (1,532 x 2,048 outputs) the bytes the data needs are ~25 MB,
// ~8 us at 3.35 TB/s; sector over-fetch on the scattered loads is what
// this simple form gives away.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
align_kernel(const float* __restrict__ csum, int n_rows, int B,
             const int32_t* __restrict__ base, int n_out, int ds, int stride,
             int pad_lo, float pol, int virt0, float* __restrict__ out) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (idx >= static_cast<size_t>(n_out) * B) return;
  const int b = static_cast<int>(idx % B);
  const long long j = static_cast<long long>(idx / B);
  const long long r = static_cast<long long>(base[b]) + j * stride - pad_lo;
  const long long n_wsum = static_cast<long long>(n_rows) + (virt0 ? 1 : 0) -
                           ds;
  const size_t Bs = static_cast<size_t>(B);
  float v = 0.0f;
  if (r >= 0 && r < n_wsum) {
    float hi, lo;
    if (virt0) {
      hi = csum[static_cast<size_t>(r + ds - 1) * Bs + b];
      lo = r == 0 ? 0.0f : csum[static_cast<size_t>(r - 1) * Bs + b];
    } else {
      hi = csum[static_cast<size_t>(r + ds) * Bs + b];
      lo = csum[static_cast<size_t>(r) * Bs + b];
    }
    v = pol * (hi - lo);
  }
  out[idx] = v;
}

}  // namespace

// csum f32 [n_rows, B]; base i32 [B]; out f32 [n_out, B].  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int wam_align(const float* csum, int n_rows, int B,
                         const int32_t* base, int n_out, int ds, int stride,
                         int pad_lo, float pol, int virt0, float* out,
                         void* stream) {
  const size_t n = static_cast<size_t>(n_out) * B;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  align_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      csum, n_rows, B, base, n_out, ds, stride, pad_lo, pol, virt0, out);
  return static_cast<int>(cudaGetLastError());
}
