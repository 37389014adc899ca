// K5 — zero-prefixed exclusive f32 prefix sum over time, strict row order.
//
// Replaces webaudio_modem_tpu/ops/pallas/cumsum0.py `_kernel` (through
// `csum0`):
//
//   x f32 [n, B] (time-major) -> out f32 [n + 1, B],
//   out[0, b] = 0,  out[t + 1, b] = out[t, b] + x[t, b]
//
// added one row at a time in float32, so the result equals a sequential
// f32 accumulation (numpy's cumsum) bit for bit.  The blind receiver's
// header and body programs take window sums as differences of two rows
// of it.
//
// Design.  The TPU kernel streamed time blocks through VMEM with a
// running-total scratch carried across its sequential grid; its row-block
// ladder, T_BLK padding and lane gates existed for Mosaic and are gone.
// Here each thread owns one channel column and keeps the running sum in a
// register; the time loop runs inside the thread.  The input is
// time-major, so a warp's loads at one row are 32 consecutive words.  The
// add chain must stay in row order, so the only parallelism within a
// column is in the loads: each thread loads a tile of kRows rows into
// registers before adding the previous tile, so the next tile's loads are
// in flight while the adds and stores of this one run in order.
// One warp per block spreads the columns over all SMs at farm batches
// (B = 4096 gives 128 blocks for 132 SMs).
//
// What bounds it on an H100.  One read and one write of 4 bytes per
// element and one add: memory (at [14400, 4096] 0.47 GB, 0.141 ms at
// 3.35 TB/s).  With one warp per SM the loads in flight are what this
// simple form can reach: kRows rows x 128 bytes per warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr int kRows = 32;  // rows loaded ahead of the adds, per thread

__global__ void __launch_bounds__(kThreads)
cumsum0_kernel(const float* __restrict__ x, int n, int B,
               float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = static_cast<size_t>(B);
  const float* col = x + b;
  float* dst = out + b;
  float acc = 0.0f;
  dst[0] = acc;
  float cur[kRows];
  const int whole = n / kRows * kRows;
  if (whole > 0) {
#pragma unroll
    for (int u = 0; u < kRows; ++u) cur[u] = col[static_cast<size_t>(u) * Bs];
  }
  for (int t0 = 0; t0 < whole; t0 += kRows) {
    float nxt[kRows];
    const int t1 = t0 + kRows;
    const bool more = t1 < whole;
    if (more) {
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        nxt[u] = col[static_cast<size_t>(t1 + u) * Bs];
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      acc = acc + cur[u];
      dst[static_cast<size_t>(t0 + u + 1) * Bs] = acc;
    }
    if (more) {
#pragma unroll
      for (int u = 0; u < kRows; ++u) cur[u] = nxt[u];
    }
  }
  for (int t = whole; t < n; ++t) {
    acc = acc + col[static_cast<size_t>(t) * Bs];
    dst[static_cast<size_t>(t + 1) * Bs] = acc;
  }
}

}  // namespace

// x f32 [n, B]; out f32 [n + 1, B].  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int wam_cumsum0(const float* x, int n, int B, float* out,
                           void* stream) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  cumsum0_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, B, out);
  return static_cast<int>(cudaGetLastError());
}
