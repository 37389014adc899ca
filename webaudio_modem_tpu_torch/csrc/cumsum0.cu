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
// of it.  The n rows are a window of a ring of `rows` rows: row t of the
// window is ring row (start + t) mod rows, so a window that wraps past
// the ring's last row is read in place, in order, without a copy.
//
// What bounds it on an H100: one read and one write of 4 bytes per
// element and one add, so memory (at [14400, 4096] 0.47 GB, 0.141 ms at
// 3.35 TB/s).  The add chain is not the limit: 14,400 dependent adds at
// ~4 cycles take ~0.03 ms at 1980 MHz.  What the loads need is bytes in
// flight: by Little's law some 15-25 KB per SM at several hundred ns of
// loaded latency.  A design that kept the next 32 rows in registers of
// one warp per SM had ~4 KB in flight and reached ~30 % of the bound.
//
// Design: the loads are separated from the ordered adds.  A block owns
// kCols = 32 columns (B = 4096 gives 128 blocks, ~one per SM; the most
// columns an SM holds is ceil(B / 132) = 32 whatever the block width, so
// narrower blocks would not spread the work further) and has two warps:
//   warp 0  the producer: keeps a ring of kStages stages of kRows rows x
//           32 columns in shared memory filled ahead with cp.async, up
//           to kStages - 1 stages (80 KB) in flight per block;
//   warp 1  the consumer: lane = column, adds the rows of each stage in
//           strict order from shared memory (consecutive lanes read
//           consecutive words: no bank conflicts) and stores each output
//           row coalesced (128 bytes a row).
// The depth was measured (NVIDIA H100 80GB HBM3, 700 W; tools/variants.py
// k5): 4 stages of 128 rows reached 47-49 % of the byte bound, 4 of 256
// rows the same, 5, 6 or 7 stages of 128 rows 58-66 %; an L2 prefetch
// size on the copies and streaming stores changed nothing.
// Stages pass through named barriers (warp_pipe.cuh): FULL once the
// producer's copies of the stage have landed (cp.async.wait_group, then
// bar.arrive), EMPTY once the consumer has read it.  The producer
// arrives on a stage's FULL before it waits on the EMPTY of the slot it
// fills next, so the consumer never waits while the producer starts
// the next stage's copies.
//
// Copy mechanism: cp.async, 16 bytes (four columns of a row, .cg) where
// that row segment is 16-byte aligned, 4 bytes per column where it is
// not: a ring view at an odd B, or a base pointer that is only 4-byte
// aligned, misaligns some rows, and the kernel takes any of them.  A 2-D
// TMA tensor map would need cuTensorMapEncodeTiled (outside the runtime
// API) on the host, and 16-byte alignment of the base and the row pitch,
// for a plane this simple; a 1-D cp.async.bulk per row would need the same alignment
// of every row and an mbarrier per stage.  Rows past n and columns past
// B are neither loaded nor stored.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_pipe.cuh"

namespace {

constexpr int kCols = 32;        // columns per block, one consumer lane each
constexpr int kRows = 128;       // rows per stage
constexpr int kStages = 6;       // stages in the ring: 96 KB
constexpr int kThreads = 64;     // warp 0 copies, warp 1 adds
constexpr int kChunks = kCols / 4;               // 16-byte pieces of a row
constexpr int kRowsPerCopy = 32 / kChunks;       // rows one copy covers
constexpr size_t kSmem = sizeof(float) * kStages * kRows * kCols;

// named barriers 1 .. 2 * kStages
__device__ __forceinline__ int full(int s) { return 1 + s; }
__device__ __forceinline__ int empty(int s) { return 1 + kStages + s; }
static_assert(2 * kStages <= 15, "named barrier ids");

using wam::bar_arrive;
using wam::bar_sync;

__global__ void __launch_bounds__(kThreads)
cumsum0_kernel(const float* __restrict__ x, int rows, int start, int n, int B,
               float* __restrict__ out) {
  // [kStages][kRows][kCols]; the dynamic shared memory base is 16-byte
  // aligned, so is every 4-column piece of a row
  extern __shared__ float tile[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * kCols;
  const size_t Bs = static_cast<size_t>(B);
  const int n_stages = (n + kRows - 1) / kRows;

  if (warp == 0) {
    // lane: the 4 columns of piece lane % kChunks, in every
    // kRowsPerCopy-th row from lane / kChunks
    const int piece = lane % kChunks;
    const int c = c0 + 4 * piece;
    const int r0 = lane / kChunks;
    auto copy_stage = [&](int k) {
      if (k < n_stages && c < B) {
        float* dst = tile + (k % kStages) * kRows * kCols + 4 * piece;
        const int t0 = k * kRows;
        const int m = min(kRows, n - t0);
        for (int u = r0; u < m; u += kRowsPerCopy) {
          int r = start + t0 + u;
          if (r >= rows) r -= rows;
          const float* src = x + static_cast<size_t>(r) * Bs + c;
          float* d = dst + u * kCols;
          if (c + 4 <= B && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
            wam::cp_async16(d, src);
          } else {
            for (int e = 0; e < 4 && c + e < B; ++e)
              wam::cp_async4(d + e, src + e);
          }
        }
      }
      wam::cp_async_commit();
    };
    for (int k = 0; k < kStages - 1; ++k) copy_stage(k);
    for (int k = 0; k < n_stages; ++k) {
      // groups 0..k have landed once at most kStages - 2 are pending
      wam::cp_async_wait<kStages - 2>();
      bar_arrive(full(k % kStages), kThreads);
      // stage k + kStages - 1 goes into the slot stage k - 1 held
      const int ahead = k + kStages - 1;
      if (ahead < n_stages && ahead >= kStages)
        bar_sync(empty(ahead % kStages), kThreads);
      copy_stage(ahead);
    }
  } else {
    const int b = c0 + lane;
    const bool store = b < B;
    float acc = 0.0f;
    if (store) out[b] = acc;
    for (int k = 0; k < n_stages; ++k) {
      const int s = k % kStages;
      bar_sync(full(s), kThreads);
      const float* col = tile + s * kRows * kCols + lane;
      const int t0 = k * kRows;
      const int m = min(kRows, n - t0);
      float* dst = out + static_cast<size_t>(t0 + 1) * Bs + b;
      if (store) {
#pragma unroll 8
        for (int u = 0; u < m; ++u) {
          acc = acc + col[u * kCols];
          dst[u * Bs] = acc;
        }
      }
      if (k + kStages < n_stages) bar_arrive(empty(s), kThreads);
    }
  }
}

}  // namespace

// x f32 [rows, B], a ring; the window is its n rows from `start`
// (0 <= start < rows, or 0 when rows = 0; 0 <= n <= rows), wrapping past
// the last row once; out f32 [n + 1, B].  Launches on `stream` and
// returns the first CUDA error (opting in to the shared memory, or the
// launch).
extern "C" int wam_cumsum0(const float* x, int rows, int start, int n, int B,
                           float* out, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      cumsum0_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((B + kCols - 1) / kCols);
  cumsum0_kernel<<<blocks, kThreads, kSmem,
                   static_cast<cudaStream_t>(stream)>>>(x, rows, start, n, B,
                                                         out);
  return static_cast<int>(cudaGetLastError());
}
