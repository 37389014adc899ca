// A host emulation of the CUDA subset the port's kernels use, so that g++
// can build csrc/*.cu for the CPU tests (test_torch_kernels_host.py):
// each block's threads run as std::threads, the blocks of a launch one
// after another; named barriers wait on a condition variable (a barrier
// that waits more than 20 s fails the launch: cudaGetLastError() returns
// 1); shared memory is one buffer, filled with 0xA5 before each block.
// Force-included (-include) ahead of each source.
#pragma once

#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <chrono>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __shared__

struct wam_dim3 { unsigned x = 1, y = 1, z = 1; };
extern thread_local wam_dim3 threadIdx;
extern wam_dim3 blockIdx, blockDim;
alignas(128) extern unsigned char wam_smem[1 << 18];

typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }

struct __nv_bfloat16 { uint16_t x; };
inline float __bfloat162float(__nv_bfloat16 h) {
  uint32_t u = uint32_t(h.x) << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {   // round to nearest even
  uint32_t u;
  memcpy(&u, &f, 4);
  __nv_bfloat16 h;
  if ((u & 0x7fffffffu) > 0x7f800000u) {
    h.x = uint16_t((u >> 16) | 0x40);
    return h;
  }
  u += 0x7fffu + ((u >> 16) & 1u);
  h.x = uint16_t(u >> 16);
  return h;
}
inline float __uint_as_float(unsigned i) { float f; memcpy(&f, &i, 4); return f; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

struct WamBarrier { int count = 0; long gen = 0; };
extern std::mutex wam_mu;
extern std::condition_variable wam_cv;
extern WamBarrier wam_barriers[16];
extern bool wam_failed;

// named barrier `id` over `n` threads; `wait` = bar.sync, else bar.arrive
inline void wam_barrier(int id, int n, bool wait) {
  std::unique_lock<std::mutex> lk(wam_mu);
  if (id < 0 || id > 15 || n <= 0 || n % 32) {
    fprintf(stderr, "barrier %d over %d threads: not a named barrier\n", id, n);
    wam_failed = true;
  }
  WamBarrier& b = wam_barriers[id & 15];
  const long gen = b.gen;
  if (++b.count == n) {
    b.count = 0;
    ++b.gen;
    wam_cv.notify_all();
    return;
  }
  if (!wait || wam_failed) return;
  if (!wam_cv.wait_for(lk, std::chrono::seconds(20),
                       [&] { return b.gen != gen || wam_failed; })) {
    fprintf(stderr, "deadlock: barrier %d holds %d of %d threads\n", id,
            b.count, n);
    wam_failed = true;
    wam_cv.notify_all();
  }
}
inline int cudaGetLastError() {
  const int err = wam_failed ? 1 : 0;
  wam_failed = false;
  return err;
}

template <class K, class... A>
void wam_launch(K kernel, int grid, int block, size_t, cudaStream_t,
                A... args) {
  blockDim.x = block;
  for (int bx = 0; bx < grid && !wam_failed; ++bx) {
    blockIdx.x = bx;
    for (auto& b : wam_barriers) b = WamBarrier();
    memset(wam_smem, 0xA5, sizeof wam_smem);
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([=] { threadIdx.x = t; kernel(args...); });
    for (auto& th : threads) th.join();
  }
}
