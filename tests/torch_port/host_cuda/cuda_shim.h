// A host emulation of the CUDA subset the port's kernels use, so that g++
// can build csrc/*.cu for the CPU tests (test_torch_kernels_host.py):
// each block's threads run as std::threads, the blocks of a launch one
// after another; named barriers wait on a condition variable (a barrier
// that waits more than 20 s fails the launch: cudaGetLastError() returns
// 1); shared memory is one buffer, filled with 0xA5 before each block.
// __syncthreads is named barrier 0 over the block.  The warp primitives
// (__shfl_sync, __shfl_xor_sync, __ballot_sync, __syncwarp) are a meeting
// of the warp's 32 threads: each deposits its value, waits for the other
// 31 (20 s, then the launch fails), and reads what it asked for.
// Force-included (-include) ahead of each source; test_torch_kernels_host.py
// fails when a CUDA call in csrc/ is not emulated here.
#pragma once

#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <array>
#include <atomic>
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

struct wam_dim3 {
  unsigned x = 1, y = 1, z = 1;
  wam_dim3() = default;
  wam_dim3(unsigned x_, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
typedef wam_dim3 dim3;
extern thread_local wam_dim3 threadIdx;
extern wam_dim3 blockIdx, blockDim, gridDim;
alignas(128) extern unsigned char wam_smem[1 << 18];

typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }

struct alignas(8) float2 { float x, y; };
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
inline unsigned __float_as_uint(float f) { unsigned i; memcpy(&i, &f, 4); return i; }
// the high word of (hi:lo) << (shift & 31)
inline unsigned __funnelshift_l(unsigned lo, unsigned hi, unsigned shift) {
  const uint64_t v = (static_cast<uint64_t>(hi) << 32) | lo;
  return static_cast<unsigned>((v << (shift & 31)) >> 32);
}
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

// fp16: binary16 bits, rounded to nearest even from f32; the arithmetic
// in f32, rounded once to fp16 (exact wherever the f32 result is, as on
// the card; the sync kernel adds integers below 2^11)
struct __half { uint16_t x; };
struct alignas(4) __half2 { __half x, y; };
inline float wam_half2float(__half h) {
  const uint32_t sign = uint32_t(h.x & 0x8000u) << 16;
  const uint32_t exp = (h.x >> 10) & 0x1f, man = h.x & 0x3ffu;
  if (exp == 0x1f) return __uint_as_float(sign | 0x7f800000u | (man << 13));
  if (exp == 0) {                                   // zero, subnormal
    const float f = ldexpf(float(man), -24);
    return sign ? -f : f;
  }
  return __uint_as_float(sign | ((exp + 112) << 23) | (man << 13));
}
inline __half wam_float2half(float f) {
  const uint32_t u = __float_as_uint(f);
  const uint16_t sign = uint16_t((u >> 16) & 0x8000u);
  __half h;
  if ((u & 0x7fffffffu) > 0x7f800000u) { h.x = sign | 0x7e00u; return h; }
  const float a = fabsf(f);
  if (a >= 65520.0f) { h.x = sign | 0x7c00u; return h; }   // to infinity
  if (a < ldexpf(1.0f, -14)) {                       // subnormal: units 2^-24
    h.x = sign | uint16_t(nearbyintf(ldexpf(a, 24)));
    return h;
  }
  const uint32_t ua = __float_as_uint(a);
  uint32_t r = ua + 0xfffu + ((ua >> 13) & 1u);      // round to nearest even
  h.x = sign | uint16_t(((r >> 23) - 112) << 10 | ((r >> 13) & 0x3ffu));
  return h;
}
inline __half2 __floats2half2_rn(float lo, float hi) {
  return __half2{wam_float2half(lo), wam_float2half(hi)};
}
inline float __low2float(__half2 v) { return wam_half2float(v.x); }
inline float __high2float(__half2 v) { return wam_half2float(v.y); }
inline __half2 __hfma2(__half2 a, __half2 b, __half2 c) {
  return __floats2half2_rn(
      fmaf(__low2float(a), __low2float(b), __low2float(c)),
      fmaf(__high2float(a), __high2float(b), __high2float(c)));
}
inline __half2 __hadd2(__half2 a, __half2 b) {
  return __floats2half2_rn(__low2float(a) + __low2float(b),
                           __high2float(a) + __high2float(b));
}
inline __half2 __hsub2(__half2 a, __half2 b) {
  return __floats2half2_rn(__low2float(a) - __low2float(b),
                           __high2float(a) - __high2float(b));
}
inline __half2 __hmax2(__half2 a, __half2 b) {
  return __floats2half2_rn(fmaxf(__low2float(a), __low2float(b)),
                           fmaxf(__high2float(a), __high2float(b)));
}

// atomics over the block's threads (the blocks run one after another)
inline unsigned long long atomicMax(unsigned long long* p,
                                    unsigned long long v) {
  unsigned long long old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (old < v && !__atomic_compare_exchange_n(
                        p, &old, v, false, __ATOMIC_SEQ_CST,
                        __ATOMIC_SEQ_CST)) {
  }
  return old;
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }

struct WamBarrier { int count = 0; long gen = 0; };
extern std::mutex wam_mu;
extern std::condition_variable wam_cv;
extern WamBarrier wam_barriers[16];
extern std::atomic<bool> wam_failed;

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
// One meeting of the calling thread's warp: every lane deposits `v`;
// returns the 32 deposits once all are in.  The slots are held until all
// 32 lanes have read them.  A lane waits by yielding a few times, then
// sleeps on its warp's condition variable (the suite runs beside other
// workers, where spinning threads starve the lanes they wait for).
struct WamWarp {
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<int> count{0}, left{0};
  std::atomic<long> gen{0};
  uint64_t vals[32];
  void reset() { count = 0; left = 0; gen = 0; }
  // publish a change a waiter may sleep on
  void wake() {
    { std::lock_guard<std::mutex> lk(mu); }
    cv.notify_all();
  }
};
extern WamWarp wam_warps[32];
template <class F>
inline void wam_wait(WamWarp& w, F ready, const char* what) {
  for (int i = 0; i < 64; ++i) {
    if (ready() || wam_failed) return;
    std::this_thread::yield();
  }
  std::unique_lock<std::mutex> lk(w.mu);
  if (!w.cv.wait_for(lk, std::chrono::seconds(20),
                     [&] { return ready() || wam_failed; })) {
    fprintf(stderr, "deadlock: warp %u waits on %s\n", threadIdx.x / 32,
            what);
    wam_failed = true;
  }
}
inline std::array<uint64_t, 32> wam_warp_meet(unsigned mask, uint64_t v) {
  std::array<uint64_t, 32> out{};
  if (mask != 0xffffffffu || blockDim.x % 32) {
    fprintf(stderr, "warp primitive over mask %08x in a block of %u: not "
            "emulated\n", mask, blockDim.x);
    wam_failed = true;
  }
  if (wam_failed) return out;
  WamWarp& w = wam_warps[(threadIdx.x / 32) % 32];
  wam_wait(w, [&] { return w.left.load() == 0; },
           "the last meeting's readers");
  w.vals[threadIdx.x % 32] = v;
  const long gen = w.gen.load();
  if (w.count.fetch_add(1) == 31) {
    w.count = 0;
    w.left = 32;
    w.gen.fetch_add(1);
    w.wake();
  } else {
    wam_wait(w, [&] { return w.gen.load() != gen; }, "its 32 lanes");
  }
  if (wam_failed) return out;
  memcpy(out.data(), w.vals, sizeof w.vals);
  if (w.left.fetch_sub(1) == 1) w.wake();
  return out;
}
template <class T>
uint64_t wam_bits(T v) {
  uint64_t u = 0;
  memcpy(&u, &v, sizeof(T));
  return u;
}
template <class T>
T wam_value(uint64_t u) {
  T v;
  memcpy(&v, &u, sizeof(T));
  return v;
}
template <class T>
T __shfl_sync(unsigned mask, T var, int src, int width = 32) {
  const auto all = wam_warp_meet(mask, wam_bits(var));
  const int lane = threadIdx.x % 32;
  return wam_value<T>(all[(lane & ~(width - 1)) + (src & (width - 1))]);
}
template <class T>
T __shfl_xor_sync(unsigned mask, T var, int lane_mask, int width = 32) {
  const auto all = wam_warp_meet(mask, wam_bits(var));
  const int lane = threadIdx.x % 32;
  const int src = lane ^ lane_mask;
  // a lane of a higher segment is not read: the lane keeps its value
  return (src & ~(width - 1)) > (lane & ~(width - 1))
             ? var : wam_value<T>(all[src]);
}
inline unsigned __ballot_sync(unsigned mask, int pred) {
  const auto all = wam_warp_meet(mask, pred != 0);
  unsigned w = 0;
  for (int i = 0; i < 32; ++i) w |= static_cast<unsigned>(all[i] != 0) << i;
  return w;
}
inline void __syncwarp(unsigned mask = 0xffffffffu) { wam_warp_meet(mask, 0); }
// the block's barrier: named barrier 0 over all its threads
inline void __syncthreads() { wam_barrier(0, blockDim.x, true); }

inline int cudaGetLastError() {
  const int err = wam_failed ? 1 : 0;
  wam_failed = false;
  return err;
}

// the blocks of `grid` one after another, x fastest; 1-D blocks
template <class K, class... A>
void wam_launch(K kernel, wam_dim3 grid, wam_dim3 block, size_t smem,
                cudaStream_t, A... args) {
  if (block.y != 1 || block.z != 1 || smem > sizeof wam_smem) {
    fprintf(stderr, "launch of %ux%ux%u threads, %zu shared bytes: not "
            "emulated\n", block.x, block.y, block.z, smem);
    wam_failed = true;
    return;
  }
  blockDim = block;
  gridDim = grid;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x && !wam_failed; ++bx) {
        blockIdx = wam_dim3(bx, by, bz);
        for (auto& b : wam_barriers) b = WamBarrier();
        for (auto& w : wam_warps) w.reset();
        memset(wam_smem, 0xA5, sizeof wam_smem);
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < block.x; ++t)
          threads.emplace_back([=] {
            threadIdx = wam_dim3(t);
            kernel(args...);
          });
        for (auto& th : threads) th.join();
      }
}
