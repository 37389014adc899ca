// Hand-over primitives of the warp-specialised kernels (K1, fsk_seq.cu,
// and K6, psk_seq.cu, through seq_pipe.cuh; K2, fsk_framing.cu; K5,
// cumsum0.cu): named barriers between the warps of one block, and 4- and
// 16-byte asynchronous copies from device memory into shared memory.
//
// A ring slot passes from a producer warp to a consumer warp through two
// named barriers over both warps' 64 threads: the producer fills the slot
// and arrives on its FULL barrier (no wait); the consumer syncs on FULL,
// reads, then arrives on EMPTY; the producer syncs on EMPTY before it
// fills the slot again.  Each barrier use must see exactly one arrival of
// each of its warps, so both sides skip the EMPTY hand-over of the slots'
// last round.  The ids 1..15 are free (0 is __syncthreads').
//
// cp.async copies complete in the order of their commit groups; a thread
// that reads only what it copied itself needs no barrier after the wait.
//
// tests/torch_port/host_cuda/warp_pipe.cuh emulates these primitives on
// the host; a primitive added, removed or given another meaning here is
// changed there too.

#pragma once

#include <cuda_runtime.h>

namespace wam {

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// copy the 4 bytes at `src` (4-byte aligned, device memory) to `dst`
// (shared memory), asynchronously; cached in L1 (.ca, the only mode of a
// 4-byte copy)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src)
               : "memory");
}

// copy the 16 bytes at `src` (16-byte aligned, device memory) to `dst`
// (shared memory, 16-byte aligned), asynchronously; cached in L2 only
// (.cg: data read once gains nothing from L1)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most kPending of this thread's commit groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

}  // namespace wam
