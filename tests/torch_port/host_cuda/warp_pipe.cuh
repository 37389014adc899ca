// Host emulation of csrc/warp_pipe.cuh (see cuda_shim.h): named barriers
// through the shim's table; a cp.async copy is queued in its thread and
// lands when a wait retires its commit group, so a read before the wait
// sees stale shared memory, as it may on the card.  This file and
// csrc/warp_pipe.cuh change together: test_torch_kernels_host.py fails
// when their sets of primitives differ.
#pragma once

#include <deque>
#include <vector>

namespace wam {

struct HostCopy { void* dst; unsigned value; };
extern thread_local std::vector<HostCopy> host_open;
extern thread_local std::deque<std::vector<HostCopy>> host_groups;

inline void bar_sync(int id, int threads) { wam_barrier(id, threads, true); }
inline void bar_arrive(int id, int threads) { wam_barrier(id, threads, false); }
inline void cp_async4(void* dst, const void* src) {
  unsigned v;
  memcpy(&v, src, 4);
  host_open.push_back({dst, v});
}
inline void cp_async_commit() {
  host_groups.push_back(host_open);
  host_open.clear();
}
template <int kPending>
inline void cp_async_wait() {
  while (static_cast<int>(host_groups.size()) > kPending) {
    for (const HostCopy& c : host_groups.front()) memcpy(c.dst, &c.value, 4);
    host_groups.pop_front();
  }
}

}  // namespace wam
