// Definitions of the host emulation's state (cuda_shim.h, warp_pipe.cuh).
#include "cuda_shim.h"
#include "warp_pipe.cuh"

thread_local wam_dim3 threadIdx;
wam_dim3 blockIdx, blockDim;
alignas(128) unsigned char wam_smem[1 << 18];
std::mutex wam_mu;
std::condition_variable wam_cv;
WamBarrier wam_barriers[16];
bool wam_failed = false;

namespace wam {
thread_local std::vector<HostCopy> host_open;
thread_local std::deque<std::vector<HostCopy>> host_groups;
}  // namespace wam
