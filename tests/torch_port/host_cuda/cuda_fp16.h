// stands in for the CUDA header in the host emulation (cuda_shim.h)
#pragma once
