// Host stand-in for <cuda_runtime.h>: lets a C++ compiler build the device
// functions of chimera_tpu_torch/csrc/*.cuh (which hold the kernels'
// arithmetic) so that the CPU tests can run them serially.  Only what those
// headers name is defined; the warp and block primitives are never called
// from the host emulation.
#pragma once

#include <cmath>
#include <cstddef>

#define __device__
#define __host__
#define __forceinline__ inline
#define __global__

struct float2 { float x, y; };
struct double2 { double x, y; };

inline float __shfl_down_sync(unsigned, float v, int) { return v; }
inline double __shfl_down_sync(unsigned, double v, int) { return v; }
inline void __syncthreads() {}
inline int __syncthreads_or(int v) { return v; }

struct HostIndex { int x; };
static HostIndex threadIdx{0}, blockIdx{0}, blockDim{1};
