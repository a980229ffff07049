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
struct int4 { int x, y, z, w; };

inline float __shfl_down_sync(unsigned, float v, int) { return v; }
inline double __shfl_down_sync(unsigned, double v, int) { return v; }
inline float __shfl_sync(unsigned, float v, int) { return v; }
inline double __shfl_sync(unsigned, double v, int) { return v; }
inline float __shfl_xor_sync(unsigned, float v, int) { return v; }
inline double __shfl_xor_sync(unsigned, double v, int) { return v; }
inline void __syncthreads() {}
inline void __syncwarp() {}
inline int __syncthreads_or(int v) { return v; }
inline int __any_sync(unsigned, int v) { return v; }
inline unsigned __ballot_sync(unsigned, int v) { return v ? 1u : 0u; }
inline int __reduce_min_sync(unsigned, int v) { return v; }
inline int __reduce_max_sync(unsigned, int v) { return v; }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int atomicMin(int* p, int v) { const int o = *p; if (v < o) *p = v; return o; }
inline int atomicMax(int* p, int v) { const int o = *p; if (v > o) *p = v; return o; }
// rounded arithmetic (the host compiler contracts nothing here)
inline float __fadd_rn(float a, float b) { return a + b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline double __dmul_rn(double a, double b) { return a * b; }
// clamps to [0, 1], NaN to 0, as the .sat modifier does
inline float __saturatef(float x) { return x > 0.0f ? (x < 1.0f ? x : 1.0f) : 0.0f; }

struct HostIndex { int x; };
static HostIndex threadIdx{0}, blockIdx{0}, blockDim{1};
