// Shared helpers of the hand-written Hopper kernels (ops/kernels.py binds
// them through ctypes; each .cu builds into its own shared library).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Element type codes passed from Python (ops/kernels.py _DTYPE_CODES).
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and widened back: the rounding a store to T would make.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// Launch-time error of the last launch (a refused launch never runs, and a
// later synchronize would not report it).
inline int last_launch_error() { return static_cast<int>(cudaGetLastError()); }
