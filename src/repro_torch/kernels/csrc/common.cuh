// Shared helpers for the port's kernels: dtype conversion through the
// intrinsics, the per-row elementwise launch shape, and the error-string
// entry point every library exports for its ctypes wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Elementwise kernels over a stacked [rows, cols] leaf: blockIdx.y is the
// row (node), blockIdx.x * blockDim.x + threadIdx.x the column.
constexpr int kElementwiseThreads = 256;

inline dim3 elementwise_grid(int64_t rows, int64_t cols) {
  return dim3((unsigned)((cols + kElementwiseThreads - 1) / kElementwiseThreads),
              (unsigned)rows);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
