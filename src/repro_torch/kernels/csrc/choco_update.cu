// K7 choco_move: the CHOCO-G consensus move over the stacked [N, D] leaf,
// (x, y, my) -> (x_new, d) in one pass.
//
// Replaces src/repro/kernels/choco_update.py:choco_move_2d (_choco_kernel):
//
//   x_new = x + gamma (my - y)   in f32, cast to the leaf dtype
//   d     = x_new - y            from the f32 x_new, cast to the leaf dtype
//
// d is the gap that every compressor without a fused kernel (identity,
// RandK, randomized gossip) compresses next.
//
// Bound: bytes, 3 reads and 2 writes per element (20 B in f32) against 4
// flops. One thread per element, coalesced. __fsub_rn / __fmul_rn /
// __fadd_rn keep nvcc from contracting the move into an fma, so both
// outputs are bitwise the plain PyTorch version's.
#include "common.cuh"

template <typename T>
__global__ void choco_move_kernel(const T* __restrict__ x, const T* __restrict__ y,
                                  const T* __restrict__ my, float gamma, T* __restrict__ x_out,
                                  T* __restrict__ d_out, int64_t cols) {
  const int64_t row = blockIdx.y;
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  const int64_t i = row * cols + col;
  const float yf = to_f32(y[i]);
  const float xn = __fadd_rn(to_f32(x[i]), __fmul_rn(gamma, __fsub_rn(to_f32(my[i]), yf)));
  x_out[i] = from_f32<T>(xn);
  d_out[i] = from_f32<T>(__fsub_rn(xn, yf));
}

template <typename T>
static int launch(const void* x, const void* y, const void* my, float gamma, void* x_out,
                  void* d_out, int64_t rows, int64_t cols, void* stream) {
  choco_move_kernel<T><<<elementwise_grid(rows, cols), kElementwiseThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(my), gamma,
      static_cast<T*>(x_out), static_cast<T*>(d_out), cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int choco_move_f32(const void* x, const void* y, const void* my, float gamma,
                              void* x_out, void* d_out, int64_t rows, int64_t cols,
                              void* stream) {
  return launch<float>(x, y, my, gamma, x_out, d_out, rows, cols, stream);
}

extern "C" int choco_move_bf16(const void* x, const void* y, const void* my, float gamma,
                               void* x_out, void* d_out, int64_t rows, int64_t cols,
                               void* stream) {
  return launch<__nv_bfloat16>(x, y, my, gamma, x_out, d_out, rows, cols, stream);
}
