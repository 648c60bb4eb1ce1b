// K3 choco_topk: the fused CHOCO-G step with TopK compression over the
// stacked [N, D] leaf, (x, y, my, d, t) -> (x_new, y_new) in one pass.
//
// Replaces src/repro/kernels/choco_fused.py:choco_topk_2d
// (_choco_topk_kernel):
//
//   x_new = x + gamma (my - y)           in f32, cast to the leaf dtype
//   y_new = y + (|d| >= t[row] ? d : 0)  in the leaf dtype
//
// d is the gap (x + gamma (my - y)) - y materialised in the leaf dtype by
// the caller, the same tensor K4 selected the per-row threshold t from,
// so every keep decision agrees with the threshold.
//
// Bound: bytes, 4 reads and 2 writes per element (24 B in f32) against
// 5 flops. One thread per element, coalesced. __fsub_rn / __fmul_rn /
// __fadd_rn keep nvcc from contracting x + gamma (my - y) into an fma, so
// both outputs are bitwise the plain PyTorch version's.
#include "common.cuh"

template <typename T>
__global__ void choco_topk_kernel(const T* __restrict__ x, const T* __restrict__ y,
                                  const T* __restrict__ my, const T* __restrict__ d,
                                  const T* __restrict__ thresh, float gamma,
                                  T* __restrict__ x_out, T* __restrict__ y_out, int64_t cols) {
  const int64_t row = blockIdx.y;
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  const int64_t i = row * cols + col;
  const float yf = to_f32(y[i]);
  const float move = __fmul_rn(gamma, __fsub_rn(to_f32(my[i]), yf));
  x_out[i] = from_f32<T>(__fadd_rn(to_f32(x[i]), move));
  const float df = to_f32(d[i]);
  const float q = fabsf(df) >= to_f32(thresh[row]) ? df : 0.0f;
  y_out[i] = from_f32<T>(__fadd_rn(yf, q));
}

template <typename T>
static int launch(const void* x, const void* y, const void* my, const void* d,
                  const void* thresh, float gamma, void* x_out, void* y_out, int64_t rows,
                  int64_t cols, void* stream) {
  choco_topk_kernel<T><<<elementwise_grid(rows, cols), kElementwiseThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(my),
      static_cast<const T*>(d), static_cast<const T*>(thresh), gamma, static_cast<T*>(x_out),
      static_cast<T*>(y_out), cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int choco_topk_f32(const void* x, const void* y, const void* my, const void* d,
                              const void* thresh, float gamma, void* x_out, void* y_out,
                              int64_t rows, int64_t cols, void* stream) {
  return launch<float>(x, y, my, d, thresh, gamma, x_out, y_out, rows, cols, stream);
}

extern "C" int choco_topk_bf16(const void* x, const void* y, const void* my, const void* d,
                               const void* thresh, float gamma, void* x_out, void* y_out,
                               int64_t rows, int64_t cols, void* stream) {
  return launch<__nv_bfloat16>(x, y, my, d, thresh, gamma, x_out, y_out, rows, cols,
                               stream);
}
