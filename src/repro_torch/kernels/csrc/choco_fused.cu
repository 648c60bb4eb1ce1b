// K2 choco_qsgd and K3 choco_topk: the fused CHOCO-G step with QSGD or
// TopK compression over the stacked [N, D] leaf, emitting (x_new, y_new)
// in one pass.
//
// K2 replaces src/repro/kernels/choco_fused.py:choco_qsgd_2d
// (_choco_qsgd_kernel):
//
//   x_new = x + gamma (my - y)           in f32, cast to the leaf dtype
//   d     = x_new - y                    from the f32 x_new, cast to the leaf dtype
//   q     = sign(d) ||d|| floor(s |d| / ||d|| + xi) / (s c), 0 if ||d|| = 0
//   y_new = y + q                        q cast to the leaf dtype, added in it
//
// with ||d|| the f32 norm of each row's gap, taken by the caller on the
// same gap (choco_fused.gap), xi f32 uniform noise and s c one f32
// constant. K2 recomputes d from x, y and my rather than reading it, as
// the TPU kernel does: the recomputation is the same rounded steps as
// gap(), so it is bitwise the tensor the norm was taken on, and it saves
// one read per element (24 B per element in f32 instead of 28). Bound:
// bytes, against about 13 operations per element.
//
// K3 replaces src/repro/kernels/choco_fused.py:choco_topk_2d
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
#include "qsgd.cuh"

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

template <typename T>
__global__ void choco_qsgd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                                  const T* __restrict__ my, const float* __restrict__ noise,
                                  const float* __restrict__ norm, float gamma, float s, float sc,
                                  T* __restrict__ x_out, T* __restrict__ y_out, int64_t cols) {
  const int64_t row = blockIdx.y;
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  const int64_t i = row * cols + col;
  const float yf = to_f32(y[i]);
  const float xn = __fadd_rn(to_f32(x[i]), __fmul_rn(gamma, __fsub_rn(to_f32(my[i]), yf)));
  x_out[i] = from_f32<T>(xn);
  const float d = to_f32(from_f32<T>(__fsub_rn(xn, yf)));
  const float q = to_f32(from_f32<T>(qsgd_coord(d, noise[i], norm[row], s, sc)));
  y_out[i] = from_f32<T>(__fadd_rn(yf, q));
}

template <typename T>
static int launch_qsgd(const void* x, const void* y, const void* my, const void* noise,
                       const void* norm, float gamma, float s, float sc, void* x_out,
                       void* y_out, int64_t rows, int64_t cols, void* stream) {
  choco_qsgd_kernel<T><<<elementwise_grid(rows, cols), kElementwiseThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(my),
      static_cast<const float*>(noise), static_cast<const float*>(norm), gamma, s, sc,
      static_cast<T*>(x_out), static_cast<T*>(y_out), cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int choco_qsgd_f32(const void* x, const void* y, const void* my, const void* noise,
                              const void* norm, float gamma, float s, float sc, void* x_out,
                              void* y_out, int64_t rows, int64_t cols, void* stream) {
  return launch_qsgd<float>(x, y, my, noise, norm, gamma, s, sc, x_out, y_out, rows, cols,
                            stream);
}

extern "C" int choco_qsgd_bf16(const void* x, const void* y, const void* my, const void* noise,
                               const void* norm, float gamma, float s, float sc, void* x_out,
                               void* y_out, int64_t rows, int64_t cols, void* stream) {
  return launch_qsgd<__nv_bfloat16>(x, y, my, noise, norm, gamma, s, sc, x_out, y_out, rows,
                                    cols, stream);
}
