// K6 qsgd_quantize: QSGD random quantization of every row of a stacked
// [N, D] leaf, with each row's norm handed in.
//
// Replaces src/repro/kernels/qsgd.py:qsgd_quantize_2d (_qsgd_kernel):
//
//   q = sign(x) ||x|| floor(s |x| / ||x|| + xi) / (s c)   (0 if ||x|| = 0)
//
// in f32 and cast to the leaf dtype; xi is f32 uniform noise of x's shape,
// ||x|| the row's f32 norm (a reduction, taken outside the kernel as the
// reference does) and s c one f32 constant from the wrapper.
//
// Bound: bytes, x and xi read and q written once (12 B per element in f32)
// against about 8 operations. One thread per element, coalesced.
#include "qsgd.cuh"

template <typename T>
__global__ void qsgd_quantize_kernel(const T* __restrict__ x, const float* __restrict__ noise,
                                     const float* __restrict__ norm, float s, float sc,
                                     T* __restrict__ out, int64_t cols) {
  const int64_t row = blockIdx.y;
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  const int64_t i = row * cols + col;
  out[i] = from_f32<T>(qsgd_coord(to_f32(x[i]), noise[i], norm[row], s, sc));
}

template <typename T>
static int launch(const void* x, const void* noise, const void* norm, float s, float sc,
                  void* out, int64_t rows, int64_t cols, void* stream) {
  qsgd_quantize_kernel<T><<<elementwise_grid(rows, cols), kElementwiseThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(noise),
      static_cast<const float*>(norm), s, sc, static_cast<T*>(out), cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qsgd_quantize_f32(const void* x, const void* noise, const void* norm, float s,
                                 float sc, void* out, int64_t rows, int64_t cols, void* stream) {
  return launch<float>(x, noise, norm, s, sc, out, rows, cols, stream);
}

extern "C" int qsgd_quantize_bf16(const void* x, const void* noise, const void* norm, float s,
                                  float sc, void* out, int64_t rows, int64_t cols, void* stream) {
  return launch<__nv_bfloat16>(x, noise, norm, s, sc, out, rows, cols, stream);
}
