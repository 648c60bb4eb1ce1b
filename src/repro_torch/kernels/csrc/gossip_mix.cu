// K1 gossip_mix: one gossip step X <- X C for a circulant C, over the
// stacked [N, D] leaf.
//
// Replaces src/repro/kernels/gossip_mix.py:gossip_mix_2d (_mix_kernel),
// which mixed one node's (rows, 128) tile with deg received copies. Here
// all N nodes sit in one tensor, so node i reads its neighbours' rows of
// the same tensor directly (no shifted copies):
//
//   out[i, c] = w[i, 0] * x[i, c] + sum_k w[i, k + 1] * x[nbr[i, k], c]
//
// accumulated in f32 in that order and cast once to the leaf dtype. The
// index table [N, deg] and the per-node weights [N, deg + 1] come from the
// topology's shifts, so per-node participation weights fit unchanged.
//
// Bound: bytes. Each element is read once per incoming edge plus once for
// itself and written once (deg + 2 accesses; the data sheet bound counts
// one read and one write, 8 B per f32 element); 2 (deg + 1) flops per
// element are far below the card's f32 rate. One thread per element with
// neighbouring threads on neighbouring columns keeps every access
// coalesced; the neighbour rows are re-read mostly from L2.
//
// __fmul_rn / __fadd_rn keep nvcc from contracting into fma, so the result
// is bitwise the plain PyTorch version's (separate mul and add kernels).
#include "common.cuh"

template <typename T>
__global__ void gossip_mix_kernel(const T* __restrict__ x, const int32_t* __restrict__ nbr,
                                  const float* __restrict__ w, T* __restrict__ out,
                                  int64_t cols, int deg) {
  const int64_t row = blockIdx.y;
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  const float* wr = w + row * (deg + 1);
  float acc = __fmul_rn(wr[0], to_f32(x[row * cols + col]));
  for (int k = 0; k < deg; ++k) {
    const int64_t src = nbr[row * deg + k];
    acc = __fadd_rn(acc, __fmul_rn(wr[k + 1], to_f32(x[src * cols + col])));
  }
  out[row * cols + col] = from_f32<T>(acc);
}

template <typename T>
static int launch(const void* x, const void* nbr, const void* w, void* out, int64_t rows,
                  int64_t cols, int deg, void* stream) {
  gossip_mix_kernel<T><<<elementwise_grid(rows, cols), kElementwiseThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(nbr),
      static_cast<const float*>(w), static_cast<T*>(out), cols, deg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gossip_mix_f32(const void* x, const void* nbr, const void* w, void* out,
                              int64_t rows, int64_t cols, int deg, void* stream) {
  return launch<float>(x, nbr, w, out, rows, cols, deg, stream);
}

extern "C" int gossip_mix_bf16(const void* x, const void* nbr, const void* w, void* out,
                               int64_t rows, int64_t cols, int deg, void* stream) {
  return launch<__nv_bfloat16>(x, nbr, w, out, rows, cols, deg, stream);
}
