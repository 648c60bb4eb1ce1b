// K4 topk_threshold and K5 topk_mask over a stacked [rows, cols] leaf.
//
// K4 replaces src/repro/kernels/topk.py:topk_partials_2d (_partials_kernel)
// together with the lax.top_k select that followed it (ops.py:243-275):
// per row, the exact k-th largest |x| in the input dtype, ties inclusive.
// The TPU kernel cut the vector into tiles of candidates and sorted them;
// here it is a radix select on the bit pattern of |x|. With the sign bit
// cleared, a finite float's bits order like its magnitude as an unsigned
// integer, so the k-th largest key, found one 8-bit digit at a time from
// the top (4 passes for f32, 2 for bf16), is the k-th largest magnitude
// bit for bit, and no value is ever moved or sorted.
//
// Bound: bytes, one read of the row per pass (the data sheet bound counts
// one). One block per row walks its row with 1024 threads, each issuing
// kUnroll loads before counting any; each pass histograms the digit of the
// keys that still match the prefix into per-warp shared-memory histograms
// (lanes with the same digit are first merged with __match_any_sync, so a
// skewed exponent byte costs one atomic per warp and digit), then a
// 256-wide suffix scan finds the bin holding the wanted rank and fixes the
// next digit. Later passes reread the row from L2. With N = 10 rows only
// 10 SMs work: a simple first version, measured in PERF.md.
//
// K5 replaces src/repro/kernels/topk.py:topk_mask_2d (_mask_kernel):
// out = |x| >= t[row] ? x : 0 in the input dtype. Bound: bytes (one read,
// one write); one thread per element, coalesced.
#include "common.cuh"

template <typename T> struct Key;
template <> struct Key<float> {
  using U = uint32_t;
  static constexpr U kAbs = 0x7fffffffu;
  static constexpr int kPasses = 4;
};
template <> struct Key<__nv_bfloat16> {
  using U = uint16_t;
  static constexpr U kAbs = 0x7fffu;
  static constexpr int kPasses = 2;
};

constexpr int kSelectThreads = 1024;
constexpr int kWarps = kSelectThreads / 32;
constexpr int kUnroll = 8;  // keys loaded per thread before any is counted
constexpr unsigned kNoBin = 256;

template <typename T>
__global__ void __launch_bounds__(kSelectThreads)
topk_threshold_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t cols, int64_t k) {
  using U = typename Key<T>::U;
  __shared__ unsigned int hist[kWarps][256];
  __shared__ unsigned int at_or_above[256];
  __shared__ uint32_t s_prefix;
  __shared__ int64_t s_k;
  const U* keys = reinterpret_cast<const U*>(x) + (int64_t)blockIdx.x * cols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t stride = blockDim.x;
  uint32_t prefix = 0, mask = 0;
  int64_t remaining = k;  // rank of the wanted key among those matching the prefix
  for (int pass = Key<T>::kPasses - 1; pass >= 0; --pass) {
    const int shift = pass * 8;
    for (int b = threadIdx.x; b < kWarps * 256; b += blockDim.x) (&hist[0][0])[b] = 0;
    __syncthreads();
    // base is uniform across the block, so every lane of a warp runs the
    // same trips and the full-mask __match_any_sync is safe. All kUnroll
    // loads are issued before the first is counted, to keep more bytes in
    // flight from one SM.
    for (int64_t base = 0; base < cols; base += kUnroll * stride) {
      uint32_t key[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = base + u * stride + threadIdx.x;
        key[u] = i < cols ? (uint32_t)(keys[i] & Key<T>::kAbs) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = base + u * stride + threadIdx.x;
        const bool counted = i < cols && (key[u] & mask) == prefix;
        const unsigned bin = counted ? (key[u] >> shift) & 0xffu : kNoBin;
        const unsigned peers = __match_any_sync(0xffffffffu, bin);
        if (counted && lane == __ffs(peers) - 1) {
          atomicAdd(&hist[warp][bin], (unsigned)__popc(peers));
        }
      }
    }
    __syncthreads();
    // per-digit totals, then suffix sums: at_or_above[b] counts the
    // matching keys whose digit is >= b
    unsigned total = 0;
    if (threadIdx.x < 256) {
      for (int w = 0; w < kWarps; ++w) total += hist[w][threadIdx.x];
      at_or_above[threadIdx.x] = total;
    }
    __syncthreads();
    for (int offset = 1; offset < 256; offset <<= 1) {
      const unsigned add = threadIdx.x + offset < 256 ? at_or_above[threadIdx.x + offset] : 0u;
      __syncthreads();
      if (threadIdx.x < 256) at_or_above[threadIdx.x] += add;
      __syncthreads();
    }
    // exactly one digit holds the wanted rank
    if (threadIdx.x < 256) {
      const int64_t upto = at_or_above[threadIdx.x];
      const int64_t above = upto - total;
      if (above < remaining && remaining <= upto) {
        s_prefix = prefix | ((uint32_t)threadIdx.x << shift);
        s_k = remaining - above;
      }
    }
    __syncthreads();
    prefix = s_prefix;
    remaining = s_k;
    mask |= 0xffu << shift;
    __syncthreads();
  }
  if (threadIdx.x == 0) reinterpret_cast<U*>(out)[blockIdx.x] = static_cast<U>(prefix);
}

template <typename T>
__global__ void topk_mask_kernel(const T* __restrict__ x, const T* __restrict__ thresh,
                                 T* __restrict__ out, int64_t cols) {
  const int64_t row = blockIdx.y;
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  const T v = x[row * cols + col];
  out[row * cols + col] = fabsf(to_f32(v)) >= to_f32(thresh[row]) ? v : from_f32<T>(0.0f);
}

template <typename T>
static int launch_threshold(const void* x, void* out, int64_t rows, int64_t cols, int64_t k,
                            void* stream) {
  topk_threshold_kernel<T><<<(unsigned)rows, kSelectThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), cols, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_mask(const void* x, const void* thresh, void* out, int64_t rows,
                       int64_t cols, void* stream) {
  topk_mask_kernel<T><<<elementwise_grid(rows, cols), kElementwiseThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(thresh), static_cast<T*>(out), cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int topk_threshold_f32(const void* x, void* out, int64_t rows, int64_t cols,
                                  int64_t k, void* stream) {
  return launch_threshold<float>(x, out, rows, cols, k, stream);
}

extern "C" int topk_threshold_bf16(const void* x, void* out, int64_t rows, int64_t cols,
                                   int64_t k, void* stream) {
  return launch_threshold<__nv_bfloat16>(x, out, rows, cols, k, stream);
}

extern "C" int topk_mask_f32(const void* x, const void* thresh, void* out, int64_t rows,
                             int64_t cols, void* stream) {
  return launch_mask<float>(x, thresh, out, rows, cols, stream);
}

extern "C" int topk_mask_bf16(const void* x, const void* thresh, void* out, int64_t rows,
                              int64_t cols, void* stream) {
  return launch_mask<__nv_bfloat16>(x, thresh, out, rows, cols, stream);
}
