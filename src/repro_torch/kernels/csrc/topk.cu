// K4 topk_threshold over every leaf of a gossip step, and K5 topk_mask over
// one stacked [rows, cols] leaf.
//
// K4 replaces src/repro/kernels/topk.py:topk_partials_2d (_partials_kernel)
// together with the lax.top_k select that followed it (ops.py:243-275):
// per row of each leaf, the exact k-th largest |x| in the input dtype, ties
// inclusive. The TPU kernel cut the vector into tiles of candidates and
// sorted them; here it is a radix select on the bit pattern of |x|. With
// the sign bit cleared, a finite float's bits order like its magnitude as
// an unsigned integer, so the k-th largest key, found one digit at a time
// from the top, is the k-th largest magnitude bit for bit, and no value is
// ever moved or sorted. The digits cover only the bits below the sign
// (30..0 for f32, 14..0 for bf16); their widths come from the wrapper
// (topk.py DIGITS: 11 + 10 + 10 for f32, 8 + 7 for bf16), so the first
// digit splits on the exponent and the top mantissa bits and the later
// passes count only the few keys that share the chosen prefix.
//
// Bound: bytes, one read of every key (the later passes reread the step's
// keys from L2, which holds a CIFAR step's 23 MB). One launch covers every
// leaf of the step: each (leaf, row) segment is cut into chunks of
// plan.chunk keys and each block takes one chunk, so a step's 5.8 M keys
// keep several hundred blocks on the 132 SMs, not one block per row.
//   * A segment of one chunk is selected whole by its block in the first
//     launch: all passes over its chunk, histograms in shared memory.
//   * A segment of several chunks takes one launch per pass. Each block
//     histograms its chunk in shared memory and adds the non-zero bins to
//     the segment's global histogram with integer atomics (sums do not
//     depend on order, so the result is deterministic); the last block to
//     finish the segment (a per-pass counter after __threadfence) scans
//     the bins, fixes the next digit and the rank left inside it, and
//     clears the histogram for the next pass.
// The leaves' descriptors travel by value in the launch parameters
// (__grid_constant__, read in place), so a call copies nothing to the card
// beside the zeroed scratch the wrapper allocates.
//
// K5 replaces src/repro/kernels/topk.py:topk_mask_2d (_mask_kernel):
// out = |x| >= t[row] ? x : 0 in the input dtype. Bound: bytes (one read,
// one write); one thread per element, coalesced.
#include "common.cuh"

template <typename T> struct Key;
template <> struct Key<float> {
  using U = uint32_t;
  static constexpr uint32_t kAbs = 0x7fffffffu;
};
template <> struct Key<__nv_bfloat16> {
  using U = uint16_t;
  static constexpr uint32_t kAbs = 0x7fffu;
};

constexpr int kMaxLeaves = 32;  // leaves per launch; the wrapper splits longer lists
constexpr int kMaxPasses = 4;
constexpr int kMaxBins = 1 << 11;  // widest digit: 11 bits
constexpr int kSelectThreads = 512;
constexpr int kLoads = 4;  // loads per thread in flight before any key is counted

struct SelectLeaf {
  const void* x;           // [rows, cols], row r at x + r * cols
  void* out;               // [rows] thresholds
  int64_t cols;
  int64_t k;
  int32_t chunk_begin;     // first block of the leaf
  int32_t chunks_per_row;  // 1: every row is selected whole by one block
  int32_t seg_begin;       // scratch slot of row 0 (leaves of several chunks a row)
  int32_t vec;             // 1 when every row starts 16-byte aligned
};

struct SelectPlan {
  SelectLeaf leaf[kMaxLeaves];  // leaves of several chunks a row first
  int32_t num_leaves;
  int32_t chunk;     // keys per chunk, a multiple of 16
  int32_t passes;
  int32_t num_segs;  // rows of the leaves of several chunks a row
  int32_t shift[kMaxPasses];
  int32_t bits[kMaxPasses];
};

// Scratch, zeroed by the wrapper, in 32-bit words: histograms
// [num_segs][kMaxBins], per-pass counters [passes][num_segs], then the
// prefix and the remaining rank of each segment [num_segs] each.

// Counts the keys of row[start, stop) whose fixed bits equal prefix into
// hist by their digit (key >> shift) & digit_mask.
template <typename T>
__device__ __forceinline__ void count_chunk(const SelectLeaf& leaf, int64_t row, int64_t start,
                                            int64_t stop, uint32_t prefix, uint32_t fixed,
                                            int shift, uint32_t digit_mask, unsigned* hist) {
  using U = typename Key<T>::U;
  const U* keys = static_cast<const U*>(leaf.x) + row * leaf.cols;
  auto count = [&](uint32_t key) {
    key &= Key<T>::kAbs;
    if ((key & fixed) == prefix) atomicAdd(&hist[(key >> shift) & digit_mask], 1u);
  };
  const int64_t stride = blockDim.x;
  if (leaf.vec) {
    constexpr int V = 16 / sizeof(U);
    const uint4* vecs = reinterpret_cast<const uint4*>(keys + start);
    const int64_t n = (stop - start) / V;  // stop - start is a multiple of V here
    for (int64_t base = 0; base < n; base += kLoads * stride) {
      uint4 q[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int64_t i = base + u * stride + threadIdx.x;
        q[u] = i < n ? vecs[i] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (base + u * stride + threadIdx.x < n) {
          const U* e = reinterpret_cast<const U*>(&q[u]);
#pragma unroll
          for (int j = 0; j < V; ++j) count(e[j]);
        }
      }
    }
  } else {
    for (int64_t base = start; base < stop; base += kLoads * stride) {
      uint32_t key[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int64_t i = base + u * stride + threadIdx.x;
        key[u] = i < stop ? keys[i] : 0u;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (base + u * stride + threadIdx.x < stop) count(key[u]);
      }
    }
  }
}

// The digit whose bin holds the wanted rank counted from the top:
// above(d) < rank <= above(d) + hist[d], above(d) the keys in bins > d.
// Exactly one thread finds it and writes (digit, rank within the bin) to
// pick; the block reads pick after the closing barrier.
__device__ __forceinline__ void select_digit(const unsigned* hist, int nbins, uint32_t rank,
                                             uint32_t* pick) {
  __shared__ unsigned warp_sum[kSelectThreads / 32];
  const int per = (nbins + blockDim.x - 1) / blockDim.x;
  const int lo = min(nbins, (int)threadIdx.x * per);
  const int hi = min(nbins, lo + per);
  unsigned local = 0;
  for (int b = lo; b < hi; ++b) local += hist[b];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  unsigned suffix = local;  // bins of this lane and the lanes above it
  for (int offset = 1; offset < 32; offset <<= 1) {
    const unsigned up = __shfl_down_sync(0xffffffffu, suffix, offset);
    if (lane + offset < 32) suffix += up;
  }
  if (lane == 0) warp_sum[warp] = suffix;
  __syncthreads();
  unsigned above = suffix - local;
  for (int w = warp + 1; w < (int)(blockDim.x / 32); ++w) above += warp_sum[w];
  for (int b = hi - 1; b >= lo; --b) {
    const unsigned c = hist[b];
    if (above < rank && rank <= above + c) {
      pick[0] = (uint32_t)b;
      pick[1] = rank - above;
    }
    above += c;
  }
  __syncthreads();
}

// One launch: pass 0 over every chunk of the plan, or pass > 0 over the
// chunks of the leaves of several chunks a row (the first blocks).
template <typename T>
__global__ void __launch_bounds__(kSelectThreads)
topk_select_kernel(const __grid_constant__ SelectPlan plan, unsigned* __restrict__ scratch,
                   int pass) {
  using U = typename Key<T>::U;
  __shared__ unsigned hist[kMaxBins];
  __shared__ uint32_t pick[2];
  __shared__ int is_last;
  int li = 0;
  while (li + 1 < plan.num_leaves && plan.leaf[li + 1].chunk_begin <= (int)blockIdx.x) ++li;
  const SelectLeaf& leaf = plan.leaf[li];
  const int64_t local = (int64_t)blockIdx.x - leaf.chunk_begin;
  const int64_t row = local / leaf.chunks_per_row;
  const int64_t start = (local % leaf.chunks_per_row) * plan.chunk;
  const int64_t stop = start + plan.chunk < leaf.cols ? start + plan.chunk : leaf.cols;
  const bool whole = leaf.chunks_per_row == 1;
  const int64_t segs = plan.num_segs;
  const int64_t seg = leaf.seg_begin + row;
  uint32_t* seg_prefix = scratch + segs * (kMaxBins + plan.passes);
  uint32_t* seg_rank = seg_prefix + segs;
  uint32_t prefix = 0, rank = (uint32_t)leaf.k;
  if (!whole && pass > 0) {
    prefix = seg_prefix[seg];
    rank = seg_rank[seg];
  }
  const int last_pass = whole ? plan.passes - 1 : pass;
  for (int p = pass; p <= last_pass; ++p) {
    const int shift = plan.shift[p];
    const int nbins = 1 << plan.bits[p];
    const uint32_t fixed =
        Key<T>::kAbs & ~(uint32_t)((1ull << (shift + plan.bits[p])) - 1ull);
    for (int b = threadIdx.x; b < nbins; b += blockDim.x) hist[b] = 0u;
    __syncthreads();
    count_chunk<T>(leaf, row, start, stop, prefix, fixed, shift, (uint32_t)nbins - 1u, hist);
    __syncthreads();
    if (!whole) {
      unsigned* seg_hist = scratch + seg * kMaxBins;
      for (int b = threadIdx.x; b < nbins; b += blockDim.x) {
        if (hist[b]) atomicAdd(&seg_hist[b], hist[b]);
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) {
        unsigned* done = scratch + segs * kMaxBins + (int64_t)p * segs + seg;
        is_last = atomicAdd(done, 1u) == (unsigned)(leaf.chunks_per_row - 1);
      }
      __syncthreads();
      if (!is_last) return;
      __threadfence();
      for (int b = threadIdx.x; b < nbins; b += blockDim.x) {
        hist[b] = __ldcg(&seg_hist[b]);
        seg_hist[b] = 0u;
      }
      __syncthreads();
    }
    select_digit(hist, nbins, rank, pick);
    prefix |= pick[0] << shift;
    rank = pick[1];
  }
  if (threadIdx.x != 0) return;
  if (whole || pass == plan.passes - 1) {
    static_cast<U*>(leaf.out)[row] = static_cast<U>(prefix);
  } else {
    seg_prefix[seg] = prefix;
    seg_rank[seg] = rank;
  }
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
static int launch_select(const void* plan, void* scratch, int pass, int64_t blocks,
                         void* stream) {
  topk_select_kernel<T><<<(unsigned)blocks, kSelectThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      *static_cast<const SelectPlan*>(plan), static_cast<unsigned*>(scratch), pass);
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

// sizeof(SelectPlan) and its limits, for the wrapper's layout check
extern "C" int topk_select_layout(int64_t* out) {
  out[0] = sizeof(SelectPlan);
  out[1] = kMaxLeaves;
  out[2] = kMaxPasses;
  out[3] = kMaxBins;
  return 0;
}

extern "C" int topk_select_f32(const void* plan, void* scratch, int pass, int64_t blocks,
                               void* stream) {
  return launch_select<float>(plan, scratch, pass, blocks, stream);
}

extern "C" int topk_select_bf16(const void* plan, void* scratch, int pass, int64_t blocks,
                                void* stream) {
  return launch_select<__nv_bfloat16>(plan, scratch, pass, blocks, stream);
}

extern "C" int topk_mask_f32(const void* x, const void* thresh, void* out, int64_t rows,
                             int64_t cols, void* stream) {
  return launch_mask<float>(x, thresh, out, rows, cols, stream);
}

extern "C" int topk_mask_bf16(const void* x, const void* thresh, void* out, int64_t rows,
                              int64_t cols, void* stream) {
  return launch_mask<__nv_bfloat16>(x, thresh, out, rows, cols, stream);
}
