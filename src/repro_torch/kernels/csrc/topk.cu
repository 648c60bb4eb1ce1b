// K4 topk_threshold over every leaf of a gossip step, and K5 topk_mask over
// every leaf of a list.
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
// K4's sharded-row form (topk_shard_count, topk_shard_pick) is the same
// select for rows split over the ranks of a gossip-fsdp mesh, each rank
// holding a part of every row: the exact k-th largest |x| of the WHOLE row
// (the reference's argument for partials, src/repro/kernels/topk.py:9-18:
// whatever the parts, the count of keys above a digit is the sum of the
// parts' counts). Every row takes one count launch and one pick launch a
// pass, whether or not its part has a key left under the prefix:
//   * count: each block histograms the keys of its chunk that match the
//     row's prefix into shared memory and adds the non-zero bins to the
//     row's histogram in the [segments, 2^bits] buffer (integer atomics);
//   * between the two launches the wrapper sums that buffer over the
//     row's ranks (one all-gather a pass a call, 8 KB a row at 11 bits);
//   * pick: one block a row scans the summed bins, fixes the digit and
//     the rank left inside it, and carries (prefix, rank) to the next
//     pass in a [segments, 2] state, or writes the threshold after the
//     last. The sum is the same on every rank, so every rank picks the
//     same digits, and the threshold is bitwise the unsharded K4's on the
//     whole row. Bound: bytes, one read of this rank's keys a pass.
//
// K5 replaces src/repro/kernels/topk.py:topk_mask_2d (_mask_kernel):
// out = |x| >= t[row] ? x : +0 in the input dtype, over every leaf of a
// list in one launch. Bound: bytes, one read and one write of every
// element; one compare an element. A pure streaming pass, so the design
// keeps enough bytes in flight on all 132 SMs: each block owns a chunk of
// one row of one leaf (MaskPlan, by value), so the row's threshold sits in
// a register; the body moves 16-byte vectors (8 bf16 or 4 f32 values),
// kMaskLoads of them loaded by each thread before any compare, with
// streaming cache hints (nothing is read twice); the wrapper picks the
// chunk (topk.py mask_plans) so that a small tree still makes about 4
// blocks an SM and a large one at most 8 K elements a block. Where the
// chunk does not start on 16 bytes (rows of D * itemsize % 16 != 0) a
// scalar head and tail take the ragged elements; where x and out are not
// congruent modulo 16 bytes (a view at an odd storage offset) the whole
// chunk is scalar. The compare is the reference's, element by element:
// |to_f32(v)| >= to_f32(t) keeps v's bits, else +0 (so -0.0 is kept at
// t = 0, a NaN is dropped and ties are kept).
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

// K4's sharded-row form, count: pass `pass` over every chunk of the plan,
// each row's keys matching its prefix (state[2 * seg], 0 at pass 0) added
// into hist[seg][2^bits] (zeroed by the wrapper).
template <typename T>
__global__ void __launch_bounds__(kSelectThreads)
topk_shard_count_kernel(const __grid_constant__ SelectPlan plan,
                        const uint32_t* __restrict__ state, unsigned* __restrict__ hist,
                        int pass) {
  __shared__ unsigned local[kMaxBins];
  int li = 0;
  while (li + 1 < plan.num_leaves && plan.leaf[li + 1].chunk_begin <= (int)blockIdx.x) ++li;
  const SelectLeaf& leaf = plan.leaf[li];
  const int64_t at = (int64_t)blockIdx.x - leaf.chunk_begin;
  const int64_t row = at / leaf.chunks_per_row;
  const int64_t start = (at % leaf.chunks_per_row) * plan.chunk;
  const int64_t stop = start + plan.chunk < leaf.cols ? start + plan.chunk : leaf.cols;
  const int64_t seg = leaf.seg_begin + row;
  const int shift = plan.shift[pass];
  const int nbins = 1 << plan.bits[pass];
  const uint32_t prefix = pass == 0 ? 0u : state[2 * seg];
  const uint32_t fixed =
      Key<T>::kAbs & ~(uint32_t)((1ull << (shift + plan.bits[pass])) - 1ull);
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) local[b] = 0u;
  __syncthreads();
  count_chunk<T>(leaf, row, start, stop, prefix, fixed, shift, (uint32_t)nbins - 1u, local);
  __syncthreads();
  unsigned* seg_hist = hist + seg * nbins;
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) {
    if (local[b]) atomicAdd(&seg_hist[b], local[b]);
  }
}

// K4's sharded-row form, pick: one block a row (segment) over the bins
// summed across the row's ranks; the digit holding the row's rank (k at
// pass 0) extends the prefix, and the last pass writes it as the
// threshold in the leaf's dtype.
template <typename T>
__global__ void __launch_bounds__(kSelectThreads)
topk_shard_pick_kernel(const __grid_constant__ SelectPlan plan,
                       const unsigned* __restrict__ hist, uint32_t* __restrict__ state,
                       int pass) {
  using U = typename Key<T>::U;
  __shared__ unsigned bins[kMaxBins];
  __shared__ uint32_t pick[2];
  const int64_t seg = blockIdx.x;
  int li = 0;
  while (li + 1 < plan.num_leaves && plan.leaf[li + 1].seg_begin <= seg) ++li;
  const SelectLeaf& leaf = plan.leaf[li];
  const int64_t row = seg - leaf.seg_begin;
  const int shift = plan.shift[pass];
  const int nbins = 1 << plan.bits[pass];
  const uint32_t prefix = pass == 0 ? 0u : state[2 * seg];
  const uint32_t rank = pass == 0 ? (uint32_t)leaf.k : state[2 * seg + 1];
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) bins[b] = hist[seg * nbins + b];
  if (threadIdx.x == 0) pick[0] = pick[1] = 0u;
  __syncthreads();
  select_digit(bins, nbins, rank, pick);
  if (threadIdx.x != 0) return;
  const uint32_t found = prefix | (pick[0] << shift);
  if (pass == plan.passes - 1) {
    static_cast<U*>(leaf.out)[row] = static_cast<U>(found);
  } else {
    state[2 * seg] = found;
    state[2 * seg + 1] = pick[1];
  }
}

constexpr int kMaskThreads = 256;
constexpr int kMaskLoads = 4;  // 16-byte vectors a thread loads before any compare

struct MaskLeaf {
  const void* x;           // [rows, cols], row r at x + r * cols
  const void* thresh;      // [rows]
  void* out;               // [rows, cols]
  int64_t cols;
  int32_t chunk_begin;     // first block of the leaf
  int32_t chunks_per_row;
};

struct MaskPlan {
  MaskLeaf leaf[kMaxLeaves];
  int32_t num_leaves;
  int32_t chunk;  // elements a block, a multiple of 16 / sizeof(T)
};

// A key's bits as f32: the bits of bf16 are the top half of an f32's, so
// the conversion is exact. The threshold is widened as it is, its sign
// kept; a value is compared by its magnitude.
template <typename T> __device__ __forceinline__ float widen(uint32_t key);
template <> __device__ __forceinline__ float widen<float>(uint32_t key) {
  return __uint_as_float(key);
}
template <> __device__ __forceinline__ float widen<__nv_bfloat16>(uint32_t key) {
  return __uint_as_float(key << 16);
}
template <typename T> __device__ __forceinline__ float magnitude(uint32_t key) {
  return fabsf(widen<T>(key));
}

// One 32-bit word of a vector: one f32 value, or two bf16 values each kept
// or zeroed on its own.
template <typename T> __device__ __forceinline__ uint32_t mask_word(uint32_t w, float t);
template <> __device__ __forceinline__ uint32_t mask_word<float>(uint32_t w, float t) {
  return magnitude<float>(w) >= t ? w : 0u;
}
template <> __device__ __forceinline__ uint32_t mask_word<__nv_bfloat16>(uint32_t w, float t) {
  const uint32_t lo = magnitude<__nv_bfloat16>(w & 0xffffu) >= t ? w & 0xffffu : 0u;
  const uint32_t hi = magnitude<__nv_bfloat16>(w >> 16) >= t ? w & 0xffff0000u : 0u;
  return lo | hi;
}

template <typename T>
__global__ void __launch_bounds__(kMaskThreads)
topk_mask_kernel(const __grid_constant__ MaskPlan plan) {
  using U = typename Key<T>::U;
  constexpr int V = 16 / sizeof(U);
  int li = 0;
  while (li + 1 < plan.num_leaves && plan.leaf[li + 1].chunk_begin <= (int)blockIdx.x) ++li;
  const MaskLeaf& leaf = plan.leaf[li];
  const int64_t local = (int64_t)blockIdx.x - leaf.chunk_begin;
  const int64_t row = local / leaf.chunks_per_row;
  const int64_t start = (local % leaf.chunks_per_row) * plan.chunk;
  const int64_t stop = start + plan.chunk < leaf.cols ? start + plan.chunk : leaf.cols;
  const U* x = static_cast<const U*>(leaf.x) + row * leaf.cols;
  U* out = static_cast<U*>(leaf.out) + row * leaf.cols;
  const float t = widen<T>(static_cast<const U*>(leaf.thresh)[row]);
  // the vector span [body, end): from the first 16-byte boundary of the
  // chunk, whole vectors (the CPU tests mirror this arithmetic)
  int64_t body = stop, end = stop;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x + start);
  if (((xa ^ reinterpret_cast<uintptr_t>(out + start)) & 15u) == 0) {
    const int64_t head = (int64_t)(((16u - (xa & 15u)) & 15u) / sizeof(U));
    body = start + head < stop ? start + head : stop;
    end = body + (stop - body) / V * V;
  }
  for (int64_t i = start + threadIdx.x; i < body; i += blockDim.x) {
    out[i] = static_cast<U>(mask_word<T>(x[i], t));
  }
  for (int64_t i = end + threadIdx.x; i < stop; i += blockDim.x) {
    out[i] = static_cast<U>(mask_word<T>(x[i], t));
  }
  const uint4* xv = reinterpret_cast<const uint4*>(x + body);
  uint4* ov = reinterpret_cast<uint4*>(out + body);
  const int n = (int)((end - body) / V);
  for (int base = threadIdx.x; base < n; base += kMaskLoads * kMaskThreads) {
    uint4 q[kMaskLoads];
#pragma unroll
    for (int u = 0; u < kMaskLoads; ++u) {
      const int i = base + u * kMaskThreads;
      if (i < n) q[u] = __ldcs(xv + i);
    }
#pragma unroll
    for (int u = 0; u < kMaskLoads; ++u) {
      const int i = base + u * kMaskThreads;
      if (i < n) {
        q[u].x = mask_word<T>(q[u].x, t);
        q[u].y = mask_word<T>(q[u].y, t);
        q[u].z = mask_word<T>(q[u].z, t);
        q[u].w = mask_word<T>(q[u].w, t);
        __stcs(ov + i, q[u]);
      }
    }
  }
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
static int launch_mask(const void* plan, int64_t blocks, void* stream) {
  topk_mask_kernel<T><<<(unsigned)blocks, kMaskThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *static_cast<const MaskPlan*>(plan));
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

template <typename T>
static int launch_shard_count(const void* plan, const void* state, void* hist, int pass,
                              int64_t blocks, void* stream) {
  topk_shard_count_kernel<T><<<(unsigned)blocks, kSelectThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      *static_cast<const SelectPlan*>(plan), static_cast<const uint32_t*>(state),
      static_cast<unsigned*>(hist), pass);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_shard_pick(const void* plan, const void* hist, void* state, int pass,
                             int64_t segments, void* stream) {
  topk_shard_pick_kernel<T><<<(unsigned)segments, kSelectThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      *static_cast<const SelectPlan*>(plan), static_cast<const unsigned*>(hist),
      static_cast<uint32_t*>(state), pass);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int topk_shard_count_f32(const void* plan, const void* state, void* hist, int pass,
                                    int64_t blocks, void* stream) {
  return launch_shard_count<float>(plan, state, hist, pass, blocks, stream);
}

extern "C" int topk_shard_count_bf16(const void* plan, const void* state, void* hist, int pass,
                                     int64_t blocks, void* stream) {
  return launch_shard_count<__nv_bfloat16>(plan, state, hist, pass, blocks, stream);
}

extern "C" int topk_shard_pick_f32(const void* plan, const void* hist, void* state, int pass,
                                   int64_t segments, void* stream) {
  return launch_shard_pick<float>(plan, hist, state, pass, segments, stream);
}

extern "C" int topk_shard_pick_bf16(const void* plan, const void* hist, void* state, int pass,
                                    int64_t segments, void* stream) {
  return launch_shard_pick<__nv_bfloat16>(plan, hist, state, pass, segments, stream);
}

// sizeof(MaskPlan), its leaf limit and its threads a block, for the
// wrapper's layout check
extern "C" int topk_mask_layout(int64_t* out) {
  out[0] = sizeof(MaskPlan);
  out[1] = kMaxLeaves;
  out[2] = kMaskThreads;
  return 0;
}

extern "C" int topk_mask_f32(const void* plan, int64_t blocks, void* stream) {
  return launch_mask<float>(plan, blocks, stream);
}

extern "C" int topk_mask_bf16(const void* plan, int64_t blocks, void* stream) {
  return launch_mask<__nv_bfloat16>(plan, blocks, stream);
}
