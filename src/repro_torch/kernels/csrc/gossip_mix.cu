// K1 gossip_mix: one gossip step X <- X C for a circulant C, over every
// stacked [N, D_i] leaf of a tree in one launch; and its received-buffer
// form, one node's leaves mixed with the copies it received (the sharded
// engine's step, gossip_mix_received_* at the end of this file).
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
// topology's shifts and are shared by every leaf.
//
// Bound: bytes, each element read once and written once (8 B per f32
// element); 2 (deg + 1) flops per element are far below the card's f32
// rate. Each block takes one column tile of one leaf and copies the whole
// [N, tile] slab into shared memory, every node's row of it, with 16-byte
// asynchronous copies where the rows start 16-byte aligned
// (D * sizeof(T) % 16 == 0, else element by element). Every output of the tile is then mixed from
// shared memory, so device memory sees each element read once, not deg + 1
// times, and written once, 16 bytes at a time where aligned. The tile
// width comes from N so that the slab fits in 48 KB (gossip_mix.py
// tile_width). The leaves' descriptors travel by value in the launch
// parameters (__grid_constant__), so one launch serves the whole tree.
//
// __fmul_rn / __fadd_rn keep nvcc from contracting into fma, so the result
// is bitwise the plain PyTorch version's (separate mul and add kernels).
#include "common.cuh"

constexpr int kMaxLeaves = 32;  // leaves per launch; the wrapper splits longer trees
constexpr int kMixThreads = 256;

struct MixLeaf {
  const void* x;       // [rows, cols]
  void* out;           // [rows, cols]
  int64_t cols;
  int32_t tile_begin;  // first block of the leaf
  int32_t vec;         // 1 when every row of x and out starts 16-byte aligned
};

struct MixPlan {
  MixLeaf leaf[kMaxLeaves];
  int32_t num_leaves;
  int32_t tile;  // columns per block, a multiple of 16 / sizeof(T)
};

// A 16-byte copy from device to shared memory that does not pass through
// registers (cp.async), so a thread keeps all its copies in flight at once.
__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void wait_async_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ float mix_one(const T* slab, int tile, int r, int c,
                                         const int32_t* __restrict__ nbr,
                                         const float* __restrict__ w, int deg) {
  const float* wr = w + r * (deg + 1);
  float acc = __fmul_rn(wr[0], to_f32(slab[r * tile + c]));
  for (int k = 0; k < deg; ++k) {
    acc = __fadd_rn(acc, __fmul_rn(wr[k + 1], to_f32(slab[nbr[r * deg + k] * tile + c])));
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kMixThreads)
gossip_mix_kernel(const __grid_constant__ MixPlan plan, const int32_t* __restrict__ nbr,
                  const float* __restrict__ w, int rows, int deg) {
  extern __shared__ uint4 slab_words[];
  T* slab = reinterpret_cast<T*>(slab_words);
  int li = 0;
  while (li + 1 < plan.num_leaves && plan.leaf[li + 1].tile_begin <= (int)blockIdx.x) ++li;
  const MixLeaf& leaf = plan.leaf[li];
  const int tile = plan.tile;
  const int64_t col0 = (int64_t)((int)blockIdx.x - leaf.tile_begin) * tile;
  const int width = leaf.cols - col0 < tile ? (int)(leaf.cols - col0) : tile;
  const T* x = static_cast<const T*>(leaf.x) + col0;
  T* out = static_cast<T*>(leaf.out) + col0;
  if (leaf.vec) {
    constexpr int V = 16 / sizeof(T);
    const int nv = width / V;  // cols and tile are multiples of V here
    const int n = rows * nv;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / nv, v = i - r * nv;
      copy16_async(slab + r * tile + v * V, x + r * leaf.cols + v * V);
    }
    wait_async_copies();
    __syncthreads();
    // one 16-byte vector of each source row a step, the accumulation
    // order of every element as in mix_one
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / nv, v = i - r * nv;
      const float* wr = w + r * (deg + 1);
      float acc[V];
      uint4 q = reinterpret_cast<const uint4*>(slab + r * tile)[v];
      const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = __fmul_rn(wr[0], to_f32(e[j]));
      for (int k = 0; k < deg; ++k) {
        const float wk = wr[k + 1];
        q = reinterpret_cast<const uint4*>(slab + nbr[r * deg + k] * tile)[v];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(wk, to_f32(e[j])));
      }
      uint4 packed;
      T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = from_f32<T>(acc[j]);
      reinterpret_cast<uint4*>(out + r * leaf.cols)[v] = packed;
    }
  } else {
    for (int i = threadIdx.x; i < rows * width; i += blockDim.x) {
      const int r = i / width, c = i - r * width;
      slab[r * tile + c] = x[r * leaf.cols + c];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * width; i += blockDim.x) {
      const int r = i / width, c = i - r * width;
      out[r * leaf.cols + c] = from_f32<T>(mix_one(slab, tile, r, c, nbr, w, deg));
    }
  }
}

template <typename T>
static int launch(const void* plan, const void* nbr, const void* w, int rows, int deg,
                  int64_t blocks, void* stream) {
  const MixPlan& p = *static_cast<const MixPlan*>(plan);
  const size_t slab_bytes = (size_t)rows * p.tile * sizeof(T);
  gossip_mix_kernel<T><<<(unsigned)blocks, kMixThreads, slab_bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int32_t*>(nbr), static_cast<const float*>(w), rows, deg);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(MixPlan) and its leaf limit, for the wrapper's layout check
extern "C" int gossip_mix_layout(int64_t* out) {
  out[0] = sizeof(MixPlan);
  out[1] = kMaxLeaves;
  return 0;
}

extern "C" int gossip_mix_f32(const void* plan, const void* nbr, const void* w, int rows,
                              int deg, int64_t blocks, void* stream) {
  return launch<float>(plan, nbr, w, rows, deg, blocks, stream);
}

extern "C" int gossip_mix_bf16(const void* plan, const void* nbr, const void* w, int rows,
                               int deg, int64_t blocks, void* stream) {
  return launch<__nv_bfloat16>(plan, nbr, w, rows, deg, blocks, stream);
}

// ---------------------------------------------------------------------------
// K1, received-buffer form: one node's gossip step on the sharded engine.
//
// Replaces src/repro/kernels/gossip_mix.py:gossip_mix_2d in its own form:
// one node's leaf x [D] mixed with the deg buffers it received from its
// neighbours (recv, deg rows of D at a stride of recv_stride elements),
//
//   out[c] = w[0] * x[c] + sum_j w[j + 1] * recv[j, c]
//
// accumulated in f32 in that order and cast once to the leaf dtype, with
// __fmul_rn / __fadd_rn as in mix_one above, so that at the same weights
// in the same order it is bitwise the stacked kernel's row. The weights
// [deg + 1] are read from device memory: masked weights change every
// round and are never read on the host.
//
// Bound: bytes, (deg + 2) D elements (x and deg buffers read once, out
// written once); 2 (deg + 1) flops an element are far below the f32 rate.
// A streaming kernel with no shared memory, so the only lever is bytes in
// flight on every SM:
//   * the wrapper picks the chunk of columns a block takes from the call's
//     total columns and the card's SM count (gossip_mix.py
//     received_plans): about 4 blocks an SM where the tree is small (one
//     CIFAR node: 568 blocks of 1,024 f32 columns, not 70 of 8,192), at
//     most 8,192 columns a block where it is large;
//   * deg is a template parameter for 1..kRecvMaxDeg (the ring's 2,
//     full(8)'s 7), so a thread starts the loads of x's 16-byte vector
//     and of all deg received vectors before the first multiply, holds the
//     weights w[0..deg] in registers, read once; beyond kRecvMaxDeg a
//     run-time loop;
//   * each thread mixes one 16-byte vector of x, of every received row and
//     of out at a time where the rows start 16-byte aligned (vec), else
//     one element.
// The leaves' descriptors travel by value in the launch parameters, so one
// launch serves a whole tree.

constexpr int kRecvThreads = 256;
constexpr int kRecvMaxDeg = 8;  // degrees compiled with deg fixed

struct RecvLeaf {
  const void* x;        // [cols]
  const void* recv;     // [deg] rows of cols, recv_stride elements apart
  void* out;            // [cols]
  int64_t cols;
  int64_t recv_stride;
  int32_t block_begin;  // first block of the leaf
  int32_t vec;          // 1 when x, out and every received row are 16-byte aligned
};

struct RecvPlan {
  RecvLeaf leaf[kMaxLeaves];
  int32_t num_leaves;
  int32_t chunk;  // columns per block, a multiple of 16 / sizeof(T)
};

// kDeg in 1..kRecvMaxDeg: deg fixed at compile time; 0: deg_arg, looped.
template <typename T, int kDeg>
__global__ void __launch_bounds__(kRecvThreads)
gossip_mix_received_kernel(const __grid_constant__ RecvPlan plan, const float* __restrict__ w,
                           int deg_arg) {
  constexpr int kW = kDeg > 0 ? kDeg + 1 : 1;  // weights held in registers
  const int deg = kDeg > 0 ? kDeg : deg_arg;
  int li = 0;
  while (li + 1 < plan.num_leaves && plan.leaf[li + 1].block_begin <= (int)blockIdx.x) ++li;
  const RecvLeaf& leaf = plan.leaf[li];
  const int64_t col0 = (int64_t)((int)blockIdx.x - leaf.block_begin) * plan.chunk;
  const int width = leaf.cols - col0 < plan.chunk ? (int)(leaf.cols - col0) : plan.chunk;
  const T* x = static_cast<const T*>(leaf.x) + col0;
  const T* recv = static_cast<const T*>(leaf.recv) + col0;
  T* out = static_cast<T*>(leaf.out) + col0;
  float wr[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) wr[k] = w[k];
  // weight k of the sum: from registers where deg is fixed
  auto weight = [&](int k) { return kDeg > 0 ? wr[k] : w[k]; };
  if (leaf.vec) {
    constexpr int V = 16 / sizeof(T);
    const int nv = width / V;  // cols and chunk are multiples of V here
    for (int v = threadIdx.x; v < nv; v += kRecvThreads) {
      float acc[V];
      if constexpr (kDeg > 0) {
        // every load of the vector started before the first multiply
        uint4 q[kDeg + 1];
        q[0] = reinterpret_cast<const uint4*>(x)[v];
#pragma unroll
        for (int k = 0; k < kDeg; ++k) {
          q[k + 1] = reinterpret_cast<const uint4*>(recv + k * leaf.recv_stride)[v];
        }
        const T* e = reinterpret_cast<const T*>(&q[0]);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = __fmul_rn(wr[0], to_f32(e[j]));
#pragma unroll
        for (int k = 0; k < kDeg; ++k) {
          e = reinterpret_cast<const T*>(&q[k + 1]);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            acc[j] = __fadd_rn(acc[j], __fmul_rn(wr[k + 1], to_f32(e[j])));
          }
        }
      } else {
        uint4 q = reinterpret_cast<const uint4*>(x)[v];
        const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = __fmul_rn(wr[0], to_f32(e[j]));
        for (int k = 0; k < deg; ++k) {
          const float wk = w[k + 1];
          q = reinterpret_cast<const uint4*>(recv + k * leaf.recv_stride)[v];
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(wk, to_f32(e[j])));
        }
      }
      uint4 packed;
      T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = from_f32<T>(acc[j]);
      reinterpret_cast<uint4*>(out)[v] = packed;
    }
  } else {
    for (int c = threadIdx.x; c < width; c += kRecvThreads) {
      float acc = __fmul_rn(weight(0), to_f32(x[c]));
#pragma unroll
      for (int k = 0; k < deg; ++k) {
        acc = __fadd_rn(acc, __fmul_rn(weight(k + 1), to_f32(recv[k * leaf.recv_stride + c])));
      }
      out[c] = from_f32<T>(acc);
    }
  }
}

template <typename T, int kDeg>
static void launch_received_deg(const RecvPlan& p, const float* w, int deg, int64_t blocks,
                                cudaStream_t stream) {
  gossip_mix_received_kernel<T, kDeg><<<(unsigned)blocks, kRecvThreads, 0, stream>>>(p, w, deg);
}

template <typename T>
static int launch_received(const void* plan, const void* w, int deg, int64_t blocks,
                           void* stream) {
  const RecvPlan& p = *static_cast<const RecvPlan*>(plan);
  const float* wf = static_cast<const float*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static_assert(kRecvMaxDeg == 8, "one case below for each fixed degree");
  switch (deg) {
    case 1: launch_received_deg<T, 1>(p, wf, deg, blocks, s); break;
    case 2: launch_received_deg<T, 2>(p, wf, deg, blocks, s); break;
    case 3: launch_received_deg<T, 3>(p, wf, deg, blocks, s); break;
    case 4: launch_received_deg<T, 4>(p, wf, deg, blocks, s); break;
    case 5: launch_received_deg<T, 5>(p, wf, deg, blocks, s); break;
    case 6: launch_received_deg<T, 6>(p, wf, deg, blocks, s); break;
    case 7: launch_received_deg<T, 7>(p, wf, deg, blocks, s); break;
    case 8: launch_received_deg<T, 8>(p, wf, deg, blocks, s); break;
    default: launch_received_deg<T, 0>(p, wf, deg, blocks, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// sizeof(RecvPlan), its leaf limit and its threads a block, for the
// wrapper's layout check
extern "C" int gossip_mix_received_layout(int64_t* out) {
  out[0] = sizeof(RecvPlan);
  out[1] = kMaxLeaves;
  out[2] = kRecvThreads;
  return 0;
}

extern "C" int gossip_mix_received_f32(const void* plan, const void* w, int deg,
                                       int64_t blocks, void* stream) {
  return launch_received<float>(plan, w, deg, blocks, stream);
}

extern "C" int gossip_mix_received_bf16(const void* plan, const void* w, int deg,
                                        int64_t blocks, void* stream) {
  return launch_received<__nv_bfloat16>(plan, w, deg, blocks, stream);
}
