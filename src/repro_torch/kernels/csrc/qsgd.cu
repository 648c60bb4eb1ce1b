// K6 qsgd_quantize: QSGD random quantization of every row of every stacked
// [rows, D_i] leaf of a tree in one launch, with each row's norm handed in.
//
// Replaces src/repro/kernels/qsgd.py:qsgd_quantize_2d (_qsgd_kernel):
//
//   q = sign(x) ||x|| floor(s |x| / ||x|| + xi) / (s c)   (0 if ||x|| = 0)
//
// in f32 and cast to the leaf dtype; xi is f32 uniform noise of x's shape,
// ||x|| the row's f32 norm (a reduction, taken outside the kernel as the
// reference does) and s c one f32 constant per leaf from the wrapper
// (c depends on D). qsgd_coord (qsgd.cuh, shared with K2) does each
// element's arithmetic, every step rounded on its own.
//
// Bound: bytes, x and xi read and q written once (12 B per element in f32,
// 8 in bf16, plus 4 per row of norm) against about 8 operations. Two
// things held the one-leaf, one-thread-per-element version back:
//   * a launch per leaf, most of them too small to matter (7 of the 10
//     CIFAR leaves under 5,000 elements a row), each paying the launch
//     floor. Here every row of every leaf is cut into chunks of
//     plan.chunk elements, one block each, and the grid is the total
//     number of chunks: one launch covers the tree (up to kMaxLeaves
//     leaves; the wrapper launches again for the rest). A block never
//     crosses a row, so it reads its row's norm and its leaf's s c once.
//     No blockIdx.y row, so no 65,535-row cap.
//   * one 4-byte element per thread, too few bytes in flight behind the
//     two IEEE divisions. Here every access moves 16 bytes: a float4 of x
//     and of noise in f32, 8 bf16 of x against two float4 of noise in
//     bf16, and 16 bytes of q stored. A thread loops over its chunk's
//     vectors, one at a time. Rows that do not start 16-byte aligned in x,
//     noise or out (f32 D % 4 != 0, bf16 D % 8 != 0) take a scalar path,
//     one element at a time.
// Picked from a sweep on the card: one vector a thread at a time keeps a
// thread under 40 registers, so 6 blocks of 256 fit an SM (4 with four
// vectors in flight), and more resident warps hide the divisions' latency
// better than more loads in flight; the streaming (evict-first) hints, as
// for data read once, help f32 and slow bf16, so only f32 takes them.
// The leaves' descriptors travel by value in the launch parameters
// (__grid_constant__), so a call copies nothing to the card.
#include "qsgd.cuh"

constexpr int kMaxLeaves = 32;  // leaves per launch; the wrapper splits longer trees
constexpr int kQsgdThreads = 256;

struct QsgdLeaf {
  const void* x;          // [rows, cols]
  const float* noise;     // [rows, cols]
  const float* norm;      // [rows]
  void* out;              // [rows, cols]
  int64_t cols;
  float sc;               // s * c, rounded to f32 once
  int32_t chunk_begin;    // first block of the leaf
  int32_t chunks_per_row;
  int32_t vec;            // 1 when every row of x, noise and out starts 16-byte aligned
};

struct QsgdPlan {
  QsgdLeaf leaf[kMaxLeaves];
  int32_t num_leaves;
  int32_t chunk;  // elements per block, a multiple of 8
  float s;        // levels
};

template <bool kStream, typename V>
__device__ __forceinline__ V load(const V* p) {
  if constexpr (kStream) return __ldcs(p);
  return *p;
}

template <bool kStream, typename V>
__device__ __forceinline__ void store(V* p, const V& v) {
  if constexpr (kStream) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

// Block b quantizes chunk b of the plan: one row's [start, start + chunk).
template <typename T>
__global__ void __launch_bounds__(kQsgdThreads)
qsgd_quantize_kernel(const __grid_constant__ QsgdPlan plan) {
  constexpr bool kStream = sizeof(T) == 4;
  int li = 0;
  while (li + 1 < plan.num_leaves && plan.leaf[li + 1].chunk_begin <= (int)blockIdx.x) ++li;
  const QsgdLeaf& leaf = plan.leaf[li];
  const int local = (int)blockIdx.x - leaf.chunk_begin;
  const int64_t row = local / leaf.chunks_per_row;
  const int64_t start = (int64_t)(local % leaf.chunks_per_row) * plan.chunk;
  const int width = leaf.cols - start < plan.chunk ? (int)(leaf.cols - start) : plan.chunk;
  const int64_t base = row * leaf.cols + start;
  const T* x = static_cast<const T*>(leaf.x) + base;
  const float* noise = leaf.noise + base;
  T* out = static_cast<T*>(leaf.out) + base;
  const float norm = leaf.norm[row];
  const float s = plan.s, sc = leaf.sc;
  if (leaf.vec) {
    constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector of x
    constexpr int W = V / 4;           // float4 noise vectors per vector of x
    const int n = width / V;           // cols and chunk are multiples of V here
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const float4* nv = reinterpret_cast<const float4*>(noise);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint4 xq = load<kStream>(xv + i);
      float4 xi[W];
#pragma unroll
      for (int w = 0; w < W; ++w) xi[w] = load<kStream>(nv + i * W + w);
      const T* e = reinterpret_cast<const T*>(&xq);
      const float* r = reinterpret_cast<const float*>(xi);
      uint4 packed;
      T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = from_f32<T>(qsgd_coord(to_f32(e[j]), r[j], norm, s, sc));
      store<kStream>(ov + i, packed);
    }
  } else {
    for (int i = threadIdx.x; i < width; i += blockDim.x)
      store<kStream>(out + i, from_f32<T>(qsgd_coord(to_f32(load<kStream>(x + i)),
                                                     load<kStream>(noise + i), norm, s, sc)));
  }
}

template <typename T>
static int launch(const void* plan, int64_t blocks, void* stream) {
  qsgd_quantize_kernel<T><<<(unsigned)blocks, kQsgdThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      *static_cast<const QsgdPlan*>(plan));
  return static_cast<int>(cudaGetLastError());
}

// sizeof(QsgdPlan), its leaf limit and sizeof(QsgdLeaf), for the wrapper's
// layout check
extern "C" int qsgd_quantize_layout(int64_t* out) {
  out[0] = sizeof(QsgdPlan);
  out[1] = kMaxLeaves;
  out[2] = sizeof(QsgdLeaf);
  return 0;
}

// Registers a thread and local memory a thread (spills), f32 then bf16,
// as the loaded kernels report them
extern "C" int qsgd_quantize_attributes(int64_t* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, qsgd_quantize_kernel<float>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = a.localSizeBytes;
  err = cudaFuncGetAttributes(&a, qsgd_quantize_kernel<__nv_bfloat16>);
  out[2] = a.numRegs;
  out[3] = a.localSizeBytes;
  return static_cast<int>(err);
}

extern "C" int qsgd_quantize_f32(const void* plan, int64_t blocks, void* stream) {
  return launch<float>(plan, blocks, stream);
}

extern "C" int qsgd_quantize_bf16(const void* plan, int64_t blocks, void* stream) {
  return launch<__nv_bfloat16>(plan, blocks, stream);
}
