// STREAM on persistent CTAs fed by a ring of bulk asynchronous copies: an
// alternative design that scripts/kernel_designs.py times beside the shipped
// src/repro_torch/kernels/csrc/stream.cu.
//
// As many CTAs as the card holds (occupancy x SMs); CTA c claims the plan's
// blocks c, c + grid, ...; a block is cut into 16 KB tiles of every stream.
// One thread issues cp.async.bulk loads of each input's tile into a ring of
// K stages in shared memory, K - 1 tiles ahead, one mbarrier a stage; K is
// the most stages of (inputs + 1) tiles that fit 227 KB (copy stores its
// input stage), at most STREAM_MAX_STAGES.  256 threads compute a stage in
// fp32 with rounded multiply and add into an output stage, fence it to the
// async proxy, and the thread bulk-stores it.  STREAM_EVICT_FIRST sets the
// L2 policy of the copies.  Contiguous, 16-B aligned (rows, width) tensors
// only.
#include "ring.cuh"

#ifndef STREAM_MAX_STAGES
#define STREAM_MAX_STAGES 64
#endif
#ifndef STREAM_EVICT_FIRST
#define STREAM_EVICT_FIRST 0
#endif

namespace {

using repro::Vec;

enum Op : int { kCopy = 0, kScale = 1, kAdd = 2, kStreamTriad = 3, kTriad = 4 };

template <int OP> struct Arity { static constexpr int value = 1; };
template <> struct Arity<kAdd> { static constexpr int value = 2; };
template <> struct Arity<kStreamTriad> { static constexpr int value = 2; };
template <> struct Arity<kTriad> { static constexpr int value = 3; };

template <int OP>
__device__ __forceinline__ float apply(float a, float b, float c, float s) {
  if (OP == kCopy) return a;
  if (OP == kScale) return __fmul_rn(s, a);
  if (OP == kAdd) return __fadd_rn(a, b);
  if (OP == kStreamTriad) return __fadd_rn(a, __fmul_rn(s, b));
  return __fadd_rn(a, __fmul_rn(b, c));
}

constexpr int kThreads = 256;
constexpr int kTileBytes = 16384;
constexpr int kSmemBudget = 232448;

template <int OP> struct Ring {
  static constexpr int kIn = Arity<OP>::value;
  static constexpr int kBufs = kIn + (OP == kCopy ? 0 : 1);
  static constexpr int kFit = kSmemBudget / (kBufs * kTileBytes + 8);
  static constexpr int kStages = kFit < STREAM_MAX_STAGES ? kFit : STREAM_MAX_STAGES;
  static constexpr int kSmem = kStages * (kBufs * kTileBytes + 8);
  static_assert(kStages >= 3, "the ring needs three stages");
};

// One CTA's tiles: its blocks (grid-stride), each block's tiles.
template <int64_t SE> struct Cursor {
  int64_t block, off;
  __device__ explicit Cursor(int64_t first) : block(first), off(0) {}
  __device__ bool valid(int64_t nblocks) const { return block < nblocks; }
  __device__ int64_t block_len(int64_t rows, int64_t width, int64_t brows) const {
    const int64_t left = rows - block * brows;
    return (left < brows ? left : brows) * width;
  }
  __device__ int64_t start(int64_t width, int64_t brows) const {
    return block * brows * width + off;
  }
  __device__ int len(int64_t rows, int64_t width, int64_t brows) const {
    const int64_t left = block_len(rows, width, brows) - off;
    return static_cast<int>(left < SE ? left : SE);
  }
  __device__ void next(int64_t rows, int64_t width, int64_t brows) {
    off += SE;
    if (off < block_len(rows, width, brows)) return;
    off = 0;
    block += gridDim.x;
  }
};

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads, 1)
ring_kernel(const T* a, const T* b, const T* c, T* out, float s, int64_t rows, int64_t width,
            int64_t brows) {
  using R = Ring<OP>;
  constexpr int NIN = R::kIn, K = R::kStages, N = Vec<T>::N;
  constexpr int64_t SE = kTileBytes / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + K * R::kBufs * kTileBytes);
  auto tile = [&](int stage, int k) {
    return reinterpret_cast<T*>(smem + (stage * R::kBufs + k) * kTileBytes);
  };
  const T* ins[3] = {a, b, c};
  const int tid = threadIdx.x;
  const int64_t nblocks = (rows + brows - 1) / brows;
  uint64_t policy = 0;
  auto issue = [&](const Cursor<SE>& cur, int stage) {
    const int64_t at = cur.start(width, brows);
    const uint32_t bytes = static_cast<uint32_t>(cur.len(rows, width, brows)) * sizeof(T);
    ring::mbar_expect_tx(&full[stage], bytes * NIN);
#pragma unroll
    for (int k = 0; k < NIN; ++k)
      ring::bulk_load(tile(stage, k), ins[k] + at, bytes, &full[stage], policy);
  };
  Cursor<SE> pre(blockIdx.x);
  if (tid == 0) {
    for (int k = 0; k < K; ++k) ring::mbar_init(&full[k], 1);
    ring::mbar_fence_init();
    policy = ring::l2_policy(STREAM_EVICT_FIRST);
  }
  __syncthreads();
  if (tid == 0)
    for (int k = 0; k < K - 1 && pre.valid(nblocks); ++k, pre.next(rows, width, brows))
      issue(pre, k);
  if (OP == kCopy && tid != 0) return;
  Cursor<SE> cur(blockIdx.x);
  for (int64_t i = 0; cur.valid(nblocks); ++i, cur.next(rows, width, brows)) {
    const int st = static_cast<int>(i % K);
    const int len = cur.len(rows, width, brows);
    ring::mbar_wait(&full[st], static_cast<uint32_t>((i / K) & 1));
    if constexpr (OP != kCopy) {
      const T* x = tile(st, 0);
      const T* y = tile(st, NIN >= 2 ? 1 : 0);
      const T* z = tile(st, NIN >= 3 ? 2 : 0);
      T* o = tile(st, NIN);
      for (int j = tid * N; j < len; j += kThreads * N) {
        float u[N], v[N] = {}, w[N] = {}, r[N];
        Vec<T>::load(x + j, u);
        if (NIN >= 2) Vec<T>::load(y + j, v);
        if (NIN >= 3) Vec<T>::load(z + j, w);
#pragma unroll
        for (int e = 0; e < N; ++e) r[e] = apply<OP>(u[e], v[e], w[e], s);
        Vec<T>::store(o + j, r);
      }
      ring::fence_proxy_async();
      // the next tile's output stage must have been read by its store
      if (tid == 0) ring::bulk_wait_read<K - 2>();
      __syncthreads();
    }
    if (tid == 0) {
      ring::bulk_store(out + cur.start(width, brows), tile(st, OP == kCopy ? 0 : NIN),
                       static_cast<uint32_t>(len) * sizeof(T), policy);
      ring::bulk_commit();
      if (OP == kCopy) ring::bulk_wait_read<1>();
      if (pre.valid(nblocks)) {
        issue(pre, static_cast<int>((i + K - 1) % K));
        pre.next(rows, width, brows);
      }
    }
  }
  if (tid == 0) ring::bulk_wait<0>();
}

template <typename T, int OP>
int go(const void* a, const void* b, const void* c, void* out, float s, int64_t rows,
       int64_t width, int64_t brows, cudaStream_t stream) {
  static int grid = 0;
  if (!grid) {
    cudaFuncSetAttribute(ring_kernel<T, OP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         Ring<OP>::kSmem);
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_kernel<T, OP>, kThreads,
                                                  Ring<OP>::kSmem);
    grid = per_sm * ring::sm_count();
  }
  const int64_t nblocks = (rows + brows - 1) / brows;
  ring_kernel<T, OP><<<static_cast<unsigned>(nblocks < grid ? nblocks : grid), kThreads,
                       Ring<OP>::kSmem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<T*>(out), s, rows, width, brows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int go_op(int op, const void* a, const void* b, const void* c, void* out, float s, int64_t rows,
          int64_t width, int64_t brows, cudaStream_t st) {
  switch (op) {
    case kCopy: return go<T, kCopy>(a, b, c, out, s, rows, width, brows, st);
    case kScale: return go<T, kScale>(a, b, c, out, s, rows, width, brows, st);
    case kAdd: return go<T, kAdd>(a, b, c, out, s, rows, width, brows, st);
    case kStreamTriad: return go<T, kStreamTriad>(a, b, c, out, s, rows, width, brows, st);
    default: return go<T, kTriad>(a, b, c, out, s, rows, width, brows, st);
  }
}

}  // namespace

extern "C" int design_stream(int op, int dtype, const void* a, const void* b, const void* c,
                             void* out, float s, int64_t rows, int64_t width, int64_t brows,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return go_op<float>(op, a, b, c, out, s, rows, width, brows, st);
  return go_op<__nv_bfloat16>(op, a, b, c, out, s, rows, width, brows, st);
}
