// Per-token cross-entropy (negative log-likelihood) by online softmax, and
// the per-token online-softmax partials of one vocab shard, on Hopper.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/xent/kernel.py: _xent_kernel (:25), launched by
//     xent_tiled (:144)                                     -> xent_kernel
//   src/repro/kernels/xent/kernel.py: _xent_partial_kernel (:54), launched
//     by xent_partial_tiled (:117)                  -> xent_partial_kernel
//
// Both fold each row r of contiguous (rows, width) logits whose first
// `limit` columns count and the rest are masked:
//   x    = logits[r, :] widened to fp32, then columns >= limit set to -1e30
//          (cast before the mask, kernel.py:35-37 and :78-83);
//   m    = max(x);  l = sum(x <= -1e29 ? 0 : exp(x - m))  (kernel.py:39-41).
// xent_kernel (limit = logical_v) then writes
//   lse  = log(max(l, 1e-30)) + m                          (kernel.py:50);
//   ll   = x[label] if 0 <= label < width, else 0: the masked sum of x over
//          the columns equal to the label (kernel.py:44-46), so a label in
//          the padding gives -1e30 and one past the row gives 0;
//   nll  = lse - ll.
// xent_partial_kernel folds one vocab shard whose local column c is global
// column c + off: a column counts when c < vl (the shard's own width, the
// rest is local padding) and c + off < logical_v (the global vocabulary),
// so limit = min(vl, logical_v - off) (kernel.py:78-81).  It writes the
// running (m, l) and
//   ll   = x[label - off] if 0 <= label - off < limit, else 0: the label
//          matches only inside the valid columns, because a padded local
//          column's global index can alias another shard's label
//          (kernel.py:88-93).
// The cross-shard combine (max of m, sum of rescaled l and of ll) is the
// caller's (kernels/xent/ops._spmd_xent).
//
// The TPU kernels carry (m, l, ll) in VMEM scratch from one vocab tile to
// the next along a sequential grid axis.  Here one CTA owns whole rows and
// folds each one in a loop of passes over its columns; nothing carries
// between CTAs, and no atomics are used, so the results are deterministic.
//
// Bound on this card: bytes.  The logits are read once (4 B an fp32
// element) against about ten operations an element (a max, a subtract, an
// exp, an add and the vector bookkeeping), far below the card's balance
// point; the labels and the outputs are one word a row.
//
// Design against that bound: each thread loads kUnroll 16-B vectors of the
// row (float4 for fp32, 8 x bf16) before it folds any, so a CTA keeps
// kUnroll x 4 KB of loads in flight and a warp moves whole 128-B lines.  A
// thread keeps its own running (max, sum of exps) in registers, rescaling
// its sum once a batch of vectors to the batch's new max.  At the end of a
// row the CTA merges the threads' (m, l) pairs with warp shuffles, then
// across warps through shared memory, each pair rescaled to the larger max.
// One thread reads the label's logit once and writes the row's outputs.

#include "common.cuh"

namespace {

using repro::Vec;

constexpr int kUnroll = 4;            // 16-B vectors a thread loads per batch
constexpr int kWarps = repro::kThreads / 32;
constexpr float kMask = -1e30f;       // value of a masked column
constexpr float kDead = -1e29f;       // at or below: contributes no exp

// Merge running pair (m_o, l_o) into (m, l), both sums rescaled to the
// larger max.  A pair that saw only masked columns is (-1e30, 0) and leaves
// the other unchanged.
__device__ __forceinline__ void merge(float& m, float& l, float m_o, float l_o) {
  const float mn = fmaxf(m, m_o);
  l = l * expf(m - mn) + l_o * expf(m_o - mn);
  m = mn;
}

// Online (max, sum of exps) of one row of nvec 16-B vectors, columns at or
// past `limit` masked.  Every thread of the CTA calls it; the row's (m, l)
// lands in thread 0's (mt, lt).  sm[] and sl[] are the CTA's kWarps-entry
// scratch; the caller syncs before reusing them.
template <typename T>
__device__ __forceinline__ void fold_row(const T* __restrict__ row, int64_t nvec, int64_t limit,
                                         float* sm, float* sl, float& mt, float& lt) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float m = kMask, l = 0.f;
  for (int64_t j0 = threadIdx.x; j0 < nvec; j0 += kUnroll * repro::kThreads) {
    float v[kUnroll][N];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = j0 + u * repro::kThreads;
      if (j < nvec) {
        Vec<T>::load(row + j * N, v[u]);
        if ((j + 1) * N > limit) {
#pragma unroll
          for (int e = 0; e < N; ++e)
            if (j * N + e >= limit) v[u][e] = kMask;
        }
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) v[u][e] = kMask;
      }
    }
    float bm = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int e = 0; e < N; ++e) bm = fmaxf(bm, v[u][e]);
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int e = 0; e < N; ++e) s += v[u][e] <= kDead ? 0.f : expf(v[u][e] - bm);
    l = l * expf(m - bm) + s;
    m = bm;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, o);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, o);
    merge(m, l, m_o, l_o);
  }
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mt = sm[0];
    lt = sl[0];
    for (int w = 1; w < kWarps; ++w) merge(mt, lt, sm[w], sl[w]);
  }
}

template <typename T>
__global__ void __launch_bounds__(repro::kThreads)
xent_kernel(const T* __restrict__ logits, const int32_t* __restrict__ labels,
            float* __restrict__ nll, int64_t rows, int64_t width, int64_t brows,
            int64_t logical_v) {
  __shared__ float sm[kWarps], sl[kWarps];
  const int64_t nvec = width / Vec<T>::N;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * brows;
  const int64_t r1 = r0 + brows < rows ? r0 + brows : rows;
  for (int64_t r = r0; r < r1; ++r) {
    const T* row = logits + r * width;
    float mt, lt;
    fold_row(row, nvec, logical_v, sm, sl, mt, lt);
    if (threadIdx.x == 0) {
      const int64_t lab = labels[r];
      float ll = 0.f;
      if (lab >= 0 && lab < width)
        ll = lab < logical_v ? repro::widen(row[lab]) : kMask;
      nll[r] = (logf(fmaxf(lt, 1e-30f)) + mt) - ll;
    }
    __syncthreads();   // sm[] and sl[] are reused by the next row
  }
}

template <typename T>
__global__ void __launch_bounds__(repro::kThreads)
xent_partial_kernel(const T* __restrict__ logits, const int32_t* __restrict__ labels,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ ll_out, int64_t rows, int64_t width, int64_t brows,
                    int64_t vl, int64_t off, int64_t logical_v) {
  __shared__ float sm[kWarps], sl[kWarps];
  const int64_t nvec = width / Vec<T>::N;
  const int64_t limit = vl < logical_v - off ? vl : logical_v - off;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * brows;
  const int64_t r1 = r0 + brows < rows ? r0 + brows : rows;
  for (int64_t r = r0; r < r1; ++r) {
    const T* row = logits + r * width;
    float mt, lt;
    fold_row(row, nvec, limit, sm, sl, mt, lt);
    if (threadIdx.x == 0) {
      const int64_t col = static_cast<int64_t>(labels[r]) - off;
      m_out[r] = mt;
      l_out[r] = lt;
      ll_out[r] = col >= 0 && col < limit ? repro::widen(row[col]) : 0.f;
    }
    __syncthreads();   // sm[] and sl[] are reused by the next row
  }
}

template <typename T>
cudaError_t launch(const void* logits, const void* labels, void* nll, int64_t rows, int64_t width,
                   int64_t brows, int64_t logical_v, cudaStream_t stream) {
  if (width % Vec<T>::N) return cudaErrorInvalidValue;
  if (!repro::aligned16(logits)) return cudaErrorInvalidValue;
  const int64_t grid = (rows + brows - 1) / brows;
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  xent_kernel<T><<<static_cast<unsigned>(grid), repro::kThreads, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<const int32_t*>(labels),
      static_cast<float*>(nll), rows, width, brows, logical_v);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_partial(const void* logits, const void* labels, void* m, void* l, void* ll,
                           int64_t rows, int64_t width, int64_t brows, int64_t vl, int64_t off,
                           int64_t logical_v, cudaStream_t stream) {
  if (width % Vec<T>::N) return cudaErrorInvalidValue;
  if (!repro::aligned16(logits)) return cudaErrorInvalidValue;
  const int64_t grid = (rows + brows - 1) / brows;
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  xent_partial_kernel<T><<<static_cast<unsigned>(grid), repro::kThreads, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<const int32_t*>(labels),
      static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(ll), rows, width,
      brows, vl, off, logical_v);
  return cudaSuccess;
}

}  // namespace

// nll[r] = logsumexp(x[r, :logical_v]) - x[r, labels[r]] for contiguous
// (rows, width) logits of `dtype` (fp32 or bf16), int32 labels and fp32 nll
// of `rows` each; a CTA walks `brows` rows.  `logits` 16-B aligned, `width`
// a whole number of 16-B vectors, 0 < logical_v <= width.  Runs on CUDA
// device `device`, on `stream`.  Returns cudaGetLastError() after the
// launch.
extern "C" int xent_launch(int device, int dtype, const void* logits, const void* labels,
                           void* nll, int64_t rows, int64_t width, int64_t brows,
                           int64_t logical_v, void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (width <= 0 || brows <= 0 || logical_v <= 0 || logical_v > width)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    err = launch<float>(logits, labels, nll, rows, width, brows, logical_v, st);
  else if (dtype == repro::kBFloat16)
    err = launch<__nv_bfloat16>(logits, labels, nll, rows, width, brows, logical_v, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}

// (m, l, ll)[r]: the online-softmax partials of row r of one vocab shard,
// contiguous (rows, width) logits of `dtype` (fp32 or bf16) whose local
// column c is global column c + off; columns c >= vl or c + off >=
// logical_v are masked; int32 global labels; fp32 m, l and ll of `rows`
// each; a CTA walks `brows` rows.  `logits` 16-B aligned, `width` a whole
// number of 16-B vectors, 0 < vl <= width, off >= 0, logical_v > 0.  Runs
// on CUDA device `device`, on `stream`.  Returns cudaGetLastError() after
// the launch.
extern "C" int xent_partial_launch(int device, int dtype, const void* logits,
                                   const void* labels, void* m, void* l, void* ll, int64_t rows,
                                   int64_t width, int64_t brows, int64_t vl, int64_t off,
                                   int64_t logical_v, void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (width <= 0 || brows <= 0 || vl <= 0 || vl > width || off < 0 || logical_v <= 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    err = launch_partial<float>(logits, labels, m, l, ll, rows, width, brows, vl, off,
                                logical_v, st);
  else if (dtype == repro::kBFloat16)
    err = launch_partial<__nv_bfloat16>(logits, labels, m, l, ll, rows, width, brows, vl, off,
                                        logical_v, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}
