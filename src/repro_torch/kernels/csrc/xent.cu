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
// element, 2 B a bf16 one) against about ten operations an element (a
// max, a subtract, an exp, an add and the vector bookkeeping), far below
// the card's balance point; the labels and the outputs are one word a row.
//
// Design against that bound: a thread loads one 16-B vector of the row a
// batch (float4 for fp32, 8 x bf16), so a warp moves whole 128-B lines,
// and keeps its own running (max, sum of exps) in registers, rescaling its
// sum once a batch to the batch's new max.  The loads in flight come from
// occupancy, not from depth per thread: at one vector a thread a batch the
// kernel needs 32 registers a thread and eight CTAs share an SM, where
// four vectors a thread took 48-72 and left three or four, and ran slower
// at every shape timed on the H100 (PERF.md §6).  At the end of a row the
// CTA merges the threads' (m, l) pairs with warp shuffles, then warp 0
// merges the warps' pairs from shared memory the same way, each pair
// rescaled to the larger max.  The thread that writes a row's outputs
// loads the label's logit when the row starts, so that load's latency
// hides behind the row's own loads.
//
// The exp of an element is __expf (ex2.approx of d log2 e), which the CUDA
// Math API bounds by 2 + floor(1.173 |d|) ulp for d = x - max <= 0.  A
// term's share of l is p = exp(d) / l, so the relative error of l is at
// most sum(p (2 + 1.173 |d|)) ulp = (2 + 1.173 (H - log l)) ulp, H the
// entropy of the row's softmax, at most log(width): 16 ulp, under 2e-6,
// at 151,936 columns, whatever the logits' spread, so lse moves by under
// 2e-6 (the plain version's tolerance is 1e-5).  The rescales between
// batches and in the merges keep the exact expf.
//
// The ragged row.  A row starts at element r * width, so at a width that
// is no whole number of 16-B vectors (whisper-tiny's 51,865 fp32 columns,
// minicpm-2b's 122,753) most rows start off a 16-B boundary: at 51,865
// fp32, 4 B aligned in three rows of four.  Each row is read in place as
// three parts: the head, the elements before its first 16-B aligned
// address (at most 3 fp32 or 7 bf16); the body, whole aligned 16-B vectors
// loaded as above; and the tail, under one vector.  Head and tail are
// scalar loads, one element to a thread (threads 0.. take the head, the
// last threads of the CTA the tail), folded into that thread's running
// (m, l) before the body's batches.  The column mask is taken on the
// column index, so a limit inside the head or the tail masks correctly.
// No load touches memory outside the tensor: the aligned vector that
// straddles a row's end is never loaded, and the logits pointer need only
// be aligned to its element size, so a view at any storage offset is read
// in place too.  TMA does not serve here: a tensor map needs 16-B row
// strides and a 1-D bulk copy 16-B aligned addresses and sizes, which an
// odd-width row has neither of.

#include "common.cuh"

namespace {

using repro::Vec;

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

// Online (max, sum of exps) of one row of `width` elements, columns at or
// past `limit` masked.  Every thread of the CTA calls it; the row's (m, l)
// lands in thread 0's (mt, lt).  sm[] and sl[] are kWarps-entry scratch
// that no other thread reads or writes until every thread has passed this
// call's barrier again (the callers alternate two of them by row).
template <typename T>
__device__ __forceinline__ void fold_row(const T* __restrict__ row, int64_t width, int64_t limit,
                                         float* sm, float* sl, float& mt, float& lt) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // head: the elements before the row's first 16-B aligned address
  const int64_t mis = static_cast<int64_t>(reinterpret_cast<uintptr_t>(row) & 15u) / sizeof(T);
  const int64_t head = mis == 0 ? 0 : (N - mis < width ? N - mis : width);
  const int64_t nvec = (width - head) / N;
  const int64_t tail = width - head - nvec * N;
  const T* body = row + head;
  float m = kMask, l = 0.f;
  {
    int64_t c = -1;
    if (threadIdx.x < head)
      c = threadIdx.x;
    else if (threadIdx.x >= repro::kThreads - tail)
      c = width - (repro::kThreads - threadIdx.x);
    if (c >= 0) {
      m = c < limit ? repro::widen(row[c]) : kMask;
      l = m <= kDead ? 0.f : 1.f;
    }
  }
  for (int64_t j = threadIdx.x; j < nvec; j += repro::kThreads) {
    float v[N];
    Vec<T>::load(body + j * N, v);
    const int64_t c0 = head + j * N;
    if (c0 + N > limit) {
#pragma unroll
      for (int e = 0; e < N; ++e)
        if (c0 + e >= limit) v[e] = kMask;
    }
    float bm = m;
#pragma unroll
    for (int e = 0; e < N; ++e) bm = fmaxf(bm, v[e]);
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < N; ++e) s += v[e] <= kDead ? 0.f : __expf(v[e] - bm);
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
  if (warp == 0) {
    m = lane < kWarps ? sm[lane] : kMask;
    l = lane < kWarps ? sl[lane] : 0.f;
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m, o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l, o);
      merge(m, l, m_o, l_o);
    }
    mt = m;
    lt = l;
  }
}

template <typename T>
__global__ void __launch_bounds__(repro::kThreads)
xent_kernel(const T* __restrict__ logits, const int32_t* __restrict__ labels,
            float* __restrict__ nll, int64_t rows, int64_t width, int64_t brows,
            int64_t logical_v) {
  __shared__ float sm[2][kWarps], sl[2][kWarps];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * brows;
  const int64_t r1 = r0 + brows < rows ? r0 + brows : rows;
  for (int64_t r = r0; r < r1; ++r) {
    const T* row = logits + r * width;
    float ll = 0.f;
    if (threadIdx.x == 0) {
      const int64_t lab = labels[r];
      if (lab >= 0 && lab < width)
        ll = lab < logical_v ? repro::widen(row[lab]) : kMask;
    }
    const int buf = (r - r0) & 1;
    float mt = kMask, lt = 0.f;
    fold_row(row, width, logical_v, sm[buf], sl[buf], mt, lt);
    if (threadIdx.x == 0) nll[r] = (logf(fmaxf(lt, 1e-30f)) + mt) - ll;
  }
}

template <typename T>
__global__ void __launch_bounds__(repro::kThreads)
xent_partial_kernel(const T* __restrict__ logits, const int32_t* __restrict__ labels,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ ll_out, int64_t rows, int64_t width, int64_t brows,
                    int64_t vl, int64_t off, int64_t logical_v) {
  __shared__ float sm[2][kWarps], sl[2][kWarps];
  const int64_t limit = vl < logical_v - off ? vl : logical_v - off;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * brows;
  const int64_t r1 = r0 + brows < rows ? r0 + brows : rows;
  for (int64_t r = r0; r < r1; ++r) {
    const T* row = logits + r * width;
    float ll = 0.f;
    if (threadIdx.x == 0) {
      const int64_t col = static_cast<int64_t>(labels[r]) - off;
      if (col >= 0 && col < limit) ll = repro::widen(row[col]);
    }
    const int buf = (r - r0) & 1;
    float mt = kMask, lt = 0.f;
    fold_row(row, width, limit, sm[buf], sl[buf], mt, lt);
    if (threadIdx.x == 0) {
      m_out[r] = mt;
      l_out[r] = lt;
      ll_out[r] = ll;
    }
  }
}

template <typename T>
bool element_aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % sizeof(T) == 0;
}

template <typename T>
cudaError_t launch(const void* logits, const void* labels, void* nll, int64_t rows, int64_t width,
                   int64_t brows, int64_t logical_v, cudaStream_t stream) {
  if (!element_aligned<T>(logits)) return cudaErrorInvalidValue;
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
  if (!element_aligned<T>(logits)) return cudaErrorInvalidValue;
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
// (rows, width) logits of `dtype` (fp32 or bf16) of any width, int32 labels
// and fp32 nll of `rows` each; a CTA walks `brows` rows.  `logits` aligned
// to its element size (any storage offset), 0 < logical_v <= width.  Runs
// on CUDA device `device`, on `stream`.  Returns cudaGetLastError() after
// the launch.
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
// contiguous (rows, width) logits of `dtype` (fp32 or bf16) of any width
// whose local column c is global column c + off; columns c >= vl or c +
// off >= logical_v are masked; int32 global labels; fp32 m, l and ll of
// `rows` each; a CTA walks `brows` rows.  `logits` aligned to its element
// size (any storage offset), 0 < vl <= width, off >= 0, logical_v > 0.
// Runs on CUDA device `device`, on `stream`.  Returns cudaGetLastError()
// after the launch.
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
