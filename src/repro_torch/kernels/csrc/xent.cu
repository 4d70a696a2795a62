// Per-token cross-entropy (negative log-likelihood) by online softmax, on
// Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/xent/kernel.py: _xent_kernel (:25), launched by
//     xent_tiled (:144)
//
// Computes, for every row r of contiguous (rows, width) logits whose first
// logical_v columns are the vocabulary and the rest padding:
//   x    = logits[r, :] widened to fp32, then columns >= logical_v set to
//          -1e30 (cast before the mask, kernel.py:35-37);
//   m    = max(x);  l = sum(x <= -1e29 ? 0 : exp(x - m))  (kernel.py:39-41);
//   lse  = log(max(l, 1e-30)) + m                          (kernel.py:50);
//   ll   = x[label] if 0 <= label < width, else 0: the masked sum of x over
//          the columns equal to the label (kernel.py:44-46), so a label in
//          the padding gives -1e30 and one past the row gives 0;
//   nll  = lse - ll.
// The TPU kernel carries (m, l, ll) in VMEM scratch from one vocab tile to
// the next along a sequential grid axis.  Here one CTA owns whole rows and
// folds each one in a loop of passes over its columns; nothing carries
// between CTAs, and no atomics are used, so the result is deterministic.
//
// Bound on this card: bytes.  The logits are read once (4 B an fp32
// element) against about ten operations an element (a max, a subtract, an
// exp, an add and the vector bookkeeping), far below the card's balance
// point; the labels and the NLL are one word a row.
//
// Design against that bound: each thread loads kUnroll 16-B vectors of the
// row (float4 for fp32, 8 x bf16) before it folds any, so a CTA keeps
// kUnroll x 4 KB of loads in flight and a warp moves whole 128-B lines.  A
// thread keeps its own running (max, sum of exps) in registers, rescaling
// its sum once a batch of vectors to the batch's new max.  At the end of a
// row the CTA merges the threads' (m, l) pairs with warp shuffles, then
// across warps through shared memory, each pair rescaled to the larger max.
// One thread reads the label's logit once and writes the row's NLL.

#include "common.cuh"

namespace {

using repro::Vec;

constexpr int kUnroll = 4;            // 16-B vectors a thread loads per batch
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

template <typename T>
__global__ void __launch_bounds__(repro::kThreads)
xent_kernel(const T* __restrict__ logits, const int32_t* __restrict__ labels,
            float* __restrict__ nll, int64_t rows, int64_t width, int64_t brows,
            int64_t logical_v) {
  constexpr int N = Vec<T>::N;
  constexpr int kWarps = repro::kThreads / 32;
  __shared__ float sm[kWarps], sl[kWarps];
  const int64_t nvec = width / N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * brows;
  const int64_t r1 = r0 + brows < rows ? r0 + brows : rows;
  for (int64_t r = r0; r < r1; ++r) {
    const T* row = logits + r * width;
    float m = kMask, l = 0.f;
    for (int64_t j0 = threadIdx.x; j0 < nvec; j0 += kUnroll * repro::kThreads) {
      float v[kUnroll][N];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = j0 + u * repro::kThreads;
        if (j < nvec) {
          Vec<T>::load(row + j * N, v[u]);
          if ((j + 1) * N > logical_v) {
#pragma unroll
            for (int e = 0; e < N; ++e)
              if (j * N + e >= logical_v) v[u][e] = kMask;
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
      float mt = sm[0], lt = sl[0];
      for (int w = 1; w < kWarps; ++w) merge(mt, lt, sm[w], sl[w]);
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
