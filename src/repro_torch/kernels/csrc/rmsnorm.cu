// RMSNorm, plain and gated, on Hopper.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/rmsnorm/kernel.py: _plain_kernel (:29) and
//     _gated_kernel (:34), both launched by _call (:44)
//
// Computes, for every row r of a (rows, width) tensor whose first d_logical
// columns are data and the rest padding:
//   plain: y = x * rsqrt(ms + eps) * scale,  ms = sum(x^2 over the logical
//          columns) / d_logical, all in fp32, y rounded once to x's dtype;
//   gated: the same on g = x * silu(z), computed in fp32 and rounded to x's
//          dtype before the statistics (kernel.py:37-41).
//
// Bound on this card: bytes.  A row is read once (twice with z) and written
// once; the scale vector is read by every row but is one row's worth and
// stays in L1/L2.  About 4 operations an element, far below the card's
// balance point.
//
// Design against that bound: a CTA owns whole rows -- the plan's block of
// rows, walked one after the other -- and its threads step through a row
// with 16-B vector loads, so a warp moves whole 128-B lines.  The thread
// count is sized from the width so that each thread holds at most kRegVecs
// vectors of the row in registers between the two passes (the statistics,
// then the scaling); a row too wide for that is read again in the second
// pass.  A narrow row gets a CTA of one warp.  The sum of squares
// accumulates in fp32 over the logical columns only (padding is masked by
// column index, as _rms does at kernel.py:21-26), is reduced with warp
// shuffles and then across warps through shared memory.  The reduction order
// differs from the plain version's, so the two agree to a tolerance, not bit
// for bit.

#include "common.cuh"

namespace {

using repro::Vec;

constexpr int kMaxThreads = 512;   // threads of the widest CTA
constexpr int kRegVecs = 4;        // 16-B vectors a thread holds in registers

__device__ __forceinline__ float silu(float z) { return z * (1.f / (1.f + expf(-z))); }

// One 16-B vector of the row at element `off`, widened to fp32; for the
// gated form x * silu(z), rounded to T and widened again.
template <typename T, bool GATED>
__device__ __forceinline__ void load_vec(const T* __restrict__ x, const T* __restrict__ z,
                                         int64_t off, float (&v)[Vec<T>::N]) {
  Vec<T>::load(x + off, v);
  if (GATED) {
    float zz[Vec<T>::N];
    Vec<T>::load(z + off, zz);
#pragma unroll
    for (int e = 0; e < Vec<T>::N; ++e)
      v[e] = repro::widen(repro::narrow<T>(v[e] * silu(zz[e])));
  }
}

// Padding columns (index >= d_logical) read as 0.
template <typename T>
__device__ __forceinline__ void mask_vec(int64_t j, int64_t d_logical, float (&v)[Vec<T>::N]) {
  constexpr int N = Vec<T>::N;
  if ((j + 1) * N <= d_logical) return;
#pragma unroll
  for (int e = 0; e < N; ++e)
    if (j * N + e >= d_logical) v[e] = 0.f;
}

// N scale values from p, widened to fp32, in 16-B vectors of S.
template <typename S, int N>
__device__ __forceinline__ void load_scale(const S* __restrict__ p, float (&s)[N]) {
  constexpr int M = Vec<S>::N;
  static_assert(N % M == 0, "a row vector must hold whole scale vectors");
#pragma unroll
  for (int e = 0; e < N; e += M) {
    float t[M];
    Vec<S>::load(p + e, t);
#pragma unroll
    for (int k = 0; k < M; ++k) s[e + k] = t[k];
  }
}

template <typename T, typename S>
__device__ __forceinline__ void store_vec(T* __restrict__ out, const S* __restrict__ scale,
                                          int64_t base, int64_t j, float inv,
                                          const float (&v)[Vec<T>::N]) {
  constexpr int N = Vec<T>::N;
  float s[N], y[N];
  load_scale<S, N>(scale + j * N, s);
#pragma unroll
  for (int e = 0; e < N; ++e) y[e] = (v[e] * inv) * s[e];
  Vec<T>::store(out + base + j * N, y);
}

template <typename T, typename S, bool GATED>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ z,
               const S* __restrict__ scale, T* __restrict__ out, int64_t rows,
               int64_t width, int64_t brows, int64_t d_logical, float eps) {
  constexpr int N = Vec<T>::N;
  __shared__ float partial[kMaxThreads / 32];
  __shared__ float total;
  const int64_t nvec = width / N;
  const int64_t step = blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * brows;
  const int64_t r1 = r0 + brows < rows ? r0 + brows : rows;
  for (int64_t r = r0; r < r1; ++r) {
    const int64_t base = r * width;
    float held[kRegVecs][N];
    float ss = 0.f;
    // pass 1: the statistics; the first kRegVecs vectors stay in registers
#pragma unroll
    for (int k = 0; k < kRegVecs; ++k) {
      const int64_t j = threadIdx.x + k * step;
      if (j < nvec) {
        load_vec<T, GATED>(x, z, base + j * N, held[k]);
        mask_vec<T>(j, d_logical, held[k]);
#pragma unroll
        for (int e = 0; e < N; ++e) ss += held[k][e] * held[k][e];
      }
    }
    for (int64_t j = threadIdx.x + kRegVecs * step; j < nvec; j += step) {
      float v[N];
      load_vec<T, GATED>(x, z, base + j * N, v);
      mask_vec<T>(j, d_logical, v);
#pragma unroll
      for (int e = 0; e < N; ++e) ss += v[e] * v[e];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) partial[warp] = ss;
    __syncthreads();
    if (warp == 0) {
      float t = lane < nwarps ? partial[lane] : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
      if (lane == 0) total = t;
    }
    __syncthreads();
    const float inv = rsqrtf(total / static_cast<float>(d_logical) + eps);
    // pass 2: scale and store; vectors past the registers are read again
#pragma unroll
    for (int k = 0; k < kRegVecs; ++k) {
      const int64_t j = threadIdx.x + k * step;
      if (j < nvec) store_vec<T, S>(out, scale, base, j, inv, held[k]);
    }
    for (int64_t j = threadIdx.x + kRegVecs * step; j < nvec; j += step) {
      float v[N];
      load_vec<T, GATED>(x, z, base + j * N, v);
      mask_vec<T>(j, d_logical, v);
      store_vec<T, S>(out, scale, base, j, inv, v);
    }
    __syncthreads();   // partial[] and total are reused by the next row
  }
}

template <typename T, typename S, bool GATED>
cudaError_t launch(const void* x, const void* z, const void* scale, void* out, int64_t rows,
                   int64_t width, int64_t brows, int64_t d_logical, float eps,
                   cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  if (width % N) return cudaErrorInvalidValue;
  if (!repro::aligned16(x) || !repro::aligned16(out) || !repro::aligned16(scale) ||
      (GATED && !repro::aligned16(z)))
    return cudaErrorInvalidValue;
  const int64_t nvec = width / N;
  // threads: enough warps that each holds at most kRegVecs vectors of a row
  int64_t threads = (nvec + kRegVecs - 1) / kRegVecs;
  threads = (threads + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const int64_t grid = (rows + brows - 1) / brows;
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  rmsnorm_kernel<T, S, GATED><<<static_cast<unsigned>(grid), static_cast<unsigned>(threads), 0,
                                stream>>>(static_cast<const T*>(x), static_cast<const T*>(z),
                                          static_cast<const S*>(scale), static_cast<T*>(out),
                                          rows, width, brows, d_logical, eps);
  return cudaSuccess;
}

template <typename T, typename S>
cudaError_t launch_gate(int gated, const void* x, const void* z, const void* scale, void* out,
                        int64_t rows, int64_t width, int64_t brows, int64_t d_logical,
                        float eps, cudaStream_t stream) {
  if (gated)
    return launch<T, S, true>(x, z, scale, out, rows, width, brows, d_logical, eps, stream);
  return launch<T, S, false>(x, z, scale, out, rows, width, brows, d_logical, eps, stream);
}

}  // namespace

// out = rmsnorm(x) (gated = 0) or rmsnorm(x * silu(z)) (gated = 1) over the
// first d_logical of `width` columns of contiguous (rows, width) tensors of
// `dtype`; `scale` is `width` values of `scale_dtype` (x's dtype, or fp32);
// a CTA walks `brows` rows.  Every pointer 16-B aligned, `width` a whole
// number of 16-B vectors.  Runs on CUDA device `device`, on `stream`.
// Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_launch(int device, int dtype, int scale_dtype, int gated, const void* x,
                              const void* z, const void* scale, void* out, int64_t rows,
                              int64_t width, int64_t brows, int64_t d_logical, float eps,
                              void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (width <= 0 || brows <= 0 || d_logical <= 0 || d_logical > width)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == repro::kFloat32 && scale_dtype == repro::kFloat32)
    err = launch_gate<float, float>(gated, x, z, scale, out, rows, width, brows, d_logical, eps,
                                    st);
  else if (dtype == repro::kBFloat16 && scale_dtype == repro::kBFloat16)
    err = launch_gate<bf16, bf16>(gated, x, z, scale, out, rows, width, brows, d_logical, eps,
                                  st);
  else if (dtype == repro::kBFloat16 && scale_dtype == repro::kFloat32)
    err = launch_gate<bf16, float>(gated, x, z, scale, out, rows, width, brows, d_logical, eps,
                                   st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}
