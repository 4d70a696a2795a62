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
// once; the scale vector is one row's worth for the whole launch.  About 4
// operations an element (9 with the gate), far below the card's balance
// point.  At a decode shape (8 rows) nothing of that matters: the launch and
// one memory round trip are the whole kernel.
//
// Design against that bound: one CTA per block of the plan's `brows` rows,
// its rows one after the other, with as many CTAs resident as an SM holds.
//   * A row's geometry depends on its width alone: up to 1024 16-B vectors
//     a row, one thread a vector (320 threads at 2560 bf16), so a row is
//     one load a thread and one trip to memory; wider rows get 512 threads
//     that hold 4 vectors each in registers and read the rest again for the
//     scaling.
//   * Each thread loads its scale vector with its first row's vector and
//     keeps it in registers for the block, so the first row costs one round
//     trip, not two (at the decode shape that round trip and the launch are
//     the kernel).
//   * Registers are capped at 32 a thread (two 1024-thread CTAs an SM), so
//     six 320-thread CTAs fit an SM and their loads overlap one another's
//     reductions (bf16 rows with an fp32 scale keep more, as they would
//     spill).
//   * Each thread sums its squares in a fixed order, a warp reduces by
//     shuffles, and every thread adds the warps' partials in warp order
//     after the row's one barrier (the partials are double-buffered, so the
//     next row needs no second barrier).  No atomics: a row's bits depend
//     on its data and width only, not on the row count or on the CTA that
//     takes it (paged = dense serving and the bit-exact training replays
//     rest on this).
//   * The gate in fast fp32: silu(z) = __fdividef(z, 1 + __expf(-z)), two
//     special-function operations an element.  Its few-ulp error is hidden
//     by the rounding of g to x's dtype at bf16 and is far inside rtol 1e-5
//     at fp32.
// Measured on an H100 (PERF.md): persistent CTAs, sized from occupancy,
// that stream their rows through a 2- or 4-stage ring of bulk asynchronous
// copies in shared memory take 8-23 % longer than this design at the main
// path's shapes (scripts/kernel_designs.py keeps them and times them).
// The sum of squares accumulates in fp32 over the logical columns only
// (padding masked by column index, as _rms does at kernel.py:21-26).  The
// reduction order differs from the plain version's, so the two agree to a
// tolerance, not bit for bit.
//
// Split mode, for a row whose columns are cut over the ranks of a mesh
// (tensor parallelism of the Mamba2 and mLSTM d_inner, the sLSTM's d): the
// same kernel in two passes, selected by the MODE template parameter, the
// one-pass form (MODE 0) compiled as before.
//   * stats (MODE 1): each row's fp32 sum of squares over the rank's
//     logical columns -- the one-pass `total`, in the same order, the gate
//     rounded to T before the square -- written to ss[row]; no output;
//   * apply (MODE 2): y = x * rsqrt(ss[row] / d_total + eps) * scale over
//     the rank's columns, ss[row] the ranks' sums summed by the caller and
//     d_total the whole row's width; no reduction and no barrier.
// Each pass reads the row once more (the apply pass reads x and z again):
// on a rank's (2048, 2048) bf16 half of a zamba2 row that is 3 reads and a
// write of the rank's bytes over the two passes, against the one-pass
// form's 2 reads and a write.

#include "common.cuh"

namespace {

using repro::Vec;

constexpr int kMaxThreads = 1024;   // one vector a thread up to this many
constexpr int kWideThreads = 512;   // threads of a wider row
constexpr int kWideVecs = 4;        // vectors a thread of a wider row holds

__device__ __forceinline__ float silu(float z) { return __fdividef(z, 1.f + __expf(-z)); }

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

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* __restrict__ out, float inv, const float (&s)[N],
                                          const float (&v)[N]) {
  float y[N];
#pragma unroll
  for (int e = 0; e < N; ++e) y[e] = (v[e] * inv) * s[e];
  Vec<T>::store(out, y);
}

template <int N>
__device__ __forceinline__ float sum_squares(const float (&v)[N], float ss) {
#pragma unroll
  for (int e = 0; e < N; ++e) ss += v[e] * v[e];
  return ss;
}

// V vectors of a row a thread holds in registers (the rest of a wider row
// is read again for the scaling); MAXT the most threads a CTA, MINB the
// CTAs an SM must hold (which caps the registers a thread).
// MODE 0 the one-pass norm, 1 the stats pass, 2 the apply pass.
template <typename T, typename S, bool GATED, int MODE, int V, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ z,
               const S* __restrict__ scale, float* __restrict__ ssum, T* __restrict__ out,
               int64_t rows, int64_t width, int64_t brows, int64_t d_logical,
               int64_t d_total, float eps) {
  constexpr int N = Vec<T>::N;
  __shared__ float partial[2][MAXT / 32];
  const int64_t nvec = width / N;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * brows;
  const int64_t r1 = r0 + brows < rows ? r0 + brows : rows;

  // one vector a thread: its scale vector, loaded with the first row
  float sc[N];
  if (MODE != 1 && V == 1 && tid < nvec) load_scale<S, N>(scale + tid * N, sc);

  int buf = 0;
  for (int64_t r = r0; r < r1; ++r, buf ^= 1) {
    const T* xr = x + r * width;
    const T* zr = GATED ? z + r * width : nullptr;
    float held[V][N];
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int64_t j = tid + static_cast<int64_t>(k) * nthreads;
      if (j < nvec) {
        load_vec<T, GATED>(xr, zr, j * N, held[k]);
        mask_vec<T>(j, d_logical, held[k]);
        if (MODE != 2) ss = sum_squares<N>(held[k], ss);
      }
    }
    if (V > 1 && MODE != 2) {
      for (int64_t j = tid + static_cast<int64_t>(V) * nthreads; j < nvec; j += nthreads) {
        float v[N];
        load_vec<T, GATED>(xr, zr, j * N, v);
        mask_vec<T>(j, d_logical, v);
        ss = sum_squares<N>(v, ss);
      }
    }
    float inv;
    if constexpr (MODE == 2) {
      // the ranks' summed statistic over the whole row's width
      inv = rsqrtf(ssum[r] / static_cast<float>(d_total) + eps);
    } else {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      if (lane == 0) partial[buf][warp] = ss;
      __syncthreads();   // the row's one barrier
      float total = 0.f;
      for (int w = 0; w < nwarps; ++w) total += partial[buf][w];
      if constexpr (MODE == 1) {
        if (tid == 0) ssum[r] = total;
        continue;
      }
      inv = rsqrtf(total / static_cast<float>(d_logical) + eps);
    }
    T* orow = out + r * width;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int64_t j = tid + static_cast<int64_t>(k) * nthreads;
      if (j < nvec) {
        float t[N];
        if (V == 1) {
#pragma unroll
          for (int e = 0; e < N; ++e) t[e] = sc[e];
        } else {
          load_scale<S, N>(scale + j * N, t);
        }
        store_vec<T, N>(orow + j * N, inv, t, held[k]);
      }
    }
    if (V > 1) {
      for (int64_t j = tid + static_cast<int64_t>(V) * nthreads; j < nvec; j += nthreads) {
        float v[N], t[N];
        load_vec<T, GATED>(xr, zr, j * N, v);
        mask_vec<T>(j, d_logical, v);
        load_scale<S, N>(scale + j * N, t);
        store_vec<T, N>(orow + j * N, inv, t, v);
      }
    }
  }
}

template <typename T, typename S, bool GATED, int MODE>
cudaError_t launch(const void* x, const void* z, const void* scale, float* ss, void* out,
                   int64_t rows, int64_t width, int64_t brows, int64_t d_logical,
                   int64_t d_total, float eps, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  if (width % N) return cudaErrorInvalidValue;
  if (!repro::aligned16(x) || (GATED && !repro::aligned16(z))) return cudaErrorInvalidValue;
  if (MODE != 1 && (!repro::aligned16(out) || !repro::aligned16(scale)))
    return cudaErrorInvalidValue;
  if (MODE != 0 && ss == nullptr) return cudaErrorInvalidValue;
  const int64_t nvec = width / N;
  const int64_t grid = (rows + brows - 1) / brows;
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const T* px = static_cast<const T*>(x);
  const T* pz = static_cast<const T*>(z);
  const S* ps = static_cast<const S*>(scale);
  T* po = static_cast<T*>(out);
  if (nvec > kMaxThreads) {
    rmsnorm_kernel<T, S, GATED, MODE, kWideVecs, kWideThreads, 1>
        <<<static_cast<unsigned>(grid), kWideThreads, 0, stream>>>(
            px, pz, ps, ss, po, rows, width, brows, d_logical, d_total, eps);
  } else {
    // two CTAs of 1024 threads an SM: 32 registers a thread, unless an fp32
    // scale beside bf16 rows needs more to hold (it would spill)
    constexpr int MINB = sizeof(S) > sizeof(T) ? 1 : 2;
    const int threads = static_cast<int>((nvec + 31) / 32 * 32);
    rmsnorm_kernel<T, S, GATED, MODE, 1, kMaxThreads, MINB>
        <<<static_cast<unsigned>(grid), static_cast<unsigned>(threads), 0, stream>>>(
            px, pz, ps, ss, po, rows, width, brows, d_logical, d_total, eps);
  }
  return cudaSuccess;
}

template <typename T, typename S>
cudaError_t launch_mode(int gated, int mode, const void* x, const void* z, const void* scale,
                        float* ss, void* out, int64_t rows, int64_t width, int64_t brows,
                        int64_t d_logical, int64_t d_total, float eps, cudaStream_t stream) {
#define REPRO_RMSNORM_LAUNCH(G, M)                                                        \
  return launch<T, S, G, M>(x, z, scale, ss, out, rows, width, brows, d_logical, d_total, \
                            eps, stream)
  if (gated) {
    if (mode == 0) REPRO_RMSNORM_LAUNCH(true, 0);
    if (mode == 1) REPRO_RMSNORM_LAUNCH(true, 1);
    if (mode == 2) REPRO_RMSNORM_LAUNCH(true, 2);
  } else {
    if (mode == 0) REPRO_RMSNORM_LAUNCH(false, 0);
    if (mode == 1) REPRO_RMSNORM_LAUNCH(false, 1);
    if (mode == 2) REPRO_RMSNORM_LAUNCH(false, 2);
  }
#undef REPRO_RMSNORM_LAUNCH
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(int device, int dtype, int scale_dtype, int gated, int mode, const void* x,
                     const void* z, const void* scale, float* ss, void* out, int64_t rows,
                     int64_t width, int64_t brows, int64_t d_logical, int64_t d_total,
                     float eps, void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (width <= 0 || brows <= 0 || d_logical <= 0 || d_logical > width || d_total <= 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == repro::kFloat32 && scale_dtype == repro::kFloat32)
    err = launch_mode<float, float>(gated, mode, x, z, scale, ss, out, rows, width, brows,
                                    d_logical, d_total, eps, st);
  else if (dtype == repro::kBFloat16 && scale_dtype == repro::kBFloat16)
    err = launch_mode<bf16, bf16>(gated, mode, x, z, scale, ss, out, rows, width, brows,
                                  d_logical, d_total, eps, st);
  else if (dtype == repro::kBFloat16 && scale_dtype == repro::kFloat32)
    err = launch_mode<bf16, float>(gated, mode, x, z, scale, ss, out, rows, width, brows,
                                   d_logical, d_total, eps, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// out = rmsnorm(x) (gated = 0) or rmsnorm(x * silu(z)) (gated = 1) over the
// first d_logical of `width` columns of contiguous (rows, width) tensors of
// `dtype`; `scale` is `width` values of `scale_dtype` (x's dtype, or fp32);
// a CTA takes a block of `brows` rows.  Every pointer 16-B aligned, `width`
// a whole number of 16-B vectors.  Runs on CUDA device `device`, on
// `stream`.  Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_launch(int device, int dtype, int scale_dtype, int gated, const void* x,
                              const void* z, const void* scale, void* out, int64_t rows,
                              int64_t width, int64_t brows, int64_t d_logical, float eps,
                              void* stream) {
  return static_cast<int>(dispatch(device, dtype, scale_dtype, gated, 0, x, z, scale, nullptr,
                                   out, rows, width, brows, d_logical, d_logical, eps, stream));
}

// The split norm's passes on a rank's (rows, width) block of a row cut over
// the ranks, arguments as rmsnorm_launch's.  mode 1, stats: ss[row] = the
// fp32 sum of squares of the row's first d_logical columns (of x * silu(z)
// rounded to `dtype` when gated); `scale` and `out` are not read (may be
// null).  mode 2, apply: out = x (or x * silu(z)) * rsqrt(ss[row] / d_total
// + eps) * scale, ss the summed statistic of the whole row of d_total
// columns.  `ss` is `rows` fp32 values.
extern "C" int rmsnorm_split_launch(int device, int dtype, int scale_dtype, int gated, int mode,
                                    const void* x, const void* z, const void* scale, float* ss,
                                    void* out, int64_t rows, int64_t width, int64_t brows,
                                    int64_t d_logical, int64_t d_total, float eps,
                                    void* stream) {
  if (mode != 1 && mode != 2) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(device, dtype, scale_dtype, gated, mode, x, z, scale, ss,
                                   out, rows, width, brows, d_logical, d_total, eps, stream));
}
