// The Jacobi sweep as the port first mapped it: an
// alternative design that scripts/jacobi_designs.py times beside the shipped
// src/repro_torch/kernels/csrc/jacobi.cu.
//
// One CTA walks `brows` full-width interior rows top to bottom; its 256
// threads loop over a row's columns one element at a time, with four 4-B
// scalar loads a point (above, below, left, right) and a scalar store; the
// first CTA also copies the two boundary rows.  At the plan's one row a CTA
// each input row is read by three CTAs, and a 3-row slab is one CTA.
// Arithmetic as the shipped kernel: bit for bit.

#include "common.cuh"

namespace {

using repro::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
jacobi_kernel(const T* __restrict__ src, T* __restrict__ dst, int64_t n_rows,
              int64_t width, int64_t n_cols, int64_t pitch, int64_t brows) {
  const int64_t r0 = 1 + static_cast<int64_t>(blockIdx.x) * brows;
  const int64_t r1 = r0 + brows < n_rows - 1 ? r0 + brows : n_rows - 1;
  for (int64_t r = r0; r < r1; ++r) {
    const T* above = src + (r - 1) * pitch;
    const T* row = src + r * pitch;
    const T* below = src + (r + 1) * pitch;
    T* out = dst + r * pitch;
    for (int64_t j = threadIdx.x; j < width; j += blockDim.x) {
      if (j >= 1 && j <= n_cols - 2) {
        float v = __fadd_rn(repro::widen(above[j]), repro::widen(below[j]));
        v = __fadd_rn(v, repro::widen(row[j - 1]));
        v = __fadd_rn(v, repro::widen(row[j + 1]));
        out[j] = repro::narrow<T>(__fmul_rn(v, 0.25f));
      } else {
        out[j] = row[j];
      }
    }
  }
  // The first CTA also copies the two boundary rows.
  if (blockIdx.x == 0) {
    const int64_t last = (n_rows - 1) * pitch;
    for (int64_t j = threadIdx.x; j < width; j += blockDim.x) {
      dst[j] = src[j];
      if (n_rows > 1) dst[last + j] = src[last + j];
    }
  }
}

template <typename T>
void launch_t(const void* src, void* dst, int64_t n_rows, int64_t width,
              int64_t n_cols, int64_t pitch, int64_t brows, unsigned grid,
              cudaStream_t stream) {
  jacobi_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), n_rows, width, n_cols,
      pitch, brows);
}

}  // namespace

// dst = one sweep of src; both (n_rows, width) with row pitch `pitch`
// elements, n_cols <= width logical columns.  src and dst must not overlap.
// Runs on CUDA device `device`, on `stream`.  Returns cudaGetLastError()
// after the launch.
extern "C" int design_jacobi_rows(int device, int dtype, const void* src, void* dst,
                             int64_t n_rows, int64_t width, int64_t n_cols,
                             int64_t pitch, int64_t brows, void* stream) {
  if (n_rows <= 0 || width <= 0) return cudaSuccess;
  if (brows <= 0 || pitch < width || n_cols > width) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t interior = n_rows > 2 ? n_rows - 2 : 0;
  int64_t grid = (interior + brows - 1) / brows;
  if (grid < 1) grid = 1;
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(grid);
  if (dtype == repro::kFloat32)
    launch_t<float>(src, dst, n_rows, width, n_cols, pitch, brows, g, st);
  else if (dtype == repro::kBFloat16)
    launch_t<__nv_bfloat16>(src, dst, n_rows, width, n_cols, pitch, brows, g, st);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}
