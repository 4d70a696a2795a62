// STREAM on persistent CTAs fed from registers: an alternative design that
// scripts/kernel_designs.py times beside the shipped
// src/repro_torch/kernels/csrc/stream.cu.
//
// As many 256-thread CTAs as the card holds (occupancy x SMs); CTA c claims
// the plan's blocks c, c + grid, ...; each thread issues 4 independent 16-B
// streaming loads (__ldcs) of every input before its stores (__stcs).
// Contiguous, 16-B aligned (rows, width) tensors only.
#include "common.cuh"

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

constexpr int kThreads = 256, U = 4;

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
persistent_kernel(const T* a, const T* b, const T* c, T* out, float s, int64_t rows,
                  int64_t width, int64_t brows) {
  constexpr int NIN = Arity<OP>::value, N = Vec<T>::N;
  const T* ins[3] = {a, b, c};
  const int64_t nblocks = (rows + brows - 1) / brows;
  const int64_t step = static_cast<int64_t>(kThreads) * N;
  for (int64_t blk = blockIdx.x; blk < nblocks; blk += gridDim.x) {
    const int64_t base = blk * brows * width;
    const int64_t len = (rows - blk * brows < brows ? rows - blk * brows : brows) * width;
    for (int64_t j = static_cast<int64_t>(threadIdx.x) * N; j < len; j += step * U) {
      uint4 raw[U][NIN];
#pragma unroll
      for (int q = 0; q < U; ++q)
        if (j + q * step < len) {
#pragma unroll
          for (int k = 0; k < NIN; ++k)
            raw[q][k] = __ldcs(reinterpret_cast<const uint4*>(ins[k] + base + j + q * step));
        }
#pragma unroll
      for (int q = 0; q < U; ++q)
        if (j + q * step < len) {
          float x[NIN][N], o[N];
#pragma unroll
          for (int k = 0; k < NIN; ++k) Vec<T>::unpack(raw[q][k], x[k]);
#pragma unroll
          for (int e = 0; e < N; ++e)
            o[e] = apply<OP>(x[0][e], x[NIN >= 2 ? 1 : 0][e], x[NIN >= 3 ? 2 : 0][e], s);
          __stcs(reinterpret_cast<uint4*>(out + base + j + q * step), Vec<T>::pack(o));
        }
    }
  }
}

template <typename T, int OP>
int go(const void* a, const void* b, const void* c, void* out, float s, int64_t rows,
       int64_t width, int64_t brows, cudaStream_t stream) {
  static int grid = 0;
  if (!grid) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, persistent_kernel<T, OP>, kThreads,
                                                  0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
    grid = per_sm * sms;
  }
  const int64_t nblocks = (rows + brows - 1) / brows;
  persistent_kernel<T, OP><<<static_cast<unsigned>(nblocks < grid ? nblocks : grid), kThreads,
                             0, stream>>>(
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
