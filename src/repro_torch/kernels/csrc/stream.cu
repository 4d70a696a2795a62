// STREAM copy/scale/add/triad and the Schoenauer vector triad on Hopper.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/stream/kernel.py: _copy_kernel, _scale_kernel,
//     _add_kernel, _triad_kernel (via _call)
//   src/repro/kernels/triad/kernel.py: _triad_kernel (via triad2d)
//
// Bound on this card: bytes.  Each element is read once per input stream and
// written once; at most two operations per element, so the time is the bytes
// over the device-memory rate (3.35 TB/s on an H100 SXM).
//
// Design against that bound (the aligned path): one CTA per block of the
// plan's `brows` rows, sized so that the whole block is in flight at once.
// Each thread issues all its loads -- U independent 16-B vectors of every
// input stream (U = 4, or 2 with three inputs, to stay inside 64
// registers) -- before its first store, so a CTA makes one trip to memory,
// not one per row; the CTA has brows * width / (16-B vector x U) threads (up
// to 1024, looping only for blocks wider than that).  The hardware
// schedules the CTAs in block order, so the lines in flight at any moment
// are a dense, contiguous stretch of every stream.  Loads and stores are
// streaming (__ldcs/__stcs, evict first): each line is touched once.
// Arithmetic is in fp32 with explicit round-to-nearest multiply and add (no
// contraction into an FMA, so the kernel is bit-exact against its plain
// version), and bf16 rounds once, on store.
//
// Measured on an H100 (PERF.md): persistent CTAs (occupancy x SMs) that
// walk the blocks in grid-stride order take 1.5-9 % longer than this
// design, whether fed by a ring of bulk asynchronous copies in shared
// memory (3-14 stages of 16 KB tiles, normal or evict-first L2 policy) or
// by registers (scripts/kernel_designs.py keeps them and times them); CTAs
// that walk a block's rows one trip at a time, as this kernel's first
// version did, lost 1.3-3.4 % to the library call (PERF.md).
//
// The unaligned path (the phased triad, whose streams start at arbitrary
// element phases) keeps one element per thread per step.

#include "common.cuh"

namespace {

using repro::Vec;
using repro::kThreads;

// op codes shared with the Python wrappers
enum Op : int { kCopy = 0, kScale = 1, kAdd = 2, kStreamTriad = 3, kTriad = 4 };

template <int OP> struct Arity { static constexpr int value = 1; };
template <> struct Arity<kAdd> { static constexpr int value = 2; };
template <> struct Arity<kStreamTriad> { static constexpr int value = 2; };
template <> struct Arity<kTriad> { static constexpr int value = 3; };

// 16-B vectors of every input stream a thread holds in flight
template <int OP> struct Unroll { static constexpr int value = Arity<OP>::value >= 3 ? 2 : 4; };

constexpr int kMaxThreads = 1024;

template <int OP>
__device__ __forceinline__ float apply(float a, float b, float c, float s) {
  if (OP == kCopy) return a;
  if (OP == kScale) return __fmul_rn(s, a);                    // B = s*C
  if (OP == kAdd) return __fadd_rn(a, b);                      // C = A + B
  if (OP == kStreamTriad) return __fadd_rn(a, __fmul_rn(s, b));  // A = B + s*C
  return __fadd_rn(a, __fmul_rn(b, c));                        // A = B + C*D
}

// The aligned path: CTA b streams block b, rows [b * brows, (b + 1) * brows).
template <typename T, int OP>
__global__ void __launch_bounds__(kMaxThreads)
stream_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ c,
              T* __restrict__ out, float s, int64_t rows, int64_t width, int64_t pitch,
              int64_t brows) {
  constexpr int NIN = Arity<OP>::value, U = Unroll<OP>::value, N = Vec<T>::N;
  const T* ins[3] = {a, b, c};
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * brows;
  const int64_t len = (rows - r0 < brows ? rows - r0 : brows) * width;
  const bool contiguous = pitch == width;
  const int64_t step = static_cast<int64_t>(blockDim.x) * N;
  for (int64_t e0 = static_cast<int64_t>(threadIdx.x) * N; e0 < len; e0 += step * U) {
    uint4 raw[U][NIN];
    int64_t at[U];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int64_t e = e0 + q * step;   // element of the block, in row order
      at[q] = contiguous ? r0 * width + e : (r0 + e / width) * pitch + e % width;
      if (e < len) {
#pragma unroll
        for (int k = 0; k < NIN; ++k)
          raw[q][k] = __ldcs(reinterpret_cast<const uint4*>(ins[k] + at[q]));
      }
    }
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if (e0 + q * step < len) {
        float x[NIN][N], o[N];
#pragma unroll
        for (int k = 0; k < NIN; ++k) Vec<T>::unpack(raw[q][k], x[k]);
#pragma unroll
        for (int e = 0; e < N; ++e)
          o[e] = apply<OP>(x[0][e], x[NIN >= 2 ? 1 : 0][e], x[NIN >= 3 ? 2 : 0][e], s);
        __stcs(reinterpret_cast<uint4*>(out + at[q]), Vec<T>::pack(o));
      }
    }
  }
}

// The unaligned path: one element per thread per step over the block.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
stream_scalar_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     const T* __restrict__ c, T* __restrict__ out, float s,
                     int64_t rows, int64_t width, int64_t pitch, int64_t brows) {
  constexpr int NIN = Arity<OP>::value;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * brows;
  const int64_t r1 = r0 + brows < rows ? r0 + brows : rows;
  for (int64_t r = r0; r < r1; ++r) {
    const int64_t base = r * pitch;
    for (int64_t j = threadIdx.x; j < width; j += blockDim.x) {
      const int64_t i = base + j;
      const float x = repro::widen(a[i]);
      const float y = NIN >= 2 ? repro::widen(b[i]) : 0.f;
      const float z = NIN >= 3 ? repro::widen(c[i]) : 0.f;
      out[i] = repro::narrow<T>(apply<OP>(x, y, z, s));
    }
  }
}

template <typename T, int OP>
cudaError_t launch_op(const void* a, const void* b, const void* c, void* out, float s,
                      int64_t rows, int64_t width, int64_t pitch, int64_t brows,
                      cudaStream_t stream) {
  constexpr int NIN = Arity<OP>::value, N = Vec<T>::N;
  const bool vec = repro::aligned16(a) && (NIN < 2 || repro::aligned16(b)) &&
                   (NIN < 3 || repro::aligned16(c)) && repro::aligned16(out) &&
                   (pitch * static_cast<int64_t>(sizeof(T))) % 16 == 0 &&
                   width % N == 0;
  const int64_t nblocks = (rows + brows - 1) / brows;
  if (nblocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  const T* pc = static_cast<const T*>(c);
  T* po = static_cast<T*>(out);
  if (vec) {
    const int64_t per_thread = static_cast<int64_t>(N) * Unroll<OP>::value;
    int64_t threads = (brows * width + per_thread - 1) / per_thread;
    threads = (threads + 31) / 32 * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    stream_kernel<T, OP><<<static_cast<unsigned>(nblocks), static_cast<unsigned>(threads), 0,
                           stream>>>(pa, pb, pc, po, s, rows, width, pitch, brows);
  } else {
    stream_scalar_kernel<T, OP><<<static_cast<unsigned>(nblocks), kThreads, 0, stream>>>(
        pa, pb, pc, po, s, rows, width, pitch, brows);
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_dtype(int op, const void* a, const void* b, const void* c,
                         void* out, float s, int64_t rows, int64_t width,
                         int64_t pitch, int64_t brows, cudaStream_t stream) {
  switch (op) {
    case kCopy: return launch_op<T, kCopy>(a, b, c, out, s, rows, width, pitch, brows, stream);
    case kScale: return launch_op<T, kScale>(a, b, c, out, s, rows, width, pitch, brows, stream);
    case kAdd: return launch_op<T, kAdd>(a, b, c, out, s, rows, width, pitch, brows, stream);
    case kStreamTriad:
      return launch_op<T, kStreamTriad>(a, b, c, out, s, rows, width, pitch, brows, stream);
    case kTriad: return launch_op<T, kTriad>(a, b, c, out, s, rows, width, pitch, brows, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// out[r, j] = op(a, b, c; s) for r < rows, j < width; element (r, j) of
// every stream lives at base + r * pitch + j.  Unused inputs may be null.
// Runs on CUDA device `device`, on `stream`.  Returns cudaGetLastError()
// after the launch.
extern "C" int stream_launch(int device, int op, int dtype, const void* a,
                             const void* b, const void* c, void* out, float s,
                             int64_t rows, int64_t width, int64_t pitch,
                             int64_t brows, void* stream) {
  if (rows <= 0 || width <= 0) return cudaSuccess;
  if (brows <= 0 || pitch < width) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    err = launch_dtype<float>(op, a, b, c, out, s, rows, width, pitch, brows, st);
  else if (dtype == repro::kBFloat16)
    err = launch_dtype<__nv_bfloat16>(op, a, b, c, out, s, rows, width, pitch, brows, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}
