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
// Design against that bound: one templated kernel over a pitched
// (rows, width) layout.  A CTA walks the plan's block of rows; its threads
// step through each row with 16-B vector loads and stores, so a warp moves
// whole 128-B lines of every stream.  The vector path needs every base
// 16-B aligned and a row pitch that keeps every row so; otherwise (the
// phased triad, whose streams start at arbitrary element phases) the same
// kernel takes its scalar path, one element per thread per step.  Arithmetic
// is in fp32 with explicit round-to-nearest multiply and add (no contraction
// into an FMA), and bf16 rounds once, on store.

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

template <int OP>
__device__ __forceinline__ float apply(float a, float b, float c, float s) {
  if (OP == kCopy) return a;
  if (OP == kScale) return __fmul_rn(s, a);                    // B = s*C
  if (OP == kAdd) return __fadd_rn(a, b);                      // C = A + B
  if (OP == kStreamTriad) return __fadd_rn(a, __fmul_rn(s, b));  // A = B + s*C
  return __fadd_rn(a, __fmul_rn(b, c));                        // A = B + C*D
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const T* __restrict__ a, const T* __restrict__ b,
              const T* __restrict__ c, T* __restrict__ out, float s,
              int64_t rows, int64_t width, int64_t pitch, int64_t brows,
              int vec) {
  constexpr int NIN = Arity<OP>::value;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * brows;
  const int64_t r1 = r0 + brows < rows ? r0 + brows : rows;
  if (vec) {
    constexpr int N = Vec<T>::N;
    for (int64_t r = r0; r < r1; ++r) {
      const int64_t base = r * pitch;
      for (int64_t j = static_cast<int64_t>(threadIdx.x) * N; j < width;
           j += static_cast<int64_t>(blockDim.x) * N) {
        float x[N], y[N] = {}, z[N] = {};
        Vec<T>::load(a + base + j, x);
        if (NIN >= 2) Vec<T>::load(b + base + j, y);
        if (NIN >= 3) Vec<T>::load(c + base + j, z);
        float o[N];
#pragma unroll
        for (int k = 0; k < N; ++k)
          o[k] = apply<OP>(x[k], NIN >= 2 ? y[k] : 0.f, NIN >= 3 ? z[k] : 0.f, s);
        Vec<T>::store(out + base + j, o);
      }
    }
  } else {
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
}

template <typename T, int OP>
cudaError_t launch_op(const void* a, const void* b, const void* c, void* out,
                      float s, int64_t rows, int64_t width, int64_t pitch,
                      int64_t brows, cudaStream_t stream) {
  constexpr int NIN = Arity<OP>::value;
  const bool vec = repro::aligned16(a) && (NIN < 2 || repro::aligned16(b)) &&
                   (NIN < 3 || repro::aligned16(c)) && repro::aligned16(out) &&
                   (pitch * static_cast<int64_t>(sizeof(T))) % 16 == 0 &&
                   width % Vec<T>::N == 0;
  const int64_t grid = (rows + brows - 1) / brows;
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  stream_kernel<T, OP><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(out), s, rows, width, pitch,
      brows, vec ? 1 : 0);
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
