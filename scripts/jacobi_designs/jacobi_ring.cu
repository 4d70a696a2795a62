// The Jacobi sweep fed by a ring of bulk asynchronous copies (TMA) in shared
// memory: an alternative design that scripts/jacobi_designs.py times beside
// the shipped src/repro_torch/kernels/csrc/jacobi.cu.
//
// The same 2-D tiles as the shipped kernel: a CTA owns a column tile of one
// 16-B vector a thread and a strip of rows.  One thread issues a
// cp.async.bulk of each input row's tile, widened by one vector on each side
// for the left and right neighbours, into a ring of kStages (8) stages in
// shared memory, one mbarrier a stage, as far as kStages - 2 rows below
// the row being computed.  The threads read the rows above, at and below from
// shared memory, compute in fp32 with the shipped kernel's rounded
// operations, and write 16-B streaming stores; a barrier a row frees the
// stage of the row above for the next copy.  Base, pitch and width must be
// whole 16-B vectors, and one strip a CTA (at most 65535 strips).
#include "ring.cuh"

namespace {

constexpr int kStages = 8;
static_assert(kStages >= 3, "the ring holds the rows above, at and below");
constexpr int kMaxThreads = 256;

template <typename T> struct Bits;
template <> struct Bits<float> {
  using U = uint32_t;
  __device__ __forceinline__ static float widen(U b) { return __uint_as_float(b); }
  __device__ __forceinline__ static U narrow(float x) { return __float_as_uint(x); }
};
template <> struct Bits<__nv_bfloat16> {
  using U = uint16_t;
  __device__ __forceinline__ static float widen(U b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  __device__ __forceinline__ static U narrow(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
jacobi_ring(const T* __restrict__ src, T* __restrict__ dst, int64_t n_rows,
            int64_t width, int64_t n_cols, int64_t pitch, int64_t strip) {
  using B = Bits<T>;
  using U = typename B::U;
  constexpr int N = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t tile = static_cast<int64_t>(blockDim.x) * N;
  const int64_t stage = tile + 2 * N;  // elements a stage: the tile and a vector each side
  U* ring_buf = reinterpret_cast<U*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kStages * stage * sizeof(T));
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t lo = c0 >= N ? c0 - N : 0;
  const int64_t hi = c0 + tile + N < width ? c0 + tile + N : width;
  const uint32_t bytes = static_cast<uint32_t>((hi - lo) * sizeof(T));
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * strip;
  const int64_t r1 = r0 + strip < n_rows ? r0 + strip : n_rows;
  const uint64_t policy = ring::l2_policy(false);

  // stage i holds the rows q with (q - r0 + 1) % kStages == i; column c of
  // a row lies at element c - c0 + N of its stage
  auto issue = [&](int64_t q) {
    const int i = static_cast<int>((q - r0 + 1) % kStages);
    const int64_t row = q < 0 ? 0 : (q > n_rows - 1 ? n_rows - 1 : q);
    ring::mbar_expect_tx(&bars[i], bytes);
    ring::bulk_load(ring_buf + i * stage + (lo - c0 + N), src + row * pitch + lo, bytes,
                    &bars[i], policy);
  };
  auto rows_of = [&](int64_t q) -> const U* {
    const int i = static_cast<int>((q - r0 + 1) % kStages);
    ring::mbar_wait(&bars[i], static_cast<uint32_t>(((q - r0 + 1) / kStages) & 1));
    return ring_buf + i * stage + N;  // element 0 is column c0
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) ring::mbar_init(&bars[i], 1);
    ring::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int64_t q = r0 - 1; q <= r1 && q <= r0 - 2 + kStages; ++q) issue(q);

  const int64_t t = static_cast<int64_t>(threadIdx.x) * N;
  const int64_t c = c0 + t;
  for (int64_t r = r0; r < r1; ++r) {
    const U* above = rows_of(r - 1);
    const U* centre = rows_of(r);
    const U* below = rows_of(r + 1);
    if (c < width) {
      uint4 out = *reinterpret_cast<const uint4*>(centre + t);
      if (r != 0 && r != n_rows - 1) {
        U* o = reinterpret_cast<U*>(&out);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const int64_t j = c + k;
          if (j < 1 || j > n_cols - 2) continue;
          float v = __fadd_rn(B::widen(above[t + k]), B::widen(below[t + k]));
          v = __fadd_rn(v, B::widen(centre[t + k - 1]));
          v = __fadd_rn(v, B::widen(centre[t + k + 1]));
          o[k] = B::narrow(__fmul_rn(v, 0.25f));
        }
      }
      __stcs(reinterpret_cast<uint4*>(dst + r * pitch + c), out);
    }
    __syncthreads();  // every thread is done with the row above
    if (threadIdx.x == 0 && r - 1 + kStages <= r1) issue(r - 1 + kStages);
  }
}

template <typename T>
int launch(const void* src, void* dst, int64_t n_rows, int64_t width, int64_t n_cols,
           int64_t pitch, int64_t strip, int64_t tile, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const int64_t threads = tile / N;
  if (tile % N || threads % 32 || threads > kMaxThreads || width % N ||
      (pitch * static_cast<int64_t>(sizeof(T))) % 16 || !repro::aligned16(src) ||
      !repro::aligned16(dst))
    return cudaErrorInvalidValue;
  const int64_t strips = (n_rows + strip - 1) / strip;
  if (strips > 65535) return cudaErrorInvalidConfiguration;
  const size_t smem = kStages * (tile + 2 * N) * sizeof(T) + kStages * sizeof(uint64_t);
  auto kernel = jacobi_ring<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((width + tile - 1) / tile),
                  static_cast<unsigned>(strips));
  kernel<<<grid, static_cast<unsigned>(threads), smem, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), n_rows, width, n_cols, pitch,
      strip);
  return cudaSuccess;
}

}  // namespace

extern "C" int design_jacobi_ring(int device, int dtype, const void* src, void* dst,
                                  int64_t n_rows, int64_t width, int64_t n_cols,
                                  int64_t pitch, int64_t strip, int64_t tile,
                                  void* stream) {
  if (n_rows <= 0 || width <= 0) return cudaSuccess;
  if (strip <= 0 || tile <= 0 || pitch < width || n_cols < 1 || n_cols > width)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int code;
  if (dtype == repro::kFloat32)
    code = launch<float>(src, dst, n_rows, width, n_cols, pitch, strip, tile, st);
  else if (dtype == repro::kBFloat16)
    code = launch<__nv_bfloat16>(src, dst, n_rows, width, n_cols, pitch, strip, tile, st);
  else
    return cudaErrorInvalidValue;
  if (code != cudaSuccess) return code;
  return static_cast<int>(cudaGetLastError());
}
