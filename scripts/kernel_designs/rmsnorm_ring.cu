// RMSNorm on persistent CTAs that stream their rows through a ring of bulk
// asynchronous copies: an alternative design that scripts/kernel_designs.py
// times beside the shipped src/repro_torch/kernels/csrc/rmsnorm.cu, whose
// row arithmetic (and so whose bits) it shares.
//
// As many CTAs as the card holds (occupancy x SMs); CTA c claims the plan's
// blocks c, c + grid, ...; each thread loads its scale vector once.  One
// thread copies each row (x, and z for the gate) into a ring of
// RMS_STAGES stages in shared memory with cp.async.bulk, RMS_STAGES - 1
// rows ahead, one mbarrier a stage; the threads reduce a row from shared
// memory with one barrier (double-buffered partials) and store it from
// registers.  Rows of up to 1024 16-B vectors.
#include "ring.cuh"
#include "rmsnorm.cu"

#ifndef RMS_STAGES
#define RMS_STAGES 2
#endif

namespace {

constexpr int kStages = RMS_STAGES;
constexpr int kRingHeader = 128;   // the mbarriers, before the stages
constexpr int kRingSmem = kRingHeader + kStages * 2 * kMaxThreads * 16;

struct Rows {
  int64_t block, row, end;
  __device__ Rows(int64_t first, int64_t rows, int64_t brows) { start(first, rows, brows); }
  __device__ void start(int64_t b, int64_t rows, int64_t brows) {
    block = b;
    row = b * brows;
    end = row + brows < rows ? row + brows : rows;
  }
  __device__ bool valid(int64_t nblocks) const { return block < nblocks; }
  __device__ void next(int64_t rows, int64_t brows) {
    if (++row < end) return;
    start(block + gridDim.x, rows, brows);
  }
};

template <typename T, typename S, bool GATED>
__global__ void __launch_bounds__(kMaxThreads)
ring_kernel(const T* __restrict__ x, const T* __restrict__ z, const S* __restrict__ scale,
            T* __restrict__ out, int64_t rows, int64_t width, int64_t brows, int64_t d_logical,
            float eps) {
  constexpr int N = Vec<T>::N;
  __shared__ float partial[2][kMaxThreads / 32];
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t nvec = width / N;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int64_t nblocks = (rows + brows - 1) / brows;
  float sc[N];
  if (tid < nvec) load_scale<S, N>(scale + tid * N, sc);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  const uint32_t row_bytes = static_cast<uint32_t>(width * sizeof(T));
  auto stage_x = [&](int s) {
    return reinterpret_cast<T*>(smem + kRingHeader + s * (GATED ? 2 : 1) * row_bytes);
  };
  auto issue = [&](int64_t r, int s) {
    ring::mbar_expect_tx(&full[s], (GATED ? 2 : 1) * row_bytes);
    ring::bulk_load(stage_x(s), x + r * width, row_bytes, &full[s], ring::l2_policy(false));
    if (GATED)
      ring::bulk_load(stage_x(s) + width, z + r * width, row_bytes, &full[s],
                      ring::l2_policy(false));
  };
  Rows cur(blockIdx.x, rows, brows);
  Rows pre = cur;   // the producer, kStages - 1 rows ahead
  if (tid == 0) {
    for (int k = 0; k < kStages; ++k) ring::mbar_init(&full[k], 1);
    ring::mbar_fence_init();
  }
  __syncthreads();
  for (int k = 0; k < kStages - 1; ++k) {
    if (tid == 0 && pre.valid(nblocks)) issue(pre.row, k);
    pre.next(rows, brows);
  }
  for (int64_t i = 0; cur.valid(nblocks); ++i, cur.next(rows, brows)) {
    const int s = static_cast<int>(i & 1);
    const int st = static_cast<int>(i % kStages);
    // the stage of the row before this one was read before its barrier
    if (tid == 0 && pre.valid(nblocks))
      issue(pre.row, static_cast<int>((i + kStages - 1) % kStages));
    pre.next(rows, brows);
    ring::mbar_wait(&full[st], static_cast<uint32_t>((i / kStages) & 1));
    float v[N];
    float ss = 0.f;
    if (tid < nvec) {
      load_vec<T, GATED>(stage_x(st), stage_x(st) + width, tid * N, v);
      mask_vec<T>(tid, d_logical, v);
      ss = sum_squares<N>(v, ss);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) partial[s][warp] = ss;
    __syncthreads();
    float total = 0.f;
    for (int w = 0; w < nwarps; ++w) total += partial[s][w];
    const float inv = rsqrtf(total / static_cast<float>(d_logical) + eps);
    if (tid < nvec) store_vec<T, N>(out + cur.row * width + tid * N, inv, sc, v);
  }
}

template <typename T, typename S, bool GATED>
int go(const void* x, const void* z, const void* scale, void* out, int64_t rows, int64_t width,
       int64_t brows, int64_t d_logical, float eps, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const int64_t nvec = width / N;
  if (nvec > kMaxThreads) return cudaErrorInvalidValue;
  auto kernel = ring_kernel<T, S, GATED>;
  static bool set = false;
  if (!set) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingSmem);
    set = true;
  }
  const int threads = static_cast<int>((nvec + 31) / 32 * 32);
  const int smem = kRingHeader + kStages * (GATED ? 2 : 1) * static_cast<int>(width * sizeof(T));
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  const int64_t grid = static_cast<int64_t>(per_sm) * ring::sm_count();
  const int64_t nblocks = (rows + brows - 1) / brows;
  kernel<<<static_cast<unsigned>(nblocks < grid ? nblocks : grid), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(z), static_cast<const S*>(scale),
      static_cast<T*>(out), rows, width, brows, d_logical, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 rows with a bf16 scale (the serving dtype)
extern "C" int design_rmsnorm(int gated, const void* x, const void* z, const void* scale,
                              void* out, int64_t rows, int64_t width, int64_t brows,
                              int64_t d_logical, float eps, void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gated)
    return go<bf16, bf16, true>(x, z, scale, out, rows, width, brows, d_logical, eps, st);
  return go<bf16, bf16, false>(x, z, scale, out, rows, width, brows, d_logical, eps, st);
}
