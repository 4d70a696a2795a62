// One 5-point Jacobi sweep over a pitched (N, width) grid on Hopper, as 2-D
// tiles.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/jacobi/kernel.py:31 _jacobi_kernel (via jacobi_rows, :56)
//
// Bound on this card: bytes.  A sweep must read the grid once and write it
// once, 2 * N * width * itemsize bytes over the device-memory rate; its four
// additions and one multiply a point are far below the card's fp32 rate.
//
// Design against that bound.  The TPU kernel DMA'd three shifted row copies
// of the grid a sweep; this one reads the grid in place through its row
// pitch.  Each CTA owns a 2-D tile that the planner sizes
// (core/planner.py, stencil_block): a column tile of one 16-B vector a
// thread (blockDim.x * Vec<T>::N columns, 256 threads) and a strip of rows.
// The grid is column tiles x strips, so even a 3-row boundary slab spreads
// over width / tile CTAs.  A CTA walks its strip top to bottom and each
// thread holds a ring of kRing row vectors in registers: the rows above, at
// and below the output row and one more; the load of a row is issued two
// rows before its first use, and the ring rolls by compile-time slot
// indices (the row loop is unrolled by kRing), so no register waits on a
// load just to move.  The strip is as tall as the ring, so a CTA issues the
// loads of all but two of its rows at once: one trip to memory, as the
// STREAM kernels make.  The two halo rows a strip shares with the strips
// above and below are read again by those, at about the same time, from
// L2; each row is read from device memory once.  A point's left and right
// neighbours come from the next lanes by warp shuffles; the lanes at a
// warp's edges load the one element past it, two rows ahead.  Registers are
// capped at 64 a thread (four CTAs an SM): the bytes in flight, not the
// ring's depth, set the rate (PERF.md records the deeper rings and the
// uncapped builds that were measured; scripts/jacobi_designs.py keeps and
// times a ring of bulk copies in shared memory and the one-CTA-a-row
// mapping this kernel replaced).  Rows go
// out by 16-B streaming stores (__stcs).
//
// Interior points 1 <= i <= N-2, 1 <= j <= n_cols-2 get
// ((above + below) + left) + right, then * 0.25, in fp32 with explicitly
// rounded adds and multiply (no contraction); every other point, including
// the padding columns up to the width, is copied bit for bit.  bf16 rounds
// once, on store.  Base and pitch must be 16-B aligned (the wrapper refuses
// anything else); a width that is not a whole number of vectors ends in a
// scalar tail, and a tile past the width idles its lanes.
//
// jacobi_row_launch sweeps one row from three row pointers (above, centre,
// below) into a fourth: a mesh rank's boundary row, read where it lies (the
// halo row from the neighbour, the rank's two edge rows) and written into
// the rank's stripe, one launch a row.  One element a thread, any alignment.

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;  // tile threads: a multiple of 32, at most this
// the register ring's depth: row vectors a thread holds (the planner's
// CTA_BUFFERS["jacobi"] and STRIP_ROWS)
constexpr int kRing = 4;
// CTAs of kMaxThreads threads an SM must be able to hold: caps a thread's
// registers at 64
constexpr int kMinBlocks = 4;
constexpr unsigned kFull = 0xffffffffu;

// One element type's view of a 16-B vector: its elements as raw bits, and
// fp32 widening and rounding of those bits.
template <typename T> struct Elem;

template <> struct Elem<float> {
  using U = uint32_t;
  static constexpr int N = 4;
  __device__ __forceinline__ static float widen(U b) { return __uint_as_float(b); }
  __device__ __forceinline__ static U narrow(float x) { return __float_as_uint(x); }
};

template <> struct Elem<__nv_bfloat16> {
  using U = uint16_t;
  static constexpr int N = 8;
  __device__ __forceinline__ static float widen(U b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  __device__ __forceinline__ static U narrow(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

__device__ __forceinline__ uint32_t& word(uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

// element k (a compile-time constant after unrolling) of a vector, as bits
template <typename T>
__device__ __forceinline__ typename Elem<T>::U get(const uint4& v, int k) {
  constexpr int kPer = 4 / sizeof(typename Elem<T>::U);
  return static_cast<typename Elem<T>::U>(word(v, k / kPer) >>
                                          (32 / kPer * (k % kPer)));
}

template <typename T>
__device__ __forceinline__ void set(uint4& v, int k, typename Elem<T>::U x) {
  constexpr int kPer = 4 / sizeof(typename Elem<T>::U);
  const int shift = 32 / kPer * (k % kPer);
  const uint32_t mask = kPer == 1 ? 0xffffffffu : (0xffffu << shift);
  uint32_t& w = word(v, k / kPer);
  w = (w & ~mask) | (static_cast<uint32_t>(x) << shift);
}

// What a thread's columns are, fixed for the whole kernel.
struct Cols {
  int64_t c0;         // first column of the thread's vector
  bool full;          // all N columns lie below the width: one 16-B access
  bool any;           // some do
  bool edge_l, edge_r;  // the lane loads the element before / after them
  unsigned interior;  // bit k: column c0 + k is an interior column
};

// The thread's vector of a row: one 16-B load, or a scalar tail.
template <typename T>
__device__ __forceinline__ uint4 fetch(const T* __restrict__ row, const Cols& c,
                                       int64_t width) {
  using E = Elem<T>;
  if (c.full) return __ldg(reinterpret_cast<const uint4*>(row + c.c0));
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  const typename E::U* bits = reinterpret_cast<const typename E::U*>(row);
#pragma unroll
  for (int k = 0; k < E::N; ++k)
    if (c.c0 + k < width) set<T>(v, k, __ldg(bits + c.c0 + k));
  return v;
}

// The elements just before and after the thread's vector, where the lane
// is a warp's edge: what no shuffle brings.
template <typename T>
__device__ __forceinline__ void fetch_edges(const T* __restrict__ row, const Cols& c,
                                            typename Elem<T>::U& left,
                                            typename Elem<T>::U& right) {
  using E = Elem<T>;
  const typename E::U* bits = reinterpret_cast<const typename E::U*>(row);
  if (c.edge_l) left = __ldg(bits + c.c0 - 1);
  if (c.edge_r) right = __ldg(bits + c.c0 + E::N);
}

// Output row r of the sweep from the thread's vectors of the rows above
// (a), at (c) and below (b) it, and the centre row's edge elements.  Called
// by every lane of the CTA with the same r (the shuffles need the warp).
template <typename T>
__device__ __forceinline__ void step(const uint4& a, const uint4& c, const uint4& b,
                                     typename Elem<T>::U c_left,
                                     typename Elem<T>::U c_right, const Cols& cols,
                                     bool edge_row, int lane, int64_t width,
                                     T* __restrict__ out_row) {
  using E = Elem<T>;
  using U = typename E::U;
  constexpr int N = E::N;
  uint4 out = c;
  if (!edge_row) {
    const float from_left = __shfl_up_sync(kFull, E::widen(get<T>(c, N - 1)), 1);
    const float from_right = __shfl_down_sync(kFull, E::widen(get<T>(c, 0)), 1);
    const float left = lane == 0 ? E::widen(c_left) : from_left;
    const float right = lane == 31 ? E::widen(c_right) : from_right;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (!((cols.interior >> k) & 1u)) continue;
      const float l = k == 0 ? left : E::widen(get<T>(c, k - 1));
      const float r = k == N - 1 ? right : E::widen(get<T>(c, k + 1));
      float v = __fadd_rn(E::widen(get<T>(a, k)), E::widen(get<T>(b, k)));
      v = __fadd_rn(v, l);
      v = __fadd_rn(v, r);
      set<T>(out, k, E::narrow(__fmul_rn(v, 0.25f)));
    }
  }
  if (cols.full) {
    __stcs(reinterpret_cast<uint4*>(out_row + cols.c0), out);
  } else if (cols.any) {
    U* bits = reinterpret_cast<U*>(out_row);
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (cols.c0 + k < width) bits[cols.c0 + k] = get<T>(out, k);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
jacobi_tiles(const T* __restrict__ src, T* __restrict__ dst, int64_t n_rows,
             int64_t width, int64_t n_cols, int64_t pitch, int64_t strip) {
  using U = typename Elem<T>::U;
  constexpr int N = Elem<T>::N;
  constexpr int K = kRing;
  static_assert(K >= 4 && K % 2 == 0,
                "the ring holds the rows above, at and below and one in flight; "
                "even, so a row's edge pair has a compile-time slot");
  const int lane = threadIdx.x & 31;
  Cols cols;
  cols.c0 = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * N;
  cols.full = cols.c0 + N <= width;
  cols.any = cols.c0 < width;
  cols.interior = 0;
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (cols.c0 + k >= 1 && cols.c0 + k <= n_cols - 2) cols.interior |= 1u << k;
  cols.edge_l = lane == 0 && (cols.interior & 1u);
  cols.edge_r = lane == 31 && ((cols.interior >> (N - 1)) & 1u);

  const int64_t n_strips = (n_rows + strip - 1) / strip;
  for (int64_t s = blockIdx.y; s < n_strips; s += gridDim.y) {
    const int64_t r0 = s * strip;
    const int64_t r1 = r0 + strip < n_rows ? r0 + strip : n_rows;
    // slot (q - r0 + 1) % K holds row q's vector, and slot (q - r0 + 1) % 2
    // its edge elements while it is at most two rows from the centre; rows
    // past the grid's edges are clamped to it (an edge row is copied, so
    // what it reads is not used)
    uint4 w[K];
    U el[2], er[2];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      int64_t q = r0 - 1 + i;
      if (q > r1) break;
      q = q < 0 ? 0 : (q > n_rows - 1 ? n_rows - 1 : q);
      w[i] = fetch(src + q * pitch, cols, width);
    }
    fetch_edges(src + r0 * pitch, cols, el[1], er[1]);
    if (r0 + 1 < r1) fetch_edges(src + (r0 + 1) * pitch, cols, el[0], er[0]);
    for (int64_t r = r0; r < r1; r += K) {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int64_t row = r + i;
        if (row >= r1) break;
        step<T>(w[i], w[(i + 1) % K], w[(i + 2) % K], el[(i + 1) % 2], er[(i + 1) % 2],
                cols, row == 0 || row == n_rows - 1, lane, width, dst + row * pitch);
        // the row above is done with: its slot takes the row K - 1 below,
        // and the centre's edge slot the edges of the row two below
        int64_t q = row - 1 + K;
        if (q <= r1) {
          q = q > n_rows - 1 ? n_rows - 1 : q;
          w[i] = fetch(src + q * pitch, cols, width);
        }
        if (row + 2 < r1)
          fetch_edges(src + (row + 2) * pitch, cols, el[(i + 1) % 2], er[(i + 1) % 2]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
jacobi_row(const T* __restrict__ above, const T* __restrict__ centre,
           const T* __restrict__ below, T* __restrict__ out, int64_t width,
           int64_t n_cols) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= width) return;
  if (j >= 1 && j <= n_cols - 2) {
    float v = __fadd_rn(repro::widen(above[j]), repro::widen(below[j]));
    v = __fadd_rn(v, repro::widen(centre[j - 1]));
    v = __fadd_rn(v, repro::widen(centre[j + 1]));
    out[j] = repro::narrow<T>(__fmul_rn(v, 0.25f));
  } else {
    out[j] = centre[j];
  }
}

template <typename T>
int launch_tiles(const void* src, void* dst, int64_t n_rows, int64_t width,
                 int64_t n_cols, int64_t pitch, int64_t strip, int64_t tile,
                 cudaStream_t stream) {
  constexpr int N = Elem<T>::N;
  if (tile % N) return cudaErrorInvalidValue;
  const int64_t threads = tile / N;
  if (threads < 32 || threads > kMaxThreads || threads % 32) return cudaErrorInvalidValue;
  if (!repro::aligned16(src) || !repro::aligned16(dst) ||
      (pitch * static_cast<int64_t>(sizeof(T))) % 16)
    return cudaErrorMisalignedAddress;
  const int64_t tiles = (width + tile - 1) / tile;
  const int64_t strips = (n_rows + strip - 1) / strip;
  if (tiles > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(strips < 65535 ? strips : 65535));
  jacobi_tiles<T><<<grid, static_cast<unsigned>(threads), 0, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), n_rows, width, n_cols,
      pitch, strip);
  return cudaSuccess;
}

template <typename T>
void launch_row(const void* above, const void* centre, const void* below,
                void* out, int64_t width, int64_t n_cols, cudaStream_t stream) {
  const int64_t blocks = (width + kMaxThreads - 1) / kMaxThreads;
  jacobi_row<T><<<static_cast<unsigned>(blocks), kMaxThreads, 0, stream>>>(
      static_cast<const T*>(above), static_cast<const T*>(centre),
      static_cast<const T*>(below), static_cast<T*>(out), width, n_cols);
}

}  // namespace

// dst = one sweep of src; both (n_rows, width) with row pitch `pitch`
// elements, n_cols <= width logical columns, 16-B aligned bases and pitch.
// Tiles of `strip` rows x `tile` columns (a multiple of 32 vectors, at most
// 256).  src and dst must not overlap.  Runs on CUDA device `device`, on
// `stream`.  Returns cudaGetLastError() after the launch.
extern "C" int jacobi_launch(int device, int dtype, const void* src, void* dst,
                             int64_t n_rows, int64_t width, int64_t n_cols,
                             int64_t pitch, int64_t strip, int64_t tile,
                             void* stream) {
  if (n_rows <= 0 || width <= 0) return cudaSuccess;
  if (strip <= 0 || tile <= 0 || pitch < width || n_cols < 1 || n_cols > width)
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int code;
  if (dtype == repro::kFloat32)
    code = launch_tiles<float>(src, dst, n_rows, width, n_cols, pitch, strip, tile, st);
  else if (dtype == repro::kBFloat16)
    code = launch_tiles<__nv_bfloat16>(src, dst, n_rows, width, n_cols, pitch, strip,
                                       tile, st);
  else
    return cudaErrorInvalidValue;
  if (code != cudaSuccess) return code;
  return static_cast<int>(cudaGetLastError());
}

// out = row 1 of one sweep of the three rows (above, centre, below): the
// first `width` elements of centre and out, the first n_cols - 1 of above
// and below read.  out must not overlap the inputs.  Runs on CUDA device
// `device`, on `stream`.  Returns cudaGetLastError() after the launch.
extern "C" int jacobi_row_launch(int device, int dtype, const void* above,
                                 const void* centre, const void* below, void* out,
                                 int64_t width, int64_t n_cols, void* stream) {
  if (width <= 0) return cudaSuccess;
  if (n_cols < 1 || n_cols > width) return cudaErrorInvalidValue;
  if ((width + kMaxThreads - 1) / kMaxThreads > 0x7fffffff)
    return cudaErrorInvalidConfiguration;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    launch_row<float>(above, centre, below, out, width, n_cols, st);
  else if (dtype == repro::kBFloat16)
    launch_row<__nv_bfloat16>(above, centre, below, out, width, n_cols, st);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}
