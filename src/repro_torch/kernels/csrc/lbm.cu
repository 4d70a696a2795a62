// D3Q19 BGK collision on Hopper, in the SoA and the interleaved IvJK layout.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/lbm/kernel.py: _soa_kernel (via collide_soa) and
//     _ivjk_kernel (via collide_ivjk), both on _collide_block
//
// Bound on this card: bytes.  Each launch reads the 19 distributions of every
// site once and writes them once, 2 * 19 * S_pad * itemsize bytes; the
// arithmetic is about 180 operations a site by the paper's count (the kernel
// below does 361, because it keeps the reference's evaluation order),
// which at fp32 is 6 % (12 %) of the byte time at the data-sheet rates.
//
// Design against that bound: one thread per site, one templated kernel with
// the layout as a template parameter.  A thread loads its site's 19 values
// into registers, computes in registers and stores 19 values; no shared
// memory.  Direction v of site s lives at
//   soa : v * S_pad + s                    (f stored (Q, S_pad))
//   ivjk: ((s / L) * Q + v) * L + s % L    (f stored (S_pad / L, Q, L))
// Neighbouring threads take neighbouring sites and L is a multiple of the
// warp width, so in both layouts each of a warp's 38 accesses is one
// coalesced walk over whole 128-B lines (fp32); the 19 independent loads of
// each thread keep plenty of bytes in flight.  A CTA walks the plan's block
// of sites (bsb * L of them); the planner sizes it to one site per thread.
// Registers: a thread holds its 19 inputs, rho and u; ptxas -v for sm_90a
// reports 48 registers and no spill for all four instantiations (fp32/bf16 x
// soa/ivjk), so 5 CTAs of 256 threads fit an SM's 65,536 registers.
//
// Evaluation order, fixed so the plain PyTorch version
// (kernels/lbm/kernel.py: plain) can repeat it bit for bit; every product,
// sum and quotient rounds to fp32 on its own (no FMA contraction):
//   rho  = ((f0 + f1) + f2) + ... + f18
//   m_k  = ((0 + c_0k*f0) + c_1k*f1) + ... , k = x, y, z, the terms with
//          c_vk = 0 skipped (c_vk*f is +-f, exact)
//   u_k  = m_k / rho
//   usq  = (ux*ux + uy*uy) + uz*uz
//   cu_v = (c_vx*ux + c_vy*uy) + c_vz*uz
//   feq_v = (w_v*rho) * (((1 + 3*cu_v) + (4.5*cu_v)*cu_v) - 1.5*usq)
//   out_v = f_v - omega*(f_v - feq_v)
// w_v and omega arrive rounded to the array dtype, as the TPU kernel takes
// them as dtype operands; bf16 widens to fp32 on load and rounds once, on
// store.  A padded site holds zeros, so rho = 0 there and u is NaN: the
// padding's output is garbage by design and the wrappers slice it off.

#include "common.cuh"

namespace {

using repro::kThreads;

constexpr int kQ = 19;
enum Layout : int { kSoa = 0, kIvjk = 1 };

// D3Q19 velocity set, in the order of kernels/lbm/ref.py C.  Every loop
// over directions is unrolled, so c is a compile-time constant at each use.
__device__ __forceinline__ constexpr int c_of(int v, int k) {
  constexpr int c[kQ][3] = {
      {0, 0, 0},
      {1, 0, 0}, {-1, 0, 0}, {0, 1, 0}, {0, -1, 0}, {0, 0, 1}, {0, 0, -1},
      {1, 1, 0}, {-1, -1, 0}, {1, -1, 0}, {-1, 1, 0},
      {1, 0, 1}, {-1, 0, -1}, {1, 0, -1}, {-1, 0, 1},
      {0, 1, 1}, {0, -1, -1}, {0, 1, -1}, {0, -1, 1}};
  return c[v][k];
}

struct Params {
  float w[kQ];
  float omega;
};

// m_k: +f_v where c_vk = 1, -f_v where c_vk = -1, in direction order.
__device__ __forceinline__ float moment(int k, const float (&f)[kQ]) {
  float m = 0.f;
#pragma unroll
  for (int v = 0; v < kQ; ++v) {
    if (c_of(v, k) == 1) m = __fadd_rn(m, f[v]);
    if (c_of(v, k) == -1) m = __fsub_rn(m, f[v]);
  }
  return m;
}

template <typename T, int LAYOUT>
__global__ void __launch_bounds__(kThreads)
lbm_collide_kernel(const T* __restrict__ f_in, T* __restrict__ f_out,
                   const Params p, int64_t sites, int64_t lanes,
                   int64_t block_sites) {
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * block_sites;
  const int64_t s1 = s0 + block_sites < sites ? s0 + block_sites : sites;
  // direction v of site s is at base + v * stride
  const int64_t stride = LAYOUT == kSoa ? sites : lanes;
  for (int64_t s = s0 + threadIdx.x; s < s1; s += blockDim.x) {
    const int64_t base = LAYOUT == kSoa ? s : (s / lanes) * kQ * lanes + s % lanes;
    float f[kQ];
#pragma unroll
    for (int v = 0; v < kQ; ++v) f[v] = repro::widen(f_in[base + v * stride]);
    float rho = f[0];
#pragma unroll
    for (int v = 1; v < kQ; ++v) rho = __fadd_rn(rho, f[v]);
    const float ux = __fdiv_rn(moment(0, f), rho);
    const float uy = __fdiv_rn(moment(1, f), rho);
    const float uz = __fdiv_rn(moment(2, f), rho);
    const float usq = __fadd_rn(__fadd_rn(__fmul_rn(ux, ux), __fmul_rn(uy, uy)),
                                __fmul_rn(uz, uz));
    const float usq15 = __fmul_rn(1.5f, usq);
#pragma unroll
    for (int v = 0; v < kQ; ++v) {
      const float cu = __fadd_rn(
          __fadd_rn(__fmul_rn(static_cast<float>(c_of(v, 0)), ux),
                    __fmul_rn(static_cast<float>(c_of(v, 1)), uy)),
          __fmul_rn(static_cast<float>(c_of(v, 2)), uz));
      const float poly = __fsub_rn(
          __fadd_rn(__fadd_rn(1.f, __fmul_rn(3.f, cu)),
                    __fmul_rn(__fmul_rn(4.5f, cu), cu)),
          usq15);
      const float feq = __fmul_rn(__fmul_rn(p.w[v], rho), poly);
      const float out = __fsub_rn(f[v], __fmul_rn(p.omega, __fsub_rn(f[v], feq)));
      f_out[base + v * stride] = repro::narrow<T>(out);
    }
  }
}

template <typename T>
cudaError_t launch_t(int layout, const void* f_in, void* f_out, const Params& p,
                     int64_t sites, int64_t lanes, int64_t block_sites,
                     unsigned grid, cudaStream_t stream) {
  const T* in = static_cast<const T*>(f_in);
  T* out = static_cast<T*>(f_out);
  if (layout == kSoa)
    lbm_collide_kernel<T, kSoa><<<grid, kThreads, 0, stream>>>(
        in, out, p, sites, lanes, block_sites);
  else if (layout == kIvjk)
    lbm_collide_kernel<T, kIvjk><<<grid, kThreads, 0, stream>>>(
        in, out, p, sites, lanes, block_sites);
  else
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// f_out = BGK collision of f_in, both holding `sites` sites of 19
// directions in `layout` (0 soa, 1 ivjk with `lanes` sites per interleave
// chunk); CTA i takes sites [i * block_sites, (i + 1) * block_sites).
// `w` points to 19 host floats, the weights rounded to the array dtype;
// `omega` likewise.  f_in and f_out must not overlap.  Runs on CUDA device
// `device`, on `stream`.  Returns cudaGetLastError() after the launch.
extern "C" int lbm_collide(int device, int layout, int dtype, const void* f_in,
                           void* f_out, const float* w, float omega,
                           int64_t sites, int64_t lanes, int64_t block_sites,
                           void* stream) {
  if (sites <= 0) return cudaSuccess;
  if (block_sites <= 0 || lanes <= 0 || sites % lanes != 0)
    return cudaErrorInvalidValue;
  const int64_t grid = (sites + block_sites - 1) / block_sites;
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Params p;
  for (int v = 0; v < kQ; ++v) p.w[v] = w[v];
  p.omega = omega;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(grid);
  if (dtype == repro::kFloat32)
    err = launch_t<float>(layout, f_in, f_out, p, sites, lanes, block_sites, g, st);
  else if (dtype == repro::kBFloat16)
    err = launch_t<__nv_bfloat16>(layout, f_in, f_out, p, sites, lanes, block_sites, g, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}
