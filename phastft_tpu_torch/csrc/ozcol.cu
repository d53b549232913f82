// Column pass of the Ozaki dd engine ("df64-oz"), four f32 planes per
// complex array, for sm_90a.
//
// Replaces: phastft_tpu/ops/pallas_ozdd.py, ozcol_pallas (_ozcol_kernel).
//
// For every batch entry b and column i2 of x viewed (n1, n2), n1 = 4m, in
// dd arithmetic, the contractions error-free bf16-slice products (oz.cuh):
//   u_p[k_m]  = W_n1^(p*k_m) * sum_i_m F_m[k_m, i_m] x[i_m*4 + p, i2]
//   y[k_r*m + k_m] = sum_p W_4^(p*k_r) u_p[k_m]
//   out[b, i2 / 128, k1, i2 % 128] = y[k1] * T1[k1, i2 / 256] * T2[k1, i2 % 256]
// with one slice scale per (digit, column): the max of |re_hi| and |im_hi|
// over the digit's m rows (oz_slice_complex along the contraction axis).
//
// Bound: the tensor cores. Each element costs 3 Karatsuba products x 15
// slice pairs x 2m flops (90m, the JAX kernel's own count): 0.78 ms of bf16
// tensor-core time at n = 2^24 (m = 512) against 0.16 ms for its 32 B of
// traffic.
//
// Design (a first version, right before fast):
// - A block owns 8 columns (the product's n = 8) of one entry and takes the
//   four digits in turn. For a digit it finds the 8 column scales, slices the
//   digit's m x 8 dd values into shared memory (15 bf16 arrays, 122 KB at
//   m = 512), and each warp runs whole 16-row k_m tiles over the full depth:
//   all 15 tier sums of its tile stay in registers (60 floats a thread),
//   the F_m slices are read from device memory (7.5 MB at m = 512, resident
//   in L2).
// - The fold, the dd phase, and the store of u_p into the output rows
//   p*m + k_m of the block's own columns: the output doubles as the
//   scratch that the four digits meet in. After a barrier each thread reads
//   u_0..u_3 of one (k_m, column), runs the radix-4 dd DFT and the two
//   correction products, and writes y over the same four positions.
// - The dd products and sums are those of the plain version (oz.cuh), so
//   the two agree bit for bit.
#include <cstdint>

#include <cuda_runtime.h>

#include "oz.cuh"

namespace ddk = phastft::ddk;
namespace oz = phastft::oz;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NC = 8;      // columns per block
constexpr int RADIX = 4;   // ozcol_radix
constexpr int LANES = 128; // the output relayout's minor width
constexpr int CT = 256;    // the correction's factoring width, OZ_COL_TILE

struct Tabs {
  oz::SliceSet f;         // F(m) slices, (m, m)
  const float* phase[4];  // W_n1^(p*k_m), (m, 4)
  const float* t1[4];     // (n1, n2 / CT)
  const float* t2[4];     // (n1, CT)
};

__device__ __forceinline__ ddk::ddc load4(const float* const (&p)[4], long long o) {
  return ddk::ddc{ddk::dd{__ldg(p[0] + o), __ldg(p[1] + o)},
                  ddk::dd{__ldg(p[2] + o), __ldg(p[3] + o)}};
}

__host__ __device__ constexpr int pad_ld(int m) { return m + 8; }

__global__ void __launch_bounds__(THREADS, 1)
ozcol_kernel(ddk::ConstQuad x, Tabs tabs, ddk::Quad out, int n1, int n2) {
  extern __shared__ uint32_t smem[];
  const int m = n1 / RADIX;
  const int ld = pad_ld(m);  // 16 B of padding per slice row: no bank conflicts
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem);  // [set][column][ld]
  unsigned* cmax = smem + oz::NSETS * NC * ld / 2;
  float* csig = reinterpret_cast<float*>(cmax + NC);

  const int groups = n2 / NC;
  const long long b = blockIdx.x / groups;
  const int col0 = static_cast<int>(blockIdx.x % groups) * NC;
  const long long n = static_cast<long long>(n1) * n2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c = tid & (NC - 1);  // the column of every element this thread slices
  const long long xin = b * n + col0 + c;
  const int mtiles = m / 16;

  for (int p = 0; p < RADIX; ++p) {
    if (tid < NC) cmax[tid] = 0u;
    __syncthreads();
    float mx = 0.f;
    for (int e = tid; e < m * NC; e += THREADS) {
      const long long o = xin + static_cast<long long>((e / NC) * RADIX + p) * n2;
      mx = fmaxf(mx, fmaxf(fabsf(__ldg(x.p[0] + o)), fabsf(__ldg(x.p[2] + o))));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    if (lane < NC) atomicMax(cmax + lane, __float_as_uint(mx));  // mx >= 0
    __syncthreads();
    float sig, inv;
    oz::sigma_of(__uint_as_float(cmax[c]), sig, inv);
    if (tid < NC) csig[tid] = sig;
    for (int e = tid; e < m * NC; e += THREADS) {
      const int im = e / NC;
      const long long o = xin + static_cast<long long>(im * RADIX + p) * n2;
      oz::slice_complex(load4(x.p, o), inv, xs + c * ld + im, NC * ld);
    }
    __syncthreads();

    for (int tile = warp; tile < mtiles; tile += WARPS) {
      oz::Tiers acc;
      acc.zero();
      for (int k0 = 0; k0 < m; k0 += 16) {
        uint32_t bf[oz::NOPS][oz::NSLICES][2];
#pragma unroll
        for (int op = 0; op < oz::NOPS; ++op)
#pragma unroll
          for (int j = 0; j < oz::NSLICES; ++j)
            oz::load_b<false>(bf[op][j], xs + (op * oz::NSLICES + j) * NC * ld, ld, 0, k0, m);
        oz::tier_step(acc, bf, [&](int op, int i, uint32_t(&af)[4]) {
          oz::load_a<true>(af, tabs.f.p[op * oz::NSLICES + i], m, tile * 16, k0, m);
        });
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int km = tile * 16 + g + (e >= 2 ? 8 : 0);
        const int cc = 2 * t + (e & 1);
        const int i2 = col0 + cc;
        const ddk::ddc w = load4(tabs.phase, km * RADIX + p);
        const ddk::ddc u = oz::cmul(acc.fold_at(e, csig[cc]), w);
        const long long o = b * n + static_cast<long long>(i2 / LANES) * n1 * LANES +
                            static_cast<long long>(p * m + km) * LANES + (i2 % LANES);
        out.p[0][o] = u.re.hi;
        out.p[1][o] = u.re.lo;
        out.p[2][o] = u.im.hi;
        out.p[3][o] = u.im.lo;
      }
    }
    __syncthreads();  // the slices are rewritten by the next digit
  }

  // the barrier above makes the block's u_p stores visible to the block
  const int t1cols = n2 / CT;
  for (int e = tid; e < m * NC; e += THREADS) {
    const int km = e / NC;
    const int i2 = col0 + (e % NC);
    const long long base = b * n + static_cast<long long>(i2 / LANES) * n1 * LANES + (i2 % LANES);
    ddk::ddc u[RADIX];
#pragma unroll
    for (int p = 0; p < RADIX; ++p) {
      const long long o = base + static_cast<long long>(p * m + km) * LANES;
      u[p] = ddk::ddc{ddk::dd{out.p[0][o], out.p[1][o]}, ddk::dd{out.p[2][o], out.p[3][o]}};
    }
    // y[k_r] = sum_p W_4^(p*k_r) u_p, as df64._dft_regs_dd splits it
    // with its lazy (unnormalised) sums
    const ddk::ddc e0 = oz::cadd_lazy(u[0], u[2]), e1 = oz::csub_lazy(u[0], u[2]);
    const ddk::ddc o0 = oz::cadd_lazy(u[1], u[3]), o1 = oz::csub_lazy(u[1], u[3]);
    const ddk::ddc o1w{o1.im, ddk::neg(o1.re)};  // -i * o1
    const ddk::ddc y[RADIX] = {oz::cadd_lazy(e0, o0), oz::cadd_lazy(e1, o1w),
                               oz::csub_lazy(e0, o0), oz::csub_lazy(e1, o1w)};
#pragma unroll
    for (int kr = 0; kr < RADIX; ++kr) {
      const int k1 = kr * m + km;
      const ddk::ddc w1 = load4(tabs.t1, static_cast<long long>(k1) * t1cols + i2 / CT);
      const ddk::ddc w2 = load4(tabs.t2, static_cast<long long>(k1) * CT + i2 % CT);
      const ddk::ddc v = oz::cmul(oz::cmul(y[kr], w1), w2);
      const long long o = base + static_cast<long long>(k1) * LANES;
      out.p[0][o] = v.re.hi;
      out.p[1][o] = v.re.lo;
      out.p[2][o] = v.im.hi;
      out.p[3][o] = v.im.lo;
    }
  }
}

}  // namespace

// ptrs: the four input planes of (batch, n1, n2); the 15 F(n1/4) slice
// arrays (bf16, (m, m)); the phase (m, 4), T1 (n1, n2/256) and T2 (n1, 256)
// 4-tuples (f32); the four output planes of (batch, n2/128, n1, 128): 35
// device pointers in the order of ops/ozdd.py's ozcol. n1 = 128..2048, n2 =
// 1024..8192, powers of two. Returns the CUDA error code of the launch.
extern "C" int phastft_ozcol(void* const* ptrs, long long batch, int n1, int n2,
                             void* stream) {
  if (batch < 1 || !phastft::is_pow2(n1) || n1 < 128 || n1 > 2048 ||
      !phastft::is_pow2(n2) || n2 < 1024 || n2 > 8192)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = batch * (n2 / NC);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int k = 0;
  auto next = [&]() { return ptrs[k++]; };
  ddk::ConstQuad x;
  for (auto& q : x.p) q = static_cast<const float*>(next());
  Tabs tabs;
  for (auto& q : tabs.f.p) q = static_cast<const uint16_t*>(next());
  for (auto& q : tabs.phase) q = static_cast<const float*>(next());
  for (auto& q : tabs.t1) q = static_cast<const float*>(next());
  for (auto& q : tabs.t2) q = static_cast<const float*>(next());
  ddk::Quad out;
  for (auto& q : out.p) q = static_cast<float*>(next());
  const int m = n1 / RADIX;
  const size_t smem = sizeof(uint16_t) * oz::NSETS * NC * pad_ld(m) + 2 * NC * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ozcol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ozcol_kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
                 static_cast<cudaStream_t>(stream)>>>(x, tabs, out, n1, n2);
  return static_cast<int>(cudaGetLastError());
}
