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
// Design: a block computes a TK x TC = 32 (k_m) x 64 (column) tile of every
// digit, so each F(m) slice value it stages serves 64 columns and each data
// slice 32 rows k_m. An output holds 15 f32 tier sums until the depth is
// done: each of the two warpgroups holds a 64 (column) x 16 (k_m) tile of
// them, 120 registers a thread, which caps the block's tile at 2048
// outputs and the SM at one block (255 registers).
// - First the block finds the 4 x 64 column scales (float4 reads of the
//   digit's rows), while the first chunks' copies are in flight.
// - The depth runs in chunks of 16 rows i_m, digit after digit without a
//   break: a ring of STAGES chunks, each the F(m) slices of the chunk (32
//   rows x 16 x 15 arrays, 15 KB: one bulk copy of a contiguous tile of the
//   card table, ops/ozdd.py ozcol_card) and its 64 x 16 raw dd values (16
//   KB, by cp.async), arrives STAGES - 1 chunks ahead; each thread copies
//   the raw values it slices itself, so it slices as soon as its own
//   copies land.
//   The slices (30 KB a chunk, two buffers) and F(m) tiles are the wgmma
//   operands (oz.cuh); the next chunk is sliced between the three
//   operands' product batches of this one, one barrier a chunk.
// - At a digit's last chunk: the fold, the dd phase, and the store of u_p
//   into the output rows p*m + k_m of the block's own columns: the output
//   doubles as the scratch that the four digits meet in. After a barrier
//   each thread reads u_0..u_3 of one (k_m, column) of the tile, runs the
//   radix-4 dd DFT and the two correction products, and writes y over the
//   same four positions.
// - The dd products and sums are those of the plain version (oz.cuh), so
//   the two agree bit for bit.
#include <cstdint>

#include <cuda_runtime.h>

#include "oz.cuh"

namespace ddk = phastft::ddk;
namespace oz = phastft::oz;

namespace {

constexpr int THREADS = 256;
constexpr int TK = 32;      // rows k_m of a block's tile: 16 a warpgroup
constexpr int TC = 64;      // columns of a block's tile: wgmma's 64 rows
constexpr int CHUNK = 16;   // depth of a chunk: one k16 step
constexpr int RADIX = 4;    // ozcol_radix
constexpr int LANES = 128;  // the output relayout's minor width
constexpr int CT = 256;     // the correction's factoring width, OZ_COL_TILE
constexpr int STAGES = 4;   // chunks in flight: copies run STAGES - 1 ahead
constexpr int F_WORDS = oz::NSETS * TK * CHUNK / 2;  // one F(m) tile: 15 KB
// A chunk's raw dd values, (plane, depth, column) with rows of TC + 2 floats:
// a half-warp's 8-byte copies and reads of 8 depths x 2 column pairs fill
// the banks.
constexpr int RS = TC + 2;
constexpr int R_WORDS = 4 * CHUNK * RS;
constexpr int D_WORDS = oz::NSETS * TC * CHUNK / 2;  // one data tile: 30 KB
constexpr size_t SMEM = sizeof(uint32_t) * (STAGES * (F_WORDS + R_WORDS) + 2 * D_WORDS) +
                        sizeof(float) * 3 * RADIX * TC;

struct Tabs {
  oz::SliceSet f;         // F(m) slices, (m, m)
  const float* phase[4];  // W_n1^(p*k_m), (m, 4)
  const float* t1[4];     // (n1, n2 / CT)
  const float* t2[4];     // (n1, CT)
  const uint16_t* card;   // the F(m) tiles of ops/ozdd.py ozcol_card
};

__device__ __forceinline__ ddk::ddc load4(const float* const (&p)[4], long long o) {
  return ddk::ddc{ddk::dd{__ldg(p[0] + o), __ldg(p[1] + o)},
                  ddk::dd{__ldg(p[2] + o), __ldg(p[3] + o)}};
}

__global__ void __launch_bounds__(THREADS, 1)
ozcol_kernel(ddk::ConstQuad x, Tabs tabs, ddk::Quad out, int n1, int n2) {
  extern __shared__ __align__(128) uint32_t smem[];
  __shared__ __align__(8) uint64_t full[STAGES];
  uint32_t* fbuf = smem;                                  // [STAGES][F_WORDS]
  float* rbuf = reinterpret_cast<float*>(fbuf + STAGES * F_WORDS);  // [STAGES][4][CHUNK][RS]
  uint32_t* dbuf = reinterpret_cast<uint32_t*>(rbuf + STAGES * R_WORDS);  // [2][D_WORDS]
  float* csig = reinterpret_cast<float*>(dbuf + 2 * D_WORDS);  // [RADIX][TC]
  float* cinv = csig + RADIX * TC;
  unsigned* cmax = reinterpret_cast<unsigned*>(cinv + RADIX * TC);

  const int m = n1 / RADIX;
  const int ktiles = m / TK, groups = n2 / TC;
  const int kt = static_cast<int>(blockIdx.x % ktiles);
  const long long rest = blockIdx.x / ktiles;
  const int col0 = static_cast<int>(rest % groups) * TC;
  const long long b = rest / groups;
  const int km0 = kt * TK;
  const long long n = static_cast<long long>(n1) * n2;
  const long long xb = b * n + col0;  // x[b, 0, col0]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the data this thread slices: columns 2cp, 2cp + 1, depths 2j, 2j + 1
  // of every chunk
  const int j = lane & 7, cp = (lane >> 3) + 4 * warp;
  const int nch = m / CHUNK, total = RADIX * nch;  // chunk q: digit q / nch

  if (tid < STAGES) oz::mbar_init(full + tid);
  cmax[tid] = 0u;
  oz::mbar_fence_init();
  __syncthreads();

  // chunk q's copies into ring stage q % STAGES: the F(m) tile (one
  // contiguous tile of the card table, a bulk copy completing on
  // full[q % STAGES]), and this thread's raw values (a cp.async group of
  // its own: only it reads them)
  auto issue = [&](int q) {
    if (q < total) {
      const int p = q / nch, c = q % nch, st = q % STAGES;
      if (tid == 0) {
        oz::mbar_expect(full + st, oz::tile_bytes(TK));
        oz::bulk_copy(fbuf + st * F_WORDS,
                      tabs.card + static_cast<long long>(kt * nch + c) * (F_WORDS * 2),
                      oz::tile_bytes(TK), full + st);
      }
      float* r = rbuf + st * R_WORDS;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int im = c * CHUNK + 2 * j + h;
        const long long o = xb + static_cast<long long>(im * RADIX + p) * n2 + 2 * cp;
#pragma unroll
        for (int pl = 0; pl < 4; ++pl)
          oz::cp_async8(r + (pl * CHUNK + 2 * j + h) * RS + 2 * cp, x.p[pl] + o);
      }
    }
    oz::cp_async_commit();  // an empty group past the end keeps the count
  };
  // slice column 2cp + e of chunk q (its copies complete) into data tile buf
  auto slice = [&](int q, int buf, int e) {
    const int p = q / nch, col = 2 * cp + e;
    const float* r = rbuf + (q % STAGES) * R_WORDS + col;
    ddk::ddc v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = (2 * j + h) * RS;
      v[h] = ddk::ddc{ddk::dd{r[at], r[CHUNK * RS + at]},
                      ddk::dd{r[2 * CHUNK * RS + at], r[3 * CHUNK * RS + at]}};
    }
    oz::put_pair(dbuf + buf * D_WORDS, TC, col, j, v[0], v[1], cinv[p * TC + col]);
  };
  // chunk q's F(m) tile has landed
  auto arrived = [&](int q) { oz::mbar_wait(full + q % STAGES, (q / STAGES) & 1); };

  for (int q = 0; q < STAGES - 1; ++q) issue(q);
  {
    // the column scales, while the first chunks arrive: thread (p, rows
    // i_m = rg mod 4, columns 4 c4 .. 4 c4 + 3) over rows i_m*4 + p
    const int p = tid >> 6, c4 = tid & 15, rg = (tid >> 4) & 3;
    float mx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int im = rg; im < m; im += 4) {
      const long long o = xb + static_cast<long long>(im * RADIX + p) * n2 + 4 * c4;
      const float4 re = __ldg(reinterpret_cast<const float4*>(x.p[0] + o));
      const float4 ie = __ldg(reinterpret_cast<const float4*>(x.p[2] + o));
      mx[0] = fmaxf(mx[0], fmaxf(fabsf(re.x), fabsf(ie.x)));
      mx[1] = fmaxf(mx[1], fmaxf(fabsf(re.y), fabsf(ie.y)));
      mx[2] = fmaxf(mx[2], fmaxf(fabsf(re.z), fabsf(ie.z)));
      mx[3] = fmaxf(mx[3], fmaxf(fabsf(re.w), fabsf(ie.w)));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) atomicMax(cmax + p * TC + 4 * c4 + u, __float_as_uint(mx[u]));
    __syncthreads();
    oz::sigma_of(__uint_as_float(cmax[tid]), csig[tid], cinv[tid]);
  }
  oz::cp_async_wait<STAGES - 2>();
  __syncthreads();
  slice(0, 0, 0);
  slice(0, 0, 1);

  const int wg = warp >> 2;  // the warpgroup's 16 rows k_m: tile rows 16wg..
  oz::Tiers<8> acc;
  acc.zero();
  for (int q = 0; q < total; ++q) {
    // publishes chunk q's data tile (and its F(m) tile, which every thread
    // has seen land); every warp is past chunk q - 1's products and
    // slicing, so stage (q - 1) % STAGES may be refilled
    arrived(q);
    oz::fence_async_smem();
    __syncthreads();
    const oz::TilePair tp = oz::tile_pair(dbuf + (q & 1) * D_WORDS, TC, 0,
                                          fbuf + (q % STAGES) * F_WORDS, TK, 16 * wg);
    const bool next = q + 1 < total;
    uint32_t a[oz::NOPS][oz::NSLICES][4];  // held until the products are done
    oz::begin_products(acc);
    oz::products_op(acc, tp, 0, a[0]);
    if (next) {
      oz::cp_async_wait<STAGES - 3>();  // chunk q + 1's copies of this thread
      slice(q + 1, (q + 1) & 1, 0);
    }
    oz::products_op(acc, tp, 1, a[1]);
    if (next) slice(q + 1, (q + 1) & 1, 1);
    oz::products_op(acc, tp, 2, a[2]);
    oz::wgmma_commit();
    issue(q + STAGES - 1);
    oz::finish_products(acc);
    if (q % nch == nch - 1) {
      // the digit's last chunk: fold, phase, and u_p into its output rows
      const int p = q / nch;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int cc = oz::acc_row(e);
        const int km = km0 + 16 * wg + oz::acc_col(e);
        const int i2 = col0 + cc;
        const ddk::ddc w = load4(tabs.phase, km * RADIX + p);
        const ddk::ddc u = oz::cmul(acc.fold_at(e, csig[p * TC + cc]), w);
        const long long o = b * n + static_cast<long long>(i2 / LANES) * n1 * LANES +
                            static_cast<long long>(p * m + km) * LANES + (i2 % LANES);
        out.p[0][o] = u.re.hi;
        out.p[1][o] = u.re.lo;
        out.p[2][o] = u.im.hi;
        out.p[3][o] = u.im.lo;
      }
      acc.zero();
    }
  }
  __syncthreads();  // the block's u_p stores are visible to the block

  const int t1cols = n2 / CT;
  for (int e = tid; e < TK * TC; e += THREADS) {
    const int km = km0 + e / TC;
    const int i2 = col0 + (e % TC);
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

cudaError_t configure() {
  cudaError_t err = cudaFuncSetAttribute(ozcol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ozcol_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

}  // namespace

// ptrs: the four input planes of (batch, n1, n2); the 15 F(n1/4) slice
// arrays (bf16, (m, m)); the phase (m, 4), T1 (n1, n2/256) and T2 (n1, 256)
// 4-tuples (f32); the four output planes of (batch, n2/128, n1, 128); the
// card table of the F(n1/4) tiles (ops/ozdd.py ozcol_card): 36 device
// pointers in the order of ops/ozdd.py's ozcol. n1 = 128..2048, n2 =
// 1024..8192, powers of two. Returns the CUDA error code of the launch.
extern "C" int phastft_ozcol(void* const* ptrs, long long batch, int n1, int n2,
                             void* stream) {
  if (batch < 1 || !phastft::is_pow2(n1) || n1 < 128 || n1 > 2048 ||
      !phastft::is_pow2(n2) || n2 < 1024 || n2 > 8192)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = batch * (n2 / TC) * (n1 / RADIX / TK);
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
  tabs.card = static_cast<const uint16_t*>(next());
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  ozcol_kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM,
                 static_cast<cudaStream_t>(stream)>>>(x, tabs, out, n1, n2);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of ozcol resident on one SM (the CUDA occupancy query), or minus
// the CUDA error code.
extern "C" int phastft_ozcol_blocks() {
  cudaError_t err = configure();
  if (err != cudaSuccess) return -static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ozcol_kernel, THREADS, SMEM);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
