// Hybrid leaf FFT: the length-n DFT of every row, n = n1*128 with
// n1 = 2..1024, planar f32, for sm_90a.
//
// Replaces: phastft_tpu/ops/pallas_leaf.py, leaf_fft_pallas_hybrid (the
// opt-in Options.leaf_kernel="hybrid"): a Stockham F(n1) on the vector
// units and one F(128) contraction on the matrix unit.
//
// Row x of length n = n1*128, x[i1*128 + i2]:
//   t[k1, i2] = sum_i1 W_n1^(k1*i1) x[i1, i2]        (F(n1) over i1)
//   u[k1, i2] = t[k1, i2] * W_n^(k1*i2)               (planner table cr, ci)
//   X[k1 + n1*k2] = sum_i2 F[k2, i2] u[k1, i2]        (F(128) over i2)
// with the contraction as Karatsuba's three real products, as the TPU
// kernel computes it: q1 = F_r u_r, q2 = F_i u_i, q3 = F_s (u_r + u_i),
// X = (q1 - q2, q3 - q1 - q2), F_s = F_r + F_i.
//
// Bound: memory, 16 B per element (0.64 ms on 2^27 points at 3.35 TB/s).
// The contraction runs on the tensor cores as three TF32 passes per
// product (3xTF32): x = big + small with big = tf32(x) and
// small = tf32(x - big), tf32 rounding to nearest with ties away (add
// 0x1000 to the bits, clear the low 13), and F u = Fb ub + Fb us + Fs ub
// (small * small dropped). That keeps the 1e-6 parity with the plain
// version that one TF32 pass (~4e-4) breaks. Its own cost is 9 passes of
// 2*128 flops per element, 0.62 ms on 2^27 points at 495 TFLOP/s, about the
// byte time; beside it F(n1) and the correction on the CUDA cores.
//
// Design:
// - F(128) is never stored: every entry is W_128^((k2*i2) mod 128), so the
//   planner's row 1 rebuilds any entry bit for bit, and F_s = F_r + F_i is
//   one FADD, rounded as the planner's table is. Each block splits the 128
//   roots once into tables of (F_r, F_i) big/small (float4) and F_s
//   big/small (float2) in shared memory, 8 copies with a one-entry skew:
//   lane (g, t) of a fragment gather reads copy 2t + (g & 1) (depth t) or
//   2t (depth t + 4), which makes the float4 gathers conflict-free.
// - M = k2 (128), N = the block's 64 columns k1, K = i2 (128). Warpgroup
//   wg (4 warps) computes k2 in [64wg, 64wg + 64) for all 64 columns with
//   wgmma m64n64k8: A (F) from registers, gathered from the root tables in
//   mma.sync's m16n8k8 layout per warp (g = lane / 4, t = lane % 4: rows g,
//   g + 8, depth t, t + 4); B (u) from shared memory. The block splits each
//   run of 16 i2 of u once into six TF32 planes ((u_r, u_i, u_r + u_i) x
//   (big, small)) in the canonical K-major layout without swizzle (core
//   matrices of 8 columns x 4 positions), double-buffered: the next run is
//   read and split while the current one is contracted. The depth is
//   permuted so that a lane's A fragment reads i2 = k0 + 4t + 2s + h for
//   k-step s (depth t + 4h).
// - Each product's six passes over a run go into a fresh accumulator (32
//   floats a thread) that one FADD per element adds to the sums (96), so
//   the tensor cores' own rounding touches only 16-deep partial sums:
//   accumulating all 48 passes in place read 9.6e-7..9.9e-7 from the plain
//   version on the H100, 16-deep partials 3.3e-7..3.7e-7. mma.sync
//   m16n8k8 (8-deep partials, 32 k2 x 32 k1 a warp) took 1.32-1.47x as
//   long in one call.
// - Every block holds 8192 points (64 columns of u): 64/n1 whole rows up
//   to n1 = 64. From n1 = 128 a row (n1 KB planar) is spread over a
//   cluster of C = n1/64 blocks (2, 4, 8, 16). Phase 1 needs whole columns
//   and phase 3 whole rows, so block c runs F(n1) and the correction on
//   the columns i2 in [c*W, c*W + W), W = 128/C, and then contracts the
//   rows k1 in [64c, 64c + 64), reading each 16-point run of i2 from the
//   blocks that hold it through distributed shared memory (float4 loads,
//   in flight while the previous run's products issue). A float4 is 4
//   consecutive i2 and W >= 8, so each one lies in one block: at n1 = 1024
//   (W = 8) a run's first 8 i2 come from block 2r and its last 8 from
//   2r + 1, and runs stay 16 deep, the partial sums that hold parity.
// - The 16-block cluster of n1 = 1024 is not a portable size: that kernel
//   has no compile-time cluster and is launched through cluster.cuh with
//   the non-portable opt-in. A block's 148 KB of shared memory leaves one
//   block an SM.
// - Loads and stores are float4s of contiguous floats: the output is
//   staged in shared memory in its natural order X[k1 + n1*k2] first, and
//   each value is multiplied by out_scale on its way to the store (1, or
//   1/N where this leaf ends an inverse).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cluster.cuh"
#include "fft_smem.cuh"

namespace cg = cooperative_groups;
using phastft::bitrev;
using phastft::load_twiddles;
using phastft::pad;
using phastft::padded_words;

namespace {

constexpr int M = 128, LOGM = 7;
constexpr int THREADS = 256;
// Points a block holds, and the columns of u (rows k1) it contracts.
constexpr int LOG_BLOCK_POINTS = 13, BLOCK_POINTS = 1 << LOG_BLOCK_POINTS;
constexpr int COLS = BLOCK_POINTS / M;
// Warpgroup tile: 64 k2 x the block's 64 k1, one m64n64k8 per pass.
constexpr int WGM = 64;
// i2 per run of the contraction (two k-steps of 8).
constexpr int RUN = 16;
// Root-table copies, and entries per copy (one-entry skew).
constexpr int COPIES = 8, TSTRIDE = M + 1;
// TF32 planes of a run of u: (u_r, u_i, u_r + u_i) x (big, small), each
// 64 columns x RUN floats; two runs' planes are held at once.
constexpr int PLANE = COLS * RUN, PLANES = 6, STAGE = PLANES * PLANE;
// float4 loads of each plane per thread.
constexpr int LOADS = BLOCK_POINTS / 4 / THREADS;

__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small, both TF32 (small rounded too).
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ float part(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// Float offset, within a plane, of column n and run position k, in the
// canonical K-major layout without swizzle: core matrices of 8 columns x 4
// positions (128 contiguous bytes), 4 cores along K 128 B apart, column
// groups of 8 512 B apart.
__device__ __forceinline__ int plane_at(int n, int k) {
  return (n >> 3) * 128 + (k >> 2) * 32 + (n & 7) * 4 + (k & 3);
}

// Shared-memory matrix descriptor of one k-step (8 positions from byte
// address addr): leading (K) byte offset 128, stride (N) byte offset 512.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32);
}

// d += A x B on the tensor cores: a warpgroup's m64n64k8, TF32 in, f32
// accumulate, A in registers, B from a shared-memory descriptor.
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Splits a thread's four values of u (columns j, run positions 4t .. 4t + 3)
// into the six TF32 planes. Position 4t + 2s + h goes to k-step s, depth
// t + 4h, so that a lane's A fragment gathers i2 = k0 + 4t + 2s + h.
__device__ __forceinline__ void split_run(float* planes, int j, int t, const float4& xr4,
                                          const float4& xi4) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int at = plane_at(j, 8 * (u >> 1) + 4 * (u & 1) + t);
    const float xr = part(xr4, u), xi = part(xi4, u);
    uint32_t big[3], small[3];
    split(xr, big[0], small[0]);
    split(xi, big[1], small[1]);
    split(xr + xi, big[2], small[2]);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      planes[(2 * q) * PLANE + at] = __uint_as_float(big[q]);
      planes[(2 * q + 1) * PLANE + at] = __uint_as_float(small[q]);
    }
  }
}

// Adds the 3xTF32 Karatsuba products of the run of i2 from k0 (its planes
// in shared memory) to warpgroup wg's sums acc[product]. A product's six
// passes over the run (two k-steps, small terms first) go into a fresh
// accumulator that one FADD per element adds to the sums.
__device__ __forceinline__ void contract_run(const float* planes, int k0, const float4* t4,
                                             const float2* t2, int wg, int wq, int lane,
                                             float (&acc)[3][32]) {
  const int g = lane >> 2, t = lane & 3;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(planes));
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    // A fragments of product q for both k-steps, big and small: element e
    // is row g + 8*(e & 1) of the warp's 16, depth column t + 4*(e >> 1)
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k2 = WGM * wg + 16 * wq + g + 8 * (e & 1);
        const int hi = e >> 1;
        const int i2 = k0 + 4 * t + 2 * s + hi;
        const int at = (2 * t + (hi ? 0 : (g & 1))) * TSTRIDE + ((k2 * i2) & (M - 1));
        if (q < 2) {
          const float4 f = t4[at];
          ab[s][e] = __float_as_uint(q ? f.z : f.x);
          as[s][e] = __float_as_uint(q ? f.w : f.y);
        } else {
          const float2 fs = t2[at];
          ab[s][e] = __float_as_uint(fs.x);
          as[s][e] = __float_as_uint(fs.y);
        }
      }
    }
    float d[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) d[e] = 0.f;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const uint64_t bb = desc(base + 4 * (2 * q) * PLANE + 256 * s);
      const uint64_t bs = desc(base + 4 * (2 * q + 1) * PLANE + 256 * s);
      wgmma(d, as[s], bb);
      wgmma(d, ab[s], bs);
      wgmma(d, ab[s], bb);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      asm volatile("" : "+f"(d[e])::"memory");
      acc[q][e] += d[e];
    }
  }
}

// One block of 8192 points. LOGC = log2 of the cluster size: 0 for
// n1 <= 64 (R = 64/n1 rows per block), else n1 = 64 << LOGC (one row per
// cluster).
template <int LOGC>
__device__ __forceinline__ void hybrid_body(const float* __restrict__ re,
                                            const float* __restrict__ im,
                                            const float* __restrict__ f2r,
                                            const float* __restrict__ f2i,
                                            const float* __restrict__ cr,
                                            const float* __restrict__ ci,
                                            float* __restrict__ ore, float* __restrict__ oim,
                                            long long batch, int logn1, float out_scale) {
  constexpr int LOGW = LOGM - LOGC, W = 1 << LOGW;
  extern __shared__ __align__(128) float4 smem4[];
  const int n1 = 1 << logn1, logn = logn1 + LOGM;
  const int logr = LOGC ? 0 : LOG_BLOCK_POINTS - logn;  // rows per block
  const int rows = 1 << logr;
  const int words = padded_words(BLOCK_POINTS);
  float* planes = reinterpret_cast<float*>(smem4);  // 2 x STAGE
  float* sr = planes + 2 * STAGE;
  float* si = sr + words;
  float4* t4 = reinterpret_cast<float4*>(si + words);  // (F_r, F_i) big, small
  float2* t2 = reinterpret_cast<float2*>(t4 + COPIES * TSTRIDE);  // F_s big, small
  float2* tw1 = reinterpret_cast<float2*>(t2 + COPIES * TSTRIDE);

  const int c = LOGC ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const long long row0 = LOGC ? static_cast<long long>(blockIdx.x >> LOGC)
                              : static_cast<long long>(blockIdx.x) << logr;
  const long long left = batch - row0;
  const int valid_rows = static_cast<int>(left < rows ? left : rows);
  const long long base = row0 << logn;

  load_twiddles(tw1, n1, nullptr, nullptr);
  for (int e = threadIdx.x; e < COPIES * M; e += THREADS) {
    const int k = e & (M - 1);
    const float fr = __ldg(f2r + M + k), fi = __ldg(f2i + M + k);
    uint32_t rb, rs, ib, is, sb, ss;
    split(fr, rb, rs);
    split(fi, ib, is);
    split(fr + fi, sb, ss);
    const int at = (e >> LOGM) * TSTRIDE + k;
    t4[at] = make_float4(__uint_as_float(rb), __uint_as_float(rs), __uint_as_float(ib),
                         __uint_as_float(is));
    t2[at] = make_float2(__uint_as_float(sb), __uint_as_float(ss));
  }
  // shared (i1, r, w): element (r, i1, c*W + w) of the block's rows; every
  // load of a thread is in flight before the first store
  float4 a[LOADS], b[LOADS];
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int g = threadIdx.x + j * THREADS;
    const int w = 4 * (g & (W / 4 - 1));
    const int i1 = (g >> (LOGW - 2)) & (n1 - 1);
    const int r = g >> (LOGW - 2 + logn1);
    a[j] = b[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid_rows) {
      const long long off = base + (static_cast<long long>(r) << logn) + i1 * M + c * W + w;
      a[j] = __ldg(reinterpret_cast<const float4*>(re + off));
      b[j] = __ldg(reinterpret_cast<const float4*>(im + off));
    }
  }
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int g = threadIdx.x + j * THREADS;
    const int w = 4 * (g & (W / 4 - 1));
    const int i1 = (g >> (LOGW - 2)) & (n1 - 1);
    const int r = g >> (LOGW - 2 + logn1);
    const int s = pad(((i1 << logr) + r) * W + w);
    *reinterpret_cast<float4*>(sr + s) = a[j];
    *reinterpret_cast<float4*>(si + s) = b[j];
  }
  __syncthreads();

  // phase 1: F(n1) over i1 for all R*W sequences (the contiguous axis)
  phastft::dif_fft(sr, si, logn1, logr + LOGW, 1, rows * W, true, tw1);
  // phase 2: shared row p of the (i1, r) axis holds k1 = bitrev(p); four
  // consecutive i2 a step, all table loads of a thread in flight at once
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int e = 4 * (threadIdx.x + j * THREADS);
    const int i2 = c * W + (e & (W - 1));
    const int k1 = bitrev(e >> (logr + LOGW), logn1);
    const float4 cs = __ldg(reinterpret_cast<const float4*>(cr + k1 * M + i2));
    const float4 sn = __ldg(reinterpret_cast<const float4*>(ci + k1 * M + i2));
    const int s = pad(e);
    const float4 x = *reinterpret_cast<const float4*>(sr + s);
    const float4 y = *reinterpret_cast<const float4*>(si + s);
    *reinterpret_cast<float4*>(sr + s) =
        make_float4(x.x * cs.x - y.x * sn.x, x.y * cs.y - y.y * sn.y,
                    x.z * cs.z - y.z * sn.z, x.w * cs.w - y.w * sn.w);
    *reinterpret_cast<float4*>(si + s) =
        make_float4(x.x * sn.x + y.x * cs.x, x.y * sn.y + y.y * cs.y,
                    x.z * sn.z + y.z * cs.z, x.w * sn.w + y.w * cs.w);
  }
  if (LOGC) cg::this_cluster().sync();
  else __syncthreads();

  // phase 3: warpgroup wg contracts k2 in [64wg, 64wg + 64) for the
  // block's 64 columns j. One block: column j is shared row j
  // (j = p*R + r). A cluster: column j is k1 = 64c + j, row bitrev(k1) of
  // the blocks' (i1, w) slabs. Each run of 16 i2 is split into TF32 planes
  // while the previous run's are contracted.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3;
  float acc[3][32];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[q][e] = 0.f;
  // thread = (column j, float4 q4 of the run)
  const int j = threadIdx.x >> 2, q4 = threadIdx.x & 3;
  const int prow = LOGC ? bitrev(COLS * c + j, logn1) * W : 0;
  float4 nr, ni;
  auto fetch = [&](int i0) {
    if (LOGC == 0) {  // a 128-point row is 144 words
      const int w = j * padded_words(M) + pad(i0) + 4 * q4;
      nr = *reinterpret_cast<const float4*>(sr + w);
      ni = *reinterpret_cast<const float4*>(si + w);
    } else {
      cg::cluster_group cluster = cg::this_cluster();
      const int i2 = i0 + 4 * q4;
      const unsigned src = static_cast<unsigned>(i2 >> LOGW);
      const int w = pad(prow + (i2 & (W - 1)));
      nr = *reinterpret_cast<const float4*>(cluster.map_shared_rank(sr, src) + w);
      ni = *reinterpret_cast<const float4*>(cluster.map_shared_rank(si, src) + w);
    }
  };
  fetch(0);
  split_run(planes, j, q4, nr, ni);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
#pragma unroll 1
  for (int run = 0; run < M / RUN; ++run) {
    const bool more = run + 1 < M / RUN;
    if (more) fetch((run + 1) * RUN);
    contract_run(planes + (run & 1) * STAGE, run * RUN, t4, t2, wg, wq, lane, acc);
    if (more) {
      split_run(planes + ((run + 1) & 1) * STAGE, j, q4, nr, ni);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();
  }
  // every read of the data (a cluster's remote ones too) precedes the stores
  if (LOGC) cg::this_cluster().sync();
  else __syncthreads();

  // stage the output in natural order: one block, local X index
  // r*n + k1 + n1*k2; a cluster block, k2*64 + (k1 - 64c). Accumulator
  // element 4n + 2v + h is row g + 8v of the warp's 16, column 8n + 2t + h.
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < COLS / 8; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 8 * n + 2 * t + h;
      int at;
      if (LOGC == 0) {
        const int r = col & (rows - 1);
        at = (r << logn) + bitrev(col >> logr, logn1);
      } else {
        at = col;
      }
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int e = 4 * n + 2 * v + h;
        const int k2 = WGM * wg + 16 * wq + g + 8 * v;
        const int s = pad(at + (LOGC ? k2 * COLS : k2 << logn1));
        const float q1 = acc[0][e], q2 = acc[1][e];
        sr[s] = q1 - q2;
        si[s] = acc[2][e] - q1 - q2;
      }
    }
  }
  __syncthreads();

  for (int g4 = threadIdx.x; g4 < BLOCK_POINTS / 4; g4 += THREADS) {
    long long o;
    if (LOGC == 0) {
      if ((4 * g4) >> logn >= valid_rows) continue;
      o = base + 4 * g4;
    } else {  // 64 contiguous floats per k2: 16 float4s
      o = base + static_cast<long long>(g4 >> 4) * n1 + COLS * c + 4 * (g4 & 15);
    }
    const int s = pad(4 * g4);
    *reinterpret_cast<float4*>(ore + o) =
        phastft::scale4(*reinterpret_cast<const float4*>(sr + s), out_scale);
    *reinterpret_cast<float4*>(oim + o) =
        phastft::scale4(*reinterpret_cast<const float4*>(si + s), out_scale);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
hybrid_kernel(const float* __restrict__ re, const float* __restrict__ im,
              const float* __restrict__ f2r, const float* __restrict__ f2i,
              const float* __restrict__ cr, const float* __restrict__ ci,
              float* __restrict__ ore, float* __restrict__ oim, long long batch, int logn1,
              float out_scale) {
  hybrid_body<0>(re, im, f2r, f2i, cr, ci, ore, oim, batch, logn1, out_scale);
}

#define PHASTFT_HYBRID_CLUSTER(LOGC)                                                     \
  __global__ void __cluster_dims__(1 << LOGC, 1, 1) __launch_bounds__(THREADS, 1)        \
  hybrid_cluster##LOGC(const float* __restrict__ re, const float* __restrict__ im,       \
                       const float* __restrict__ f2r, const float* __restrict__ f2i,     \
                       const float* __restrict__ cr, const float* __restrict__ ci,       \
                       float* __restrict__ ore, float* __restrict__ oim, long long batch, \
                       int logn1, float out_scale) {                                     \
    hybrid_body<LOGC>(re, im, f2r, f2i, cr, ci, ore, oim, batch, logn1, out_scale);     \
  }

PHASTFT_HYBRID_CLUSTER(1)  // n1 = 128
PHASTFT_HYBRID_CLUSTER(2)  // n1 = 256
PHASTFT_HYBRID_CLUSTER(3)  // n1 = 512

// n1 = 1024: a cluster of 16 blocks, set at launch (cluster.cuh).
__global__ void __launch_bounds__(THREADS, 1)
hybrid_cluster4(const float* __restrict__ re, const float* __restrict__ im,
                const float* __restrict__ f2r, const float* __restrict__ f2i,
                const float* __restrict__ cr, const float* __restrict__ ci,
                float* __restrict__ ore, float* __restrict__ oim, long long batch, int logn1,
                float out_scale) {
  hybrid_body<4>(re, im, f2r, f2i, cr, ci, ore, oim, batch, logn1, out_scale);
}

constexpr int CLUSTER1024 = 16;

size_t smem_bytes(int n1) {
  return sizeof(float) * 2 * STAGE + 2 * sizeof(float) * padded_words(BLOCK_POINTS) +
         (sizeof(float4) + sizeof(float2)) * COPIES * TSTRIDE + sizeof(float2) * (n1 / 2);
}

template <typename Kernel>
int launch(Kernel kernel, int logc, const float* re, const float* im, const float* f2r,
           const float* f2i, const float* cr, const float* ci, float* ore, float* oim,
           long long batch, int n1, float out_scale, cudaStream_t s) {
  const int logn1 = phastft::ilog2(n1);
  const int logr = logc ? 0 : LOG_BLOCK_POINTS - LOGM - logn1;
  const long long blocks = ((batch + (1LL << logr) - 1) >> logr) << logc;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n1);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, s>>>(re, im, f2r, f2i, cr, ci, ore,
                                                              oim, batch, logn1, out_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// re, im, ore, oim: (batch, n1*128), n1 = 2..1024 a power of two. f2r, f2i:
// the planner's F(128) (row 1 is read); cr, ci: the (n1, 128) correction
// W_n^(k1*i2); out_scale: the factor of every output. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int phastft_hybrid(const float* re, const float* im, const float* f2r,
                              const float* f2i, const float* cr, const float* ci, float* ore,
                              float* oim, long long batch, int n1, double out_scale,
                              void* stream) {
  if (batch < 1 || !phastft::is_pow2(n1) || n1 < 2 || n1 > 1024 || f2r == nullptr ||
      f2i == nullptr || cr == nullptr || ci == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = static_cast<float>(out_scale);
  if (n1 == 1024) {
    static int resident = 0;  // queried on first use
    return phastft::launch_clusters(hybrid_cluster4, CLUSTER1024, CLUSTER1024 * batch, THREADS,
                                    smem_bytes(n1), s, resident, re, im, f2r, f2i, cr, ci, ore,
                                    oim, batch, phastft::ilog2(n1), scale);
  }
  if (n1 == 128)
    return launch(hybrid_cluster1, 1, re, im, f2r, f2i, cr, ci, ore, oim, batch, n1, scale, s);
  if (n1 == 256)
    return launch(hybrid_cluster2, 2, re, im, f2r, f2i, cr, ci, ore, oim, batch, n1, scale, s);
  if (n1 == 512)
    return launch(hybrid_cluster3, 3, re, im, f2r, f2i, cr, ci, ore, oim, batch, n1, scale, s);
  return launch(hybrid_kernel, 0, re, im, f2r, f2i, cr, ci, ore, oim, batch, n1, scale, s);
}

// The number of hybrid clusters at n1 = 128, 256, 512 or 1024 (2, 4, 8, 16
// blocks) the current device holds at once (the CUDA occupancy query), or
// minus the CUDA error code.
extern "C" int phastft_hybrid_clusters(int n1) {
  const size_t smem = smem_bytes(n1);
  if (n1 == 128) return phastft::resident_clusters(hybrid_cluster1, 2, THREADS, smem);
  if (n1 == 256) return phastft::resident_clusters(hybrid_cluster2, 4, THREADS, smem);
  if (n1 == 512) return phastft::resident_clusters(hybrid_cluster3, 8, THREADS, smem);
  if (n1 == 1024) return phastft::resident_clusters(hybrid_cluster4, CLUSTER1024, THREADS, smem);
  return -static_cast<int>(cudaErrorInvalidValue);
}
