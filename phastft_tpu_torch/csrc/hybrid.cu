// Hybrid leaf FFT: the length-n DFT of every row, n = n1*128 with
// n1 = 2..512, planar f32, for sm_90a.
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
// Bound: operations. The dense contraction is 3*128 FMAs (768 flops) per
// element, against 16 B of memory traffic per element: at 67 TFLOP/s of
// f32 on the CUDA cores that is ~5x the byte time. TF32 tensor cores
// would break the 1e-6 parity with the plain version, so the products are
// f32 FFMA; a three-pass TF32 or wgmma form is later work.
//
// Design against that bound:
// - F(128) is never stored: every entry is W_128^((k2*i2) mod 128), so a
//   128-entry root table (row 1 of the planner's F(128), 1 KB of shared
//   memory) rebuilds any entry bit for bit, and F_s = F_r + F_i is one
//   FADD, rounded as the planner's table is.
// - Each warp owns a tile of 8 columns k1 (rows of u) and all 128 k2:
//   lane l accumulates k2 = l, l+32, l+64, l+96, so the 8 columns' u values
//   are warp-wide broadcasts (float4 loads of 4 i2 at a time) and each
//   table entry a lane reads serves 8 columns: 3*4*8 = 96 FMAs per i2 and
//   lane against 8 table loads and 4 broadcast loads.
// - Every block holds 8192 points (64 columns of u, one tile per warp):
//   64/n1 whole rows up to n1 = 64. From n1 = 128 a row (n1 KB planar) is
//   spread over a cluster of C = n1/64 blocks (2, 4, 8). Phase 1 needs
//   whole columns and phase 3 whole rows, so block c runs F(n1) and the
//   correction on the columns i2 in [c*W, c*W + W), W = 128/C, and then
//   contracts the rows k1 in [64c, 64c + 64), reading each 32-point (or
//   W-point) run of i2 from the block that holds it through distributed
//   shared memory into a per-warp staging buffer.
// - Loads and stores are float4s of contiguous floats: the output is
//   staged in shared memory in its natural order X[k1 + n1*k2] first.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fft_smem.cuh"

namespace cg = cooperative_groups;
using phastft::bitrev;
using phastft::load_twiddles;
using phastft::pad;
using phastft::padded_words;

namespace {

constexpr int M = 128, LOGM = 7;
constexpr int THREADS = 256, WARPS = THREADS / 32;
// Points a block holds, and the columns of u (rows k1) it contracts.
constexpr int LOG_BLOCK_POINTS = 13, BLOCK_POINTS = 1 << LOG_BLOCK_POINTS;
constexpr int COLS = BLOCK_POINTS / M;
// Columns per warp tile, and k2 values per lane.
constexpr int TN = COLS / WARPS, KM = M / 32;

__device__ __forceinline__ float part(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// Adds the Karatsuba products of i2 in [i2base, i2base + LEN) into the
// tile's sums. Column c of the tile holds i2base + i at ur[c*cs + o(i)],
// o(i) = i + 4*(i/32) (the padding of a 128-point row; o(i) = i below 32).
template <int LEN>
__device__ __forceinline__ void contract(const float* ur, const float* ui, int cs,
                                         int i2base, const float* rr, const float* ri,
                                         int lane, float (&q1)[KM][TN],
                                         float (&q2)[KM][TN], float (&q3)[KM][TN]) {
#pragma unroll 1
  for (int i = 0; i < LEN; i += 4) {
    const int o = i + ((i >> 5) << 2);
    float4 xr[TN], xi[TN];
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      xr[c] = *reinterpret_cast<const float4*>(ur + c * cs + o);
      xi[c] = *reinterpret_cast<const float4*>(ui + c * cs + o);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i2 = i2base + i + u;
      float ar[TN], ai[TN], as[TN];
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        ar[c] = part(xr[c], u);
        ai[c] = part(xi[c], u);
        as[c] = ar[c] + ai[c];
      }
#pragma unroll
      for (int m = 0; m < KM; ++m) {
        const int idx = ((lane + 32 * m) * i2) & (M - 1);
        const float fr = rr[idx], fi = ri[idx], fs = fr + fi;
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          q1[m][c] = fmaf(fr, ar[c], q1[m][c]);
          q2[m][c] = fmaf(fi, ai[c], q2[m][c]);
          q3[m][c] = fmaf(fs, as[c], q3[m][c]);
        }
      }
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
                                            long long batch, int logn1) {
  constexpr int LOGW = LOGM - LOGC, W = 1 << LOGW;
  // i2 per staged run (a cluster's columns come from one block at a time)
  constexpr int CH = W < 32 ? W : 32;
  extern __shared__ float4 smem4[];
  const int n1 = 1 << logn1, logn = logn1 + LOGM;
  const int logr = LOGC ? 0 : LOG_BLOCK_POINTS - logn;  // rows per block
  const int rows = 1 << logr;
  const int words = padded_words(BLOCK_POINTS);
  float* sr = reinterpret_cast<float*>(smem4);
  float* si = sr + words;
  float* rr = si + words;  // W_128^k, k < 128
  float* ri = rr + M;
  float* stg = ri + M;  // clusters: per warp 2 x TN x CH staged floats
  float2* tw1 = reinterpret_cast<float2*>(stg + (LOGC ? WARPS * 2 * TN * CH : 0));

  const int c = LOGC ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const long long row0 = LOGC ? static_cast<long long>(blockIdx.x >> LOGC)
                              : static_cast<long long>(blockIdx.x) << logr;
  const long long left = batch - row0;
  const int valid_rows = static_cast<int>(left < rows ? left : rows);
  const long long base = row0 << logn;

  load_twiddles(tw1, n1, nullptr, nullptr);
  for (int k = threadIdx.x; k < M; k += blockDim.x) {
    rr[k] = f2r[M + k];
    ri[k] = f2i[M + k];
  }
  // shared (i1, r, w): element (r, i1, c*W + w) of the block's rows
  for (int g = threadIdx.x; g < BLOCK_POINTS / 4; g += blockDim.x) {
    const int w = 4 * (g & (W / 4 - 1));
    const int i1 = (g >> (LOGW - 2)) & (n1 - 1);
    const int r = g >> (LOGW - 2 + logn1);
    const int s = pad(((i1 << logr) + r) * W + w);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (r < valid_rows) {
      const long long off = base + (static_cast<long long>(r) << logn) + i1 * M + c * W + w;
      a = __ldg(reinterpret_cast<const float4*>(re + off));
      b = __ldg(reinterpret_cast<const float4*>(im + off));
    }
    *reinterpret_cast<float4*>(sr + s) = a;
    *reinterpret_cast<float4*>(si + s) = b;
  }
  __syncthreads();

  // phase 1: F(n1) over i1 for all R*W sequences (the contiguous axis)
  phastft::dif_fft(sr, si, logn1, logr + LOGW, 1, rows * W, true, tw1);
  // phase 2: shared row p of the (i1, r) axis holds k1 = bitrev(p)
  for (int e = threadIdx.x; e < BLOCK_POINTS; e += blockDim.x) {
    const int i2 = c * W + (e & (W - 1));
    const int k1 = bitrev(e >> (logr + LOGW), logn1);
    const float cs = __ldg(cr + k1 * M + i2), sn = __ldg(ci + k1 * M + i2);
    const int s = pad(e);
    const float x = sr[s], y = si[s];
    sr[s] = x * cs - y * sn;
    si[s] = x * sn + y * cs;
  }
  if (LOGC) cg::this_cluster().sync();
  else __syncthreads();

  // phase 3: warp tile = columns j in [8*warp, 8*warp + 8) of the block's
  // 64. One block: column j is shared row j (j = p*R + r). A cluster:
  // column j is k1 = 64c + j, row bitrev(k1) of the blocks' (i1, w) slabs.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = warp * TN;
  float q1[KM][TN], q2[KM][TN], q3[KM][TN];
#pragma unroll
  for (int m = 0; m < KM; ++m)
#pragma unroll
    for (int j = 0; j < TN; ++j) q1[m][j] = q2[m][j] = q3[m][j] = 0.f;
  if (LOGC == 0) {
    const int row = col0 * padded_words(M);  // a 128-point row is 144 words
    contract<M>(sr + row, si + row, padded_words(M), 0, rr, ri, lane, q1, q2, q3);
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    float* sgr = stg + warp * 2 * TN * CH;
    float* sgi = sgr + TN * CH;
#pragma unroll 1
    for (int i0 = 0; i0 < M; i0 += CH) {
      const float* xr = cluster.map_shared_rank(sr, static_cast<unsigned>(i0 >> LOGW));
      const float* xi = cluster.map_shared_rank(si, static_cast<unsigned>(i0 >> LOGW));
      for (int e = lane; e < TN * CH; e += 32) {
        const int j = e / CH, i = e % CH;
        const int p = bitrev(COLS * c + col0 + j, logn1);
        const int s = pad(p * W + (i0 & (W - 1)) + i);
        sgr[e] = xr[s];
        sgi[e] = xi[s];
      }
      __syncwarp();
      contract<CH>(sgr, sgi, CH, i0, rr, ri, lane, q1, q2, q3);
      __syncwarp();
    }
  }
  // every read of the data (a cluster's remote ones too) precedes the stores
  if (LOGC) cg::this_cluster().sync();
  else __syncthreads();

  // stage the output in natural order: one block, local X index
  // r*n + k1 + n1*k2; a cluster block, k2*64 + (k1 - 64c)
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = col0 + j;
    int at;
    if (LOGC == 0) {
      const int r = col & (rows - 1);
      at = (r << logn) + bitrev(col >> logr, logn1);
    } else {
      at = col;
    }
#pragma unroll
    for (int m = 0; m < KM; ++m) {
      const int k2 = lane + 32 * m;
      const int s = pad(at + (LOGC ? k2 * COLS : k2 << logn1));
      sr[s] = q1[m][j] - q2[m][j];
      si[s] = q3[m][j] - q1[m][j] - q2[m][j];
    }
  }
  __syncthreads();

  for (int g = threadIdx.x; g < BLOCK_POINTS / 4; g += blockDim.x) {
    long long o;
    if (LOGC == 0) {
      if ((4 * g) >> logn >= valid_rows) continue;
      o = base + 4 * g;
    } else {  // 64 contiguous floats per k2: 16 float4s
      o = base + static_cast<long long>(g >> 4) * n1 + COLS * c + 4 * (g & 15);
    }
    const int s = pad(4 * g);
    *reinterpret_cast<float4*>(ore + o) = *reinterpret_cast<const float4*>(sr + s);
    *reinterpret_cast<float4*>(oim + o) = *reinterpret_cast<const float4*>(si + s);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
hybrid_kernel(const float* __restrict__ re, const float* __restrict__ im,
              const float* __restrict__ f2r, const float* __restrict__ f2i,
              const float* __restrict__ cr, const float* __restrict__ ci,
              float* __restrict__ ore, float* __restrict__ oim, long long batch, int logn1) {
  hybrid_body<0>(re, im, f2r, f2i, cr, ci, ore, oim, batch, logn1);
}

#define PHASTFT_HYBRID_CLUSTER(LOGC)                                                     \
  __global__ void __cluster_dims__(1 << LOGC, 1, 1) __launch_bounds__(THREADS, 1)        \
  hybrid_cluster##LOGC(const float* __restrict__ re, const float* __restrict__ im,       \
                       const float* __restrict__ f2r, const float* __restrict__ f2i,     \
                       const float* __restrict__ cr, const float* __restrict__ ci,       \
                       float* __restrict__ ore, float* __restrict__ oim, long long batch, \
                       int logn1) {                                                      \
    hybrid_body<LOGC>(re, im, f2r, f2i, cr, ci, ore, oim, batch, logn1);                \
  }

PHASTFT_HYBRID_CLUSTER(1)  // n1 = 128
PHASTFT_HYBRID_CLUSTER(2)  // n1 = 256
PHASTFT_HYBRID_CLUSTER(3)  // n1 = 512

template <typename Kernel>
int launch(Kernel kernel, int logc, const float* re, const float* im, const float* f2r,
           const float* f2i, const float* cr, const float* ci, float* ore, float* oim,
           long long batch, int n1, cudaStream_t s) {
  const int logn1 = phastft::ilog2(n1);
  const int logr = logc ? 0 : LOG_BLOCK_POINTS - LOGM - logn1;
  const long long blocks = ((batch + (1LL << logr) - 1) >> logr) << logc;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int ch = (M >> logc) < 32 ? (M >> logc) : 32;
  const size_t smem = 2 * sizeof(float) * padded_words(BLOCK_POINTS) + 2 * sizeof(float) * M +
                      (logc ? sizeof(float) * WARPS * 2 * TN * ch : 0) +
                      sizeof(float2) * (n1 / 2);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, s>>>(re, im, f2r, f2i, cr, ci, ore,
                                                              oim, batch, logn1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// re, im, ore, oim: (batch, n1*128), n1 = 2..512 a power of two. f2r, f2i:
// the planner's F(128) (row 1 is read); cr, ci: the (n1, 128) correction
// W_n^(k1*i2). Returns the CUDA error code of the launch (0 on success).
extern "C" int phastft_hybrid(const float* re, const float* im, const float* f2r,
                              const float* f2i, const float* cr, const float* ci, float* ore,
                              float* oim, long long batch, int n1, void* stream) {
  if (batch < 1 || !phastft::is_pow2(n1) || n1 < 2 || n1 > 512 || f2r == nullptr ||
      f2i == nullptr || cr == nullptr || ci == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n1 == 128) return launch(hybrid_cluster1, 1, re, im, f2r, f2i, cr, ci, ore, oim, batch, n1, s);
  if (n1 == 256) return launch(hybrid_cluster2, 2, re, im, f2r, f2i, cr, ci, ore, oim, batch, n1, s);
  if (n1 == 512) return launch(hybrid_cluster3, 3, re, im, f2r, f2i, cr, ci, ore, oim, batch, n1, s);
  return launch(hybrid_kernel, 0, re, im, f2r, f2i, cr, ci, ore, oim, batch, n1, s);
}
