// Leaf FFT: the whole length-n DFT of every row, n = 2..2^15, planar f32,
// for sm_90a.
//
// Replaces: phastft_tpu/ops/pallas_leaf.py, leaf_fft_pallas (the
// two-factor leaf n = n1*128, n1 = 2..256), and the XLA leaves the JAX
// package runs below it (ops/mxu.py leaf_fft_mxu at n = 128,
// ops/stockham.py tiny_fft at n < 128).
//
// Row x of length n = n1*m (m = 128, or m = n and n1 = 1 below 128),
// x[i1*m + i2]:
//   t[k1, i2] = sum_i1 W_n1^(k1*i1) x[i1, i2]        (F(n1) over i1)
//   u[k1, i2] = t[k1, i2] * W_n^(k1*i2)               (planner table cr, ci)
//   X[k1 + n1*k2] = sum_i2 W_m^(k2*i2) u[k1, i2]      (F(m) over i2)
//
// Bound: memory. Each element is read once and written once, 16 B per
// complex element, against ~5*log2(n) flops per element.
//
// Design against that bound:
// - Up to 2^14 points a block holds R = max(1, 8192/n) whole rows in
//   shared memory, laid out (i1, r, i2), so that F(n1) runs over all R*m
//   columns at once (stride R*m) and F(m) over all n1*R rows (stride 1):
//   one radix pass serves every row of the block, and device memory is
//   touched once each way. Rows go in gridDim.x (any batch); the last
//   block masks its missing rows.
// - Loads and stores are contiguous float4s: the transposed output order
//   X[k1 + n1*k2] is gathered from shared memory, not scattered to device
//   memory.
// - At 2^15 a row (256 KB) does not fit one block's 227 KB, so a cluster
//   of 2 blocks holds it: block c runs F(256) and the correction on the
//   columns i2 in [64c, 64c + 64), the two trade halves through
//   distributed shared memory (read into registers, cluster barrier,
//   write), and block c then runs F(128) on the rows k1 in
//   [128c, 128c + 128) and stores 128 contiguous floats per k2.
//
// Twiddles come from the planner's tables, so this kernel computes from
// the same bits as the plain version: W_n1^k is row 1 of F(n1), W_128^k
// row 1 of F(128), and W_n^(k1*i2) the (n1, 128) correction table. Below
// 128 points (no table) W_m^k is formed from the exact phase with
// sincospi in double, rounded once to float.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fft_smem.cuh"

namespace cg = cooperative_groups;
using phastft::bitrev;
using phastft::load_twiddles;
using phastft::pad;
using phastft::padded_words;

namespace {

// log2 of the points a block holds below 2^14 (R = 2^13 / n rows).
constexpr int LOG_BLOCK_POINTS = 13;
constexpr int THREADS = 512;
constexpr int CLUSTER_THREADS = 1024;
// Complex elements each thread carries through the cluster exchange.
constexpr int EXCHANGE_PER_THREAD = 16384 / CLUSTER_THREADS;

__global__ void __launch_bounds__(THREADS)
leaf_kernel(const float* __restrict__ re, const float* __restrict__ im,
            const float* __restrict__ f1r, const float* __restrict__ f1i,
            const float* __restrict__ f2r, const float* __restrict__ f2i,
            const float* __restrict__ cr, const float* __restrict__ ci,
            float* __restrict__ ore, float* __restrict__ oim, long long batch,
            int logn1, int logm, int logr) {
  extern __shared__ float4 smem4[];
  const int n1 = 1 << logn1, m = 1 << logm, rows = 1 << logr;
  const int logn = logn1 + logm;
  const int points = rows << logn;
  const int words = padded_words(points);
  float* sr = reinterpret_cast<float*>(smem4);
  float* si = sr + words;
  float2* tw1 = reinterpret_cast<float2*>(si + words);  // W_n1^k, k < n1/2
  float2* tw2 = tw1 + n1 / 2;                           // W_m^k, k < m/2

  const long long row0 = static_cast<long long>(blockIdx.x) << logr;
  const long long left = batch - row0;
  const int valid = static_cast<int>((left < rows ? left : rows) << logn);
  const long long base = row0 << logn;

  load_twiddles(tw1, n1, f1r, f1i);
  load_twiddles(tw2, m, f2r, f2i);
  // local flat index f = r*n + i1*m + i2 -> shared (i1, r, i2)
  for (int f = 4 * threadIdx.x; f < points; f += 4 * blockDim.x) {
    const int r = f >> logn, j = f & ((1 << logn) - 1);
    const int w = pad(((j >> logm) << (logr + logm)) + (r << logm) + (j & (m - 1)));
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (f + 4 <= valid) {
      a = __ldg(reinterpret_cast<const float4*>(re + base + f));
      b = __ldg(reinterpret_cast<const float4*>(im + base + f));
    } else if (f < valid) {  // rows of 2 points: the last row ends mid-float4
      a.x = re[base + f];
      b.x = im[base + f];
      if (f + 1 < valid) {
        a.y = re[base + f + 1];
        b.y = im[base + f + 1];
      }
    }
    *reinterpret_cast<float4*>(sr + w) = a;
    *reinterpret_cast<float4*>(si + w) = b;
  }
  __syncthreads();

  if (n1 > 1) {
    // F(n1) over i1: R*m sequences (the contiguous axis), stride R*m
    phastft::dif_fft(sr, si, logn1, logr + logm, 1, rows * m, true, tw1);
    // shared row p of the (i1, r) axis holds k1 = bitrev(p): W_n^(k1*i2)
    for (int e = threadIdx.x; e < points; e += blockDim.x) {
      const int i2 = e & (m - 1);
      const int k1 = bitrev(e >> (logr + logm), logn1);
      const float c = __ldg(cr + k1 * m + i2), s = __ldg(ci + k1 * m + i2);
      const int w = pad(e);
      const float x = sr[w], y = si[w];
      sr[w] = x * c - y * s;
      si[w] = x * s + y * c;
    }
    __syncthreads();
  }

  // F(m) along every row of m contiguous elements: n1*R sequences
  phastft::dif_fft(sr, si, logm, logn1 + logr, m, 1, false, tw2);

  // out[r*n + k1 + n1*k2] = shared (bitrev(k1), r, bitrev(k2))
  for (int f = 4 * threadIdx.x; f < valid; f += 4 * blockDim.x) {
    float vr[4], vi[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = (f + u) >> logn, k = (f + u) & ((1 << logn) - 1);
      const int k1 = k & (n1 - 1), k2 = k >> logn1;
      const int w = pad((bitrev(k1, logn1) << (logr + logm)) + (r << logm) +
                        bitrev(k2, logm));
      vr[u] = sr[w];
      vi[u] = si[w];
    }
    if (f + 4 <= valid) {
      *reinterpret_cast<float4*>(ore + base + f) = make_float4(vr[0], vr[1], vr[2], vr[3]);
      *reinterpret_cast<float4*>(oim + base + f) = make_float4(vi[0], vi[1], vi[2], vi[3]);
    } else {
      for (int u = 0; u < 4 && f + u < valid; ++u) {
        ore[base + f + u] = vr[u];
        oim[base + f + u] = vi[u];
      }
    }
  }
}

// n = 2^15 = 256 x 128, one row per cluster of 2 blocks.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(CLUSTER_THREADS)
leaf_cluster_kernel(const float* __restrict__ re, const float* __restrict__ im,
                    const float* __restrict__ f1r, const float* __restrict__ f1i,
                    const float* __restrict__ f2r, const float* __restrict__ f2i,
                    const float* __restrict__ cr, const float* __restrict__ ci,
                    float* __restrict__ ore, float* __restrict__ oim) {
  constexpr int N1 = 256, LOGN1 = 8, M = 128, LOGM = 7, HALF = 64, N = N1 * M;
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int words = padded_words(N / 2);
  float* sr = reinterpret_cast<float*>(smem4);
  float* si = sr + words;
  float2* tw1 = reinterpret_cast<float2*>(si + words);
  float2* tw2 = tw1 + N1 / 2;

  const int c = static_cast<int>(cluster.block_rank());
  const long long base = (static_cast<long long>(blockIdx.x) >> 1) * N;

  load_twiddles(tw1, N1, f1r, f1i);
  load_twiddles(tw2, M, f2r, f2i);
  // columns i2 in [64c, 64c + 64) of every i1, shared (i1, i2 - 64c)
  for (int e = threadIdx.x; e < N1 * HALF / 4; e += blockDim.x) {
    const int i1 = e >> 4, v = e & 15;
    const long long off = base + i1 * M + HALF * c + 4 * v;
    const int w = pad(i1 * HALF + 4 * v);
    *reinterpret_cast<float4*>(sr + w) = __ldg(reinterpret_cast<const float4*>(re + off));
    *reinterpret_cast<float4*>(si + w) = __ldg(reinterpret_cast<const float4*>(im + off));
  }
  __syncthreads();

  phastft::dif_fft(sr, si, LOGN1, 6, 1, HALF, true, tw1);
  for (int e = threadIdx.x; e < N / 2; e += blockDim.x) {
    const int i2 = HALF * c + (e & (HALF - 1));
    const int k1 = bitrev(e >> 6, LOGN1);
    const float cs = __ldg(cr + k1 * M + i2), sn = __ldg(ci + k1 * M + i2);
    const int w = pad(e);
    const float x = sr[w], y = si[w];
    sr[w] = x * cs - y * sn;
    si[w] = x * sn + y * cs;
  }

  // exchange: block c gathers (k1 - 128c, i2) for k1 in [128c, 128c + 128)
  // from both blocks into registers, then overwrites its own buffer
  cluster.sync();
  float xr[EXCHANGE_PER_THREAD], xi[EXCHANGE_PER_THREAD];
#pragma unroll
  for (int j = 0; j < EXCHANGE_PER_THREAD; ++j) {
    const int e = threadIdx.x + j * CLUSTER_THREADS;
    const int kl = e >> 7, i2 = e & (M - 1);
    const int w = pad(bitrev(M * c + kl, LOGN1) * HALF + (i2 & (HALF - 1)));
    const unsigned src = static_cast<unsigned>(i2 >> 6);
    xr[j] = cluster.map_shared_rank(sr, src)[w];
    xi[j] = cluster.map_shared_rank(si, src)[w];
  }
  cluster.sync();
#pragma unroll
  for (int j = 0; j < EXCHANGE_PER_THREAD; ++j) {
    const int w = pad(threadIdx.x + j * CLUSTER_THREADS);
    sr[w] = xr[j];
    si[w] = xi[j];
  }
  __syncthreads();

  // F(128) along each of the 128 rows k1 - 128c
  phastft::dif_fft(sr, si, LOGM, 7, M, 1, false, tw2);

  // out[k1 + 256*k2], k1 in [128c, 128c + 128): 128 contiguous floats per k2
  for (int e = threadIdx.x; e < N / 8; e += blockDim.x) {
    const int k2 = e >> 5, kl = 4 * (e & 31);
    float vr[4], vi[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int w = pad((kl + u) * M + bitrev(k2, LOGM));
      vr[u] = sr[w];
      vi[u] = si[w];
    }
    const long long o = base + static_cast<long long>(k2) * N1 + M * c + kl;
    *reinterpret_cast<float4*>(ore + o) = make_float4(vr[0], vr[1], vr[2], vr[3]);
    *reinterpret_cast<float4*>(oim + o) = make_float4(vi[0], vi[1], vi[2], vi[3]);
  }
}

}  // namespace

// re, im, ore, oim: (batch, n) with n = n1*m; m = 128 with n1 = 1..256, or
// n1 = 1 and m = 2..64. f1r/f1i: F(n1) (n1 >= 2, else unused), f2r/f2i:
// F(128) (m = 128, else NULL: the twiddles come from the exact phase),
// cr/ci: the (n1, 128) correction (n1 >= 2). Returns the CUDA error code of
// the launch (0 on success).
extern "C" int phastft_leaf(const float* re, const float* im, const float* f1r,
                            const float* f1i, const float* f2r, const float* f2i,
                            const float* cr, const float* ci, float* ore, float* oim,
                            long long batch, int n1, int m, void* stream) {
  const bool tiny = m < 128;
  if (batch < 1 || !phastft::is_pow2(n1) || !phastft::is_pow2(m) || n1 > 256 ||
      (tiny && (n1 != 1 || m < 2 || f2r != nullptr)) || (!tiny && m != 128) ||
      (!tiny && f2r == nullptr) || (n1 > 1 && (f1r == nullptr || cr == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int logn1 = phastft::ilog2(n1), logm = phastft::ilog2(m);
  if (n1 == 256) {
    if (batch > 0x3fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = 2 * sizeof(float) * padded_words(n1 * m / 2) +
                        sizeof(float2) * (n1 / 2 + m / 2);
    cudaError_t err = cudaFuncSetAttribute(
        leaf_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    leaf_cluster_kernel<<<static_cast<unsigned>(2 * batch), CLUSTER_THREADS, smem, s>>>(
        re, im, f1r, f1i, f2r, f2i, cr, ci, ore, oim);
    return static_cast<int>(cudaGetLastError());
  }
  const int logn = logn1 + logm;
  const int logr = logn < LOG_BLOCK_POINTS ? LOG_BLOCK_POINTS - logn : 0;
  const long long blocks = (batch + (1LL << logr) - 1) >> logr;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * sizeof(float) * padded_words(1 << (logn + logr)) +
                      sizeof(float2) * (n1 / 2 + m / 2);
  cudaError_t err = cudaFuncSetAttribute(
      leaf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  leaf_kernel<<<static_cast<unsigned>(blocks), THREADS, smem, s>>>(
      re, im, f1r, f1i, f2r, f2i, cr, ci, ore, oim, batch, logn1, logm, logr);
  return static_cast<int>(cudaGetLastError());
}
