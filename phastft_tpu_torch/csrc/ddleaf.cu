// dd (double-float) leaf FFT: the whole length-n DFT of every row,
// n = n1 * 128 with n1 = 1..512, four f32 planes per complex array, for
// sm_90a.
//
// Replaces: phastft_tpu/ops/pallas_dd.py, ddleaf_pallas (the dd leaf held
// in fast memory: column steps, dd correction, transpose, lane steps).
//
// Row x of length n = n1 * 128, x[i1*128 + i2], in dd arithmetic:
//   t[k1, i2] = sum_i1 W_n1^(k1*i1) x[i1, i2]          (F(n1) over i1)
//   u[k1, i2] = t[k1, i2] * W_n^(k1*i2)                 (planner table)
//   X[k1 + n1*k2] = sum_i2 W_128^(k2*i2) u[k1, i2]      (F(128) over i2)
//
// Bound: near the balance point, as the dd column kernel is: 32 B per
// complex element against 47 flops per element per radix-2 stage plus 50
// for the correction (dd.cuh); at n = 2^16 that is 802 flops per element.
//
// Design:
// - A dd point is 16 B, so a block's shared memory holds 8 K points. Up to
//   n = 2^13 one block holds R = max(1, 4096 / n) whole rows (one row at
//   2^13), laid out (i1, r, i2) as the f32 leaf kernel lays them out: F(n1)
//   runs over all R * 128 columns at once and F(128) over all n1 * R rows,
//   and device memory is touched once each way. Rows go in gridDim.x (any
//   batch); the last block masks its missing rows.
// - Past 2^13 a row does not fit one block, so a cluster of C = n / 8192
//   blocks (2, 4, 8: the portable limit) holds it, with no scratch in
//   device memory. Block c runs F(n1) and the correction on the 128 / C
//   columns i2 in [c*128/C, (c+1)*128/C); the blocks trade through
//   distributed shared memory (each reads its 64 rows k1 in [64c, 64c + 64)
//   from all blocks into registers, cluster barrier, writes them to its own
//   buffer), and block c then runs F(128) on those rows and stores 64
//   contiguous floats per k2.
// - Loads and stores of device memory are contiguous float4s; the
//   transposed output order is gathered from shared memory.
// - Twiddles W_n1^k and W_128^k are dd pairs from tables the wrapper builds
//   on the host in f64; the correction is the planner's ddleaf{n1} table.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dd.cuh"

namespace cg = cooperative_groups;
using phastft::bitrev;
using phastft::pad;
using phastft::padded_words;
namespace ddk = phastft::ddk;

namespace {

constexpr int M = 128, LOGM = 7;
constexpr int THREADS = 512;
// Points a cluster block holds, and rows k1 it owns after the exchange.
constexpr int LOCAL = 8192, KROWS = 64;
constexpr int PER_THREAD = LOCAL / THREADS;

__device__ __forceinline__ ddk::ddc table_at(const ddk::ConstQuad& t, int i) {
  return ddk::ddc{ddk::dd{__ldg(t.p[0] + i), __ldg(t.p[1] + i)},
                  ddk::dd{__ldg(t.p[2] + i), __ldg(t.p[3] + i)}};
}

__global__ void __launch_bounds__(THREADS)
ddleaf_kernel(ddk::ConstQuad x, const float* __restrict__ tw1t,
              const float* __restrict__ tw2t, ddk::ConstQuad corr, ddk::Quad out,
              long long batch, int logn1, int logr) {
  extern __shared__ float4 smem4[];
  const int n1 = 1 << logn1, rows = 1 << logr;
  const int logn = logn1 + LOGM;
  const int points = rows << logn;
  const int words = padded_words(points);
  const ddk::Planes s = ddk::make_planes(reinterpret_cast<float*>(smem4), words);
  float4* tw1 = reinterpret_cast<float4*>(s.p[0] + 4 * words);  // W_n1^k, k < n1/2
  float4* tw2 = tw1 + n1 / 2;                                   // W_128^k, k < 64

  const long long row0 = static_cast<long long>(blockIdx.x) << logr;
  const long long left = batch - row0;
  const int valid = static_cast<int>((left < rows ? left : rows) << logn);
  const long long base = row0 << logn;

  if (n1 > 1) ddk::load_twiddles(tw1, n1, tw1t);
  ddk::load_twiddles(tw2, M, tw2t);
  // local flat index f = r*n + i1*128 + i2 -> shared (i1, r, i2)
  for (int f = 4 * threadIdx.x; f < points; f += 4 * blockDim.x) {
    const int r = f >> logn, j = f & ((1 << logn) - 1);
    const int w = pad(((j >> LOGM) << (logr + LOGM)) + (r << LOGM) + (j & (M - 1)));
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (f < valid) v = __ldg(reinterpret_cast<const float4*>(x.p[p] + base + f));
      *reinterpret_cast<float4*>(s.p[p] + w) = v;
    }
  }
  __syncthreads();

  if (n1 > 1) {
    // F(n1) over i1: R*128 sequences (the contiguous axis), stride R*128
    ddk::dif_fft(s, logn1, logr + LOGM, 1, rows * M, true, tw1);
    // shared row p of the i1 axis holds k1 = bitrev(p): W_n^(k1*i2)
    for (int e = threadIdx.x; e < points; e += blockDim.x) {
      const int i2 = e & (M - 1);
      const int k1 = bitrev(e >> (logr + LOGM), logn1);
      const int w = pad(e);
      ddk::store(s, w, ddk::cmul(ddk::load(s, w), table_at(corr, k1 * M + i2)));
    }
    __syncthreads();
  }

  // F(128) along every row of 128 contiguous elements: n1*R sequences
  ddk::dif_fft(s, LOGM, logn1 + logr, M, 1, false, tw2);

  // out[r*n + k1 + n1*k2] = shared (bitrev(k1), r, bitrev(k2))
  for (int f = 4 * threadIdx.x; f < valid; f += 4 * blockDim.x) {
    float v[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = (f + u) >> logn, k = (f + u) & ((1 << logn) - 1);
      const int k1 = k & (n1 - 1), k2 = k >> logn1;
      const int w = pad((bitrev(k1, logn1) << (logr + LOGM)) + (r << LOGM) +
                        bitrev(k2, LOGM));
#pragma unroll
      for (int p = 0; p < 4; ++p) v[p][u] = s.p[p][w];
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
      *reinterpret_cast<float4*>(out.p[p] + base + f) =
          make_float4(v[p][0], v[p][1], v[p][2], v[p][3]);
  }
}

// One row of n = n1 * 128 points, n1 = 64 << LOGC, per cluster of 2^LOGC
// blocks.
template <int LOGC>
__device__ __forceinline__ void cluster_body(const ddk::ConstQuad& x, const float* tw1t,
                                             const float* tw2t,
                                             const ddk::ConstQuad& corr,
                                             const ddk::Quad& out) {
  constexpr int LOGN1 = 6 + LOGC, N1 = 1 << LOGN1;
  constexpr int LOGW = LOGM - LOGC, W = 1 << LOGW;  // columns per block
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int words = padded_words(LOCAL);
  const ddk::Planes s = ddk::make_planes(reinterpret_cast<float*>(smem4), words);
  float4* tw1 = reinterpret_cast<float4*>(s.p[0] + 4 * words);
  float4* tw2 = tw1 + N1 / 2;

  const int c = static_cast<int>(cluster.block_rank());
  const long long base = (static_cast<long long>(blockIdx.x) >> LOGC) * (N1 * M);

  ddk::load_twiddles(tw1, N1, tw1t);
  ddk::load_twiddles(tw2, M, tw2t);
  // columns i2 in [W*c, W*c + W) of every i1, shared (i1, i2 - W*c)
  for (int e = threadIdx.x; e < LOCAL / 4; e += blockDim.x) {
    const int i1 = e >> (LOGW - 2), v4 = e & (W / 4 - 1);
    const long long off = base + i1 * M + W * c + 4 * v4;
    const int w = pad(i1 * W + 4 * v4);
#pragma unroll
    for (int p = 0; p < 4; ++p)
      *reinterpret_cast<float4*>(s.p[p] + w) =
          __ldg(reinterpret_cast<const float4*>(x.p[p] + off));
  }
  __syncthreads();

  ddk::dif_fft(s, LOGN1, LOGW, 1, W, true, tw1);
  for (int e = threadIdx.x; e < LOCAL; e += blockDim.x) {
    const int i2 = W * c + (e & (W - 1));
    const int k1 = bitrev(e >> LOGW, LOGN1);
    const int w = pad(e);
    ddk::store(s, w, ddk::cmul(ddk::load(s, w), table_at(corr, k1 * M + i2)));
  }

  // exchange: block c gathers (k1 - 64c, i2) for k1 in [64c, 64c + 64) from
  // every block into registers, then overwrites its own buffer once every
  // block has read it
  cluster.sync();
  float xv[4][PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int e = threadIdx.x + j * THREADS;
    const int kl = e >> LOGM, i2 = e & (M - 1);
    const int w = pad(bitrev(KROWS * c + kl, LOGN1) * W + (i2 & (W - 1)));
    const unsigned src = static_cast<unsigned>(i2 >> LOGW);
#pragma unroll
    for (int p = 0; p < 4; ++p) xv[p][j] = cluster.map_shared_rank(s.p[p], src)[w];
  }
  cluster.sync();
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int w = pad(threadIdx.x + j * THREADS);
#pragma unroll
    for (int p = 0; p < 4; ++p) s.p[p][w] = xv[p][j];
  }
  __syncthreads();

  // F(128) along each of the 64 rows k1 - 64c
  ddk::dif_fft(s, LOGM, 6, M, 1, false, tw2);

  // out[k1 + n1*k2], k1 in [64c, 64c + 64): 64 contiguous floats per k2
  for (int e = threadIdx.x; e < LOCAL / 4; e += blockDim.x) {
    const int k2 = e >> 4, kl = 4 * (e & 15);
    float v[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int w = pad((kl + u) * M + bitrev(k2, LOGM));
#pragma unroll
      for (int p = 0; p < 4; ++p) v[p][u] = s.p[p][w];
    }
    const long long o = base + static_cast<long long>(k2) * N1 + KROWS * c + kl;
#pragma unroll
    for (int p = 0; p < 4; ++p)
      *reinterpret_cast<float4*>(out.p[p] + o) =
          make_float4(v[p][0], v[p][1], v[p][2], v[p][3]);
  }
}

#define PHASTFT_DDLEAF_CLUSTER(LOGC)                                                  \
  __global__ void __cluster_dims__(1 << LOGC, 1, 1) __launch_bounds__(THREADS)        \
  ddleaf_cluster##LOGC(ddk::ConstQuad x, const float* __restrict__ tw1t,              \
                       const float* __restrict__ tw2t, ddk::ConstQuad corr,           \
                       ddk::Quad out) {                                               \
    cluster_body<LOGC>(x, tw1t, tw2t, corr, out);                                     \
  }

PHASTFT_DDLEAF_CLUSTER(1)  // n = 2^14, n1 = 128
PHASTFT_DDLEAF_CLUSTER(2)  // n = 2^15, n1 = 256
PHASTFT_DDLEAF_CLUSTER(3)  // n = 2^16, n1 = 512

template <typename Kernel>
int launch_cluster(Kernel kernel, int logc, const ddk::ConstQuad& x, const float* tw1t,
                   const float* tw2t, const ddk::ConstQuad& corr, const ddk::Quad& out,
                   long long batch, int n1, cudaStream_t s) {
  if ((batch << logc) > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      4 * sizeof(float) * padded_words(LOCAL) + sizeof(float4) * (n1 / 2 + M / 2);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(batch << logc), THREADS, smem, s>>>(x, tw1t, tw2t, corr,
                                                                     out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x*, o*: the four planes (re_hi, re_lo, im_hi, im_lo) of (batch, n1 * 128)
// arrays, n1 = 1..512 a power of two. tw1t: four planes of n1/2 floats,
// W_n1^k (n1 >= 2, else unused); tw2t: four planes of 64 floats, W_128^k;
// c*: the (n1, 128) correction W_n^(k1*i2) (n1 >= 2, else unused). Returns
// the CUDA error code of the launch (0 on success).
extern "C" int phastft_ddleaf(const float* xrh, const float* xrl, const float* xih,
                              const float* xil, const float* tw1t, const float* tw2t,
                              const float* crh, const float* crl, const float* cih,
                              const float* cil, float* orh, float* orl, float* oih,
                              float* oil, long long batch, int n1, void* stream) {
  if (batch < 1 || !phastft::is_pow2(n1) || n1 > 512 || tw2t == nullptr ||
      (n1 > 1 && (tw1t == nullptr || crh == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ddk::ConstQuad x{{xrh, xrl, xih, xil}};
  const ddk::ConstQuad corr{{crh, crl, cih, cil}};
  const ddk::Quad out{{orh, orl, oih, oil}};
  if (n1 == 128)
    return launch_cluster(ddleaf_cluster1, 1, x, tw1t, tw2t, corr, out, batch, n1, s);
  if (n1 == 256)
    return launch_cluster(ddleaf_cluster2, 2, x, tw1t, tw2t, corr, out, batch, n1, s);
  if (n1 == 512)
    return launch_cluster(ddleaf_cluster3, 3, x, tw1t, tw2t, corr, out, batch, n1, s);
  const int logn1 = phastft::ilog2(n1);
  const int logn = logn1 + LOGM;
  int logr = logn < 12 ? 12 - logn : 0;  // rows per block: 4 K points
  while (logr > 0 && (1LL << (logr - 1)) >= batch) --logr;
  const long long blocks = (batch + (1LL << logr) - 1) >> logr;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 4 * sizeof(float) * padded_words(1 << (logn + logr)) +
                      sizeof(float4) * (n1 / 2 + M / 2);
  cudaError_t err = cudaFuncSetAttribute(
      ddleaf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = (1 << (logn + logr)) >= 8192 ? THREADS : 256;
  ddleaf_kernel<<<static_cast<unsigned>(blocks), threads, smem, s>>>(
      x, tw1t, tw2t, corr, out, batch, logn1, logr);
  return static_cast<int>(cudaGetLastError());
}
