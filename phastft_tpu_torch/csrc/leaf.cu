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
// Design against that bound: every block holds 8192 points (64 KB of data,
// ~74 KB of shared memory with padding and twiddles) and runs 256 threads
// at <= 80 registers, so three blocks share an SM and one block's loads and
// stores overlap another's radix passes (the design of leaf3.cu). Device
// memory is touched once each way.
// - Radix passes of up to four stages in registers (fft_smem.cuh
//   dif_fft16): F(128) in two trips (4 + 3), F(256) in two (4 + 4); the
//   correction is multiplied in the registers of the last F(n1) trip.
// - Up to 2^13 points a block holds R = 8192/n whole rows, laid out
//   (i1, r, i2), so that F(n1) runs over all R*m columns at once (stride
//   R*m) and F(m) over all n1*R rows (stride 1). Rows go in gridDim.x (any
//   batch); the last block masks its missing rows. Loads and stores are
//   contiguous float4s: the transposed output order X[k1 + n1*k2] is
//   gathered from shared memory, not scattered to device memory.
// - At 2^14 and 2^15 a row is held by a cluster of C = 2 or 4 blocks
//   (n1 = 64*C). Block c loads the W = 128/C columns i2 in [W c, W c + W)
//   of every i1 (all loads of a thread in flight before the first store),
//   runs F(n1) and the correction on them, and after a cluster barrier
//   reads its 64 rows k1 in [64c, 64c + 64) from every block (distributed
//   shared memory) straight into the first pass of F(128), a radix-16 over
//   i2 = r + 8j, holding the 32 results a thread in registers until a
//   second barrier says no block reads its buffer any more. The second
//   pass of F(128) runs in its own buffer; the stores write 64 contiguous
//   floats per k2 as 64-byte runs of four lanes.
//
// The store multiplies every output by out_scale (1 on a forward or an
// inner pass, 1/N where this pass ends an inverse): the same bits as a
// separate multiply after the kernel, without its second pass over memory.
//
// Twiddles come from the planner's tables, so this kernel computes from
// the same bits as the plain version: W_n1^k is row 1 of F(n1), W_128^k
// row 1 of F(128), and W_n^(k1*i2) the (n1, 128) correction table. Below
// 128 points (no table) W_m^k is formed from the exact phase with
// sincospi in double, rounded once to float.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "fft_smem.cuh"

namespace cg = cooperative_groups;
using phastft::bitrev;
using phastft::dif_fft16;
using phastft::load_twiddles;
using phastft::pad;
using phastft::padded_words;

namespace {

// log2 of the points a block holds (R = 2^13 / n rows below 2^14).
constexpr int LOG_BLOCK_POINTS = 13;
constexpr int LOCAL = 1 << LOG_BLOCK_POINTS;
constexpr int WORDS = padded_words(LOCAL);
constexpr int THREADS = 256;
constexpr int M = 128, LOGM = 7;
// Rows k1 a cluster block owns after the exchange.
constexpr int KROWS = 64;
// float4 loads (and stores) of each plane per thread in a cluster block.
constexpr int LOADS = LOCAL / 4 / THREADS;
// Exchange items per thread: (k1 - 64c, r), the radix-16 over i2 = r + 8j.
constexpr int ITEMS = KROWS * 8 / THREADS;

constexpr size_t smem_bytes(int n1, int m) {
  return 2 * sizeof(float) * WORDS + sizeof(float2) * (n1 / 2 + m / 2);
}

__global__ void __launch_bounds__(THREADS, 3)
leaf_kernel(const float* __restrict__ re, const float* __restrict__ im,
            const float* __restrict__ f1r, const float* __restrict__ f1i,
            const float* __restrict__ f2r, const float* __restrict__ f2i,
            const float* __restrict__ cr, const float* __restrict__ ci,
            float* __restrict__ ore, float* __restrict__ oim, long long batch,
            int logn1, int logm, int logr, float out_scale) {
  extern __shared__ float4 smem4[];
  const int n1 = 1 << logn1, m = 1 << logm, rows = 1 << logr;
  const int logn = logn1 + logm;
  const int points = rows << logn;
  float* sr = reinterpret_cast<float*>(smem4);
  float* si = sr + WORDS;
  float2* tw1 = reinterpret_cast<float2*>(si + WORDS);  // W_n1^k, k < n1/2
  float2* tw2 = tw1 + n1 / 2;                           // W_m^k, k < m/2

  const long long row0 = static_cast<long long>(blockIdx.x) << logr;
  const long long left = batch - row0;
  const int valid = static_cast<int>((left < rows ? left : rows) << logn);
  const long long base = row0 << logn;

  load_twiddles(tw1, n1, f1r, f1i);
  load_twiddles(tw2, m, f2r, f2i);
  // local flat index f = r*n + i1*m + i2 -> shared (i1, r, i2)
#pragma unroll 4
  for (int f = 4 * threadIdx.x; f < points; f += 4 * THREADS) {
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

  // F(n1) over i1: R*m sequences (the contiguous axis), stride R*m; the
  // correction W_n^(k1*i2) folded into its last trip
  if (n1 > 1)
    dif_fft16(sr, si, logn1, logn1, logr + logm, 1, rows * m, true, tw1, cr, ci, true, 0);
  // F(m) along every row of m contiguous elements: n1*R sequences
  dif_fft16(sr, si, logm, logm, logn1 + logr, m, 1, false, tw2, nullptr, nullptr, false, 0);

  // out[r*n + k1 + n1*k2] = shared (bitrev(k1), r, bitrev(k2))
  for (int f = 4 * threadIdx.x; f < valid; f += 4 * THREADS) {
    float vr[4], vi[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = (f + u) >> logn, k = (f + u) & ((1 << logn) - 1);
      const int k1 = k & (n1 - 1), k2 = k >> logn1;
      const int w = pad((bitrev(k1, logn1) << (logr + logm)) + (r << logm) +
                        bitrev(k2, logm));
      vr[u] = sr[w] * out_scale;
      vi[u] = si[w] * out_scale;
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

// n = n1 * 128, n1 = 64 << LOGC, one row per cluster of 2^LOGC blocks (the
// cluster size is set at launch).
template <int LOGC>
__global__ void __launch_bounds__(THREADS, 3)
leaf_cluster(const float* __restrict__ re, const float* __restrict__ im,
             const float* __restrict__ f1r, const float* __restrict__ f1i,
             const float* __restrict__ f2r, const float* __restrict__ f2i,
             const float* __restrict__ cr, const float* __restrict__ ci,
             float* __restrict__ ore, float* __restrict__ oim, float out_scale) {
  constexpr int LOGN1 = 6 + LOGC, N1 = 1 << LOGN1;
  constexpr int LOGW = LOGM - LOGC, W = 1 << LOGW;  // columns per block
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  float* sr = reinterpret_cast<float*>(smem4);
  float* si = sr + WORDS;
  float2* tw1 = reinterpret_cast<float2*>(si + WORDS);
  float2* tw2 = tw1 + N1 / 2;

  const int c = static_cast<int>(cluster.block_rank());
  const long long base = (static_cast<long long>(blockIdx.x) >> LOGC) * (N1 * M);

  load_twiddles(tw1, N1, f1r, f1i);
  load_twiddles(tw2, M, f2r, f2i);
  // columns i2 in [W*c, W*c + W) of every i1, shared (i1, i2 - W*c); every
  // load of a thread is in flight before the first store
  float4 a[LOADS], b[LOADS];
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int e = threadIdx.x + j * THREADS;
    const long long off = base + (e >> (LOGW - 2)) * M + W * c + 4 * (e & (W / 4 - 1));
    a[j] = __ldg(reinterpret_cast<const float4*>(re + off));
    b[j] = __ldg(reinterpret_cast<const float4*>(im + off));
  }
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int e = threadIdx.x + j * THREADS;
    const int w = pad((e >> (LOGW - 2)) * W + 4 * (e & (W / 4 - 1)));
    *reinterpret_cast<float4*>(sr + w) = a[j];
    *reinterpret_cast<float4*>(si + w) = b[j];
  }
  __syncthreads();

  // F(n1) over i1: W sequences (the contiguous axis), stride W, the
  // correction folded into the last trip
  dif_fft16(sr, si, LOGN1, LOGN1, LOGW, 1, W, true, tw1, cr, ci, true, W * c);
  cluster.sync();

  // exchange, straight into the first pass of F(128): item (k_l, r) takes
  // i2 = r + 8j, j < 16, of row k1 = 64c + k_l, held at shared row
  // bitrev(k1) of block i2 / W, column i2 mod W
  float yr[ITEMS][16], yi[ITEMS][16];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int e = threadIdx.x + it * THREADS;
    const int r = e & 7, kl = e >> 3;
    const int row = bitrev(KROWS * c + kl, LOGN1) * W;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i2 = r + 8 * j;
      const unsigned src = static_cast<unsigned>(i2 >> LOGW);
      const int w = pad(row + (i2 & (W - 1)));
      yr[it][j] = cluster.map_shared_rank(sr, src)[w];
      yi[it][j] = cluster.map_shared_rank(si, src)[w];
    }
    phastft::dif_group<4>(yr[it], yi[it], r, 3, LOGM, LOGM, tw2);
  }
  // no block reads another's buffer past this point
  cluster.sync();
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int e = threadIdx.x + it * THREADS;
    const int r = e & 7, kl = e >> 3;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int w = pad(kl * M + r + 8 * j);
      sr[w] = yr[it][j];
      si[w] = yi[it][j];
    }
  }
  __syncthreads();

  // the last three stages of F(128) along each of the 64 rows k1 - 64c
  dif_fft16(sr, si, LOGM, 3, 6, M, 1, false, tw2, nullptr, nullptr, false, 0);

  // out[k1 + n1*k2], k1 in [64c, 64c + 64): 64 contiguous floats per k2,
  // written by four neighbouring lanes as 64-byte runs; the other lanes
  // take 8 k2 whose bit-reversed columns differ in their low 3 bits, so a
  // warp's shared-memory reads are 4-way conflicted at most
#pragma unroll 2
  for (int j = 0; j < LOADS; ++j) {
    const int lane = threadIdx.x & 31, rest = (threadIdx.x >> 5) + j * (THREADS / 32);
    const int kl = 4 * ((lane & 3) + 4 * (rest & 3));
    const int kb = 16 * (lane >> 2) + (rest >> 2);
    const int col = bitrev(kb, LOGM);
    float vr[4], vi[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int w = pad((kl + u) * M + col);
      vr[u] = sr[w] * out_scale;
      vi[u] = si[w] * out_scale;
    }
    const long long o = base + static_cast<long long>(kb) * N1 + KROWS * c + kl;
    *reinterpret_cast<float4*>(ore + o) = make_float4(vr[0], vr[1], vr[2], vr[3]);
    *reinterpret_cast<float4*>(oim + o) = make_float4(vi[0], vi[1], vi[2], vi[3]);
  }
}

using ClusterKernel = void (*)(const float*, const float*, const float*, const float*,
                               const float*, const float*, const float*, const float*,
                               float*, float*, float);

ClusterKernel cluster_kernel(int logc) {
  return logc == 1 ? leaf_cluster<1>   // n = 2^14, n1 = 128
                   : leaf_cluster<2>;  // n = 2^15, n1 = 256
}

// Clusters of 2^logc blocks resident at once, or minus the CUDA error code.
int resident(int logc) {
  return phastft::resident_clusters(cluster_kernel(logc), 1 << logc, THREADS,
                                    smem_bytes(64 << logc, M));
}

}  // namespace

// re, im, ore, oim: (batch, n) with n = n1*m; m = 128 with n1 = 1..256, or
// n1 = 1 and m = 2..64. f1r/f1i: F(n1) (n1 >= 2, else unused), f2r/f2i:
// F(128) (m = 128, else NULL: the twiddles come from the exact phase),
// cr/ci: the (n1, 128) correction (n1 >= 2); out_scale: the factor of every
// output (1, or 1/N where the leaf ends an inverse). Returns the CUDA error
// code of the launch (0 on success).
extern "C" int phastft_leaf(const float* re, const float* im, const float* f1r,
                            const float* f1i, const float* f2r, const float* f2i,
                            const float* cr, const float* ci, float* ore, float* oim,
                            long long batch, int n1, int m, double out_scale,
                            void* stream) {
  const bool tiny = m < 128;
  if (batch < 1 || !phastft::is_pow2(n1) || !phastft::is_pow2(m) || n1 > 256 ||
      (tiny && (n1 != 1 || m < 2 || f2r != nullptr)) || (!tiny && m != 128) ||
      (!tiny && f2r == nullptr) || (n1 > 1 && (f1r == nullptr || cr == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = static_cast<float>(out_scale);
  const int logn1 = phastft::ilog2(n1), logm = phastft::ilog2(m);
  if (n1 >= 128) {
    const int logc = logn1 - 6;
    static int resident[3] = {0, 0, 0};  // per logc, queried on first use
    return phastft::launch_clusters(cluster_kernel(logc), 1 << logc, batch << logc, THREADS,
                                    smem_bytes(n1, M), s, resident[logc], re, im, f1r, f1i,
                                    f2r, f2i, cr, ci, ore, oim, scale);
  }
  const int logn = logn1 + logm;
  const int logr = LOG_BLOCK_POINTS - logn;
  const long long blocks = (batch + (1LL << logr) - 1) >> logr;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n1, m);
  cudaError_t err = cudaFuncSetAttribute(
      leaf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(leaf_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  leaf_kernel<<<static_cast<unsigned>(blocks), THREADS, smem, s>>>(
      re, im, f1r, f1i, f2r, f2i, cr, ci, ore, oim, batch, logn1, logm, logr, scale);
  return static_cast<int>(cudaGetLastError());
}

// The number of clusters of the leaf kernel at n1 = 128 or 256 (2 or 4
// blocks) the current device holds at once (the CUDA occupancy query), or
// minus the CUDA error code.
extern "C" int phastft_leaf_clusters(int n1) {
  if (n1 != 128 && n1 != 256) return -static_cast<int>(cudaErrorInvalidValue);
  return resident(phastft::ilog2(n1) - 6);
}
