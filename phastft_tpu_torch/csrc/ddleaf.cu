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
// Bound: FP32 instruction issue. dd arithmetic is single-rounded adds and
// multiplies (dd.cuh): a dd complex sum is 22 FP32 instructions, a product
// 42. Radix-4 with the trivial twiddles dropped takes 75.5 per point per
// radix-4 stage (44 at span 4); at n = 2^16 the kernel issues 614.5 per
// point (the correction's 42 included) against 32 B of device memory: at
// 132 SMs x 128 lanes x 1.98 GHz the instructions take ~2x the bytes' time.
//
// Design: nothing but latency stands between the two, so a block is small
// enough for two to share an SM and overlap one's memory with the other's
// arithmetic, and the trips through shared memory are few.
// - A block holds 4096 dd points (64 KB of data, 78,848 B of shared memory
//   with padding and twiddles) and runs 256 threads at <= 128 registers
//   (__launch_bounds__(256, 2)).
// - Radix-4 passes (dd.cuh dif4_pass): each thread takes 4 points through
//   two stages in registers, the last trip of an odd count a radix-8; the
//   products by -i are swaps, and a span-4 butterfly has none. The
//   correction is multiplied in the registers of the last F(n1) trip.
// - Up to n = 2^12 a block holds R = 4096 / n whole rows, laid out
//   (i1, r, i2) so that F(n1) runs over all R * 128 columns at once and
//   F(128) over all n1 * R rows. Rows go in gridDim.x (any batch); the last
//   block masks its missing rows.
// - From n = 2^13 a row of n1 = 32 * C points per column is held by a
//   cluster of C = 2, 4, 8, 16 blocks (16 is a non-portable cluster size,
//   set at launch; the entry refuses a shape no cluster of which fits the
//   device). Block c loads the W = 128 / C columns i2 in [W c, W c + W) of
//   every i1 (all loads of a thread in flight before the first store), runs
//   F(n1) and the correction on them, and after a cluster barrier reads its
//   32 rows k1 in [32c, 32c + 32) from every block straight into the first
//   radix-4 pass of F(128), holding the 16 results a thread in registers
//   until a second barrier says no block reads its buffer any more. The
//   rest of F(128) runs in its own buffer; the stores write 32 contiguous
//   floats per k2 and plane as 64-byte runs of four lanes.
// - Loads and stores of device memory are float4s; the transposed output
//   order is gathered from shared memory.
// - Twiddles W_n1^k and W_128^k are dd pairs from tables the wrapper builds
//   on the host in f64 (k < n/2; W^(k + n/2) = -W^k); the correction is the
//   planner's ddleaf{n1} table.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "dd.cuh"

namespace cg = cooperative_groups;
using phastft::bitrev;
using phastft::pad;
using phastft::padded_words;
namespace ddk = phastft::ddk;

namespace {

constexpr int M = 128, LOGM = 7;
constexpr int THREADS = 256;
// Points a block holds, and rows k1 a cluster block owns after the exchange.
constexpr int LOCAL = 4096, LOG_LOCAL = 12, KROWS = 32;
constexpr int WORDS = padded_words(LOCAL);
// float4 loads (and stores) of each plane per thread in a cluster block.
constexpr int LOADS = LOCAL / 4 / THREADS;
// Exchange items per thread: (k1 - 32c, r), the radix-4 over i2 = r + 32j.
constexpr int ITEMS = KROWS * 32 / THREADS;

constexpr size_t smem_bytes(int n1) {
  return 4 * sizeof(float) * WORDS + sizeof(float4) * (n1 / 2 + M / 2);
}

// The correction folded into the last F(n1) trip: output k1 of sequence q
// times corr[k1 * 128 + i2], i2 = col0 + (q mod 128).
struct LeafCorr {
  ddk::ConstQuad corr;
  int col0;
  __device__ __forceinline__ ddk::ddc operator()(ddk::ddc x, int k1, int q) const {
    const int i2 = col0 + (q & 127);
    return ddk::cmul(x, ddk::table_at(corr, i2 + (k1 << 7)));
  }
};

__global__ void __launch_bounds__(THREADS, 2)
ddleaf_kernel(ddk::ConstQuad x, const float* __restrict__ tw1t,
              const float* __restrict__ tw2t, ddk::ConstQuad corr, ddk::Quad out,
              long long batch, int logn1, int logr) {
  extern __shared__ float4 smem4[];
  const int n1 = 1 << logn1, rows = 1 << logr;
  const int logn = logn1 + LOGM;
  const int points = rows << logn;
  const ddk::Planes s = ddk::make_planes(reinterpret_cast<float*>(smem4), WORDS);
  float4* tw1 = reinterpret_cast<float4*>(s.p[0] + 4 * WORDS);  // W_n1^k, k < n1/2
  float4* tw2 = tw1 + n1 / 2;                                   // W_128^k, k < 64

  const long long row0 = static_cast<long long>(blockIdx.x) << logr;
  const long long left = batch - row0;
  const int valid = static_cast<int>((left < rows ? left : rows) << logn);
  const long long base = row0 << logn;

  if (n1 > 1) ddk::load_twiddles(tw1, n1, tw1t);
  ddk::load_twiddles(tw2, M, tw2t);
  // local flat index f = r*n + i1*128 + i2 -> shared (i1, r, i2)
#pragma unroll 4
  for (int f = 4 * threadIdx.x; f < points; f += 4 * THREADS) {
    const int r = f >> logn, j = f & ((1 << logn) - 1);
    const int w = pad(((j >> LOGM) << (logr + LOGM)) + (r << LOGM) + (j & (M - 1)));
    float4 v[4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
      v[p] = f < valid ? __ldg(reinterpret_cast<const float4*>(x.p[p] + base + f))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int p = 0; p < 4; ++p) *reinterpret_cast<float4*>(s.p[p] + w) = v[p];
  }
  __syncthreads();

  // F(n1) over i1: R*128 sequences (the contiguous axis), stride R*128; the
  // correction W_n^(k1*i2) folded into the last trip
  if (n1 > 1)
    ddk::dif4_fft(s, logn1, logn1, logr + LOGM, 1, rows * M, true, tw1, logn1,
                  LeafCorr{corr, 0}, true);
  // F(128) along every row of 128 contiguous elements: n1*R sequences
  ddk::dif4_fft(s, LOGM, LOGM, logn1 + logr, M, 1, false, tw2, LOGM, LeafCorr{corr, 0}, false);

  // out[r*n + k1 + n1*k2] = shared (bitrev(k1), r, bitrev(k2))
  for (int f = 4 * threadIdx.x; f < valid; f += 4 * THREADS) {
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

// One row of n = n1 * 128 points, n1 = 32 << LOGC, per cluster of 2^LOGC
// blocks (the cluster size is set at launch).
template <int LOGC>
__global__ void __launch_bounds__(THREADS, 2)
ddleaf_cluster(ddk::ConstQuad x, const float* __restrict__ tw1t,
               const float* __restrict__ tw2t, ddk::ConstQuad corr, ddk::Quad out) {
  constexpr int LOGN1 = 5 + LOGC, N1 = 1 << LOGN1;
  constexpr int LOGW = LOGM - LOGC, W = 1 << LOGW;  // columns per block
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const ddk::Planes s = ddk::make_planes(reinterpret_cast<float*>(smem4), WORDS);
  float4* tw1 = reinterpret_cast<float4*>(s.p[0] + 4 * WORDS);
  float4* tw2 = tw1 + N1 / 2;

  const int c = static_cast<int>(cluster.block_rank());
  const long long base = (static_cast<long long>(blockIdx.x) >> LOGC) * (N1 * M);

  ddk::load_twiddles(tw1, N1, tw1t);
  ddk::load_twiddles(tw2, M, tw2t);
  // columns i2 in [W*c, W*c + W) of every i1, shared (i1, i2 - W*c); every
  // load of a thread is in flight before the first store
  float4 v[LOADS][4];
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int e = threadIdx.x + j * THREADS;
    const long long off = base + (e >> (LOGW - 2)) * M + W * c + 4 * (e & (W / 4 - 1));
#pragma unroll
    for (int p = 0; p < 4; ++p) v[j][p] = __ldg(reinterpret_cast<const float4*>(x.p[p] + off));
  }
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int e = threadIdx.x + j * THREADS;
    const int w = pad((e >> (LOGW - 2)) * W + 4 * (e & (W / 4 - 1)));
#pragma unroll
    for (int p = 0; p < 4; ++p) *reinterpret_cast<float4*>(s.p[p] + w) = v[j][p];
  }
  __syncthreads();

  // F(n1) over i1: W sequences (the contiguous axis), stride W, the
  // correction folded into the last trip
  ddk::dif4_fft(s, LOGN1, LOGN1, LOGW, 1, W, true, tw1, LOGN1, LeafCorr{corr, W * c}, true);
  cluster.sync();

  // exchange, straight into the first radix-4 pass of F(128): item (k_l, r)
  // takes i2 = r + 32j, j < 4, of row k1 = 32c + k_l, held at shared row
  // bitrev(k1) of block i2 / W, column i2 mod W
  ddk::ddc y[ITEMS][4];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int e = threadIdx.x + it * THREADS;
    const int r = e & 31, kl = e >> 5;
    const int row = bitrev(KROWS * c + kl, LOGN1) * W;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i2 = r + 32 * j;
      const unsigned src = static_cast<unsigned>(i2 >> LOGW);
      const int w = pad(row + (i2 & (W - 1)));
      float f[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) f[p] = cluster.map_shared_rank(s.p[p], src)[w];
      y[it][j] = ddk::ddc{ddk::dd{f[0], f[1]}, ddk::dd{f[2], f[3]}};
    }
    ddk::dif4_group<2>(y[it], r, 5, LOGM, LOGM, tw2);
  }
  // no block reads another's buffer past this point
  cluster.sync();
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int e = threadIdx.x + it * THREADS;
    const int r = e & 31, kl = e >> 5;
#pragma unroll
    for (int j = 0; j < 4; ++j) ddk::store(s, pad(kl * M + r + 32 * j), y[it][j]);
  }
  __syncthreads();

  // the rest of F(128) (spans 32 .. 2) along each of the 32 rows k1 - 32c
  ddk::dif4_fft(s, LOGM, 5, 5, M, 1, false, tw2, LOGM, LeafCorr{corr, 0}, false);

  // out[k1 + n1*k2], k1 in [32c, 32c + 32): 32 contiguous floats per k2 and
  // plane, written by four neighbouring lanes as 64-byte runs; the other
  // lanes take 8 k2 whose bit-reversed columns differ in their low 3 bits,
  // so a warp's shared-memory reads are 4-way conflicted at most
#pragma unroll 2
  for (int j = 0; j < LOADS; ++j) {
    const int lane = threadIdx.x & 31, rest = (threadIdx.x >> 5) + j * (THREADS / 32);
    const int kl = 4 * ((lane & 3) + 4 * (rest & 1));
    const int kb = 16 * (lane >> 2) + (rest >> 1);
    const int col = bitrev(kb, LOGM);
    float f[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int w = pad((kl + u) * M + col);
#pragma unroll
      for (int p = 0; p < 4; ++p) f[p][u] = s.p[p][w];
    }
    const long long o = base + static_cast<long long>(kb) * N1 + KROWS * c + kl;
#pragma unroll
    for (int p = 0; p < 4; ++p)
      *reinterpret_cast<float4*>(out.p[p] + o) = make_float4(f[p][0], f[p][1], f[p][2], f[p][3]);
  }
}

using ClusterKernel = void (*)(ddk::ConstQuad, const float*, const float*, ddk::ConstQuad,
                               ddk::Quad);

ClusterKernel cluster_kernel(int logc) {
  switch (logc) {
    case 1: return ddleaf_cluster<1>;  // n = 2^13, n1 = 64
    case 2: return ddleaf_cluster<2>;  // n = 2^14, n1 = 128
    case 3: return ddleaf_cluster<3>;  // n = 2^15, n1 = 256
    default: return ddleaf_cluster<4>;  // n = 2^16, n1 = 512
  }
}

// Clusters of 2^logc blocks resident at once, or minus the CUDA error code.
int resident(int logc) {
  return phastft::resident_clusters(cluster_kernel(logc), 1 << logc, THREADS,
                                    smem_bytes(32 << logc));
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
  const int logn1 = phastft::ilog2(n1);
  if (n1 >= 64) {
    const int logc = logn1 - 5;
    static int resident[5] = {0, 0, 0, 0, 0};  // per logc, queried on first use
    return phastft::launch_clusters(cluster_kernel(logc), 1 << logc, batch << logc, THREADS,
                                    smem_bytes(n1), s, resident[logc], x, tw1t, tw2t, corr,
                                    out);
  }
  const int logn = logn1 + LOGM;
  int logr = LOG_LOCAL - logn;  // rows per block: 4 K points
  while (logr > 0 && (1LL << (logr - 1)) >= batch) --logr;
  const long long blocks = (batch + (1LL << logr) - 1) >> logr;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n1);
  cudaError_t err = cudaFuncSetAttribute(
      ddleaf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ddleaf_kernel<<<static_cast<unsigned>(blocks), THREADS, smem, s>>>(
      x, tw1t, tw2t, corr, out, batch, logn1, logr);
  return static_cast<int>(cudaGetLastError());
}

// The number of clusters of the ddleaf kernel at n1 = 64..512 (2, 4, 8, 16
// blocks) the current device holds at once (the CUDA occupancy query), or
// minus the CUDA error code.
extern "C" int phastft_ddleaf_clusters(int n1) {
  if (n1 < 64 || n1 > 512 || !phastft::is_pow2(n1))
    return -static_cast<int>(cudaErrorInvalidValue);
  return resident(phastft::ilog2(n1) - 5);
}
