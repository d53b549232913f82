// Leaf FFT of the native f64 engine: the whole length-n DFT of every row,
// n = 2..2^16, planar f64, natural order in and out, for sm_90a.
//
// Stands for: the JAX package's XLA leaf_fft and tiny_fft of its native f64
// engine (phastft_tpu/ops/stockham.py:236, :254). No Pallas kernel lies on
// that path; this kernel has no TPU counterpart.
//
// Row x of length n = n1 * n2, n2 = min(n, 128), x[i1*n2 + i2]:
//   t[k1, i2] = sum_i1 W_n1^(k1*i1) x[i1, i2]          (F(n1), n1 >= 2)
//   u[k1, i2] = t[k1, i2] * W_n^(k1*i2)                 (the planner's leaf{n1})
//   X[k1 + n1*k2] = sum_i2 W_n2^(k2*i2) u[k1, i2]       (F(n2) over i2)
//
// Bound: memory. 16 B read and 16 B written per element; the FP64
// arithmetic (radix-4 DIF, ~3.5 FP64 instructions per point and stage, 16
// stages and the correction at 2^16) takes about half the bytes' time at
// 132 SMs x 64 FP64 lanes, so the design keeps two blocks an SM to overlap
// one's memory with the other's arithmetic, and few trips through shared
// memory.
//
// Design (ddleaf.cu's geometry, in double):
// - A block holds 4096 points (73,728 B of shared memory with padding, plus
//   the W_n1 and W_n2 tables) and runs 256 threads at <= 128 registers
//   (__launch_bounds__(256, 2)).
// - Radix-4 DIF trips (f64.cuh); the correction is multiplied in the
//   registers of the last F(n1) trip.
// - Up to n = 2^12 a block holds R = 4096 / n whole rows (fewer for a small
//   batch), laid out (i1, r, i2) so that F(n1) runs over all R * 128 columns
//   at once (neighbouring threads on neighbouring columns) and F(n2) over
//   all n1 * R rows; rows go in gridDim.x (any batch), the last block masks
//   its missing rows. Below 128 points n1 = 1 and the row is one F(n).
// - From n = 2^13 a row of n1 = 32 * C points per column is held by a
//   cluster of C = 2, 4, 8, 16 blocks (16 is a non-portable cluster size,
//   set at launch; the entry refuses a shape no cluster of which fits the
//   device). Block c loads the W = 128 / C columns i2 in [W c, W c + W) of
//   every i1, runs F(n1) and the correction on them, and after a cluster
//   barrier reads its 32 rows k1 in [32c, 32c + 32) from every block
//   straight into the first radix-4 trip of F(128), holding the 16 results
//   a thread in registers until a second barrier says no block reads its
//   buffer any more. The rest of F(128) runs in its own buffer; the store
//   writes the 32 contiguous outputs k1 of each k2 as 32-byte sectors, two
//   lanes a sector, the lanes of a quarter-warp on k2 whose bit-reversed
//   columns differ in their low bits (2-way bank conflicts at most).
// - Device memory is read and written as double2s of each plane; twiddles
//   W_n1^k and W_n2^k come from tables of exact f64 angles the wrapper
//   builds on the host; no trigonometry runs in the kernel.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "f64.cuh"

namespace cg = cooperative_groups;
using phastft::bitrev;
namespace fk = phastft::f64k;
using fk::cd;
using fk::pad2;

namespace {

constexpr int M = 128, LOGM = 7;
constexpr int THREADS = 256;
// Points a block holds, and rows k1 a cluster block owns after the exchange.
constexpr int LOCAL = 4096, LOG_LOCAL = 12, KROWS = 32;
constexpr int SLOTS = pad2(LOCAL);
// double2 loads (and stores) of each plane per thread.
constexpr int PAIRS = LOCAL / 2 / THREADS;
// Exchange items per thread: (k1 - 32c, r), the radix-4 over i2 = r + 32j.
constexpr int ITEMS = KROWS * 32 / THREADS;

size_t smem_bytes(int n1, int n2) {
  return sizeof(cd) * (SLOTS + pad2(n1 / 2) + pad2(n2 / 2));
}

// The correction folded into the last F(n1) trip: output k1 of sequence q
// times corr[k1 * 128 + i2], i2 = col0 + (q mod 128).
struct LeafCorr {
  const double* __restrict__ cr;
  const double* __restrict__ ci;
  int col0;
  __device__ __forceinline__ cd operator()(cd x, int k1, int q) const {
    const int t = (k1 << LOGM) + col0 + (q & (M - 1));
    return fk::cmul(x, make_double2(__ldg(cr + t), __ldg(ci + t)));
  }
};

__global__ void __launch_bounds__(THREADS, 2)
leaf64_kernel(const double* __restrict__ xr, const double* __restrict__ xi,
              const cd* __restrict__ tw1t, const cd* __restrict__ tw2t, LeafCorr corr,
              double* __restrict__ outr, double* __restrict__ outi, long long batch,
              int logn1, int logn2, int logr) {
  extern __shared__ cd smem[];
  const int n1 = 1 << logn1, n2 = 1 << logn2, rows = 1 << logr;
  const int logn = logn1 + logn2;
  const int points = rows << logn;
  cd* s = smem;
  cd* tw1 = smem + SLOTS;          // W_n1^k, k < n1/2
  cd* tw2 = tw1 + pad2(n1 / 2);    // W_n2^k, k < n2/2

  const long long row0 = static_cast<long long>(blockIdx.x) << logr;
  const long long left = batch - row0;
  const int valid = static_cast<int>((left < rows ? left : rows) << logn);
  const long long base = row0 << logn;

  if (n1 > 1) fk::load_twiddles(tw1, n1, tw1t);
  fk::load_twiddles(tw2, n2, tw2t);
  // local flat index f = r*n + i1*n2 + i2 -> shared (i1, r, i2); a double2
  // holds two neighbouring i2 (n2 >= 2)
  double2 vr[PAIRS], vi[PAIRS];
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    const int f = 2 * (threadIdx.x + j * THREADS);
    vr[j] = vi[j] = make_double2(0.0, 0.0);
    if (f < valid) {
      vr[j] = __ldg(reinterpret_cast<const double2*>(xr + base + f));
      vi[j] = __ldg(reinterpret_cast<const double2*>(xi + base + f));
    }
  }
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    const int f = 2 * (threadIdx.x + j * THREADS);
    if (f >= points) continue;
    const int r = f >> logn, i = f & ((1 << logn) - 1);
    const int w = ((i >> logn2) << (logr + logn2)) + (r << logn2) + (i & (n2 - 1));
    s[pad2(w)] = make_double2(vr[j].x, vi[j].x);
    s[pad2(w + 1)] = make_double2(vr[j].y, vi[j].y);
  }
  __syncthreads();

  // F(n1) over i1: R*n2 sequences along the contiguous axis, stride R*n2;
  // the correction folded into the last trip
  if (n1 > 1)
    fk::dif4_fft(s, logn1, logn1, logr + logn2, 1, rows << logn2, true, tw1, logn1, corr,
                 true);
  // F(n2) along every row of n2 contiguous points: n1*R sequences
  fk::dif4_fft(s, logn2, logn2, logn1 + logr, n2, 1, false, tw2, logn2, fk::NoFold{}, false);

  // out[r*n + k1 + n1*k2] = shared (bitrev(k1), r, bitrev(k2)), two
  // neighbouring outputs a thread
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    const int f = 2 * (threadIdx.x + j * THREADS);
    if (f >= valid) continue;
    cd v[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = (f + u) >> logn, k = (f + u) & ((1 << logn) - 1);
      const int k1 = k & (n1 - 1), k2 = k >> logn1;
      v[u] = s[pad2((bitrev(k1, logn1) << (logr + logn2)) + (r << logn2) + bitrev(k2, logn2))];
    }
    *reinterpret_cast<double2*>(outr + base + f) = make_double2(v[0].x, v[1].x);
    *reinterpret_cast<double2*>(outi + base + f) = make_double2(v[0].y, v[1].y);
  }
}

// One row of n = n1 * 128 points, n1 = 32 << LOGC, per cluster of 2^LOGC
// blocks (the cluster size is set at launch).
template <int LOGC>
__global__ void __launch_bounds__(THREADS, 2)
leaf64_cluster(const double* __restrict__ xr, const double* __restrict__ xi,
               const cd* __restrict__ tw1t, const cd* __restrict__ tw2t, LeafCorr corr,
               double* __restrict__ outr, double* __restrict__ outi) {
  constexpr int LOGN1 = 5 + LOGC, N1 = 1 << LOGN1;
  constexpr int LOGW = LOGM - LOGC, W = 1 << LOGW;  // columns per block
  extern __shared__ cd smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cd* s = smem;
  cd* tw1 = smem + SLOTS;
  cd* tw2 = tw1 + pad2(N1 / 2);

  const int c = static_cast<int>(cluster.block_rank());
  const long long base = (static_cast<long long>(blockIdx.x) >> LOGC) * (N1 * M);

  fk::load_twiddles(tw1, N1, tw1t);
  fk::load_twiddles(tw2, M, tw2t);
  // columns i2 in [W*c, W*c + W) of every i1, shared (i1, i2 - W*c); every
  // load of a thread is in flight before the first store
  double2 vr[PAIRS], vi[PAIRS];
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    const int e = 2 * (threadIdx.x + j * THREADS);  // shared point (i1, col)
    const long long off = base + (e >> LOGW) * M + W * c + (e & (W - 1));
    vr[j] = __ldg(reinterpret_cast<const double2*>(xr + off));
    vi[j] = __ldg(reinterpret_cast<const double2*>(xi + off));
  }
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    const int e = 2 * (threadIdx.x + j * THREADS);
    s[pad2(e)] = make_double2(vr[j].x, vi[j].x);
    s[pad2(e + 1)] = make_double2(vr[j].y, vi[j].y);
  }
  __syncthreads();

  // F(n1) over i1: W sequences (the contiguous axis), stride W, the
  // correction folded into the last trip
  LeafCorr cc = corr;
  cc.col0 = W * c;
  fk::dif4_fft(s, LOGN1, LOGN1, LOGW, 1, W, true, tw1, LOGN1, cc, true);
  cluster.sync();

  // exchange, straight into the first radix-4 trip of F(128): item (k_l, r)
  // takes i2 = r + 32j, j < 4, of row k1 = 32c + k_l, held at shared row
  // bitrev(k1) of block i2 / W, column i2 mod W
  cd y[ITEMS][4];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int e = threadIdx.x + it * THREADS;
    const int r = e & 31, kl = e >> 5;
    const int row = bitrev(KROWS * c + kl, LOGN1) * W;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i2 = r + 32 * j;
      const unsigned src = static_cast<unsigned>(i2 >> LOGW);
      y[it][j] = cluster.map_shared_rank(s, src)[pad2(row + (i2 & (W - 1)))];
    }
    fk::dif4_group<2>(y[it], r, 5, LOGM, LOGM, tw2);
  }
  // no block reads another's buffer past this point
  cluster.sync();
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int e = threadIdx.x + it * THREADS;
    const int r = e & 31, kl = e >> 5;
#pragma unroll
    for (int j = 0; j < 4; ++j) s[pad2(kl * M + r + 32 * j)] = y[it][j];
  }
  __syncthreads();

  // the rest of F(128) (spans 32 .. 2) along each of the 32 rows k1 - 32c
  fk::dif4_fft(s, LOGM, 5, 5, M, 1, false, tw2, LOGM, fk::NoFold{}, false);

  // out[k1 + n1*k2], k1 in [32c, 32c + 32): item e takes the pair of
  // outputs k1 = 32c + 2p, 2p + 1 of one k2. Two neighbouring lanes fill a
  // 32-byte sector (p's low bit); the four lane pairs of a quarter-warp take
  // k2 that differ in bits 4-5, whose bit reverses differ in bits 1-2, so
  // their shared-memory reads fall on different banks.
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    const int e = threadIdx.x + j * THREADS;
    const int rest = e >> 3;
    const int p = (e & 1) | ((rest & 7) << 1);
    const int k2 = ((rest >> 3) & 15) | (((e >> 1) & 3) << 4) | ((rest >> 7) << 6);
    const int col = bitrev(k2, LOGM);
    const cd a = s[pad2(2 * p * M + col)], b = s[pad2((2 * p + 1) * M + col)];
    const long long o = base + static_cast<long long>(k2) * N1 + KROWS * c + 2 * p;
    *reinterpret_cast<double2*>(outr + o) = make_double2(a.x, b.x);
    *reinterpret_cast<double2*>(outi + o) = make_double2(a.y, b.y);
  }
}

using ClusterKernel = void (*)(const double*, const double*, const cd*, const cd*, LeafCorr,
                               double*, double*);

ClusterKernel cluster_kernel(int logc) {
  switch (logc) {
    case 1: return leaf64_cluster<1>;  // n = 2^13, n1 = 64
    case 2: return leaf64_cluster<2>;  // n = 2^14, n1 = 128
    case 3: return leaf64_cluster<3>;  // n = 2^15, n1 = 256
    default: return leaf64_cluster<4>;  // n = 2^16, n1 = 512
  }
}

// Clusters of 2^logc blocks resident at once, or minus the CUDA error code.
int resident(int logc) {
  return phastft::resident_clusters(cluster_kernel(logc), 1 << logc, THREADS,
                                    smem_bytes(32 << logc, M));
}

}  // namespace

// x*, o*: the two planes of (batch, n) arrays, n = 2..2^16 a power of two.
// tw1t: n1/2 (re, im) pairs, W_n1^k, n1 = n / 128 (n >= 256, else unused);
// tw2t: n2/2 pairs, W_n2^k, n2 = min(n, 128); cr, ci: the (n1, 128)
// correction W_n^(k1*i2) (n >= 256, else unused). Returns the CUDA error
// code of the launch (0 on success).
extern "C" int phastft_leaf64(const double* xr, const double* xi, const void* tw1t,
                              const void* tw2t, const double* cr, const double* ci,
                              double* outr, double* outi, long long batch, int n,
                              void* stream) {
  const int n1 = n > M ? n / M : 1, n2 = n > M ? M : n;
  if (batch < 1 || !phastft::is_pow2(n) || n < 2 || n > (1 << 16) || tw2t == nullptr ||
      (n1 > 1 && (tw1t == nullptr || cr == nullptr || ci == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cd* tw1 = static_cast<const cd*>(tw1t);
  const cd* tw2 = static_cast<const cd*>(tw2t);
  const LeafCorr corr{cr, ci, 0};
  const int logn1 = phastft::ilog2(n1), logn2 = phastft::ilog2(n2);
  if (n1 >= 64) {
    const int logc = logn1 - 5;
    static int resident_at[5] = {0, 0, 0, 0, 0};  // per logc, queried on first use
    return phastft::launch_clusters(cluster_kernel(logc), 1 << logc, batch << logc, THREADS,
                                    smem_bytes(n1, M), s, resident_at[logc], xr, xi, tw1, tw2,
                                    corr, outr, outi);
  }
  const int logn = logn1 + logn2;
  int logr = LOG_LOCAL - logn;  // rows per block: 4 K points
  while (logr > 0 && (1LL << (logr - 1)) >= batch) --logr;
  const long long blocks = (batch + (1LL << logr) - 1) >> logr;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n1, n2);
  cudaError_t err = cudaFuncSetAttribute(
      leaf64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  leaf64_kernel<<<static_cast<unsigned>(blocks), THREADS, smem, s>>>(
      xr, xi, tw1, tw2, corr, outr, outi, batch, logn1, logn2, logr);
  return static_cast<int>(cudaGetLastError());
}

// The number of clusters of the leaf64 kernel at n = 2^13..2^16 (2, 4, 8, 16
// blocks) the current device holds at once (the CUDA occupancy query), or
// minus the CUDA error code.
extern "C" int phastft_leaf64_clusters(int n) {
  if (n < (1 << 13) || n > (1 << 16) || !phastft::is_pow2(n))
    return -static_cast<int>(cudaErrorInvalidValue);
  return resident(phastft::ilog2(n) - 12);
}
