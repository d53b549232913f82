// Column pass of the native f64 engine's four-step FFT: the column DFT fused
// with the split twiddle, planar f64, for sm_90a.
//
// Stands for: the JAX package's XLA column pass of its native f64 engine,
// phastft_tpu/ops/fourstep.py:353-380 (stockham_axis2 over the columns, then
// the factored split correction split{n1}x{n2}). No Pallas kernel lies on
// that path; this kernel has no TPU counterpart.
//
// For every batch entry b and column i2 of x viewed (n1, n2):
//   y[k1, i2] = sum_i1 W_n1^(k1*i1) x[b, i1, i2]
//   out[b, k1, i2] = (y[k1, i2] * T1[k1, i2 / s]) * T2[k1, i2 % s]
// with T1 (n1, n2/s) and T2 (n1, s), s = 2^(log2(n2) / 2), the planner's
// factored tables of W_n^(k1*i2) (exact f64 angles; their product adds one
// rounding, ~1e-16), or the tables of a distributed shard's column block,
// W_N^(k1*(col_base + i2)) (ops/native.col64_shard_tables). The bare mode
// (phastft_col64_nocorr, the distributed permuted-input branch's column
// pass; it stands for the JAX package's stockham_axis2 at
// phastft_tpu/parallel/fourstep_dist.py:203) stores y: the twiddle products
// are a template argument of both designs, as in ddcol.cu.
//
// Bound: memory. 16 B read and 16 B written per element; the FP64
// arithmetic (radix-4 DIF with the trivial twiddles dropped, ~3.5 FP64
// instructions per point and stage, and the two twiddle products) takes
// less than the bytes' time at every n1 <= 2048 (132 SMs x 64 FP64 lanes).
//
// Design (ddcol.cu's two designs, in double):
// - A block holds 4096 points (64 KB of data, 73,728 B of shared memory with
//   padding, plus the W_n1 table: 92,160 B at n1 = 2048) and runs 256
//   threads at <= 128 registers, two blocks per SM
//   (__launch_bounds__(256, 2)).
// - One block a slab (col64_kernel: n1 <= 512, and n1 = 1024 / 2048 with
//   n2 < 32): T = min(4096 / n1, n2) neighbouring columns of one entry
//   (T >= 8 for n1 <= 512 and n2 >= 8; at n2 = 1, a distributed shard's
//   one-column block or the rows of a split planned with leaf_fft_size < 128,
//   a thread's double2 holds two rows of the column, each stored to its own
//   row): every row segment it reads and
//   writes is T * 8 contiguous bytes of each plane. Threads move double2s
//   (two neighbouring columns) of each plane, every load of a thread in
//   flight before the first store to shared memory. Radix-4 DIF trips over
//   the T sequences, neighbouring threads on neighbouring columns (f64.cuh:
//   conflict-free, twiddle reads broadcast), the split twiddle's two
//   products in the registers of the last trip, so the store is a copy; the
//   DIF leaves X[k1] at position bitrev(k1), which the store's row index
//   undoes.
// - Long columns (col64_cluster: n1 = 1024 and 2048 with n2 >= 32): at
//   4096 / n1 = 4 or 2 columns a block, the one-block design would read
//   32- or 16-byte row pieces. Instead a slab of W = 256 / P columns (32 at
//   n1 = 1024, 16 at 2048: 256- or 128-byte row pieces in each plane) spans
//   a cluster of CB = 8 blocks, a portable size that every block slot of
//   the card can hold. With n1 = P * Q, Q = 128, P = n1 / 128 (8, 16),
//   i1 = Q*p + q and k1 = kp + P*kq:
//   - block c loads the rows q in [16c, 16c + 16) for every p straight into
//     registers (a thread W / 16 sequences (q, column), the column its lane,
//     every load in flight at once), runs F(P) over p there, multiplies
//     output kp by W_n1^(kp*q) and writes (kp, q, column) to shared memory;
//   - after a cluster barrier it reads its KP = P / 8 values of kp (kp =
//     KP*c + kl), every q, from every block (mapa + ld.shared::cluster, a
//     quarter-warp 8 neighbouring columns of one q) straight into a radix-16
//     group, the first four stages of F(Q) (a thread one column, one kl and
//     q = r + 8j, j < 16); it arrives on a second cluster barrier right after
//     its last remote read, runs the radix-16, and waits on that barrier just
//     before it writes its own buffer;
//   - the last three stages of F(Q) run as one radix-8 straight from its
//     buffer, with the split twiddle folded in, to the stores: rows
//     k1 = kp + P*kq, W * 8 bytes a row and plane.
//   256 threads at 128 registers, no spills (-Xptxas -v, sm_90a), two
//   blocks an SM: 30 clusters resident on the H100 at either n1. The entry
//   refuses a shape no cluster of which fits the device. On the H100 (NVIDIA
//   H100 80GB HBM3, 700.00 W) this design reads 1.09 / 2.44 ms at
//   (1024, 2^16) / (2048, 2^16); the first cluster design (a 32-column slab
//   over P blocks, 16 at n1 = 2048, a non-portable size of which 14 fitted
//   the card at once, two full cluster barriers and a trip back through
//   shared memory before the store) read 1.24 / 3.01 in the same call.
//   Three blocks an SM (80 registers: 136 B of spills) measured 1.15-1.18x
//   slower, an L2 prefetch of the next wave's slab 1.07-1.15x, and
//   persistent clusters that load the next slab into a second buffer
//   (cp.async; one block an SM) 1.29-1.38x.
// - Twiddles W_n1^k come from a table of exact f64 angles the wrapper builds
//   on the host; no trigonometry runs in the kernel.
// - The batch and the slabs are folded into gridDim.x; device offsets are
//   64-bit.
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

constexpr int THREADS = 256;
constexpr int LOCAL = 4096, LOG_LOCAL = 12;  // points a block holds
constexpr int SLOTS = pad2(LOCAL);
constexpr int PAIRS = LOCAL / 2 / THREADS;  // double2s of each plane a thread moves
// Long columns: CT columns a slab, the second factor Q = 2^LOGQ, from
// n1 = CLUSTER_N1. A build with -DCOL64_CLUSTER_N1=4096 runs every shape on
// the one-block design: chip_smoke.py times the two designs against each
// other that way.
constexpr int LOGCT = 5, CT = 1 << LOGCT;
constexpr int LOGQ = 7;
// A cluster: CB = 8 blocks (portable) on a slab of n1 * W = 8 * 4096 points,
// W = 256 / P columns (32 at n1 = 1024, 16 at 2048).
constexpr int LOGCB = 3, CB = 1 << LOGCB;
constexpr int LOG_SLAB_POINTS = 8;  // log2(P * W)
#ifdef COL64_CLUSTER_N1
constexpr int CLUSTER_N1 = COL64_CLUSTER_N1;
#else
constexpr int CLUSTER_N1 = 1024;
#endif

size_t smem_bytes(int n1) { return sizeof(cd) * (SLOTS + pad2(n1 / 2)); }

// The split twiddle folded into the last trip: output k of sequence q is
// row k1 = (k << logp) + kp0 and column i2 = col0 + q, times
// T1[k1, i2 >> logs], then T2[k1, i2 mod s].
struct SplitCorr {
  const double* __restrict__ t1r;
  const double* __restrict__ t1i;
  const double* __restrict__ t2r;
  const double* __restrict__ t2i;
  int logs, t1cols, col0, logp, kp0;
  __device__ __forceinline__ cd operator()(cd v, int k, int q) const {
    const int k1 = (k << logp) + kp0;
    const int i2 = col0 + q;
    const int a = k1 * t1cols + (i2 >> logs);
    const int b = (k1 << logs) + (i2 & ((1 << logs) - 1));
    const cd w1 = make_double2(__ldg(t1r + a), __ldg(t1i + a));
    const cd w2 = make_double2(__ldg(t2r + b), __ldg(t2i + b));
    return fk::cmul(fk::cmul(v, w1), w2);
  }
};

template <bool CORR>
__global__ void __launch_bounds__(THREADS, 2)
col64_kernel(const double* __restrict__ xr, const double* __restrict__ xi,
             const cd* __restrict__ twt, SplitCorr corr, double* __restrict__ outr,
             double* __restrict__ outi, int logn1, int n2, int logT) {
  extern __shared__ cd smem[];
  cd* s = smem;
  cd* tw = smem + SLOTS;  // W_n1^k, k < n1/2
  const int n1 = 1 << logn1, T = 1 << logT;
  const int points = n1 << logT;

  // block -> (entry b, slab); n2 / T slabs per entry, a power of two
  const unsigned nblk = static_cast<unsigned>(n2 >> logT);
  const int col0 = static_cast<int>(blockIdx.x & (nblk - 1)) << logT;
  const long long base =
      static_cast<long long>(blockIdx.x >> (31 - __clz(nblk))) * n1 * n2 + col0;

  fk::load_twiddles(tw, n1, twt);
  // point f = (i1, c) of the slab, two neighbouring columns a thread
  double2 vr[PAIRS], vi[PAIRS];
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    const int f = 2 * (threadIdx.x + j * THREADS);
    if (f >= points) continue;
    const long long off = base + static_cast<long long>(f >> logT) * n2 + (f & (T - 1));
    vr[j] = __ldg(reinterpret_cast<const double2*>(xr + off));
    vi[j] = __ldg(reinterpret_cast<const double2*>(xi + off));
  }
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    const int f = 2 * (threadIdx.x + j * THREADS);
    if (f >= points) continue;
    s[pad2(f)] = make_double2(vr[j].x, vi[j].x);
    s[pad2(f + 1)] = make_double2(vr[j].y, vi[j].y);
  }
  __syncthreads();

  // F(n1) over i1: T sequences along the contiguous axis, stride T; the
  // split twiddle (CORR) folded into the last trip
  SplitCorr c = corr;
  c.col0 = col0;
  fk::dif4_fft(s, logn1, logn1, logT, 1, T, true, tw, logn1, c, CORR);

  // shared (row, c): row holds k1 = bitrev(row), stored at its row of device
  // memory
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    const int f = 2 * (threadIdx.x + j * THREADS);
    if (f >= points) continue;
    const cd a = s[pad2(f)], b = s[pad2(f + 1)];
    if (T == 1) {  // one column: the pair is rows f and f + 1, each to its own row
      const long long o0 = base + bitrev(f, logn1), o1 = base + bitrev(f + 1, logn1);
      outr[o0] = a.x;
      outi[o0] = a.y;
      outr[o1] = b.x;
      outi[o1] = b.y;
      continue;
    }
    const int k1 = bitrev(f >> logT, logn1);
    const long long off = base + static_cast<long long>(k1) * n2 + (f & (T - 1));
    *reinterpret_cast<double2*>(outr + off) = make_double2(a.x, b.x);
    *reinterpret_cast<double2*>(outi + off) = make_double2(a.y, b.y);
  }
}

// A read-only load that has L2 fetch the 256-byte span around it: at
// n1 = 2048 a cluster reads 128-byte pieces of each row, and the cluster of
// the neighbouring slab, running at the same time, the rest (1.02x there on
// the H100 80GB HBM3 at 700.00 W; at n1 = 1024 the pieces are 256 bytes
// already).
__device__ __forceinline__ double load_span(const double* p) {
  double v;
  asm volatile("ld.global.nc.L2::256B.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}

// The cluster's shared-memory window: the address of slot w of block
// `rank`'s buffer (mapa), and a load from it.
__device__ __forceinline__ unsigned remote_slot(const cd* s, int w, unsigned rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s + w));
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(a), "r"(rank));
  return out;
}

__device__ __forceinline__ cd load_remote(unsigned addr) {
  cd v;
  asm volatile("ld.shared::cluster.v2.f64 {%0, %1}, [%2];" : "=d"(v.x), "=d"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// One slab of W = 256 / P columns of one entry per cluster of CB = 8 blocks,
// n1 = P * Q (n1 = 2^(LOGP + LOGQ)); CORR: the split twiddle's products.
template <int LOGP, bool CORR>
__global__ void __launch_bounds__(THREADS, 2)
col64_cluster(const double* __restrict__ xr, const double* __restrict__ xi,
              const cd* __restrict__ twt, SplitCorr corr, double* __restrict__ outr,
              double* __restrict__ outi, int n2) {
  constexpr int P = 1 << LOGP;
  constexpr int LOGN1 = LOGP + LOGQ;
  constexpr int LOGW = LOG_SLAB_POINTS - LOGP, W = 1 << LOGW;  // the slab's columns
  constexpr int LOGKP = LOGP - LOGCB, KP = 1 << LOGKP;        // kp a block owns
  constexpr int LOGQC = LOGQ - LOGCB;                          // rows q a block loads
  constexpr int LOGM1 = LOGQC + LOGW;                          // F(P)'s sequences (ql, column)
  constexpr int PER = (1 << LOGM1) / THREADS;                  // sequences a thread in F(P)
  static_assert(PER >= 1 && KP >= 1 && (W << 3 << LOGKP) == THREADS, "the cluster map");
  extern __shared__ cd smem[];
  cd* s = smem;
  cd* tw = smem + SLOTS;  // W_n1^k, k < n1/2

  const int c = static_cast<int>(cg::this_cluster().block_rank());
  // cluster -> (batch entry b, slab); n2 / W slabs per entry
  const unsigned slab = blockIdx.x >> LOGCB;
  const unsigned nblk = static_cast<unsigned>(n2 >> LOGW);
  const int col0 = static_cast<int>(slab & (nblk - 1)) << LOGW;
  const long long base =
      (static_cast<long long>(slab >> (31 - __clz(nblk))) * n2 << LOGN1) + col0;

  // F(P) in registers: sequence (ql, column) of block c loads rows
  // i1 = Q*p + Q/CB*c + ql, a warp 256 / W rows of W * 8 bytes a plane, every
  // load in flight at once
  cd v[PER][P];
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int seq = threadIdx.x + t * THREADS;
    const int col = seq & (W - 1), ql = seq >> LOGW;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const long long off =
          base + static_cast<long long>((p << LOGQ) + (c << LOGQC) + ql) * n2 + col;
      v[t][p] = W < CT ? make_double2(load_span(xr + off), load_span(xi + off))
                       : make_double2(__ldg(xr + off), __ldg(xi + off));
    }
  }
  fk::load_twiddles(tw, 1 << LOGN1, twt);
  __syncthreads();
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int seq = threadIdx.x + t * THREADS;
    const int q = (c << LOGQC) + (seq >> LOGW);
    fk::dif4_group<LOGP>(v[t], 0, 0, LOGN1, LOGP, tw);
    // output u holds kp = bitrev(u): shared (u, ql, column)
#pragma unroll
    for (int u = 0; u < P; ++u)
      s[pad2((u << LOGM1) + seq)] =
          fk::cmul(v[t][u], fk::twiddle(tw, bitrev(u, LOGP) * q, LOGN1));
  }
  cluster_arrive();
  cluster_wait();

  // the exchange, straight into a radix-16 group of F(Q) (spans 128 .. 16):
  // item (column, r, kl) takes q = r + 8j, j < 16, of kp = KP*c + kl, held at
  // shared row bitrev(kp) of block q / (Q/CB) (mapa + ld.shared::cluster)
  const int col = threadIdx.x & (W - 1), r = (threadIdx.x >> LOGW) & 7;
  const int kl = threadIdx.x >> (LOGW + 3), kp = (c << LOGKP) + kl;
  const int row = bitrev(kp, LOGP) << LOGM1;
  unsigned at[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int q = r + 8 * j;
    at[j] = remote_slot(s, pad2(row + ((q & ((1 << LOGQC) - 1)) << LOGW) + col),
                        static_cast<unsigned>(q >> LOGQC));
  }
  cd y[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) y[j] = load_remote(at[j]);
  // no read of another block's buffer follows
  cluster_arrive();
  fk::dif4_group<4>(y, r, 3, LOGN1, LOGQ, tw);
  cluster_wait();
  // shared (kl, position, column)
#pragma unroll
  for (int j = 0; j < 16; ++j) s[pad2((((kl << LOGQ) + r + 8 * j) << LOGW) + col)] = y[j];
  __syncthreads();

  // the last three stages of F(Q) (spans 8 .. 2), one radix-8 with the split
  // twiddle folded in, straight to the stores: item (column, g, kl), q =
  // 8g + s; output s is kq = bitrev(8g + s), row k1 = kp + P*kq, a warp W
  // columns of 256 / W rows (W * 8 bytes a row and plane)
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int e = threadIdx.x + it * THREADS;
    const int ec = e & (W - 1), g = (e >> LOGW) & 15, el = e >> (LOGW + 4);
    cd x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = s[pad2((((el << LOGQ) + 8 * g + j) << LOGW) + ec)];
    fk::dif4_group<3>(x, 0, 0, LOGN1, 3, tw);
    SplitCorr fold = corr;
    fold.col0 = col0;
    fold.logp = LOGP;
    fold.kp0 = (c << LOGKP) + el;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kq = bitrev(8 * g + j, LOGQ);
      const cd a = CORR ? fold(x[j], kq, ec) : x[j];
      const long long o = base + static_cast<long long>(fold.kp0 + (kq << LOGP)) * n2 + ec;
      outr[o] = a.x;
      outi[o] = a.y;
    }
  }
}

// Whether the long-column design runs (n1, n2): n1 = CLUSTER_N1..2048 and a
// whole CT-column slab.
bool long_columns(int n1, int n2) { return n1 >= CLUSTER_N1 && n2 >= CT; }

// The cluster kernel at n1 = 1024 (P = 8) or 2048 (P = 16), as a pointer.
using ClusterKernel = void (*)(const double*, const double*, const cd*, SplitCorr, double*,
                               double*, int);
template <bool CORR>
ClusterKernel cluster_kernel(int n1) {
  return n1 == 2048 ? col64_cluster<4, CORR> : col64_cluster<3, CORR>;
}

bool shape_ok(long long batch, int n1, int n2) {
  return !(batch < 1 || !phastft::is_pow2(n1) || n1 < 2 || n1 > 2048 || !phastft::is_pow2(n2) ||
           n2 < 1);
}

template <bool CORR>
int launch(const double* xr, const double* xi, const cd* tw, const SplitCorr& corr,
           double* outr, double* outi, long long batch, int n1, int n2, cudaStream_t s) {
  const int logn1 = phastft::ilog2(n1), logn2 = phastft::ilog2(n2);
  if (long_columns(n1, n2)) {
    static int resident[2] = {0, 0};  // per n1, queried on first use
    const int logp = logn1 - LOGQ;
    const long long blocks = (batch * (n2 >> (LOG_SLAB_POINTS - logp))) << LOGCB;
    return phastft::launch_clusters(cluster_kernel<CORR>(n1), CB, blocks, THREADS,
                                    smem_bytes(n1), s, resident[logp - 3], xr, xi, tw, corr,
                                    outr, outi, n2);
  }
  const int logT = LOG_LOCAL - logn1 < logn2 ? LOG_LOCAL - logn1 : logn2;
  const long long blocks = batch << (logn2 - logT);
  if (blocks > 0x7fffffffLL || (blocks >> (logn2 - logT)) != batch)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n1);
  cudaError_t err = cudaFuncSetAttribute(
      col64_kernel<CORR>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  col64_kernel<CORR><<<static_cast<unsigned>(blocks), THREADS, smem, s>>>(
      xr, xi, tw, corr, outr, outi, logn1, n2, logT);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x*, o*: the two planes of (batch, n1, n2) arrays; n1 = 2..2048 and n2 >= 1,
// powers of two. twt: n1/2 (re, im) pairs, W_n1^k. t1*: (n1, n2 / s) and
// t2*: (n1, s), s = 2^(log2(n2) / 2), the factored split twiddle. Returns the
// CUDA error code of the launch (0 on success; cudaErrorInvalidConfiguration
// when no cluster of a long-column shape fits the device).
extern "C" int phastft_col64(const double* xr, const double* xi, const void* twt,
                             const double* t1r, const double* t1i, const double* t2r,
                             const double* t2i, double* outr, double* outi, long long batch,
                             int n1, int n2, void* stream) {
  if (!shape_ok(batch, n1, n2)) return static_cast<int>(cudaErrorInvalidValue);
  const int logs = phastft::ilog2(n2) / 2;
  const SplitCorr corr{t1r, t1i, t2r, t2i, logs, n2 >> logs, 0, 0, 0};
  return launch<true>(xr, xi, static_cast<const cd*>(twt), corr, outr, outi, batch, n1, n2,
                      static_cast<cudaStream_t>(stream));
}

// As phastft_col64 with no twiddle: out = y, the bare column DFT.
extern "C" int phastft_col64_nocorr(const double* xr, const double* xi, const void* twt,
                                    double* outr, double* outi, long long batch, int n1,
                                    int n2, void* stream) {
  if (!shape_ok(batch, n1, n2)) return static_cast<int>(cudaErrorInvalidValue);
  const SplitCorr none{nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0, 0};
  return launch<false>(xr, xi, static_cast<const cd*>(twt), none, outr, outi, batch, n1, n2,
                       static_cast<cudaStream_t>(stream));
}

// The clusters of the long-column design at n1 = 1024 or 2048 the current
// device holds at once (the CUDA occupancy query), or minus the CUDA error
// code.
extern "C" int phastft_col64_clusters(int n1) {
  if (n1 != 1024 && n1 != 2048) return -static_cast<int>(cudaErrorInvalidValue);
  return phastft::resident_clusters(cluster_kernel<true>(n1), CB, THREADS, smem_bytes(n1));
}
