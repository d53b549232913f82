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
// rounding, ~1e-16).
//
// Bound: memory. 16 B read and 16 B written per element; the FP64
// arithmetic (radix-4 DIF with the trivial twiddles dropped, ~3.5 FP64
// instructions per point and stage, and the two twiddle products) takes a
// fourth of the bytes' time or less at n1 <= 512 (132 SMs x 64 FP64 lanes).
//
// Design (ddcol.cu's one-block path, in double):
// - A block holds 4096 points (64 KB of data, 73,728 B of shared memory with
//   padding, plus the W_n1 table) and runs 256 threads at <= 128 registers,
//   two blocks per SM (__launch_bounds__(256, 2)).
// - A block owns a slab of T = min(4096 / n1, n2) neighbouring columns of
//   one entry (T >= 8 for n1 <= 512 and n2 >= 8): every row segment it reads
//   and writes is T * 8 contiguous bytes of each plane. Threads move
//   double2s (two neighbouring columns) of each plane, every load of a
//   thread in flight before the first store to shared memory.
// - Radix-4 DIF trips over the T sequences, neighbouring threads on
//   neighbouring columns (f64.cuh: conflict-free, twiddle reads broadcast),
//   the split twiddle's two products in the registers of the last trip, so
//   the store is a copy; the DIF leaves X[k1] at position bitrev(k1), which
//   the store's row index undoes.
// - Twiddles W_n1^k come from a table of exact f64 angles the wrapper builds
//   on the host; no trigonometry runs in the kernel.
// - The batch and the slabs are folded into gridDim.x; device offsets are
//   64-bit.
#include <cuda_runtime.h>

#include "f64.cuh"

using phastft::bitrev;
namespace fk = phastft::f64k;
using fk::cd;
using fk::pad2;

namespace {

constexpr int THREADS = 256;
constexpr int LOCAL = 4096, LOG_LOCAL = 12;  // points a block holds
constexpr int SLOTS = pad2(LOCAL);
constexpr int PAIRS = LOCAL / 2 / THREADS;  // double2s of each plane a thread moves

size_t smem_bytes(int n1) { return sizeof(cd) * (SLOTS + pad2(n1 / 2)); }

// The split twiddle folded into the last trip: output k1 of sequence q
// (column i2 = col0 + q) times T1[k1, i2 >> logs], then T2[k1, i2 mod s].
struct SplitCorr {
  const double* __restrict__ t1r;
  const double* __restrict__ t1i;
  const double* __restrict__ t2r;
  const double* __restrict__ t2i;
  int logs, t1cols, col0;
  __device__ __forceinline__ cd operator()(cd v, int k1, int q) const {
    const int i2 = col0 + q;
    const int a = k1 * t1cols + (i2 >> logs);
    const int b = (k1 << logs) + (i2 & ((1 << logs) - 1));
    const cd w1 = make_double2(__ldg(t1r + a), __ldg(t1i + a));
    const cd w2 = make_double2(__ldg(t2r + b), __ldg(t2i + b));
    return fk::cmul(fk::cmul(v, w1), w2);
  }
};

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
  // split twiddle folded into the last trip
  SplitCorr c = corr;
  c.col0 = col0;
  fk::dif4_fft(s, logn1, logn1, logT, 1, T, true, tw, logn1, c, true);

  // shared (row, c): row holds k1 = bitrev(row), stored at its row of device
  // memory
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    const int f = 2 * (threadIdx.x + j * THREADS);
    if (f >= points) continue;
    const int k1 = bitrev(f >> logT, logn1);
    const cd a = s[pad2(f)], b = s[pad2(f + 1)];
    const long long off = base + static_cast<long long>(k1) * n2 + (f & (T - 1));
    *reinterpret_cast<double2*>(outr + off) = make_double2(a.x, b.x);
    *reinterpret_cast<double2*>(outi + off) = make_double2(a.y, b.y);
  }
}

}  // namespace

// x*, o*: the two planes of (batch, n1, n2) arrays; n1 = 2..512 and n2 >= 2,
// powers of two. twt: n1/2 (re, im) pairs, W_n1^k. t1*: (n1, n2 / s) and
// t2*: (n1, s), s = 2^(log2(n2) / 2), the factored split twiddle. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int phastft_col64(const double* xr, const double* xi, const void* twt,
                             const double* t1r, const double* t1i, const double* t2r,
                             const double* t2i, double* outr, double* outi, long long batch,
                             int n1, int n2, void* stream) {
  if (batch < 1 || !phastft::is_pow2(n1) || n1 < 2 || n1 > 512 || !phastft::is_pow2(n2) ||
      n2 < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int logn1 = phastft::ilog2(n1), logn2 = phastft::ilog2(n2);
  const int logT = LOG_LOCAL - logn1 < logn2 ? LOG_LOCAL - logn1 : logn2;
  const long long blocks = batch << (logn2 - logT);
  if (blocks > 0x7fffffffLL || (blocks >> (logn2 - logT)) != batch)
    return static_cast<int>(cudaErrorInvalidValue);
  const int logs = logn2 / 2;
  const SplitCorr corr{t1r, t1i, t2r, t2i, logs, n2 >> logs, 0};
  const size_t smem = smem_bytes(n1);
  cudaError_t err = cudaFuncSetAttribute(
      col64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  col64_kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      xr, xi, static_cast<const cd*>(twt), corr, outr, outi, logn1, n2, logT);
  return static_cast<int>(cudaGetLastError());
}
