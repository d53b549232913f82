// Column pass of the four-step FFT, planar f32, for sm_90a.
//
// Replaces: phastft_tpu/ops/pallas_col.py, colfft_pallas, in both of its
// output modes (the column DFT fused with the split twiddle), and
// colfft_pallas_nocorr (the bare column DFT), three modes of one kernel:
//   CLASSIC  the (n1, n2) layout, for the outer level of a nested plan,
//            every split the fused pipeline refuses, and a distributed
//            shard's column block (the twiddle of a longer transform);
//   OUT3D    the (A, n1, 128) relayout that the row kernel reads;
//   NOCORR   the (n1, n2) layout with no twiddle: the column pass of the
//            distributed four-step's permuted-input branch.
//
// For every batch b and column i2 of x viewed (n1, n2), with N = n_total
// (n1*n2 unless a distributed shard passes its transform's length) and
// i2' = col_base + i2 (the shard's column offset, else 0):
//   y[k1, i2] = W_N^(k1*i2') * sum_i1 W_n1^(k1*i1) x[b, i1, i2]
//   classic:  c[b, k1, i2]                = y[k1, i2]
//   out3d:    c3[b, i2/128, k1, i2%128]   = y[k1, i2]
//   nocorr:   c[b, k1, i2]                = sum_i1 W_n1^(k1*i1) x[b, i1, i2]
//
// Bound: memory. Each element is read once and written once, 16 B per
// complex element per pass, against ~5*log2(n1) flops per element; at
// 3.35 TB/s the bytes take several times longer than the flops.
//
// Two designs against that bound, chosen by shape in the C entry:
//
// Long columns (n1 = 1024, 2048; n2 >= 32): colfft_cluster. A slab of
// T = 32 columns (128-byte row segments) is split over a cluster of
// C = n1/256 blocks (4 or 8) of 8192 points (64 KB, ~72 KB of shared
// memory with the twiddle table), 256 threads capped at 80 registers, so
// three blocks share an SM and one block's loads and stores overlap
// another's radix passes. At that cap ptxas spills 16 B a thread at
// n1 = 1024 and 20-32 B at 2048 (-Xptxas -v for sm_90a).
// With n1 = P*Q, Q = 128, i1 = Q*p + q and k1 = kp + P*kq:
//   - block c loads the rows q in [Q/C*c, Q/C*(c+1)) for every p straight
//     into registers (float2 pairs of columns, every load of a thread in
//     flight at once), runs F(P) over p there, multiplies by W_n1^(kp*q)
//     and writes (kp, q, column);
//   - after a cluster barrier it reads its two kp, every q, from every
//     block (distributed shared memory) straight into the first trip of
//     F(Q), a radix-16 over q = r + 8j, and holds the results until a
//     second barrier says no block reads its buffer any more;
//   - the last three stages of F(Q) run in its own buffer, and the store
//     writes rows k1 = kp + P*kq as float4s, 128 bytes a row.
//   Shared memory is rows of 32 words, one word per bank, so every phase
//   is free of bank conflicts without padding. On the H100 a 16-column
//   slab (64-byte segments, 2- and 4-block clusters) measured 1.21-1.24x
//   slower, a 64-column slab (8- and 16-block clusters) 1.06x slower at
//   n1 = 2048.
//
// Other shapes (n1 <= 512, and shard blocks narrower than 32 columns): one
// slab a block, colfft_kernel. A block owns T neighbouring columns. The
// out3d mode takes T = 16. The classic mode runs shallow columns (n1 = 32
// at the outer level of 2^26), so it widens T as n1 shrinks to keep a slab
// of about 8 K points: rows of T floats are read with float4 loads,
// neighbouring threads on neighbouring addresses, and a row segment is
// T * 4 contiguous bytes. The whole size-n1 DFT runs in shared memory,
// three radix-2 stages per trip (fft_smem.cuh), and the store needs no
// transpose: for fixed k1 the T columns land contiguously in either layout
// (float4 stores).
//
// In both designs:
// - The split twiddle and the store are one helper, store_row4. The twiddle
//   is formed from the exact phase m = (k1*i2') mod N in 64-bit integers
//   and sincospi(-2m/N) in double, rounded once to float:
//   an f32 angle k1*i2 would lose the phase past n = 2^24. The in-block
//   twiddles W_n1^k are formed the same way into shared memory.
// - The classic and nocorr modes take any n2 >= 4 (a shard's column block
//   can be narrower than a slab: the slab is then n2 wide, on
//   colfft_kernel).
// - The batch is folded into gridDim.x (up to 2^31 - 1 blocks, the
//   cluster factor counted) and every device-memory offset is 64-bit: the
//   inner level of a nested plan has a batch of 32..512 per transform, and
//   one transform of 2^30 points already reaches offsets of 2^30.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "fft_smem.cuh"

namespace cg = cooperative_groups;
using phastft::bitrev;
using phastft::pad;
using phastft::padded_words;

namespace {

enum Mode { CLASSIC = 0, OUT3D = 1, NOCORR = 2 };

// Stores columns i2..i2+3 of row k1 of batch entry b (a, c: real and
// imaginary parts) at their place in the mode's layout, times the split
// twiddle W_N^(k1*(col_base + i2 + u)) but in the nocorr mode. The phase is
// exact, m = (k1*i2') mod N in 64-bit integers, and sincospi(-2m/N) runs in
// double, rounded once to float.
template <int MODE>
__device__ __forceinline__ void store_row4(float* __restrict__ ore, float* __restrict__ oim,
                                           float4 a, float4 c, long long b, int k1, int i2,
                                           int n1, int n2, long long n_total,
                                           long long col_base) {
  const float vr[4] = {a.x, a.y, a.z, a.w};
  const float vi[4] = {c.x, c.y, c.z, c.w};
  float outr[4], outi[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (MODE == NOCORR) {
      outr[u] = vr[u];
      outi[u] = vi[u];
      continue;
    }
    const long long m = (static_cast<long long>(k1) * (col_base + i2 + u)) & (n_total - 1);
    double s, cs;
    sincospi(-2.0 * static_cast<double>(m) / static_cast<double>(n_total), &s, &cs);
    const float wr = static_cast<float>(cs), wi = static_cast<float>(s);
    outr[u] = vr[u] * wr - vi[u] * wi;
    outi[u] = vr[u] * wi + vi[u] * wr;
  }
  const long long n = static_cast<long long>(n1) * n2;  // the batch stride
  const long long o =
      MODE == OUT3D ? ((b * (n2 >> 7) + (i2 >> 7)) * n1 + k1) * 128 + (i2 & 127)
                    : b * n + static_cast<long long>(k1) * n2 + i2;
  *reinterpret_cast<float4*>(ore + o) = make_float4(outr[0], outr[1], outr[2], outr[3]);
  *reinterpret_cast<float4*>(oim + o) = make_float4(outi[0], outi[1], outi[2], outi[3]);
}

// LOGT > 0 fixes log2 of the slab width when the kernel is compiled (the
// out3d mode's 16 columns: index arithmetic folds into constants);
// LOGT = 0 takes it from the argument (the classic mode's widths).
template <int MODE, int LOGT>
__global__ void __launch_bounds__(512)
colfft_kernel(const float* __restrict__ re, const float* __restrict__ im,
              float* __restrict__ ore, float* __restrict__ oim,
              int logn1, int logt_arg, int n2, long long n_total, long long col_base) {
  extern __shared__ float4 smem4[];
  const int logt = LOGT ? LOGT : logt_arg;
  const int n1 = 1 << logn1;
  const int T = 1 << logt;
  const int logv = logt - 2;  // float4 per slab row
  const int V = 1 << logv;
  const int words = padded_words(n1 * T);
  float* sr = reinterpret_cast<float*>(smem4);
  float* si = sr + words;
  float2* tw = reinterpret_cast<float2*>(si + words);

  // block -> (batch entry b, slab j); n2 / T slabs per entry, a power of two
  const unsigned nblk = static_cast<unsigned>(n2 >> logt);
  const int j = static_cast<int>(blockIdx.x & (nblk - 1));
  const long long b = blockIdx.x >> (31 - __clz(nblk));
  const long long n = static_cast<long long>(n1) * n2;  // the batch stride
  const float* xr = re + b * n + static_cast<long long>(j) * T;
  const float* xi = im + b * n + static_cast<long long>(j) * T;

  for (int k = threadIdx.x; k < n1 / 2; k += blockDim.x) {
    double s, c;
    sincospi(-2.0 * k / n1, &s, &c);
    tw[k] = make_float2(static_cast<float>(c), static_cast<float>(s));
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < n1 * V; e += blockDim.x) {
    const int i1 = e >> logv, v = e & (V - 1);
    const long long off = static_cast<long long>(i1) * n2 + 4 * v;
    const int w = pad(i1 * T + 4 * v);
    *reinterpret_cast<float4*>(sr + w) = __ldg(reinterpret_cast<const float4*>(xr + off));
    *reinterpret_cast<float4*>(si + w) = __ldg(reinterpret_cast<const float4*>(xi + off));
  }
  __syncthreads();

  // column q of the slab is the contiguous axis: sequences are neighbours
  phastft::dif_fft(sr, si, logn1, logt, 1, T, true, tw);

#pragma unroll 2
  for (int e = threadIdx.x; e < n1 * V; e += blockDim.x) {
    const int k1 = e >> logv, v = e & (V - 1);
    const int w = pad(bitrev(k1, logn1) * T + 4 * v);
    store_row4<MODE>(ore, oim, *reinterpret_cast<const float4*>(sr + w),
                     *reinterpret_cast<const float4*>(si + w), b, k1, j * T + 4 * v, n1, n2,
                     n_total, col_base);
  }
}

// Columns per block of colfft_kernel. out3d: 16. Classic and nocorr: a
// slab of about 8 K points, so 512 columns at n1 <= 16 down to 16 at
// n1 = 512 and 1024, 8 at 2048 (blocks narrower than 32 columns there).
// Never more than n2.
int slab_columns(int n1, int n2, bool out3d) {
  int t = n1 >= 2048 ? 8 : 16;
  if (!out3d)
    while (t < 512 && n1 * t < 8192) t *= 2;
  return t < n2 ? t : n2;
}

// -- long columns: one slab of CT columns over a cluster of n1/256 blocks

constexpr int CT = 32, LOGCT = 5;      // columns of a slab: 128-byte row segments
constexpr int CQ = 128, LOGCQ = 7;     // Q, the second column factor
constexpr int CKP = 2, LOGCKP = 1;     // kp a block owns after the exchange
constexpr int CLOCAL = 8192;           // points a block holds: CKP * CQ * CT
constexpr int CTHREADS = 256;
// Exchange items a thread: (column, r, kp - CKP*c), a radix-16 over q = r + 8j.
constexpr int CITEMS = CKP * 8 * CT / CTHREADS;
// Items of the last three stages a thread: (column, q / 8, kp - CKP*c).
constexpr int CLAST = CKP * (CQ / 8) * CT / CTHREADS;
// float4 stores of each plane a thread.
constexpr int CSTORES = CLOCAL / 4 / CTHREADS;

constexpr size_t cluster_smem_bytes(int n1) {
  return 2 * sizeof(float) * CLOCAL + sizeof(float2) * (n1 / 2);
}

// n1 = 2^LOGN1 (1024 or 2048) = P * Q: a cluster of C = P / CKP blocks (4 or 8).
// Shared memory holds rows of CT = 32 words, one per bank: every phase's
// warp reads or writes whole rows, so no padding is needed.
template <int MODE, int LOGN1>
__global__ void __launch_bounds__(CTHREADS, 3)
colfft_cluster(const float* __restrict__ re, const float* __restrict__ im,
               float* __restrict__ ore, float* __restrict__ oim, int n2,
               long long n_total, long long col_base) {
  constexpr int N1 = 1 << LOGN1;
  constexpr int LOGP = LOGN1 - LOGCQ, P = 1 << LOGP;
  constexpr int LOGC = LOGP - LOGCKP;
  constexpr int LOGQC = LOGCQ - LOGC, QC = 1 << LOGQC;  // q a block loads
  constexpr int LOADS = QC * (CT / 2) / CTHREADS;       // (q, column pair) items
  static_assert(LOGC >= 1 && LOGC <= 3 && LOADS >= 1, "a portable cluster of 2..8 blocks");
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  float* sr = reinterpret_cast<float*>(smem4);
  float* si = sr + CLOCAL;
  float2* tw = reinterpret_cast<float2*>(si + CLOCAL);  // W_n1^k, k < n1/2

  const int c = static_cast<int>(cluster.block_rank());
  // cluster -> (batch entry b, slab j); n2 / CT slabs per entry
  const unsigned slab = blockIdx.x >> LOGC;
  const unsigned nblk = static_cast<unsigned>(n2 >> LOGCT);
  const int j = static_cast<int>(slab & (nblk - 1));
  const long long b = slab >> (31 - __clz(nblk));
  const long long n = static_cast<long long>(N1) * n2;  // the batch stride
  const float* xr = re + b * n + static_cast<long long>(j) * CT;
  const float* xi = im + b * n + static_cast<long long>(j) * CT;

  // rows i1 = Q*p + q, q in [QC*c, QC*c + QC), straight into registers;
  // item (q, column pair), the pair the fast axis: a warp reads two
  // 128-byte row segments per load
  float2 ar[LOADS][P], ai[LOADS][P];
#pragma unroll
  for (int it = 0; it < LOADS; ++it) {
    const int e = threadIdx.x + it * CTHREADS;
    const int cp = e & (CT / 2 - 1), q = QC * c + (e >> (LOGCT - 1));
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const long long off = static_cast<long long>(CQ * p + q) * n2 + 2 * cp;
      ar[it][p] = __ldg(reinterpret_cast<const float2*>(xr + off));
      ai[it][p] = __ldg(reinterpret_cast<const float2*>(xi + off));
    }
  }
  for (int k = threadIdx.x; k < N1 / 2; k += CTHREADS) {
    double s, cs;
    sincospi(-2.0 * k / N1, &s, &cs);
    tw[k] = make_float2(static_cast<float>(cs), static_cast<float>(s));
  }
  __syncthreads();

  // F(P) over p in registers for both columns, then W_n1^(kp*q); write
  // (kp, q - QC*c, column)
#pragma unroll
  for (int it = 0; it < LOADS; ++it) {
    const int e = threadIdx.x + it * CTHREADS;
    const int cp = e & (CT / 2 - 1), ql = e >> (LOGCT - 1), q = QC * c + ql;
    float xr0[P], xi0[P], xr1[P], xi1[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      xr0[p] = ar[it][p].x;
      xr1[p] = ar[it][p].y;
      xi0[p] = ai[it][p].x;
      xi1[p] = ai[it][p].y;
    }
    phastft::dif_group<LOGP>(xr0, xi0, 0, 0, LOGN1, LOGP, tw);
    phastft::dif_group<LOGP>(xr1, xi1, 0, 0, LOGN1, LOGP, tw);
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int kp = bitrev(u, LOGP);
      const int m = kp * q;  // < n1
      float2 w = tw[m & (N1 / 2 - 1)];
      if (m & (N1 / 2)) w = make_float2(-w.x, -w.y);
      const int at = ((kp << LOGQC) + ql) * CT + 2 * cp;
      *reinterpret_cast<float2*>(sr + at) =
          make_float2(xr0[u] * w.x - xi0[u] * w.y, xr1[u] * w.x - xi1[u] * w.y);
      *reinterpret_cast<float2*>(si + at) =
          make_float2(xr0[u] * w.y + xi0[u] * w.x, xr1[u] * w.y + xi1[u] * w.x);
    }
  }
  cluster.sync();

  // exchange, straight into the first trip of F(Q): item (column, r, kl)
  // takes q = r + 8j, j < 16, of kp = CKP*c + kl from block q / QC
  float yr[CITEMS][16], yi[CITEMS][16];
#pragma unroll
  for (int it = 0; it < CITEMS; ++it) {
    const int e = threadIdx.x + it * CTHREADS;
    const int col = e & (CT - 1), r = (e >> LOGCT) & 7, kl = e >> (LOGCT + 3);
    const int kp = CKP * c + kl;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int q = r + 8 * jj;
      const int at = ((kp << LOGQC) + (q & (QC - 1))) * CT + col;
      const unsigned src = static_cast<unsigned>(q >> LOGQC);
      yr[it][jj] = cluster.map_shared_rank(sr, src)[at];
      yi[it][jj] = cluster.map_shared_rank(si, src)[at];
    }
    phastft::dif_group<4>(yr[it], yi[it], r, 3, LOGN1, LOGCQ, tw);
  }
  // no block reads another's buffer past this point
  cluster.sync();
#pragma unroll
  for (int it = 0; it < CITEMS; ++it) {
    const int e = threadIdx.x + it * CTHREADS;
    const int col = e & (CT - 1), r = (e >> LOGCT) & 7, kl = e >> (LOGCT + 3);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int at = ((kl << LOGCQ) + r + 8 * jj) * CT + col;
      sr[at] = yr[it][jj];
      si[at] = yi[it][jj];
    }
  }
  __syncthreads();

  // the last three stages of F(Q): item (column, g, kl), q = 8g + s
#pragma unroll
  for (int it = 0; it < CLAST; ++it) {
    const int e = threadIdx.x + it * CTHREADS;
    const int col = e & (CT - 1), g = (e >> LOGCT) & 15, kl = e >> (LOGCT + 4);
    float xr8[8], xi8[8];
    int at[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      at[s] = ((kl << LOGCQ) + 8 * g + s) * CT + col;
      xr8[s] = sr[at[s]];
      xi8[s] = si[at[s]];
    }
    phastft::dif_group<3>(xr8, xi8, 0, 0, LOGN1, 3, tw);
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      sr[at[s]] = xr8[s];
      si[at[s]] = xi8[s];
    }
  }
  __syncthreads();

  // rows k1 = kp + P*kq: lanes (4 columns, kl, kq) write two rows of 128
  // bytes a kq, two kq a warp
#pragma unroll 2
  for (int it = 0; it < CSTORES; ++it) {
    const int e = threadIdx.x + it * CTHREADS;
    const int v = e & (CT / 4 - 1), kl = (e >> (LOGCT - 2)) & (CKP - 1);
    const int kq = e >> (LOGCT - 2 + LOGCKP);
    const int at = ((kl << LOGCQ) + bitrev(kq, LOGCQ)) * CT + 4 * v;
    store_row4<MODE>(ore, oim, *reinterpret_cast<const float4*>(sr + at),
                     *reinterpret_cast<const float4*>(si + at), b, CKP * c + kl + P * kq,
                     j * CT + 4 * v, N1, n2, n_total, col_base);
  }
}

using ClusterKernel = void (*)(const float*, const float*, float*, float*, int, long long,
                               long long);

// Whether the long-column design runs (n1, n2): n1 = 1024 or 2048 and a
// whole 32-column slab. colfft_kernel runs the rest: n1 <= 512 (on the
// H100 one 8192-point block of the cluster design at n1 = 512 measured
// 10-13% slower than colfft_kernel's slab) and narrower shard blocks.
bool long_columns(int n1, int n2) { return (n1 == 1024 || n1 == 2048) && n2 >= CT; }

// log2 of the cluster at n1 = 1024 or 2048 (4 or 8 blocks).
int cluster_log(int n1) { return phastft::ilog2(n1) - LOGCQ - LOGCKP; }

template <int MODE>
ClusterKernel cluster_kernel(int n1) {
  return n1 == 1024 ? colfft_cluster<MODE, 10> : colfft_cluster<MODE, 11>;
}

ClusterKernel cluster_kernel(int mode, int n1) {
  return mode == CLASSIC ? cluster_kernel<CLASSIC>(n1)
         : mode == OUT3D ? cluster_kernel<OUT3D>(n1)
                         : cluster_kernel<NOCORR>(n1);
}

int launch_cluster(int mode, const float* re, const float* im, float* ore, float* oim,
                   long long batch, int n1, int n2, long long n_total, long long col_base,
                   cudaStream_t stream) {
  static int resident[3][2] = {};  // per mode and n1, queried on first use
  const int logc = cluster_log(n1);
  const long long blocks = (batch * (n2 / CT)) << logc;
  return phastft::launch_clusters(cluster_kernel(mode, n1), 1 << logc, blocks, CTHREADS,
                                  cluster_smem_bytes(n1), stream,
                                  resident[mode][n1 == 2048], re, im, ore, oim, n2, n_total,
                                  col_base);
}

template <int MODE, int LOGT>
int launch(const float* re, const float* im, float* ore, float* oim,
           long long batch, int n1, int n2, int t, long long n_total, long long col_base,
           cudaStream_t stream) {
  const int logn1 = phastft::ilog2(n1);
  const long long blocks = batch * (n2 / t);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * sizeof(float) * padded_words(n1 * t) + sizeof(float2) * (n1 / 2 + 1);
  cudaError_t err = cudaFuncSetAttribute(colfft_kernel<MODE, LOGT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = n1 * t / 8 >= 512 ? 512 : 256;
  colfft_kernel<MODE, LOGT><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      re, im, ore, oim, logn1, phastft::ilog2(t), n2, n_total, col_base);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// re, im: (batch, n1, n2); ore, oim: (batch, n1, n2), or with mode 1
// (out3d) (batch, n2/128, n1, 128). mode 0 (classic), 1 (out3d), 2 (nocorr:
// no twiddle). n1 = 2..2048 and n2 >= 4 (>= 128 for out3d), powers of two.
// The twiddle is W_{n_total}^(k1*(col_base + i2)): n_total a power of two
// that is at least n1 * (col_base + n2) (n1 * n2 and 0 for a whole
// transform). Returns the CUDA error code of the launch (0 on success).
extern "C" int phastft_colfft(const float* re, const float* im, float* ore,
                              float* oim, long long batch, int n1, int n2,
                              int mode, long long n_total, long long col_base,
                              void* stream) {
  if (batch < 1 || !phastft::is_pow2(n1) || n1 < 2 || n1 > 2048 ||
      !phastft::is_pow2(n2) || n2 < (mode == OUT3D ? 128 : 4) || mode < CLASSIC ||
      mode > NOCORR || n_total < 1 || (n_total & (n_total - 1)) || col_base < 0 ||
      n_total / n1 < col_base + n2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (long_columns(n1, n2))
    return launch_cluster(mode, re, im, ore, oim, batch, n1, n2, n_total, col_base, s);
  const int t = slab_columns(n1, n2, mode == OUT3D);
  if (mode == CLASSIC)
    return launch<CLASSIC, 0>(re, im, ore, oim, batch, n1, n2, t, n_total, col_base, s);
  if (mode == NOCORR)
    return launch<NOCORR, 0>(re, im, ore, oim, batch, n1, n2, t, n_total, col_base, s);
  return launch<OUT3D, 4>(re, im, ore, oim, batch, n1, n2, t, n_total, col_base, s);
}

// The clusters of the long-column design at n1 = 1024 or 2048 in `mode`
// the current device holds at once (the CUDA occupancy query), or minus the
// CUDA error code.
extern "C" int phastft_colfft_clusters(int n1, int mode) {
  if (!long_columns(n1, CT) || mode < CLASSIC || mode > NOCORR)
    return -static_cast<int>(cudaErrorInvalidValue);
  return phastft::resident_clusters(cluster_kernel(mode, n1), 1 << cluster_log(n1), CTHREADS,
                                    cluster_smem_bytes(n1));
}
