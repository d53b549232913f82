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
// No trigonometry runs per element. The split twiddle is factored as the
// JAX kernel factors it (pallas_col.py _apply_split_corr), on the block's
// first column col0 rather than on the T2 tile:
//   W_N^(k1*i2') = T1[k1] * T2[k1, i2 - col0],
//   T1[k1] = W_N^((k1*col0) mod N), n1 values a block from the exact 64-bit
//   phase (sincospi in double, rounded once to float), in shared memory;
//   T2[k1, c] = W_N^(k1*(col_base + c)), the wrapper's table (the planner's
//   pcol / pcolT table, or the one a shard block's wrapper builds), read
//   with __ldg. Every block reads the same first columns of T2, which stay
//   in L1. The in-block W_n1^k come from a host-built table of exact f64
//   angles rounded once, loaded once a block.
//
// Two designs, chosen by shape in the C entry:
//
// One block a slab (colfft_block: n1 <= 512, and shard blocks narrower than
// 32 columns): a block owns T = min(8192 / n1, 512, n2) neighbouring columns
// of one entry (512 at n1 <= 16 down to 16 at n1 = 512; the T2 table is at
// least T wide), 8192 points at most, and runs 512 threads of 16 points
// capped at 64 registers, two blocks an SM, so one block's loads and stores
// overlap the other's trips. A call of fewer than two blocks an SM takes
// narrower slabs, down to 16 columns, and below 2^20 points its blocks
// prefetch the T2 rows into L1 while the first trip's loads fly: on the
// H100 (NVIDIA H100 80GB HBM3, 700.00 W) the fused 2^17 plan's (128, 1024)
// column pass read 0.0126 ms on 64-column slabs, 0.0109 on 16 and 0.0099
// with the prefetch, and the prefetch cost 2-4% from 2^20 points up.
// -Xptxas -v (sm_90a): 64 registers (60 at n1 = 2); spills of 8 B a thread
// at n1 = 8 and 256, 16 B at 16, 4 B stored and 16 loaded at 512, none at
// the other n1.
// - F(n1) runs as trips of S radix-2 DIF stages in registers, taken as
//   radix-4 layers and a radix-2 for an odd S: F(n1) as 2 | 4 | 8 | 16 |
//   4.8 | 8.8 | 16.8 | 16.16 | 8.8.8 | 16.8.8 | 16.16.8 for n1 = 2..2048.
//   A thread moves 16 points a trip: 16 >> S groups of 2^S, each one
//   column; neighbouring threads on neighbouring columns.
// - The first trip reads its groups straight from device memory (every load
//   of a thread in flight before the first butterfly; a warp reads 128
//   contiguous bytes of a row and plane when T >= 32; at T <= 32 each load
//   asks L2 for the 256-byte span around it, which the neighbouring slabs'
//   blocks read: 1.05x at n1 = 512 on the H100 80GB HBM3 at 700.00 W, and no
//   slower elsewhere). Shared memory is touched only between trips. The
//   last trip multiplies by T1 * T2 in its registers and stores straight to
//   device memory, a warp 32 neighbouring
//   columns of one row k1 (128 contiguous bytes a plane: the segments float4
//   stores would write). The DIF leaves X[k1] at position bitrev(k1), which
//   the store's row index undoes.
// - Shared-memory accesses per point (a read or a write of one float of
//   each plane): 0 at n1 <= 16, 2 at n1 = 32..256, 4 at 512..2048, where
//   staging the slab in shared memory for radix-2 trips of three stages
//   makes 6..12. tests/test_torch_colslab.py counts them from its
//   re-enactment of this schedule.
// - Bank conflicts: element i1 of column q sits at word
//   (i1 ^ ((i1 >> SL) & zmask)) * T + q of each plane, SL the last trip's
//   stages and zmask = 32 / T - 1 below T = 32 (else 0): a warp's lanes on
//   32 neighbouring columns of one row, or below T = 32 on 32 / T rows that
//   the XOR spreads over distinct banks. Every data access is free of bank
//   conflicts (the test counts them); twiddle reads are broadcasts at
//   T >= 32.
//
// Long columns (n1 = 1024, 2048; n2 >= 32): colfft_cluster. A slab of
// T = 32 columns (128-byte row segments) is split over a cluster of
// C = n1/256 blocks (4 or 8) of 8192 points (64 KB, ~74 KB of shared
// memory with the tables), 256 threads capped at 80 registers, so
// three blocks share an SM and one block's loads and stores overlap
// another's radix passes. At that cap ptxas spills 48-52 B a thread in the
// classic and out3d modes, 0-4 B in the bare mode (-Xptxas -v for sm_90a);
// the table twiddle, which costs those spills, made the path 1.05-1.10x
// faster than a sincospi per element on the H100 (80GB HBM3, 700.00 W).
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
//     writes rows k1 = kp + P*kq as float4s, 128 bytes a row, times T1 * T2
//     (T1 for the block's 256 rows).
//   Shared memory is rows of 32 words, one word per bank, so every phase
//   is free of bank conflicts without padding. On the H100 a 16-column
//   slab (64-byte segments, 2- and 4-block clusters) measured 1.21-1.24x
//   slower, a 64-column slab (8- and 16-block clusters) 1.06x slower at
//   n1 = 2048, and this design at n1 = 512 0.87-0.91x the one-block path.
//
// The classic and nocorr modes take any n2 >= 1: a shard's column block, and
// the rows of a split planned with leaf_fft_size < 128, can be narrower than
// a slab, which is then n2 wide. Below 4 columns (T = 1, 2) colfft_block
// runs as it does at T = 4: one thread a group of 2^S points of one column,
// scalar loads and stores, the same F(n1) trips and T1 * T2 twiddle (a
// one-column table at n2 = 1), and a block of n1 * T points. The
// batch is folded into gridDim.x (up to 2^31 - 1 blocks, the cluster factor
// counted) and every device-memory offset is 64-bit: the inner level of a
// nested plan has a batch of 32..512 per transform, and one transform of
// 2^30 points already reaches offsets of 2^30.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "fft_smem.cuh"

namespace cg = cooperative_groups;
using phastft::bitrev;

namespace {

enum Mode { CLASSIC = 0, OUT3D = 1, NOCORR = 2 };

// W_N^k for 0 <= k < N, N = 2^logn, from a table of W_N^k for k < N/2
// (W_N^(k + N/2) = -W_N^k, exact).
__device__ __forceinline__ float2 twiddle(const float2* tw, int k, int logn) {
  const int h = 1 << (logn - 1);
  const float2 w = tw[k & (h - 1)];
  return (k & h) ? make_float2(-w.x, -w.y) : w;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

__device__ __forceinline__ void cmul_in(float& xr, float& xi, float2 w) {
  const float r = xr * w.x - xi * w.y;
  xi = xr * w.y + xi * w.x;
  xr = r;
}

// W_N^((k1*col0) mod N), the block's T1 entry of row k1, from the exact
// 64-bit phase: sincospi in double, rounded once to float.
__device__ __forceinline__ float2 block_t1(int k1, long long col0, long long n_total) {
  const long long m = (static_cast<long long>(k1) * col0) & (n_total - 1);
  double s, c;
  sincospi(-2.0 * static_cast<double>(m) / static_cast<double>(n_total), &s, &c);
  return make_float2(static_cast<float>(c), static_cast<float>(s));
}

// S radix-2 DIF stages on one group held in registers, f64.cuh's dif4_group
// in f32: element j of the group sits at position r + j*R of its span
// L = 2^logL (R = 2^logR = L / 2^S), taken as radix-4 layers (a = x0 + x2,
// b = x1 + x3, c = x0 - x2, d = -i(x1 - x3); out a + b, (a - b) W^2r,
// (c + d) W^r, (c - d) W^3r, the outputs in their bit-reversed places) and,
// for an odd S, a last radix-2. tw: W_W^k, k < W/2, W = 2^logW >= L.
template <int S>
__device__ __forceinline__ void dif4_group(float (&xr)[1 << S], float (&xi)[1 << S], int r,
                                           int logR, int logW, int logL, const float2* tw) {
#pragma unroll
  for (int t = 0; t + 2 <= S; t += 2) {
    const int h = 1 << (S - 2 - t);
    const int shift = logW - logL + t;
    const bool trivial = logL - t == 2;
#pragma unroll
    for (int j = 0; j < (1 << S); ++j) {
      if (j & (3 * h)) continue;
      const int k = (r + ((j & (h - 1)) << logR)) << shift;
      const float ar = xr[j] + xr[j + 2 * h], ai = xi[j] + xi[j + 2 * h];
      const float br = xr[j + h] + xr[j + 3 * h], bi = xi[j + h] + xi[j + 3 * h];
      const float cr = xr[j] - xr[j + 2 * h], ci = xi[j] - xi[j + 2 * h];
      const float dr = xi[j + h] - xi[j + 3 * h], di = xr[j + 3 * h] - xr[j + h];
      xr[j] = ar + br;
      xi[j] = ai + bi;
      xr[j + h] = ar - br;
      xi[j + h] = ai - bi;
      xr[j + 2 * h] = cr + dr;
      xi[j + 2 * h] = ci + di;
      xr[j + 3 * h] = cr - dr;
      xi[j + 3 * h] = ci - di;
      if (!trivial) {
        cmul_in(xr[j + h], xi[j + h], twiddle(tw, 2 * k, logW));
        cmul_in(xr[j + 2 * h], xi[j + 2 * h], twiddle(tw, k, logW));
        cmul_in(xr[j + 3 * h], xi[j + 3 * h], twiddle(tw, 3 * k, logW));
      }
    }
  }
  if (S & 1) {
    const int shift = logW - logL + S - 1;
    const bool trivial = logL - (S - 1) == 1;
#pragma unroll
    for (int j = 0; j < (1 << S); j += 2) {
      const float ar = xr[j], ai = xi[j];
      xr[j] = ar + xr[j + 1];
      xi[j] = ai + xi[j + 1];
      xr[j + 1] = ar - xr[j + 1];
      xi[j + 1] = ai - xi[j + 1];
      if (!trivial) cmul_in(xr[j + 1], xi[j + 1], twiddle(tw, r << shift, logW));
    }
  }
}

// -- one block a slab

constexpr int THREADS = 512;
constexpr int PER_THREAD = 16;   // points a thread moves a trip
constexpr int LOCAL = 8192;      // points a block holds at most
constexpr int MAX_T = 512;       // the widest slab: the T2 tables' width
constexpr int FILL = 2;          // blocks an SM a small call is spread over
constexpr int MIN_FILL_LOGT = 4;  // ... by slabs down to 16 columns
// Calls of fewer points wait on latency: their blocks prefetch the T2 rows
// the last trip reads into L1 while the first trip's loads fly.
constexpr long long PREFETCH_POINTS = 1LL << 20;

// Stages of trip i of F(2^logn1), the first trip first.
__host__ __device__ constexpr int f1_stages(int logn1, int i) {
  return logn1 <= 4 ? (i == 0 ? logn1 : 0)
         : logn1 == 5 ? (i == 0 ? 2 : i == 1 ? 3 : 0)
         : logn1 == 6 ? (i < 2 ? 3 : 0)
         : logn1 == 7 ? (i == 0 ? 4 : i == 1 ? 3 : 0)
         : logn1 == 8 ? (i < 2 ? 4 : 0)
         : logn1 == 9 ? (i < 3 ? 3 : 0)
         : logn1 == 10 ? (i == 0 ? 4 : i < 3 ? 3 : 0)
                       : (i < 2 ? 4 : i == 2 ? 3 : 0);
}

// log2 of the slab width at (n1, n2) for `batch` entries: LOCAL points, at
// most MAX_T and n2; narrowed down to MIN_FILL_T columns while the call has
// fewer than FILL blocks an SM.
int slab_log(int logn1, int logn2, long long batch) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 1;
  }
  int logt = phastft::ilog2(LOCAL) - logn1;
  while ((1 << logt) > MAX_T) --logt;
  if (logt > logn2) logt = logn2;
  while (logt > MIN_FILL_LOGT && (batch << (logn2 - logt)) < static_cast<long long>(FILL) * sms)
    --logt;
  return logt;
}

// The block's view of its slab and of where its results go.
struct Slab {
  const float* __restrict__ xr;   // input at (entry, 0, col0)
  const float* __restrict__ xi;
  float* __restrict__ ore;        // output of the entry
  float* __restrict__ oim;
  const float* __restrict__ t2r;  // T2, row stride ldt (null in the nocorr mode)
  const float* __restrict__ t2i;
  const float2* t1;               // T1 of the block's rows, in shared memory
  long long n2;                   // row stride
  int ldt, logt, zmask, col0, mode, logn1;
};

// A read-only load that has L2 fetch the 256-byte span around it: a slab of
// T <= 32 columns reads 64- or 128-byte pieces of each row, and the blocks
// of the neighbouring slabs, running at the same time, the rest.
__device__ __forceinline__ float load_span(const float* p) {
  float v;
  asm volatile("ld.global.nc.L2::256B.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// Word of element i1 of column q in each plane (see the header).
template <int SL>
__device__ __forceinline__ int slot(const Slab& s, int i1, int q) {
  return ((i1 ^ ((i1 >> SL) & s.zmask)) << s.logt) + q;
}

// Output k1 of column q: times T1[k1] * T2[k1, q] (but in the nocorr mode),
// stored at its place in the mode's layout.
__device__ __forceinline__ void store(const Slab& s, int k1, int q, float vr, float vi) {
  if (s.mode != NOCORR) {
    const int at = k1 * s.ldt + q;
    const float2 w = cmul(s.t1[k1], make_float2(__ldg(s.t2r + at), __ldg(s.t2i + at)));
    cmul_in(vr, vi, w);
  }
  const int i2 = s.col0 + q;
  const long long o =
      s.mode == OUT3D
          ? ((static_cast<long long>(i2 >> 7) << s.logn1) + k1) * 128 + (i2 & 127)
          : static_cast<long long>(k1) * s.n2 + i2;
  s.ore[o] = vr;
  s.oim[o] = vi;
}

// One trip of F(2^LOGN1) over the block's T columns: S stages at span
// 2^LOGL. Item e = (rest, q), q = e mod T the column, a group of 2^S
// elements i1 = p + j*R. FIRST: the groups come from device memory, then
// prep() fills the tables and a __syncthreads makes them visible. LAST
// (R = 1): each output is stored by store(). SL: the last trip's stages.
template <int S, int LOGL, int LOGN1, int SL, bool FIRST, bool LAST, class Prep>
__device__ __forceinline__ void trip(const Slab& s, float* sr, float* si, const float2* tw,
                                     const Prep& prep) {
  constexpr int LOGR = LOGL - S, ITEMS = PER_THREAD >> S;
  const int items = (1 << (LOGN1 + s.logt)) >> S;
  const int tmask = (1 << s.logt) - 1;
  float xr[ITEMS][1 << S], xi[ITEMS][1 << S];
  int q[ITEMS], p[ITEMS], r[ITEMS];
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const int e = threadIdx.x + u * blockDim.x;
    const int rest = e >> s.logt;
    q[u] = e & tmask;
    r[u] = rest & ((1 << LOGR) - 1);
    p[u] = ((rest >> LOGR) << LOGL) + r[u];
    if (e >= items) continue;
#pragma unroll
    for (int j = 0; j < (1 << S); ++j) {
      const int i1 = p[u] + (j << LOGR);
      if (FIRST) {
        const long long off = static_cast<long long>(i1) * s.n2 + q[u];
        if (s.logt < 6) {
          xr[u][j] = load_span(s.xr + off);
          xi[u][j] = load_span(s.xi + off);
        } else {
          xr[u][j] = __ldg(s.xr + off);
          xi[u][j] = __ldg(s.xi + off);
        }
      } else {
        const int w = slot<SL>(s, i1, q[u]);
        xr[u][j] = sr[w];
        xi[u][j] = si[w];
      }
    }
  }
  if (FIRST) {
    prep();
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    if (static_cast<int>(threadIdx.x + u * blockDim.x) >= items) continue;
    dif4_group<S>(xr[u], xi[u], r[u], LOGR, LOGN1, LOGL, tw);
#pragma unroll
    for (int j = 0; j < (1 << S); ++j) {
      const int i1 = p[u] + (j << LOGR);
      if (LAST) {
        store(s, bitrev(i1, LOGN1), q[u], xr[u][j], xi[u][j]);
      } else {
        const int w = slot<SL>(s, i1, q[u]);
        sr[w] = xr[u][j];
        si[w] = xi[u][j];
      }
    }
  }
}

template <int LOGN1>
__global__ void __launch_bounds__(THREADS, 2)
colfft_block(const float* __restrict__ re, const float* __restrict__ im,
             const float2* __restrict__ steps, const float* __restrict__ t2r,
             const float* __restrict__ t2i, int ldt, float* __restrict__ ore,
             float* __restrict__ oim, int n2, int logt, int mode, long long n_total,
             int prefetch) {
  constexpr int N1 = 1 << LOGN1;
  constexpr int S0 = f1_stages(LOGN1, 0), S1 = f1_stages(LOGN1, 1), S2 = f1_stages(LOGN1, 2);
  constexpr int SL = S2 ? S2 : S1 ? S1 : S0;
  extern __shared__ float4 smem4[];
  const int points = N1 << logt;
  float* sr = reinterpret_cast<float*>(smem4);
  float* si = sr + (S1 ? points : 0);
  float2* tw = reinterpret_cast<float2*>(si + (S1 ? points : 0));  // W_n1^k, k < n1/2
  float2* t1 = tw + N1 / 2;                                        // T1[k1], k1 < n1

  // block -> (batch entry b, slab j); n2 / T slabs per entry, a power of two
  const unsigned nblk = static_cast<unsigned>(n2 >> logt);
  const int col0 = static_cast<int>(blockIdx.x & (nblk - 1)) << logt;
  const long long b = blockIdx.x >> (31 - __clz(nblk));
  const long long n = static_cast<long long>(N1) * n2;  // the batch stride
  const Slab s{re + b * n + col0, im + b * n + col0, ore + b * n, oim + b * n, t2r, t2i, t1,
               n2, ldt, logt, logt < 5 ? (32 >> logt) - 1 : 0, col0, mode, LOGN1};
  const auto prep = [&]() {
    if (mode != NOCORR && prefetch)  // the T2 rows the last trip reads, into L1
      for (int k = threadIdx.x; k < 2 * N1; k += blockDim.x) {
        const float* row = ((k & 1) ? t2i : t2r) + static_cast<long long>(k >> 1) * ldt;
        for (int c = 0; c < (1 << logt); c += 32)
          asm volatile("prefetch.global.L1 [%0];" ::"l"(row + c));
      }
    for (int k = threadIdx.x; k < N1 / 2; k += blockDim.x) tw[k] = __ldg(steps + k);
    if (mode != NOCORR)
      for (int k = threadIdx.x; k < N1; k += blockDim.x) t1[k] = block_t1(k, col0, n_total);
  };
  const auto none = []() {};

  if constexpr (S1 == 0) {
    trip<S0, LOGN1, LOGN1, SL, true, true>(s, sr, si, tw, prep);
  } else {
    trip<S0, LOGN1, LOGN1, SL, true, false>(s, sr, si, tw, prep);
    __syncthreads();
    if constexpr (S2 == 0) {
      trip<S1, LOGN1 - S0, LOGN1, SL, false, true>(s, sr, si, tw, none);
    } else {
      trip<S1, LOGN1 - S0, LOGN1, SL, false, false>(s, sr, si, tw, none);
      __syncthreads();
      trip<S2, S2, LOGN1, SL, false, true>(s, sr, si, tw, none);
    }
  }
}

using BlockKernel = void (*)(const float*, const float*, const float2*, const float*,
                             const float*, int, float*, float*, int, int, int, long long, int);

BlockKernel block_kernel(int logn1) {
  switch (logn1) {
    case 1: return colfft_block<1>;
    case 2: return colfft_block<2>;
    case 3: return colfft_block<3>;
    case 4: return colfft_block<4>;
    case 5: return colfft_block<5>;
    case 6: return colfft_block<6>;
    case 7: return colfft_block<7>;
    case 8: return colfft_block<8>;
    case 9: return colfft_block<9>;
    case 10: return colfft_block<10>;
    default: return colfft_block<11>;
  }
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
  return 2 * sizeof(float) * CLOCAL + sizeof(float2) * (n1 / 2 + CKP * CQ);
}

// n1 = 2^LOGN1 (1024 or 2048) = P * Q: a cluster of C = P / CKP blocks (4 or 8).
// Shared memory holds rows of CT = 32 words, one per bank: every phase's
// warp reads or writes whole rows, so no padding is needed.
template <int MODE, int LOGN1>
__global__ void __launch_bounds__(CTHREADS, 3)
colfft_cluster(const float* __restrict__ re, const float* __restrict__ im,
               const float2* __restrict__ steps, const float* __restrict__ t2r,
               const float* __restrict__ t2i, int ldt, float* __restrict__ ore,
               float* __restrict__ oim, int n2, long long n_total) {
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
  float2* t1 = tw + N1 / 2;                             // T1 of rows (kl, kq)

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
  for (int k = threadIdx.x; k < N1 / 2; k += CTHREADS) tw[k] = __ldg(steps + k);
  if (MODE != NOCORR)
    for (int k = threadIdx.x; k < CKP * CQ; k += CTHREADS)
      t1[k] = block_t1(CKP * c + (k >> LOGCQ) + P * (k & (CQ - 1)),
                       static_cast<long long>(j) * CT, n_total);
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
      const float2 w = twiddle(tw, kp * q, LOGN1);  // kp * q < n1
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
  // bytes a kq, two kq a warp; T1 of row (kl, kq) times T2[k1, column]
#pragma unroll 2
  for (int it = 0; it < CSTORES; ++it) {
    const int e = threadIdx.x + it * CTHREADS;
    const int v = e & (CT / 4 - 1), kl = (e >> (LOGCT - 2)) & (CKP - 1);
    const int kq = e >> (LOGCT - 2 + LOGCKP);
    const int at = ((kl << LOGCQ) + bitrev(kq, LOGCQ)) * CT + 4 * v;
    const int k1 = CKP * c + kl + P * kq;
    float4 a = *reinterpret_cast<const float4*>(sr + at);
    float4 d = *reinterpret_cast<const float4*>(si + at);
    if (MODE != NOCORR) {
      const float2 w1 = t1[(kl << LOGCQ) + kq];
      const long long tat = static_cast<long long>(k1) * ldt + 4 * v;
      const float4 br = __ldg(reinterpret_cast<const float4*>(t2r + tat));
      const float4 bi = __ldg(reinterpret_cast<const float4*>(t2i + tat));
      cmul_in(a.x, d.x, cmul(w1, make_float2(br.x, bi.x)));
      cmul_in(a.y, d.y, cmul(w1, make_float2(br.y, bi.y)));
      cmul_in(a.z, d.z, cmul(w1, make_float2(br.z, bi.z)));
      cmul_in(a.w, d.w, cmul(w1, make_float2(br.w, bi.w)));
    }
    const int i2 = j * CT + 4 * v;
    const long long o =
        MODE == OUT3D ? ((b * (n2 >> 7) + (i2 >> 7)) * N1 + k1) * 128 + (i2 & 127)
                      : b * n + static_cast<long long>(k1) * n2 + i2;
    *reinterpret_cast<float4*>(ore + o) = a;
    *reinterpret_cast<float4*>(oim + o) = d;
  }
}

using ClusterKernel = void (*)(const float*, const float*, const float2*, const float*,
                               const float*, int, float*, float*, int, long long);

// Whether the long-column design runs (n1, n2): n1 = 1024 or 2048 and a
// whole 32-column slab. colfft_block runs the rest: n1 <= 512 (on the
// H100 one 8192-point block of the cluster design at n1 = 512 measured
// 10-13% slower than a one-block slab) and narrower shard blocks.
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

}  // namespace

// re, im: (batch, n1, n2); ore, oim: (batch, n1, n2), or with mode 1
// (out3d) (batch, n2/128, n1, 128). mode 0 (classic), 1 (out3d), 2 (nocorr:
// no twiddle). n1 = 2..2048 and n2 >= 1 (>= 128 for out3d), powers of two.
// steps: n1/2 (re, im) f32 pairs, W_n1^k. t2r, t2i: the (n1, ldt) T2 table,
// T2[k1, c] = W_{n_total}^(k1*(col_base + c)), at least as wide as a slab
// (min(8192 / n1, 512, n2) columns, 32 at n1 = 1024 / 2048 with n2 >= 32;
// unused with mode 2). n_total: a power of two that is at least
// n1 * (col_base + n2) (n1 * n2 and 0 for a whole transform). Returns the
// CUDA error code of the launch (0 on success).
extern "C" int phastft_colfft(const float* re, const float* im, const void* steps,
                              const float* t2r, const float* t2i, int ldt, float* ore,
                              float* oim, long long batch, int n1, int n2, int mode,
                              long long n_total, long long col_base, void* stream) {
  if (batch < 1 || !phastft::is_pow2(n1) || n1 < 2 || n1 > 2048 ||
      !phastft::is_pow2(n2) || (mode == OUT3D && n2 < 128) || mode < CLASSIC ||
      mode > NOCORR || n_total < 1 || (n_total & (n_total - 1)) || col_base < 0 ||
      n_total / n1 < col_base + n2 || steps == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int logn1 = phastft::ilog2(n1), logn2 = phastft::ilog2(n2);
  const bool longc = long_columns(n1, n2);
  const int logt = longc ? LOGCT : slab_log(logn1, logn2, batch);
  if (mode != NOCORR && (t2r == nullptr || t2i == nullptr || ldt < (1 << logt)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float2* tw = static_cast<const float2*>(steps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (longc) {
    static int resident[3][2] = {};  // per mode and n1, queried on first use
    const int logc = cluster_log(n1);
    const long long blocks = (batch * (n2 / CT)) << logc;
    return phastft::launch_clusters(cluster_kernel(mode, n1), 1 << logc, blocks, CTHREADS,
                                    cluster_smem_bytes(n1), s, resident[mode][n1 == 2048], re,
                                    im, tw, t2r, t2i, ldt, ore, oim, n2, n_total);
  }
  const long long blocks = batch << (logn2 - logt);
  if (blocks > 0x7fffffffLL || (blocks >> (logn2 - logt)) != batch)
    return static_cast<int>(cudaErrorInvalidValue);
  const int points = n1 << logt;
  const int threads = points / PER_THREAD < 32 ? 32 : points / PER_THREAD;
  const size_t smem = sizeof(float) * (f1_stages(logn1, 1) ? 2 * points : 0) +
                      sizeof(float2) * (n1 / 2 + n1);
  const BlockKernel kernel = block_kernel(logn1);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int prefetch = batch * n1 * n2 < PREFETCH_POINTS;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, s>>>(re, im, tw, t2r, t2i, ldt, ore,
                                                              oim, n2, logt, mode, n_total,
                                                              prefetch);
  return static_cast<int>(cudaGetLastError());
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
