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
// arithmetic (~3.5 FP64 instructions per point and stage, 16 stages and the
// correction at 2^16) takes about a third of the bytes' time at 132 SMs x 64
// FP64 lanes. A point is 16 B, so every trip through shared memory moves as
// many bytes as the point's whole device-memory traffic: the design makes as
// few trips as 128 registers a thread allow. On a cluster two costs remain
// that no trip count removes (PERF.md): every point crosses the SM-to-SM
// network once in the exchange, and at 2^16 a block reads 64-byte pieces of
// each row (W = 8 columns), which the loads ask L2 to fetch as whole lines.
//
// Design:
// - A block holds 4096 points (65,536 B of shared memory, plus the step
//   tables, <= 72,576 B) and runs 256 threads of 16 points each at <= 128
//   registers, two blocks an SM (__launch_bounds__(256, 2); ptxas -v: 128
//   registers at 2^10 and 2^12..2^16, 124-127 at 2^8, 2^9, 2^11, 2^13,
//   96-124 below, no spills).
// - Trips of S radix-2 DIF stages in registers, taken as radix-4 layers and
//   a radix-2 for an odd S: F(n1) as 2 | 4 | 8 | 16 | 8.4 | 8.8 | 16.8 |
//   16.16 | 8.8.8 for n1 = 2 .. 512, F(128) as 16.8, F(64) 8.8, F(32) 4.8,
//   F(n <= 16) one trip. Each thread moves 16 points a trip: one radix-16
//   group, or two radix-8, four radix-4, eight radix-2 groups.
// - The first trip of a row reads its groups straight from device memory
//   (neighbouring threads on neighbouring columns i2: 64-256 contiguous
//   bytes of each plane a warp and load); the last trip of F(n1) multiplies
//   the correction in its registers; the last trip of F(n2), radix-8 over
//   span 8, stores straight to device memory with the lanes of a warp on 32
//   neighbouring outputs of one k2 (256 contiguous bytes a plane), each
//   value times out_scale (1, or 1/N where this leaf ends an inverse: the
//   same bits as a separate multiply after the kernel, without its second
//   pass over memory).
// - Up to n = 2^12 a block holds R = 4096 / n whole rows (the last block
//   masks rows past the batch), laid out (i1, r, i2): F(n1) over all R * 128
//   columns at once, F(128) over all n1 * R rows. n <= 16: the rows pass
//   through shared memory in natural order (contiguous loads and stores), one
//   trip in registers; n = 32..128: two trips (F(n / 8) from the loads, the
//   radix-8 to the stores).
// - From n = 2^13 a row of n1 = 32 * C points per column is held by a
//   cluster of C = 2, 4, 8, 16 blocks (16 is a non-portable cluster size,
//   set at launch; the entry refuses a shape no cluster of which fits the
//   device). Block c runs F(n1) and the correction on the W = 128 / C
//   columns i2 in [W c, W c + W), and after a cluster barrier reads its 32
//   rows k1 in [32c, 32c + 32) from every block (distributed shared memory,
//   mapa + ld.shared::cluster) straight into the radix-16 trip of F(128). It
//   arrives on a second barrier right after its last remote read, runs the
//   radix-16 in registers, and waits on that barrier just before it writes
//   its own buffer again.
// - Shared-memory accesses per point (a read or a write of a 16-byte point;
//   the step tables not counted): 8 at 2^16, 6 at 2^13..2^15 and 2^12, 4 at
//   2^8..2^11 and at n <= 16, 2 at 32..128 (the parent design: 16, 16, 12,
//   10 at 2^10; tests/test_torch_leaf64.py counts them from its re-enactment
//   of this schedule).
// - Barriers: one __syncthreads after every trip that writes shared memory;
//   on a cluster one full cluster barrier after F(n1) and the split one
//   around the exchange.
// - Bank conflicts: a warp's 16-byte accesses are served a quarter-warp (8
//   lanes) at a time. Point w sits at slot(w) = w ^ h(w >> 3), h the XOR of
//   the three 3-bit fields of w >> 3 (bits 3..11 of w): every aligned run of
//   8 points fills its own 8 slots, so an access whose quarter-warp reads
//   such a run (neighbouring columns, or a group's neighbouring offsets) is
//   free of conflicts; the row-strided accesses (the last trip of F(n2), the
//   rows at n <= 16) land on 8 banks too, because their 8 rows differ in bits
//   that h folds onto distinct values (2 a bank in the last trip at n = 256
//   only). The radix-16 of F(128) reads its twiddles from a table laid out
//   for its lanes (conflict-free); the other trips read theirs as broadcasts.
// - Twiddles W_n1^k and W_n2^k come from the planner's tables of exact f64
//   angles, the correction from its leaf{n1}; no trigonometry runs in the
//   kernel.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "f64.cuh"

namespace cg = cooperative_groups;
using phastft::bitrev;
namespace fk = phastft::f64k;
using fk::cd;

namespace {

constexpr int M = 128, LOGM = 7;
constexpr int THREADS = 256;
// Points a block holds, points a thread moves a trip, rows k1 a cluster
// block owns after the exchange.
constexpr int LOCAL = 4096, LOG_LOCAL = 12, PER_THREAD = 16, KROWS = 32;

// The bit reverse of k < 2^bits, for indices the compiler knows.
__host__ __device__ constexpr int rev(int k, int bits) {
  int out = 0;
  for (int b = 0; b < bits; ++b) out |= ((k >> b) & 1) << (bits - 1 - b);
  return out;
}

// Shared slot of point w (see the header).
__device__ __forceinline__ int slot(int w) {
  return w ^ (((w >> 3) ^ (w >> 6) ^ (w >> 9)) & 7);
}

// Stages of the i-th trip of F(2^logn1), the first trip first.
__host__ __device__ constexpr int f1_stages(int logn1, int i) {
  return logn1 <= 4 ? (i == 0 ? logn1 : 0)
         : logn1 == 5 ? (i == 0 ? 3 : i == 1 ? 2 : 0)
         : logn1 == 6 ? (i < 2 ? 3 : 0)
         : logn1 == 7 ? (i == 0 ? 4 : i == 1 ? 3 : 0)
         : logn1 == 8 ? (i < 2 ? 4 : 0)
                      : (i < 3 ? 3 : 0);
}

// Entries of the radix-16 / radix-8 / radix-4 first trip of F(n2)'s lane
// table (n2 = 128, 64, 32): 3 twiddles x h butterflies x 8 lanes a radix-4
// layer, 8 for a last radix-2.
__host__ __device__ constexpr int lane_table_size(int logn2) {
  return logn2 == 7 ? 3 * 4 * 8 + 3 * 8 : logn2 == 6 ? 3 * 2 * 8 + 8 : logn2 == 5 ? 3 * 8 : 0;
}

size_t smem_bytes(int n1, int n2) {
  return sizeof(cd) * (LOCAL + (n1 > 1 ? n1 / 2 : 0) + n2 / 2 +
                       lane_table_size(phastft::ilog2(n2)));
}

// W_N^m, 0 <= m < N, from a table of W_N^m for m < N/2 (W^(m + N/2) = -W^m).
template <int LOGN>
__device__ __forceinline__ cd step(const cd* tw, int m) {
  const cd w = tw[m & ((1 << (LOGN - 1)) - 1)];
  return (m >> (LOGN - 1)) & 1 ? make_double2(-w.x, -w.y) : w;
}

// The twiddles of a trip at span 2^LOGL, R = 2^LOGR, from a table of W_N
// (N = 2^LOGN >= the span): tw(t, jj, k) = W_(L >> t)^(k (r + jj R)), the
// radix-4 layer t's twiddle k of butterfly jj; read as broadcasts when the
// lanes of a quarter-warp share r.
template <int LOGN, int LOGL, int LOGR>
struct TableTw {
  const cd* tw;
  int r;
  __device__ __forceinline__ cd operator()(int t, int jj, int k) const {
    return step<LOGN>(tw, (k * (r + (jj << LOGR))) << (LOGN - LOGL + t));
  }
};

// The first trip of F(n2) (span n2, R = 8): its lane table, entry
// off(t) + ((k - 1) h + jj) * 8 + r = W_(n2 >> t)^(k (r + 8 jj)), the lanes
// of a quarter-warp on the 8 values of r.
template <int S>
struct LaneTw {
  const cd* ta;
  int r;
  __device__ __forceinline__ cd operator()(int t, int jj, int k) const {
    const int h = t + 2 <= S ? 1 << (S - 2 - t) : 1;
    const int off = t == 0 ? 0 : 3 * 8 * (1 << (S - 2));
    return ta[off + (((k - 1) * h + jj) << 3) + r];
  }
};

// Builds the lane table of F(2^LOGN2)'s first trip from the W_n2 table.
template <int LOGN2>
__device__ __forceinline__ void build_lane_table(cd* ta, const cd* __restrict__ tw2t) {
  constexpr int S = LOGN2 - 3;
  for (int e = threadIdx.x; e < lane_table_size(LOGN2); e += THREADS) {
    const int first = 3 * 8 * (1 << (S - 2));  // entries of layer 0
    int t, k, jj, r = e & 7;
    if (e < first) {
      t = 0;
      k = (e >> 3) / (1 << (S - 2)) + 1;
      jj = (e >> 3) % (1 << (S - 2));
    } else if (S >= 4) {
      t = 2;
      k = ((e - first) >> 3) + 1;
      jj = 0;
    } else {  // the radix-2 layer of an odd S: W_16^r
      t = S - 1;
      k = 1;
      jj = 0;
    }
    const int m = (k * (r + 8 * jj)) << t;  // in units of W_n2
    const cd w = __ldg(tw2t + (m & ((1 << (LOGN2 - 1)) - 1)));
    ta[e] = (m >> (LOGN2 - 1)) & 1 ? make_double2(-w.x, -w.y) : w;
  }
}

// A read-only load that has L2 fetch the whole 128-byte line: a cluster
// block reads W * 8 contiguous bytes of each row, 64 at 2^16, and its
// neighbour the rest of the line.
__device__ __forceinline__ double load_line(const double* p) {
  double v;
  asm volatile("ld.global.nc.L2::128B.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void load_table(cd* tw, int entries, const cd* __restrict__ t) {
  for (int k = threadIdx.x; k < entries; k += THREADS) tw[k] = __ldg(t + k);
}

// S radix-2 DIF stages on a group held in registers: element j at position
// r + j R of its span (the outputs in bit-reversed places), as radix-4
// layers (f64.cuh's butterfly order) and, for an odd S, a last radix-2.
// R1: R = 1 (r = 0), so butterfly 0 of every layer is trivial.
template <int S, bool R1, class Tw>
__device__ __forceinline__ void dif_group(cd (&x)[1 << S], const Tw& tw) {
#pragma unroll
  for (int t = 0; t + 2 <= S; t += 2) {
    const int h = 1 << (S - 2 - t);
#pragma unroll
    for (int j = 0; j < (1 << S); ++j) {
      if (j & (3 * h)) continue;
      const int jj = j & (h - 1);
      const cd a = fk::cadd(x[j], x[j + 2 * h]), b = fk::cadd(x[j + h], x[j + 3 * h]);
      const cd c = fk::csub(x[j], x[j + 2 * h]);
      const cd d = fk::mul_neg_i(fk::csub(x[j + h], x[j + 3 * h]));
      x[j] = fk::cadd(a, b);
      if (R1 && jj == 0) {
        x[j + h] = fk::csub(a, b);
        x[j + 2 * h] = fk::cadd(c, d);
        x[j + 3 * h] = fk::csub(c, d);
      } else {
        x[j + h] = fk::cmul(fk::csub(a, b), tw(t, jj, 2));
        x[j + 2 * h] = fk::cmul(fk::cadd(c, d), tw(t, jj, 1));
        x[j + 3 * h] = fk::cmul(fk::csub(c, d), tw(t, jj, 3));
      }
    }
  }
  if (S & 1) {
#pragma unroll
    for (int j = 0; j < (1 << S); j += 2) {
      const cd a = x[j], b = x[j + 1];
      x[j] = fk::cadd(a, b);
      x[j + 1] = R1 ? fk::csub(a, b) : fk::cmul(fk::csub(a, b), tw(S - 1, 0, 1));
    }
  }
}

// One trip of F(n1) over the 2^LOGQ column sequences of a block's view
// (element i1 of column q at point i1 * 2^LOGQ + q), neighbouring threads
// on neighbouring columns: S stages at span 2^LOGL. FIRST: the groups come
// from device memory, load(i1, q); the step table is ready only after the
// __syncthreads that follows the loads. LAST (R = 1): output k1 of column q
// is multiplied by corr(k1, q) before its store.
template <int S, int LOGL, int LOGN1, int LOGQ, bool FIRST, bool LAST, class Load, class Corr>
__device__ __forceinline__ void col_trip(cd* s, const cd* tw1, const Load& load,
                                         const Corr& corr) {
  constexpr int LOGR = LOGL - S, ITEMS = PER_THREAD >> S;
  cd x[ITEMS][1 << S];
  int q[ITEMS], p[ITEMS], r[ITEMS];
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const int e = threadIdx.x + u * THREADS;
    const int rest = e >> LOGQ;
    q[u] = e & ((1 << LOGQ) - 1);
    r[u] = rest & ((1 << LOGR) - 1);
    p[u] = ((rest >> LOGR) << LOGL) + r[u];  // position of element 0
#pragma unroll
    for (int j = 0; j < (1 << S); ++j) {
      const int i1 = p[u] + (j << LOGR);
      x[u][j] = FIRST ? load(i1, q[u]) : s[slot((i1 << LOGQ) + q[u])];
    }
  }
  if (FIRST) __syncthreads();
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    dif_group<S, LOGR == 0>(x[u], TableTw<LOGN1, LOGL, LOGR>{tw1, r[u]});
#pragma unroll
    for (int j = 0; j < (1 << S); ++j) {
      const int i1 = p[u] + (j << LOGR);
      if (LAST) x[u][j] = corr(x[u][j], bitrev(i1, LOGN1), q[u]);
      s[slot((i1 << LOGQ) + q[u])] = x[u][j];
    }
  }
}

// The correction: output k1 of column q times corr[k1 * 128 + i2], i2 =
// col0 + (q mod 128).
struct LeafCorr {
  const double* __restrict__ cr;
  const double* __restrict__ ci;
  int col0;
  __device__ __forceinline__ cd operator()(cd x, int k1, int q) const {
    const int t = (k1 << LOGM) + col0 + (q & (M - 1));
    return fk::cmul(x, make_double2(__ldg(cr + t), __ldg(ci + t)));
  }
};

struct NoCorr {
  __device__ __forceinline__ cd operator()(cd x, int, int) const { return x; }
};

// The trips of F(2^LOGN1) from the loads, the correction in the last.
template <int LOGN1, int LOGQ, class Load>
__device__ __forceinline__ void col_fft(cd* s, const cd* tw1, const Load& load,
                                        const LeafCorr& corr) {
  constexpr int S0 = f1_stages(LOGN1, 0), S1 = f1_stages(LOGN1, 1), S2 = f1_stages(LOGN1, 2);
  if constexpr (S1 == 0) {
    col_trip<S0, LOGN1, LOGN1, LOGQ, true, true>(s, tw1, load, corr);
  } else {
    col_trip<S0, LOGN1, LOGN1, LOGQ, true, false>(s, tw1, load, NoCorr{});
    __syncthreads();
    if constexpr (S2 == 0) {
      col_trip<S1, LOGN1 - S0, LOGN1, LOGQ, false, true>(s, tw1, load, corr);
    } else {
      col_trip<S1, LOGN1 - S0, LOGN1, LOGQ, false, false>(s, tw1, load, NoCorr{});
      __syncthreads();
      col_trip<S2, S2, LOGN1, LOGQ, false, true>(s, tw1, load, corr);
    }
  }
}

// The last trip of F(2^LOGN2): the radix-8 over span 8 (R = 1) of one group
// of 8 points at w0 + j, whose output j is X[k2], k2 = bitrev(8g + j) =
// bitrev3(j) * n2/8 + bitrev(g); returned in x for the caller's store.
template <int LOGN2>
__device__ __forceinline__ void last_trip(const cd* s, const cd* tw2, int w0, cd (&x)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = s[slot(w0 + j)];
  dif_group<3, true>(x, TableTw<LOGN2, 3, 0>{tw2, 0});
}

// Rows of n = 2^LOGN <= 2^12 points, R = 4096 / n whole rows a block.
template <int LOGN>
__global__ void __launch_bounds__(THREADS, 2)
leaf64_block(const double* __restrict__ xr, const double* __restrict__ xi,
             const cd* __restrict__ tw1t, const cd* __restrict__ tw2t, LeafCorr corr,
             double* __restrict__ outr, double* __restrict__ outi, long long batch,
             double out_scale) {
  constexpr int LOGN2 = LOGN < LOGM ? LOGN : LOGM, LOGN1 = LOGN - LOGN2;
  constexpr int N = 1 << LOGN, N1 = 1 << LOGN1, N2 = 1 << LOGN2;
  constexpr int LOGR = LOG_LOCAL - LOGN;
  extern __shared__ cd smem[];
  cd* s = smem;
  cd* tw1 = smem + LOCAL;                     // W_n1^k, k < n1/2
  cd* tw2 = tw1 + (N1 > 1 ? N1 / 2 : 0);      // W_n2^k, k < n2/2
  cd* ta = tw2 + N2 / 2;                      // the first F(n2) trip's lane table

  const long long row0 = static_cast<long long>(blockIdx.x) << LOGR;
  const long long left = batch - row0;
  const int rows = left < (1 << LOGR) ? static_cast<int>(left) : 1 << LOGR;
  const long long base = row0 << LOGN;

  load_table(tw2, N2 / 2, tw2t);
  if constexpr (LOGN <= 4) {
    // one trip in registers, 16 / n whole rows a thread; the rows pass
    // through shared memory in natural order both ways, so that every load
    // and store is a warp's contiguous double2s of each plane
    constexpr int PAIRS = PER_THREAD / 2, ITEMS = PER_THREAD >> LOGN;
    const int valid = rows << LOGN;
#pragma unroll
    for (int u = 0; u < PAIRS; ++u) {
      const int f = 2 * (threadIdx.x + u * THREADS);
      double2 a = make_double2(0.0, 0.0), b = a;
      if (f < valid) {
        a = __ldg(reinterpret_cast<const double2*>(xr + base + f));
        b = __ldg(reinterpret_cast<const double2*>(xi + base + f));
      }
      s[slot(f)] = make_double2(a.x, b.x);
      s[slot(f + 1)] = make_double2(a.y, b.y);
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      const int r = threadIdx.x + u * THREADS;
      cd x[N];
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = s[slot((r << LOGN) + i)];
      dif_group<LOGN, true>(x, TableTw<LOGN, LOGN, 0>{tw2, 0});
#pragma unroll
      for (int j = 0; j < N; ++j) s[slot((r << LOGN) + rev(j, LOGN))] = x[j];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < PAIRS; ++u) {
      const int f = 2 * (threadIdx.x + u * THREADS);
      if (f >= valid) continue;
      const cd a = s[slot(f)], b = s[slot(f + 1)];
      *reinterpret_cast<double2*>(outr + base + f) =
          make_double2(a.x * out_scale, b.x * out_scale);
      *reinterpret_cast<double2*>(outi + base + f) =
          make_double2(a.y * out_scale, b.y * out_scale);
    }
    return;
  } else {
    constexpr int SA = LOGN2 - 3;  // the first trip of F(n2): span n2, R = 8
    build_lane_table<LOGN2>(ta, tw2t);
    if constexpr (N1 > 1) {
      // F(n1) over the R * 128 columns q = r * 128 + i2
      load_table(tw1, N1 / 2, tw1t);
      const auto load = [&](int i1, int q) {
        const int r = q >> LOGM;
        double a = 0.0, b = 0.0;
        if (r < rows) {
          const long long o = base + (static_cast<long long>(r) << LOGN) + (i1 << LOGM) +
                              (q & (M - 1));
          a = __ldg(xr + o);
          b = __ldg(xi + o);
        }
        return make_double2(a, b);
      };
      col_fft<LOGN1, LOGR + LOGM>(s, tw1, load, corr);
      __syncthreads();
      // the radix-16 of F(128) along each of the n1 * R rows (shared row
      // bitrev(k1) * R + r), in place
      const int rr = threadIdx.x & 7, row = threadIdx.x >> 3;
      cd y[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) y[j] = s[slot((row << LOGM) + rr + 8 * j)];
      dif_group<4, false>(y, LaneTw<4>{ta, rr});
#pragma unroll
      for (int j = 0; j < 16; ++j) s[slot((row << LOGM) + rr + 8 * j)] = y[j];
    } else {
      // n = 32..128: the first trip of F(n) straight from the loads, 128 / n
      // groups (r, rr) a thread, rr on the lanes of a quarter-warp
      constexpr int ITEMS = PER_THREAD >> SA;
      cd y[ITEMS][1 << SA];
#pragma unroll
      for (int u = 0; u < ITEMS; ++u) {
        const int e = threadIdx.x + u * THREADS;
        const int rr = e & 7, r = e >> 3;
        const long long o = base + (static_cast<long long>(r) << LOGN) + rr;
#pragma unroll
        for (int j = 0; j < (1 << SA); ++j) {
          double a = 0.0, b = 0.0;
          if (r < rows) {
            a = __ldg(xr + o + 8 * j);
            b = __ldg(xi + o + 8 * j);
          }
          y[u][j] = make_double2(a, b);
        }
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < ITEMS; ++u) {
        const int e = threadIdx.x + u * THREADS;
        const int rr = e & 7, r = e >> 3;
        dif_group<SA, false>(y[u], LaneTw<SA>{ta, rr});
#pragma unroll
        for (int j = 0; j < (1 << SA); ++j) s[slot((r << LOGN) + rr + 8 * j)] = y[u][j];
      }
    }
    __syncthreads();
    // the radix-8 of F(n2) to the stores: item e = k1 + n1 (m + n2/8 r), g =
    // bitrev(m): a warp's lanes on 32 neighbouring outputs k1 + n1 m of one
    // row and j
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = threadIdx.x + u * THREADS;
      const int k1 = e & (N1 - 1);
      const int m = (e >> LOGN1) & (N2 / 8 - 1);
      const int r = e >> (LOGN1 + LOGN2 - 3);
      const int g = bitrev(m, LOGN2 - 3);
      const int row = (bitrev(k1, LOGN1) << LOGR) + r;
      cd x[8];
      last_trip<LOGN2>(s, tw2, (row << LOGN2) + 8 * g, x);
      if (r >= rows) continue;
      const long long o = base + (static_cast<long long>(r) << LOGN) + k1 + N1 * m;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long at = o + static_cast<long long>(rev(j, 3) * (N2 / 8)) * N1;
        outr[at] = x[j].x * out_scale;
        outi[at] = x[j].y * out_scale;
      }
    }
  }
}

// The cluster's shared-memory window: the address of point w of block
// `rank`'s buffer (mapa), and a load from it.
__device__ __forceinline__ unsigned remote_slot(const cd* s, int w, unsigned rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s + slot(w)));
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

// One row of n = n1 * 128 points, n1 = 32 << LOGC, per cluster of 2^LOGC
// blocks (the cluster size is set at launch).
template <int LOGC>
__global__ void __launch_bounds__(THREADS, 2)
leaf64_cluster(const double* __restrict__ xr, const double* __restrict__ xi,
               const cd* __restrict__ tw1t, const cd* __restrict__ tw2t, LeafCorr corr,
               double* __restrict__ outr, double* __restrict__ outi, double out_scale) {
  constexpr int LOGN1 = 5 + LOGC, N1 = 1 << LOGN1;
  constexpr int LOGW = LOGM - LOGC, W = 1 << LOGW;  // columns per block
  extern __shared__ cd smem[];
  cd* s = smem;
  cd* tw1 = smem + LOCAL;
  cd* tw2 = tw1 + N1 / 2;
  cd* ta = tw2 + M / 2;

  const int c = static_cast<int>(cg::this_cluster().block_rank());
  const long long base = (static_cast<long long>(blockIdx.x) >> LOGC) * (N1 * M);

  load_table(tw1, N1 / 2, tw1t);
  load_table(tw2, M / 2, tw2t);
  build_lane_table<LOGM>(ta, tw2t);
  // F(n1) over the block's W columns i2 = W c + q, shared (i1, q); the
  // correction in the last trip
  const auto load = [&](int i1, int q) {
    const long long o = base + (i1 << LOGM) + W * c + q;
    return make_double2(load_line(xr + o), load_line(xi + o));
  };
  LeafCorr cc = corr;
  cc.col0 = W * c;
  col_fft<LOGN1, LOGW>(s, tw1, load, cc);
  cluster_arrive();
  cluster_wait();

  // the exchange, straight into the radix-16 of F(128): item (kl, rr) takes
  // i2 = rr + 8j, j < 16, of row k1 = 32c + kl, at shared (bitrev(k1), i2
  // mod W) of block i2 / W = j >> (LOGW - 3)
  const int rr = threadIdx.x & 7, kl = threadIdx.x >> 3;
  const int row = bitrev(KROWS * c + kl, LOGN1) << LOGW;
  cd y[16];
  unsigned at[16];
#pragma unroll
  for (int j = 0; j < 16; ++j)
    at[j] = remote_slot(s, row + ((rr + 8 * j) & (W - 1)),
                        static_cast<unsigned>(j >> (LOGW - 3)));
#pragma unroll
  for (int j = 0; j < 16; ++j) y[j] = load_remote(at[j]);
  // no read of another block's buffer follows
  cluster_arrive();
  dif_group<4, false>(y, LaneTw<4>{ta, rr});
  cluster_wait();
#pragma unroll
  for (int j = 0; j < 16; ++j) s[slot((kl << LOGM) + rr + 8 * j)] = y[j];
  __syncthreads();

  // the radix-8 of F(128) to the stores: item (kl, g), a warp's lanes on the
  // 32 rows kl, so each store is 32 neighbouring outputs k1 of one k2
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int e = threadIdx.x + u * THREADS;
    const int l = e & (KROWS - 1), g = e >> 5;
    cd x[8];
    last_trip<LOGM>(s, tw2, (l << LOGM) + 8 * g, x);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long o =
          base + static_cast<long long>(rev(j, 3) * 16 + bitrev(g, 4)) * N1 + KROWS * c + l;
      outr[o] = x[j].x * out_scale;
      outi[o] = x[j].y * out_scale;
    }
  }
}

using BlockKernel = void (*)(const double*, const double*, const cd*, const cd*, LeafCorr,
                             double*, double*, long long, double);
using ClusterKernel = void (*)(const double*, const double*, const cd*, const cd*, LeafCorr,
                               double*, double*, double);

BlockKernel block_kernel(int logn) {
  switch (logn) {
    case 1: return leaf64_block<1>;
    case 2: return leaf64_block<2>;
    case 3: return leaf64_block<3>;
    case 4: return leaf64_block<4>;
    case 5: return leaf64_block<5>;
    case 6: return leaf64_block<6>;
    case 7: return leaf64_block<7>;
    case 8: return leaf64_block<8>;
    case 9: return leaf64_block<9>;
    case 10: return leaf64_block<10>;
    case 11: return leaf64_block<11>;
    default: return leaf64_block<12>;
  }
}

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
// correction W_n^(k1*i2) (n >= 256, else unused); out_scale: the factor of
// every output. Returns the CUDA error code of the launch (0 on success).
extern "C" int phastft_leaf64(const double* xr, const double* xi, const void* tw1t,
                              const void* tw2t, const double* cr, const double* ci,
                              double* outr, double* outi, long long batch, int n,
                              double out_scale, void* stream) {
  const int n1 = n > M ? n / M : 1, n2 = n > M ? M : n;
  if (batch < 1 || !phastft::is_pow2(n) || n < 2 || n > (1 << 16) || tw2t == nullptr ||
      (n1 > 1 && (tw1t == nullptr || cr == nullptr || ci == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cd* tw1 = static_cast<const cd*>(tw1t);
  const cd* tw2 = static_cast<const cd*>(tw2t);
  const LeafCorr corr{cr, ci, 0};
  const int logn = phastft::ilog2(n);
  if (n1 >= 64) {
    const int logc = logn - LOG_LOCAL;
    static int resident_at[5] = {0, 0, 0, 0, 0};  // per logc, queried on first use
    return phastft::launch_clusters(cluster_kernel(logc), 1 << logc, batch << logc, THREADS,
                                    smem_bytes(n1, M), s, resident_at[logc], xr, xi, tw1, tw2,
                                    corr, outr, outi, out_scale);
  }
  const int logr = LOG_LOCAL - logn;  // rows per block: 4 K points
  const long long blocks = (batch + (1LL << logr) - 1) >> logr;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const BlockKernel kernel = block_kernel(logn);
  const size_t smem = smem_bytes(n1, n2);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, s>>>(xr, xi, tw1, tw2, corr, outr,
                                                             outi, batch, out_scale);
  return static_cast<int>(cudaGetLastError());
}

// The number of clusters of the leaf64 kernel at n = 2^13..2^16 (2, 4, 8, 16
// blocks) the current device holds at once (the CUDA occupancy query), or
// minus the CUDA error code.
extern "C" int phastft_leaf64_clusters(int n) {
  if (n < (1 << 13) || n > (1 << 16) || !phastft::is_pow2(n))
    return -static_cast<int>(cudaErrorInvalidValue);
  return resident(phastft::ilog2(n) - LOG_LOCAL);
}
