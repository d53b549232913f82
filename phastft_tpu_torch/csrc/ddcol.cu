// dd (double-float) column pass of the four-step FFT, four f32 planes per
// complex array, for sm_90a.
//
// Replaces: phastft_tpu/ops/pallas_dd.py, ddcol_pallas (the dd column DFT
// fused with the dd split correction) and ddcol_pallas_nocorr (the bare dd
// column DFT): one kernel, the correction a template argument.
//
// For every batch entry b and column i2 of x viewed (n1, n2), in dd
// arithmetic:
//   y[k1, i2] = sum_i1 W_n1^(k1*i1) x[b, i1, i2]
//   corr:   out[b, k1, i2] = y[k1, i2] * T1[k1, i2 / t] * T2[k1, i2 % t]
//   nocorr: out[b, k1, i2] = y[k1, i2]
// T1 (n1, n2/t) and T2 (n1, t) are the planner's factored tables of
// W_n^(k1*i2), t = min(256, n2); their product is formed in that order, as
// the plain version forms it.
//
// Bound: FP32 instruction issue. dd arithmetic is single-rounded adds and
// multiplies (dd.cuh): a dd complex sum is 22 FP32 instructions, a product
// 42. A radix-4 DFT with the trivial twiddles dropped takes 75.5 per point
// per radix-4 stage (44 at span 4); at n1 = 2048 that is 399.5 per point
// and the correction 84 more, against 32 B of device memory: at 132 SMs x
// 128 lanes x 1.98 GHz the instructions take ~1.5x the bytes' time.
//
// Design: as ddleaf.cu's, blocks small enough for two to share an SM, so
// one's memory traffic overlaps the other's arithmetic, and few trips
// through shared memory.
// - A block holds 4096 dd points (64 KB of data; with padding and the
//   twiddle table 77,824 B up to n1 = 512, 90,112 B at 2048) and runs 256
//   threads at <= 128 registers (__launch_bounds__(256, 2)).
// - Radix-4 trips (dd.cuh dif4_pass), the last one of an odd stage count a
//   radix-8; the correction T1 then T2 is multiplied in the registers of the
//   last trip, so the store is a copy.
// - One block a slab (ddcol_kernel, n1 <= 512, and columns narrower than a
//   cluster's slab): T = 4096 / n1 neighbouring columns of one entry. When a
//   whole entry is smaller than the slab (the split leaf's passes: n1 * n2
//   of 256..64 K points), a block owns R entries, laid out (i1, r, c), so
//   one radix pass serves all of them; the last block masks its missing
//   entries.
// - Long columns (ddcol_cluster, n1 = 1024 and 2048 with n2 >= 32): a slab
//   of CT = 32 columns (128-byte row segments) over a cluster of
//   C = n1 * CT / 4096 blocks (8, or 16 at n1 = 2048: a non-portable size,
//   set at launch). With n1 = P * Q, Q = 128, i1 = Q*p + q and
//   k1 = kp + P*kq:
//   - block c loads the rows q in [Q/C*c, Q/C*(c+1)) for every p straight
//     into registers (a thread one or two (q, column) sequences, every load in
//     flight at once), runs F(P) over p there, multiplies by W_n1^(kp*q) and
//     writes (kp, q, column) to shared memory;
//   - after a cluster barrier it reads its kp = c, every q, from every block
//     (distributed shared memory, float4 across columns) straight into the
//     first radix-4 trip of F(Q), and holds the results until a second
//     barrier says no block reads its buffer any more;
//   - the rest of F(Q) and the correction run in its own buffer, and the
//     store writes rows k1 = kp + P*kq, 128 bytes a row and plane.
//   The entry refuses a shape no cluster of which fits the device.
//   On the H100, F(P) as trips through shared memory after the loads
//   measured 1.07x (n1 = 1024) and 1.09x (2048) slower, 16-column slabs on
//   4- and 8-block clusters 1.13x and 1.03x, the cluster design at n1 = 512
//   1.07x (against one block of 8 columns), and the correction's table loads
//   issued before the last trip's butterflies 1.02-1.20x (T2 alone: 0.99x
//   at n1 = 2048).
// - Device memory is read and written as float4s per plane (columns narrower
//   than 4, n2 = 1 and 2, element by element: the one- and two-column blocks
//   of a distributed shard and the rows of a split planned with
//   leaf_fft_size < 128); the DIF leaves X[k] at position
//   bitrev(k), which the store index undoes.
// - Step twiddles W_n1^k are dd pairs from a table the wrapper builds on the
//   host in f64; every factor reads it (dd.cuh). No trigonometry runs in the
//   kernel.
// - The batch is folded into gridDim.x and every device offset is 64-bit.
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

constexpr int THREADS = 256;
constexpr int LOCAL = 4096, LOG_LOCAL = 12;  // dd points a block holds
constexpr int WORDS = padded_words(LOCAL);
constexpr int VECS = LOCAL / 4 / THREADS;  // float4s of each plane a thread moves
// Long columns: CT columns a slab, the second factor Q, from n1 = CLUSTER_N1.
constexpr int LOGCT = 5, CT = 1 << LOGCT;
constexpr int LOGQ = 7, Q = 1 << LOGQ;
constexpr int CLUSTER_N1 = 1024;

constexpr size_t smem_bytes(int n1) {
  return 4 * sizeof(float) * WORDS + sizeof(float4) * (n1 / 2);
}

// Component u of a float4 (u a constant after unrolling).
__device__ __forceinline__ float& part(float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// The split correction folded into the last trip: output k of sequence q
// is row k1 = (k << logp) + kp0 + ((q >> logT) & kpmask), column
// i2 = col0 + (q mod 2^logT), multiplied by T1[k1, i2 >> logt], then by
// T2[k1, i2 mod t].
struct Corr {
  ddk::ConstQuad t1, t2;
  int logt, t1cols, logT, col0, logp, kp0, kpmask;
  __device__ __forceinline__ ddk::ddc operator()(ddk::ddc v, int k, int q) const {
    const int k1 = (k << logp) + kp0 + ((q >> logT) & kpmask);
    const int i2 = col0 + (q & ((1 << logT) - 1));
    const ddk::ddc w1 = ddk::table_at(t1, k1 * t1cols + (i2 >> logt));
    const ddk::ddc w2 = ddk::table_at(t2, (k1 << logt) + (i2 & ((1 << logt) - 1)));
    return ddk::cmul(ddk::cmul(v, w1), w2);
  }
};

// One slab of T = 2^logT columns of R = 2^logR entries a block.
template <bool CORR>
__global__ void __launch_bounds__(THREADS, 2)
ddcol_kernel(ddk::ConstQuad x, const float* __restrict__ twt, ddk::ConstQuad t1,
             ddk::ConstQuad t2, ddk::Quad out, long long batch, int logn1, int n2,
             int logT, int logR, int logt) {
  extern __shared__ float4 smem4[];
  const int n1 = 1 << logn1, T = 1 << logT;
  const int logM = logT + logR, M = 1 << logM;  // sequences: R entries x T columns
  const int logE = logn1 + logT;                 // points of an entry in the block
  const int points = n1 << logM;
  const ddk::Planes s = ddk::make_planes(reinterpret_cast<float*>(smem4), WORDS);
  float4* tw = reinterpret_cast<float4*>(s.p[0] + 4 * WORDS);

  // block -> (first entry b0, slab j); n2 / T slabs per entry, a power of two
  const unsigned nblk = static_cast<unsigned>(n2 >> logT);
  const int col0 = static_cast<int>(blockIdx.x & (nblk - 1)) << logT;
  const long long b0 = static_cast<long long>(blockIdx.x >> (31 - __clz(nblk))) << logR;
  const long long n = static_cast<long long>(n1) * n2;

  ddk::load_twiddles(tw, n1, twt);
  // element g in device order (r, i1, c) -> shared (i1, r, c); a thread's
  // four elements are neighbours, a float4 in device memory when T >= 4;
  // every load of a thread is in flight before the first store
  float4 v[VECS][4];
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
    const int f = 4 * (threadIdx.x + j * THREADS);
#pragma unroll
    for (int p = 0; p < 4; ++p) v[j][p] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (f >= points) continue;
    if (T >= 4) {
      const int r = f >> logE, i1 = (f >> logT) & (n1 - 1), c = f & (T - 1);
      if (b0 + r >= batch) continue;
      const long long off = (b0 + r) * n + static_cast<long long>(i1) * n2 + col0 + c;
#pragma unroll
      for (int p = 0; p < 4; ++p) v[j][p] = __ldg(reinterpret_cast<const float4*>(x.p[p] + off));
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int g = f + u;
        const int r = g >> logE, i1 = (g >> logT) & (n1 - 1), c = g & (T - 1);
        if (b0 + r >= batch) continue;
        const long long off = (b0 + r) * n + static_cast<long long>(i1) * n2 + col0 + c;
#pragma unroll
        for (int p = 0; p < 4; ++p) part(v[j][p], u) = __ldg(x.p[p] + off);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
    const int f = 4 * (threadIdx.x + j * THREADS);
    if (f >= points) continue;
    if (T >= 4) {
      const int r = f >> logE, i1 = (f >> logT) & (n1 - 1), c = f & (T - 1);
      const int w = pad((i1 << logM) + (r << logT) + c);
#pragma unroll
      for (int p = 0; p < 4; ++p) *reinterpret_cast<float4*>(s.p[p] + w) = v[j][p];
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int g = f + u;
        const int r = g >> logE, i1 = (g >> logT) & (n1 - 1), c = g & (T - 1);
        const int w = pad((i1 << logM) + (r << logT) + c);
#pragma unroll
        for (int p = 0; p < 4; ++p) s.p[p][w] = part(v[j][p], u);
      }
    }
  }
  __syncthreads();

  // the (r, c) axis is the contiguous one: sequences are neighbours; the
  // correction is folded into the last trip
  const Corr corr{t1, t2, logt, n2 >> logt, logT, col0, 0, 0, 0};
  ddk::dif4_fft(s, logn1, logn1, logM, 1, M, true, tw, logn1, corr, CORR);

  // shared order (row, r, c): row holds k1 = bitrev(row), stored at its row
  // of device memory, T contiguous floats an entry
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
    const int f = 4 * (threadIdx.x + j * THREADS);
    if (f >= points) continue;
    if (T >= 4) {
      const int r = (f >> logT) & ((1 << logR) - 1), c = f & (T - 1);
      if (b0 + r >= batch) continue;
      const int k1 = bitrev(f >> logM, logn1);
      const long long o = (b0 + r) * n + static_cast<long long>(k1) * n2 + col0 + c;
#pragma unroll
      for (int p = 0; p < 4; ++p)
        *reinterpret_cast<float4*>(out.p[p] + o) =
            *reinterpret_cast<const float4*>(s.p[p] + pad(f));
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int g = f + u;
        const int r = (g >> logT) & ((1 << logR) - 1), c = g & (T - 1);
        if (b0 + r >= batch) continue;
        const int k1 = bitrev(g >> logM, logn1);
        const long long o = (b0 + r) * n + static_cast<long long>(k1) * n2 + col0 + c;
#pragma unroll
        for (int p = 0; p < 4; ++p) out.p[p][o] = s.p[p][pad(g)];
      }
    }
  }
}

// The first phase of ddcol_cluster, block c: F(P) over p in registers. A thread owns
// PER = 16 / P sequences (ql, column) = threadIdx.x + THREADS*t (the column its lane, so a
// warp reads 128-byte row segments), loads their P rows i1 = Q*p + (Q/C*c + ql) (every load
// in flight at once), runs F(P), multiplies output kp by W_n1^(kp*q) and writes it at row
// position u (kp = bitrev(u)) of shared (u, ql, column).
template <int LOGP>
__device__ __forceinline__ void cluster_fp(const ddk::ConstQuad& x, const float* twt,
                                           const ddk::Planes& s, float4* tw, long long base,
                                           int n2, int c, int logn1, int logQC) {
  constexpr int P = 1 << LOGP, PER = 16 / P;
  const int logM1 = logQC + LOGCT;
  ddk::ddc v[PER][P];
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int seq = threadIdx.x + t * THREADS;
    const int col = seq & (CT - 1), ql = seq >> LOGCT;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const long long off =
          base + static_cast<long long>((p << LOGQ) + (c << logQC) + ql) * n2 + col;
      v[t][p] = ddk::ddc{ddk::dd{__ldg(x.p[0] + off), __ldg(x.p[1] + off)},
                         ddk::dd{__ldg(x.p[2] + off), __ldg(x.p[3] + off)}};
    }
  }
  ddk::load_twiddles(tw, 1 << logn1, twt);
  __syncthreads();
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int seq = threadIdx.x + t * THREADS;
    const int q = (c << logQC) + (seq >> LOGCT);
    ddk::dif4_group<LOGP>(v[t], 0, 0, logn1, LOGP, tw);
#pragma unroll
    for (int u = 0; u < P; ++u)
      ddk::store(s, pad((u << logM1) + seq),
                 ddk::cmul(v[t][u], ddk::twiddle(tw, bitrev(u, LOGP) * q, logn1)));
  }
}

// One slab of CT columns of one entry per cluster of C = n1 * CT / 4096
// blocks (the cluster size is set at launch); n1 = P * Q.
template <bool CORR>
__global__ void __launch_bounds__(THREADS, 2)
ddcol_cluster(ddk::ConstQuad x, const float* __restrict__ twt, ddk::ConstQuad t1,
              ddk::ConstQuad t2, ddk::Quad out, int logn1, int n2, int logt) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n1 = 1 << logn1;
  const int logP = logn1 - LOGQ;
  const int logC = logn1 + LOGCT - LOG_LOCAL;
  const int logQC = LOGQ - logC;    // rows q a block loads
  const int logKP = logP - logC;    // kp a block owns after the exchange
  const int logM1 = logQC + LOGCT;  // F(P)'s sequences (ql, column)
  const int logM2 = logKP + LOGCT;  // F(Q)'s sequences (kpl, column)
  const ddk::Planes s = ddk::make_planes(reinterpret_cast<float*>(smem4), WORDS);
  float4* tw = reinterpret_cast<float4*>(s.p[0] + 4 * WORDS);  // W_n1^k, k < n1/2

  const int c = static_cast<int>(cluster.block_rank());
  // cluster -> (batch entry b, slab j); n2 / CT slabs per entry
  const unsigned slab = blockIdx.x >> logC;
  const unsigned nblk = static_cast<unsigned>(n2 >> LOGCT);
  const int col0 = static_cast<int>(slab & (nblk - 1)) << LOGCT;
  const long long b = slab >> (31 - __clz(nblk));
  const long long base = b * n1 * n2 + col0;

  if (logP == 4)
    cluster_fp<4>(x, twt, s, tw, base, n2, c, logn1, logQC);
  else
    cluster_fp<3>(x, twt, s, tw, base, n2, c, logn1, logQC);
  cluster.sync();

  // exchange, straight into the first radix-4 trip of F(Q): item (4
  // columns, r, kpl), the columns the fast axis, takes q = r + 32j, j < 4, of
  // kp = KP*c + kpl (KP = P / C, 1 at CT = 32), held at shared row
  // bitrev(kp) of block q / QC
  const int c4 = threadIdx.x & (CT / 4 - 1);
  const int r = (threadIdx.x >> (LOGCT - 2)) & (Q / 4 - 1);
  const int kpl = threadIdx.x >> (LOGCT - 2 + LOGQ - 2);
  const int row = bitrev((c << logKP) + kpl, logP) << logM1;
  ddk::ddc y[4][4];  // [column][j]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = r + (Q / 4) * j;
    const unsigned src = static_cast<unsigned>(q >> logQC);
    const int w = pad(row + ((q & ((1 << logQC) - 1)) << LOGCT) + 4 * c4);
    float4 f[4];
#pragma unroll
    for (int pl = 0; pl < 4; ++pl)
      f[pl] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(s.p[pl], src) + w);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      y[u][j] = ddk::ddc{ddk::dd{part(f[0], u), part(f[1], u)},
                         ddk::dd{part(f[2], u), part(f[3], u)}};
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) ddk::dif4_group<2>(y[u], r, LOGQ - 2, logn1, LOGQ, tw);
  // no block reads another's buffer past this point
  cluster.sync();
  // shared (q, kpl, column)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int w = pad(((r + (Q / 4) * j) << logM2) + (kpl << LOGCT) + 4 * c4);
    *reinterpret_cast<float4*>(s.p[0] + w) =
        make_float4(y[0][j].re.hi, y[1][j].re.hi, y[2][j].re.hi, y[3][j].re.hi);
    *reinterpret_cast<float4*>(s.p[1] + w) =
        make_float4(y[0][j].re.lo, y[1][j].re.lo, y[2][j].re.lo, y[3][j].re.lo);
    *reinterpret_cast<float4*>(s.p[2] + w) =
        make_float4(y[0][j].im.hi, y[1][j].im.hi, y[2][j].im.hi, y[3][j].im.hi);
    *reinterpret_cast<float4*>(s.p[3] + w) =
        make_float4(y[0][j].im.lo, y[1][j].im.lo, y[2][j].im.lo, y[3][j].im.lo);
  }
  __syncthreads();

  // the rest of F(Q) (spans 32 .. 2), the correction folded into its last
  // trip
  const Corr corr{t1, t2, logt, n2 >> logt, LOGCT, col0, logP, c << logKP, (1 << logKP) - 1};
  ddk::dif4_fft(s, LOGQ, LOGQ - 2, logM2, 1, 1 << logM2, true, tw, logn1, corr, CORR);

  // rows k1 = kp + P*kq: item (4 columns, kpl, kq), the columns the fast
  // axis: CT/4 lanes write a row's 128 bytes of each plane
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
    const int e = threadIdx.x + j * THREADS;
    const int e4 = e & (CT / 4 - 1), kl = (e >> (LOGCT - 2)) & ((1 << logKP) - 1);
    const int kq = e >> (LOGCT - 2 + logKP);
    const int w = pad((bitrev(kq, LOGQ) << logM2) + (kl << LOGCT) + 4 * e4);
    const int k1 = (c << logKP) + kl + (kq << logP);
    const long long o = base + static_cast<long long>(k1) * n2 + 4 * e4;
#pragma unroll
    for (int pl = 0; pl < 4; ++pl)
      *reinterpret_cast<float4*>(out.p[pl] + o) = *reinterpret_cast<const float4*>(s.p[pl] + w);
  }
}

// Whether the long-column design runs (n1, n2): n1 = CLUSTER_N1..2048 and a
// whole CT-column slab.
bool long_columns(int n1, int n2) { return n1 >= CLUSTER_N1 && n2 >= CT; }

// log2 of the cluster at n1 (a slab of CT columns in 4096-point blocks).
int cluster_log(int n1) { return phastft::ilog2(n1) + LOGCT - LOG_LOCAL; }

template <bool CORR>
int launch_cluster(ddk::ConstQuad x, const float* twt, ddk::ConstQuad t1, ddk::ConstQuad t2,
                   ddk::Quad out, long long batch, int n1, int n2, int logt,
                   cudaStream_t stream) {
  static int resident[12] = {};  // per log2(n1), queried on first use
  const int logn1 = phastft::ilog2(n1), logc = cluster_log(n1);
  const long long blocks = (batch * (n2 >> LOGCT)) << logc;
  return phastft::launch_clusters(ddcol_cluster<CORR>, 1 << logc, blocks, THREADS,
                                  smem_bytes(n1), stream, resident[logn1], x, twt, t1, t2,
                                  out, logn1, n2, logt);
}

template <bool CORR>
int launch(ddk::ConstQuad x, const float* twt, ddk::ConstQuad t1, ddk::ConstQuad t2,
           ddk::Quad out, long long batch, int n1, int n2, int logt, cudaStream_t stream) {
  if (long_columns(n1, n2))
    return launch_cluster<CORR>(x, twt, t1, t2, out, batch, n1, n2, logt, stream);
  const int logn1 = phastft::ilog2(n1);
  int logT = LOG_LOCAL - logn1;
  if ((1 << logT) > n2) logT = phastft::ilog2(n2);
  int logR = 0;  // entries per block, when a whole entry is below the slab
  if ((1 << logT) == n2)
    while (logn1 + logT + logR < LOG_LOCAL && (1LL << logR) < batch) ++logR;
  const long long blocks = ((batch + (1LL << logR) - 1) >> logR) * (n2 >> logT);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n1);
  cudaError_t err =
      cudaFuncSetAttribute(ddcol_kernel<CORR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ddcol_kernel<CORR><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      x, twt, t1, t2, out, batch, logn1, n2, logT, logR, logt);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(long long batch, int n1, int n2) {
  return batch >= 1 && phastft::is_pow2(n1) && n1 >= 2 && n1 <= 2048 &&
         phastft::is_pow2(n2);
}

// TwoSum and TwoProd of dd.cuh on n pairs: s + e = a + b, p + pe = a * b.
__global__ void dd_exact_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                float* __restrict__ s, float* __restrict__ e,
                                float* __restrict__ p, float* __restrict__ pe,
                                long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float vs, ve, vp, vpe;
  ddk::two_sum(a[i], b[i], vs, ve);
  ddk::two_prod(a[i], b[i], vp, vpe);
  s[i] = vs;
  e[i] = ve;
  p[i] = vp;
  pe[i] = vpe;
}

}  // namespace

// x*, o*: the four planes (re_hi, re_lo, im_hi, im_lo) of (batch, n1, n2)
// arrays; n1 = 2..2048 and n2 >= 1, powers of two. twt: four planes of n1/2
// floats, W_n1^k. t1*: (n1, n2 / t) and t2*: (n1, t) with t = min(256, n2),
// the factored correction. Returns the CUDA error code of the launch (0 on
// success; cudaErrorInvalidConfiguration when no cluster of a long-column
// shape fits the device).
extern "C" int phastft_ddcol(const float* xrh, const float* xrl, const float* xih,
                             const float* xil, const float* twt, const float* t1rh,
                             const float* t1rl, const float* t1ih, const float* t1il,
                             const float* t2rh, const float* t2rl, const float* t2ih,
                             const float* t2il, float* orh, float* orl, float* oih,
                             float* oil, long long batch, int n1, int n2, void* stream) {
  if (!shape_ok(batch, n1, n2)) return static_cast<int>(cudaErrorInvalidValue);
  const int t = n2 < 256 ? n2 : 256;
  return launch<true>(ddk::ConstQuad{{xrh, xrl, xih, xil}}, twt,
                      ddk::ConstQuad{{t1rh, t1rl, t1ih, t1il}},
                      ddk::ConstQuad{{t2rh, t2rl, t2ih, t2il}},
                      ddk::Quad{{orh, orl, oih, oil}}, batch, n1, n2, phastft::ilog2(t),
                      static_cast<cudaStream_t>(stream));
}

// As phastft_ddcol with no correction.
extern "C" int phastft_ddcol_nocorr(const float* xrh, const float* xrl, const float* xih,
                                    const float* xil, const float* twt, float* orh,
                                    float* orl, float* oih, float* oil, long long batch,
                                    int n1, int n2, void* stream) {
  if (!shape_ok(batch, n1, n2)) return static_cast<int>(cudaErrorInvalidValue);
  const ddk::ConstQuad none{{nullptr, nullptr, nullptr, nullptr}};
  return launch<false>(ddk::ConstQuad{{xrh, xrl, xih, xil}}, twt, none, none,
                       ddk::Quad{{orh, orl, oih, oil}}, batch, n1, n2, 0,
                       static_cast<cudaStream_t>(stream));
}

// The clusters of the long-column design at n1 (with the correction, or
// without) the current device holds at once (the CUDA occupancy query), or
// minus the CUDA error code.
extern "C" int phastft_ddcol_clusters(int n1, int corr) {
  if (!phastft::is_pow2(n1) || !long_columns(n1, CT) || n1 > 2048)
    return -static_cast<int>(cudaErrorInvalidValue);
  const int cluster = 1 << cluster_log(n1);
  return corr ? phastft::resident_clusters(ddcol_cluster<true>, cluster, THREADS,
                                           smem_bytes(n1))
              : phastft::resident_clusters(ddcol_cluster<false>, cluster, THREADS,
                                           smem_bytes(n1));
}

// a, b: n floats; s + e = a + b and p + pe = a * b, each exactly.
extern "C" int phastft_dd_exact(const float* a, const float* b, float* s, float* e,
                                float* p, float* pe, long long n, void* stream) {
  if (n < 1 || n > 0x7fffffffLL * 256) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  dd_exact_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(a, b, s, e, p, pe, n);
  return static_cast<int>(cudaGetLastError());
}
