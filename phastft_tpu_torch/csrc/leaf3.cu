// Three-factor leaf FFT: the length-2^16 or 2^17 DFT of every row, planar
// f32, for sm_90a.
//
// Replaces: phastft_tpu/ops/pallas_leaf.py, leaf_fft_pallas3 (n = a*4*b,
// b = 128 and a = 128 or 256: the f32 leaf at n = 2^16, and the leaf of
// Options.leaf_fft_size = 2^17).
//
// Row x viewed (a, 4b), x[i_a, i_r], i_r = i_p*b + i_b, in the TPU
// kernel's factor order (the output index comes out natural only so):
//   t[k_a, i_r] = sum_ia W_a^(k_a*i_a) x[i_a, i_r]       (F(a) over i_a)
//   u = t * W_n^(k_a*i_r)                                 (table c1)
//   y_p[k_a, i_b] = sum_ip W_4^(p*i_p) u[k_a, i_p*b + i_b] (radix-4, adds)
//   w_p = y_p * W_4b^(p*i_b)                              (table c2)
//   X[k_a + a*p + 4a*k_b] = sum_ib W_b^(k_b*i_b) w_p[k_a, i_b]  (F(b))
//
// Bound: memory. Each element is read once and written once, 16 B per
// complex element, against ~5*16 flops per element.
//
// Design against that bound: a row (512 KB at a = 128, 1 MiB at 256) is held
// by a cluster of C = a / 16 blocks (8, or 16 at a = 256: a non-portable
// size, set at launch) of 256 threads, 64 KB each (74,752 B of shared memory
// with padding and twiddles, 75,264 B at a = 256), so device memory is
// touched once each way. At a = 128 three blocks share an SM (80 registers a
// thread: ptxas spills 40 bytes, which costs less than the third block
// gains); at a = 256 two do (128 registers, no spills; at the 80-register cap
// of three ptxas spills 372 bytes, and on the H100 three blocks an SM read
// 5% slower, PERF.md). The blocks of one SM belong to different rows and run
// different phases, so one block's loads and stores overlap another's radix
// passes, and one row spreads over C SMs.
// - Block c loads the columns i_r in [W*c, W*c + W), W = 4b / C (64 or 32
//   columns: 256- or 128-byte pieces of every i_a, float4 loads), and runs
//   F(a) over i_a and the c1 twiddle on them (float4 table reads).
// - Exchange, two cluster barriers: after the first, block c reads k_a in
//   [16c, 16c + 16) for all four i_p and all i_b straight from the blocks
//   that hold them (float4 loads through distributed shared memory, column
//   i_r = i_p*b + i_b from block i_r / W) into the radix-4 over i_p and c2,
//   and keeps the result in registers (32 complex values a thread); after
//   the second, when no block reads its buffer any more, it writes them back
//   as rows (k_a - 16c, p) of 128 i_b.
// - F(b) along each of those 64 rows, then the stores: 16 contiguous floats
//   per (k_b, p) as float4s of four neighbouring lanes, gathered from
//   shared memory, each value times out_scale (1 on a forward or an inner
//   pass, 1/N where this leaf ends an inverse: the same bits as a separate
//   multiply after the kernel, without its second pass over memory).
// F(128) is two passes over shared memory (4 + 3 radix-2 stages in
// registers), F(256) two of 4 + 4. Rows go in gridDim.x (C blocks each), so
// any batch runs. The 8-block shape keeps its compile-time cluster; the
// 16-block one is launched as leaf64.cu's are (cluster.cuh).
//
// Twiddles come from the planner's tables (mxu3_512, mxu3_1024), the same
// bits as the plain version: row 1 of F(a) and F(b), c1 = W_n^(k_a*i_r)
// (a, 4b) and c2 = W_4b^(p*i_b) (4, b).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "fft_smem.cuh"

namespace cg = cooperative_groups;
using phastft::bitrev;
using phastft::load_twiddles;
using phastft::pad;
using phastft::padded_words;

namespace {

constexpr int B = 128, LOGB = 7;
constexpr int IR = 4 * B;             // length of the i_r axis
constexpr int KA = 16;                // k_a rows a block owns after the exchange
constexpr int LOCAL = 8192;           // complex elements per block
constexpr int WORDS = padded_words(LOCAL);
constexpr int THREADS = 256;
// exchange items per thread: (k_a - 16c, four consecutive i_b)
constexpr int ITEMS = KA * B / 4 / THREADS;
// float4 loads of each plane per thread.
constexpr int LOADS = LOCAL / 4 / THREADS;

// The row's shape at a = 2^LOGA: N points over a cluster of CLUSTER blocks,
// COLS = 2^LOGCOLS columns i_r a block before the exchange.
template <int LOGA>
struct Shape {
  static constexpr int A = 1 << LOGA;
  static constexpr int N = A * IR;
  static constexpr int CLUSTER = A / KA;
  static constexpr int LOGCOLS = 13 - LOGA;
  static constexpr int COLS = 1 << LOGCOLS;
  static_assert(COLS * CLUSTER == IR && COLS * A == LOCAL, "one row over the cluster");
};

__device__ __forceinline__ float& part(float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// F(2^LOGN) of 2^logM sequences in place, in two passes (4 + 3 radix-2
// stages at 128, 4 + 4 at 256); natural order in, X[k] at position
// bitrev(k) out.
template <int LOGN>
__device__ __forceinline__ void dif_two(float* sr, float* si, int logM, int qs, int is,
                                        bool qfast, const float2* tw) {
  constexpr int S0 = (LOGN + 1) / 2, S1 = LOGN - S0;
  phastft::dif_pass<S0>(sr, si, LOGN, LOGN, logM, qs, is, qfast, tw);
  __syncthreads();
  phastft::dif_pass<S1>(sr, si, LOGN, S1, logM, qs, is, qfast, tw);
  __syncthreads();
}

template <int LOGA>
__device__ __forceinline__ void leaf3_body(
    const float* __restrict__ re, const float* __restrict__ im, const float* __restrict__ f1r,
    const float* __restrict__ f1i, const float* __restrict__ f2r, const float* __restrict__ f2i,
    const float* __restrict__ c1r, const float* __restrict__ c1i, const float* __restrict__ c2r,
    const float* __restrict__ c2i, float* __restrict__ ore, float* __restrict__ oim,
    float out_scale) {
  using S = Shape<LOGA>;
  constexpr int A = S::A, N = S::N, COLS = S::COLS, LOGCOLS = S::LOGCOLS;
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  float* sr = reinterpret_cast<float*>(smem4);
  float* si = sr + WORDS;
  float2* tw1 = reinterpret_cast<float2*>(si + WORDS);  // W_a^k, k < a/2
  float2* tw2 = tw1 + A / 2;                            // W_b^k, k < b/2

  const int c = static_cast<int>(cluster.block_rank());
  const long long base = static_cast<long long>(blockIdx.x / S::CLUSTER) * N;

  load_twiddles(tw1, A, f1r, f1i);
  load_twiddles(tw2, B, f2r, f2i);
  // columns i_r in [COLS*c, COLS*c + COLS): shared (i_a, column); every
  // load of a thread is in flight before the first store
  float4 a[LOADS], b[LOADS];
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int e = threadIdx.x + j * THREADS;
    const long long off =
        base + (e >> (LOGCOLS - 2)) * IR + COLS * c + 4 * (e & (COLS / 4 - 1));
    a[j] = __ldg(reinterpret_cast<const float4*>(re + off));
    b[j] = __ldg(reinterpret_cast<const float4*>(im + off));
  }
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int e = threadIdx.x + j * THREADS;
    const int w = pad((e >> (LOGCOLS - 2)) * COLS + 4 * (e & (COLS / 4 - 1)));
    *reinterpret_cast<float4*>(sr + w) = a[j];
    *reinterpret_cast<float4*>(si + w) = b[j];
  }
  __syncthreads();

  // F(a) over i_a: COLS sequences (the contiguous axis), stride COLS
  dif_two<LOGA>(sr, si, LOGCOLS, 1, COLS, true, tw1);
  // shared row q holds k_a = bitrev(q): u = t * W_n^(k_a*i_r)
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int e = threadIdx.x + j * THREADS;
    const int q = e >> (LOGCOLS - 2), v = 4 * (e & (COLS / 4 - 1));
    const int t = bitrev(q, LOGA) * IR + COLS * c + v;
    const float4 cs = __ldg(reinterpret_cast<const float4*>(c1r + t));
    const float4 sn = __ldg(reinterpret_cast<const float4*>(c1i + t));
    const int w = pad(q * COLS + v);
    float4 x = *reinterpret_cast<float4*>(sr + w);
    float4 y = *reinterpret_cast<float4*>(si + w);
    const float4 xr = x;
    x = make_float4(x.x * cs.x - y.x * sn.x, x.y * cs.y - y.y * sn.y,
                    x.z * cs.z - y.z * sn.z, x.w * cs.w - y.w * sn.w);
    y = make_float4(xr.x * sn.x + y.x * cs.x, xr.y * sn.y + y.y * cs.y,
                    xr.z * sn.z + y.z * cs.z, xr.w * sn.w + y.w * cs.w);
    *reinterpret_cast<float4*>(sr + w) = x;
    *reinterpret_cast<float4*>(si + w) = y;
  }
  cluster.sync();

  // exchange, straight into the radix-4 over i_p and c2: item j is
  // (k_l, i_b .. i_b + 3), k_a = 16c + k_l held at shared row bitrev(k_a)
  // of block (i_p*b + i_b) / COLS, column i_b mod COLS
  float4 wr[ITEMS][4], wi[ITEMS][4];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int e = threadIdx.x + j * THREADS;
    const int ib = 4 * (e & (B / 4 - 1)), kl = e >> 5;
    const int w = pad(bitrev(KA * c + kl, LOGA) * COLS + (ib & (COLS - 1)));
    float4 s_r[4], s_i[4];
#pragma unroll
    for (int ip = 0; ip < 4; ++ip) {
      const unsigned src = static_cast<unsigned>(ip * (B >> LOGCOLS) + (ib >> LOGCOLS));
      s_r[ip] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(sr, src) + w);
      s_i[ip] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(si, src) + w);
    }
    float4 cs[4], sn[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      cs[p] = __ldg(reinterpret_cast<const float4*>(c2r + p * B + ib));
      sn[p] = __ldg(reinterpret_cast<const float4*>(c2i + p * B + ib));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float e_r = part(s_r[0], u) + part(s_r[2], u);
      const float e_i = part(s_i[0], u) + part(s_i[2], u);
      const float d_r = part(s_r[0], u) - part(s_r[2], u);
      const float d_i = part(s_i[0], u) - part(s_i[2], u);
      const float g_r = part(s_r[1], u) + part(s_r[3], u);
      const float g_i = part(s_i[1], u) + part(s_i[3], u);
      const float h_r = part(s_r[1], u) - part(s_r[3], u);
      const float h_i = part(s_i[1], u) - part(s_i[3], u);
      const float y_r[4] = {e_r + g_r, d_r + h_i, e_r - g_r, d_r - h_i};
      const float y_i[4] = {e_i + g_i, d_i - h_r, e_i - g_i, d_i + h_r};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        part(wr[j][p], u) = y_r[p] * part(cs[p], u) - y_i[p] * part(sn[p], u);
        part(wi[j][p], u) = y_r[p] * part(sn[p], u) + y_i[p] * part(cs[p], u);
      }
    }
  }
  // no block reads another's buffer past this point
  cluster.sync();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int e = threadIdx.x + j * THREADS;
    const int ib = 4 * (e & (B / 4 - 1)), kl = e >> 5;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int w = pad((kl * 4 + p) * B + ib);
      *reinterpret_cast<float4*>(sr + w) = wr[j][p];
      *reinterpret_cast<float4*>(si + w) = wi[j][p];
    }
  }
  __syncthreads();

  // F(b) along each of the 64 rows (k_a - 16c, p)
  dif_two<LOGB>(sr, si, 6, B, 1, false, tw2);

  // out[k_b*4a + p*a + k_a], k_a in [16c, 16c + 16): 16 contiguous floats
  // per (k_b, p), written by four neighbouring lanes as float4s. The
  // other lanes take the top 3 bits of k_b (8 neighbouring columns
  // bitrev(k_b)), so a warp's shared-memory reads are 4-way conflicted
  // where lanes over p would be 8-way (lanes over whole runs would have
  // none, but their scattered 16-byte stores took 4.8x as long).
#pragma unroll 2
  for (int j = 0; j < LOADS; ++j) {
    const int lane = threadIdx.x & 31, rest = (threadIdx.x >> 5) + j * (THREADS / 32);
    const int kl = 4 * (lane & 3), p = rest & 3;
    const int kb = 16 * (lane >> 2) + (rest >> 2);
    const int col = bitrev(kb, LOGB);
    float vr[4], vi[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int w = pad(((kl + u) * 4 + p) * B + col);
      vr[u] = sr[w] * out_scale;
      vi[u] = si[w] * out_scale;
    }
    const long long o = base + kb * 4 * A + p * A + KA * c + kl;
    *reinterpret_cast<float4*>(ore + o) = make_float4(vr[0], vr[1], vr[2], vr[3]);
    *reinterpret_cast<float4*>(oim + o) = make_float4(vi[0], vi[1], vi[2], vi[3]);
  }
}

#define LEAF3_PARAMS                                                                        \
  const float *__restrict__ re, const float *__restrict__ im, const float *__restrict__ f1r, \
      const float *__restrict__ f1i, const float *__restrict__ f2r,                          \
      const float *__restrict__ f2i, const float *__restrict__ c1r,                          \
      const float *__restrict__ c1i, const float *__restrict__ c2r,                          \
      const float *__restrict__ c2i, float *__restrict__ ore, float *__restrict__ oim,     \
      float out_scale

// a = 128: an 8-block cluster, fixed at compile time
__global__ void __cluster_dims__(8, 1, 1) __launch_bounds__(THREADS, 3)
leaf3_kernel(LEAF3_PARAMS) {
  leaf3_body<7>(re, im, f1r, f1i, f2r, f2i, c1r, c1i, c2r, c2i, ore, oim, out_scale);
}

// a = 256: a 16-block cluster, set at launch (a non-portable size), two
// blocks an SM
__global__ void __launch_bounds__(THREADS, 2) leaf3_kernel256(LEAF3_PARAMS) {
  leaf3_body<8>(re, im, f1r, f1i, f2r, f2i, c1r, c1i, c2r, c2i, ore, oim, out_scale);
}

template <int LOGA>
constexpr size_t smem_bytes() {
  return 2 * sizeof(float) * WORDS + sizeof(float2) * ((1 << LOGA) / 2 + B / 2);
}

cudaError_t configure() {
  cudaError_t err = cudaFuncSetAttribute(
      leaf3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes<7>()));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(leaf3_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// re, im, ore, oim: (batch, a*512), a = 128 or 256; f1r/f1i: F(a),
// f2r/f2i: F(128) (b), c1r/c1i: (a, 512) W_n^(k_a*i_r), c2r/c2i: (4, 128)
// W_512^(p*i_b); out_scale: the factor of every output. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int phastft_leaf3(const float* re, const float* im, const float* f1r,
                             const float* f1i, const float* f2r, const float* f2i,
                             const float* c1r, const float* c1i, const float* c2r,
                             const float* c2i, float* ore, float* oim, long long batch, int a,
                             double out_scale, void* stream) {
  if (batch < 1 || (a != 128 && a != 256)) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = static_cast<float>(out_scale);
  if (a == 256) {
    static int resident = 0;  // queried on first use
    return phastft::launch_clusters(leaf3_kernel256, Shape<8>::CLUSTER,
                                    Shape<8>::CLUSTER * batch, THREADS, smem_bytes<8>(),
                                    static_cast<cudaStream_t>(stream), resident, re, im, f1r,
                                    f1i, f2r, f2i, c1r, c1i, c2r, c2i, ore, oim, scale);
  }
  if (batch > 0x0fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  leaf3_kernel<<<static_cast<unsigned>(Shape<7>::CLUSTER * batch), THREADS, smem_bytes<7>(),
                 static_cast<cudaStream_t>(stream)>>>(re, im, f1r, f1i, f2r, f2i, c1r,
                                                      c1i, c2r, c2i, ore, oim, scale);
  return static_cast<int>(cudaGetLastError());
}

// The number of leaf3 clusters at a = 128 or 256 the current device holds at
// once (the CUDA occupancy query), or minus the CUDA error code.
extern "C" int phastft_leaf3_clusters(int a) {
  if (a == 256)
    return phastft::resident_clusters(leaf3_kernel256, Shape<8>::CLUSTER, THREADS,
                                      smem_bytes<8>());
  if (a != 128) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure();
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(Shape<7>::CLUSTER * 1024);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = smem_bytes<7>();
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, leaf3_kernel, &config);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}
