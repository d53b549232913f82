// Three-factor leaf FFT: the length-2^16 DFT of every row, planar f32, for
// sm_90a.
//
// Replaces: phastft_tpu/ops/pallas_leaf.py, leaf_fft_pallas3 (n = a*4*b,
// a = b = 128, the f32 leaf at n = 2^16).
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
// Design against that bound: a row (512 KB) is held by a cluster of 4
// blocks, 128 KB each, so device memory is touched once each way.
// - Block p loads the column slab i_r in [128p, 128p + 128), which is
//   exactly i_p = p, for every i_a (float4 loads, 512 contiguous bytes per
//   i_a), and runs F(a) over i_a and the c1 twiddle on it.
// - The cluster trades slabs through distributed shared memory: block c
//   gathers k_a in [32c, 32c + 32) for all four i_p and all i_b into
//   registers, a cluster barrier, then it overwrites its own buffer (two
//   128 KB buffers do not fit one block's 227 KB).
// - Block c then runs the radix-4 over i_p, c2 and F(b) over i_b locally
//   and stores 32 contiguous floats per (k_b, p), gathered from shared
//   memory as float4s.
// Rows go in gridDim.x (4 blocks each), so any batch runs.
//
// Twiddles come from the planner's tables (mxu3_512), the same bits as the
// plain version: row 1 of F(a) and F(b), c1 = W_n^(k_a*i_r) (a, 4b) and
// c2 = W_4b^(p*i_b) (4, b).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fft_smem.cuh"

namespace cg = cooperative_groups;
using phastft::bitrev;
using phastft::load_twiddles;
using phastft::pad;
using phastft::padded_words;

namespace {

constexpr int A = 128, LOGA = 7, B = 128, LOGB = 7;
constexpr int IR = 4 * B;        // length of the i_r axis
constexpr int N = A * IR;        // 2^16
constexpr int SLAB = IR / 4;     // i_r columns per block (one i_p)
constexpr int KA = A / 4;        // k_a rows per block after the exchange
constexpr int LOCAL = N / 4;     // complex elements per block
constexpr int THREADS = 1024;
constexpr int PER_THREAD = LOCAL / THREADS;

__global__ void __cluster_dims__(4, 1, 1) __launch_bounds__(THREADS)
leaf3_kernel(const float* __restrict__ re, const float* __restrict__ im,
             const float* __restrict__ f1r, const float* __restrict__ f1i,
             const float* __restrict__ f2r, const float* __restrict__ f2i,
             const float* __restrict__ c1r, const float* __restrict__ c1i,
             const float* __restrict__ c2r, const float* __restrict__ c2i,
             float* __restrict__ ore, float* __restrict__ oim) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int words = padded_words(LOCAL);
  float* sr = reinterpret_cast<float*>(smem4);
  float* si = sr + words;
  float2* tw1 = reinterpret_cast<float2*>(si + words);  // W_a^k, k < a/2
  float2* tw2 = tw1 + A / 2;                            // W_b^k, k < b/2

  const int c = static_cast<int>(cluster.block_rank());
  const long long base = (static_cast<long long>(blockIdx.x) >> 2) * N;

  load_twiddles(tw1, A, f1r, f1i);
  load_twiddles(tw2, B, f2r, f2i);
  // slab i_p = c: shared (i_a, i_b)
  for (int e = threadIdx.x; e < LOCAL / 4; e += blockDim.x) {
    const int ia = e >> 5, v = e & 31;
    const long long off = base + ia * IR + SLAB * c + 4 * v;
    const int w = pad(ia * SLAB + 4 * v);
    *reinterpret_cast<float4*>(sr + w) = __ldg(reinterpret_cast<const float4*>(re + off));
    *reinterpret_cast<float4*>(si + w) = __ldg(reinterpret_cast<const float4*>(im + off));
  }
  __syncthreads();

  // F(a) over i_a: 128 sequences (the contiguous axis), stride 128
  phastft::dif_fft(sr, si, LOGA, 7, 1, SLAB, true, tw1);
  // shared row q holds k_a = bitrev(q): u = t * W_n^(k_a*i_r)
  for (int e = threadIdx.x; e < LOCAL; e += blockDim.x) {
    const int ka = bitrev(e >> 7, LOGA);
    const int t = ka * IR + SLAB * c + (e & (SLAB - 1));
    const float cs = __ldg(c1r + t), sn = __ldg(c1i + t);
    const int w = pad(e);
    const float x = sr[w], y = si[w];
    sr[w] = x * cs - y * sn;
    si[w] = x * sn + y * cs;
  }

  // exchange: block c gathers (k_a - 32c, i_p, i_b) for k_a in
  // [32c, 32c + 32) from block i_p into registers, then overwrites its own
  // buffer once every block has read it
  cluster.sync();
  float xr[PER_THREAD], xi[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int e = threadIdx.x + j * THREADS;
    const int ib = e & (B - 1), ip = (e >> 7) & 3, kl = e >> 9;
    const int w = pad(bitrev(KA * c + kl, LOGA) * SLAB + ib);
    xr[j] = cluster.map_shared_rank(sr, static_cast<unsigned>(ip))[w];
    xi[j] = cluster.map_shared_rank(si, static_cast<unsigned>(ip))[w];
  }
  cluster.sync();
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int w = pad(threadIdx.x + j * THREADS);
    sr[w] = xr[j];
    si[w] = xi[j];
  }
  __syncthreads();

  // radix-4 over i_p, then w_p = y_p * W_4b^(p*i_b), for each (k_a, i_b)
  for (int e = threadIdx.x; e < KA * B; e += blockDim.x) {
    const int kl = e >> 7, ib = e & (B - 1);
    int w[4];
    float s_r[4], s_i[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      w[p] = pad(((kl * 4 + p) << 7) + ib);
      s_r[p] = sr[w[p]];
      s_i[p] = si[w[p]];
    }
    const float e_r = s_r[0] + s_r[2], e_i = s_i[0] + s_i[2];
    const float d_r = s_r[0] - s_r[2], d_i = s_i[0] - s_i[2];
    const float g_r = s_r[1] + s_r[3], g_i = s_i[1] + s_i[3];
    const float h_r = s_r[1] - s_r[3], h_i = s_i[1] - s_i[3];
    const float y_r[4] = {e_r + g_r, d_r + h_i, e_r - g_r, d_r - h_i};
    const float y_i[4] = {e_i + g_i, d_i - h_r, e_i - g_i, d_i + h_r};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float cs = __ldg(c2r + p * B + ib), sn = __ldg(c2i + p * B + ib);
      sr[w[p]] = y_r[p] * cs - y_i[p] * sn;
      si[w[p]] = y_r[p] * sn + y_i[p] * cs;
    }
  }
  __syncthreads();

  // F(b) along each of the 128 rows (k_a - 32c, p)
  phastft::dif_fft(sr, si, LOGB, 7, B, 1, false, tw2);

  // out[k_b*4a + p*a + k_a], k_a in [32c, 32c + 32): 32 contiguous floats
  for (int e = threadIdx.x; e < LOCAL / 4; e += blockDim.x) {
    const int kl = 4 * (e & 7), p = (e >> 3) & 3, kb = e >> 5;
    float vr[4], vi[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int w = pad((((kl + u) * 4 + p) << 7) + bitrev(kb, LOGB));
      vr[u] = sr[w];
      vi[u] = si[w];
    }
    const long long o = base + kb * 4 * A + p * A + KA * c + kl;
    *reinterpret_cast<float4*>(ore + o) = make_float4(vr[0], vr[1], vr[2], vr[3]);
    *reinterpret_cast<float4*>(oim + o) = make_float4(vi[0], vi[1], vi[2], vi[3]);
  }
}

}  // namespace

// re, im, ore, oim: (batch, 2^16); f1r/f1i: F(128) (a), f2r/f2i: F(128)
// (b), c1r/c1i: (128, 512) W_n^(k_a*i_r), c2r/c2i: (4, 128) W_512^(p*i_b).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int phastft_leaf3(const float* re, const float* im, const float* f1r,
                             const float* f1i, const float* f2r, const float* f2i,
                             const float* c1r, const float* c1i, const float* c2r,
                             const float* c2i, float* ore, float* oim, long long batch,
                             void* stream) {
  if (batch < 1 || batch > 0x1fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * sizeof(float) * padded_words(LOCAL) + sizeof(float2) * (A / 2 + B / 2);
  cudaError_t err = cudaFuncSetAttribute(
      leaf3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  leaf3_kernel<<<static_cast<unsigned>(4 * batch), THREADS, smem,
                 static_cast<cudaStream_t>(stream)>>>(re, im, f1r, f1i, f2r, f2i, c1r,
                                                      c1i, c2r, c2i, ore, oim);
  return static_cast<int>(cudaGetLastError());
}
