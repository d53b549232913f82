// Row pass of the fused two-pass four-step FFT, planar f32, for sm_90a.
//
// Replaces: phastft_tpu/ops/pallas_leaft.py, leaft_pallas (row FFTs of
// length n2 = A*128 over the column pass's (A, n1, 128) relayout, with the
// four-step's output transpose folded into the store index).
//
// For each batch b and row k1, with c[i2] = c3[b, iA, k1, iM], i2 = iA*128 + iM:
//   t[kA, iM] = sum_iA W_A^(kA*iA) c[iA, iM]        (F(A) over iA)
//   u[kA, iM] = t[kA, iM] * W_n2^(kA*iM)             (planner table cr, ci)
//   out[b, k1 + n1*(kA + A*kM)] = sum_iM W_128^(kM*iM) u[kA, iM]
// This factor order is what puts k2 = kA + A*kM in natural order.
//
// Bound: memory. Each element is read once and written once, 16 B per
// complex element per pass, against ~5*log2(n2) flops per element.
//
// Design against that bound: the contiguous axis of the output is k1, the
// row index, so a cluster owns R = 8 consecutive rows and writes R
// contiguous floats (one 32-byte sector) per (kA, kM). Its C = A/8 blocks
// hold 8192 points each (64 KB, ~74 KB of shared memory with padding and
// twiddles) and run 256 threads capped at 80 registers, so three blocks
// share an SM; at that cap ptxas spills 16 B a thread, 64 B at A = 8
// (-Xptxas -v for sm_90a). At A = 128 the 16-block cluster is a
// non-portable size, set at launch (cluster.cuh). Device memory is touched
// once each way.
// - Block c loads the W = 128/C columns iM in [W c, W c + W) of every iA
//   for the R rows (for fixed iA the R rows of 128 floats are contiguous:
//   W-float runs, float4 loads, every load of a thread in flight at once),
//   laid out (iA, row, iM), and runs F(A) over iA on all R*W columns in
//   trips of up to four stages (fft_smem.cuh dif_fft16), the correction
//   W_n2^(kA*iM) multiplied in the registers of the last trip.
// - After a cluster barrier it reads its A/C values of kA, every iM, for
//   the R rows from every block (distributed shared memory) straight into
//   the first trip of F(128), a radix-16 over iM = r + 8j, and holds the
//   results until a second barrier says no block reads its buffer any
//   more. The last three stages of F(128) run in its own buffer, laid out
//   (kA, iM, row) so that the store reads R rows of one (kA, kM) as
//   float4s and writes them as one contiguous run, each value times
//   out_scale (1, or 1/N where this pass ends an inverse: the same bits as
//   a separate multiply after the kernel, without its pass over memory).
//
// Twiddles come from the planner's tables, so this kernel computes from the
// same bits as the plain version: W_A^k is row 1 of F(A), W_128^k row 1 of
// F(128), and W_n2^(kA*iM) the (A, 128) correction table.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "fft_smem.cuh"

namespace cg = cooperative_groups;
using phastft::bitrev;
using phastft::pad;
using phastft::padded_words;

namespace {

// -- R rows a cluster: 2^LOGR consecutive rows k1 over 2^LOGC = A*R/64 blocks

constexpr int LOCAL = 8192;  // points a block holds
constexpr int WORDS = padded_words(LOCAL);
constexpr int THREADS = 256;
constexpr int LOADS = LOCAL / 4 / THREADS;  // float4 loads of each plane a thread
constexpr int M = 128, LOGM = 7;
constexpr int LOG_ROWS = 3;  // R = 8 rows a cluster: one 32-byte sector

__host__ __device__ constexpr int cluster_log(int loga, int logr) {
  return loga + logr + LOGM - 13;
}

constexpr size_t cluster_smem_bytes(int na) {
  return 2 * sizeof(float) * WORDS + sizeof(float2) * (na / 2 + M / 2);
}

template <int LOGA, int LOGR>
__global__ void __launch_bounds__(THREADS, 3)
leaft_cluster(const float* __restrict__ cre, const float* __restrict__ cim,
              const float* __restrict__ f1r, const float* __restrict__ f1i,
              const float* __restrict__ f2r, const float* __restrict__ f2i,
              const float* __restrict__ cr, const float* __restrict__ ci,
              float* __restrict__ ore, float* __restrict__ oim, int n1, float out_scale) {
  constexpr int A = 1 << LOGA, R = 1 << LOGR;
  constexpr int LOGC = cluster_log(LOGA, LOGR);
  static_assert(LOGC >= 0 && LOGC <= 4, "clusters of 1..16 blocks");
  constexpr int LOGW = LOGM - LOGC, W = 1 << LOGW;  // iM a block loads
  constexpr int LOGRW = LOGR + LOGW, RW = 1 << LOGRW;
  constexpr int LOGKA = LOGA - LOGC, KA = 1 << LOGKA;  // kA a block owns
  // exchange items a thread: (row, r, kA - KA*c), a radix-16 over iM = r + 8j
  constexpr int ITEMS = (R * 8 * KA) / THREADS;
  // items of the last three stages: (row, iM / 8, kA - KA*c)
  constexpr int LAST = (R * 16 * KA) / THREADS;
  constexpr int LOGH = LOGR - 2;  // float4s per R rows
  static_assert(ITEMS == 2 && LAST == 4 && W >= 8, "block shape");
  extern __shared__ float4 smem4[];
  float* sr = reinterpret_cast<float*>(smem4);
  float* si = sr + WORDS;
  float2* twa = reinterpret_cast<float2*>(si + WORDS);  // W_A^k, k < A/2
  float2* twm = twa + A / 2;                            // W_128^k, k < 64

  int c = 0;
  if (LOGC) c = static_cast<int>(cg::this_cluster().block_rank());
  // cluster -> (batch entry b, rows [k0, k0 + R))
  const unsigned grp = blockIdx.x >> LOGC;
  const unsigned groups = static_cast<unsigned>(n1) >> LOGR;
  const long long b = grp / groups;
  const int k0 = static_cast<int>(grp % groups) << LOGR;
  const long long n = static_cast<long long>(A) * M * n1;

  // (iA, row, iM - W c): float4 e of the block is shared word 4e
  float4 va[LOADS], vb[LOADS];
#pragma unroll
  for (int it = 0; it < LOADS; ++it) {
    const int e = threadIdx.x + it * THREADS;
    const int v = e & (W / 4 - 1), row = (e >> (LOGW - 2)) & (R - 1);
    const int ia = e >> (LOGRW - 2);
    const long long off = ((b * A + ia) * n1 + k0 + row) * M + W * c + 4 * v;
    va[it] = __ldg(reinterpret_cast<const float4*>(cre + off));
    vb[it] = __ldg(reinterpret_cast<const float4*>(cim + off));
  }
  phastft::load_twiddles(twa, A, f1r, f1i);
  phastft::load_twiddles(twm, M, f2r, f2i);
#pragma unroll
  for (int it = 0; it < LOADS; ++it) {
    const int w = pad(4 * (threadIdx.x + it * THREADS));
    *reinterpret_cast<float4*>(sr + w) = va[it];
    *reinterpret_cast<float4*>(si + w) = vb[it];
  }
  __syncthreads();

  // F(A) over iA: R*W sequences (the contiguous axis), stride R*W, the
  // correction W_n2^(kA*iM), iM = W c + (sequence mod W), folded into the
  // last trip
  phastft::dif_fft16(sr, si, LOGA, LOGA, LOGRW, 1, RW, true, twa, cr, ci, true, W * c,
                     W - 1);
  if (LOGC) cg::this_cluster().sync();

  // exchange, straight into the first trip of F(128): item (row, r, kl)
  // takes iM = r + 8j, j < 16, of kA = KA c + kl, held at shared row
  // bitrev(kA) of block iM / W
  float yr[ITEMS][16], yi[ITEMS][16];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int e = threadIdx.x + it * THREADS;
    const int row = e & (R - 1), r = (e >> LOGR) & 7, kl = e >> (LOGR + 3);
    const int base = (bitrev(KA * c + kl, LOGA) << LOGRW) + (row << LOGW);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int i = r + 8 * jj;
      const int w = pad(base + (i & (W - 1)));
      const float* rr = sr;
      const float* ri = si;
      if (LOGC) {
        const unsigned src = static_cast<unsigned>(i >> LOGW);
        rr = cg::this_cluster().map_shared_rank(sr, src);
        ri = cg::this_cluster().map_shared_rank(si, src);
      }
      yr[it][jj] = rr[w];
      yi[it][jj] = ri[w];
    }
    phastft::dif_group<4>(yr[it], yi[it], r, 3, LOGM, LOGM, twm);
  }
  // no block reads another's buffer past this point
  if (LOGC) cg::this_cluster().sync(); else __syncthreads();
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int e = threadIdx.x + it * THREADS;
    const int row = e & (R - 1), r = (e >> LOGR) & 7, kl = e >> (LOGR + 3);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int w = pad((((kl << LOGM) + r + 8 * jj) << LOGR) + row);
      sr[w] = yr[it][jj];
      si[w] = yi[it][jj];
    }
  }
  __syncthreads();

  // the last three stages of F(128): item (row, g, kl), iM = 8g + s
#pragma unroll
  for (int it = 0; it < LAST; ++it) {
    const int e = threadIdx.x + it * THREADS;
    const int row = e & (R - 1), g = (e >> LOGR) & 15, kl = e >> (LOGR + 4);
    float xr8[8], xi8[8];
    int at[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      at[s] = pad((((kl << LOGM) + 8 * g + s) << LOGR) + row);
      xr8[s] = sr[at[s]];
      xi8[s] = si[at[s]];
    }
    phastft::dif_group<3>(xr8, xi8, 0, 0, LOGM, 3, twm);
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      sr[at[s]] = xr8[s];
      si[at[s]] = xi8[s];
    }
  }
  __syncthreads();

  // out[k1 + n1*(kA + A*kM)], k1 in [k0, k0 + R): R contiguous floats per
  // (kA, kM) as float4s; neighbouring lanes take neighbouring positions
  // bitrev(kM), so the shared reads of a quarter warp fill the 32 banks
#pragma unroll 2
  for (int it = 0; it < LOADS; ++it) {
    const int e = threadIdx.x + it * THREADS;
    const int h = e & ((1 << LOGH) - 1), pos = (e >> LOGH) & (M - 1);
    const int kl = e >> (LOGH + LOGM);
    const int w = pad((((kl << LOGM) + pos) << LOGR) + 4 * h);
    const float4 a = phastft::scale4(*reinterpret_cast<const float4*>(sr + w), out_scale);
    const float4 d = phastft::scale4(*reinterpret_cast<const float4*>(si + w), out_scale);
    const int km = bitrev(pos, LOGM), ka = KA * c + kl;
    const long long o = b * n + (static_cast<long long>(km) * A + ka) * n1 + k0 + 4 * h;
    *reinterpret_cast<float4*>(ore + o) = a;
    *reinterpret_cast<float4*>(oim + o) = d;
  }
}

using ClusterKernel = void (*)(const float*, const float*, const float*, const float*,
                               const float*, const float*, const float*, const float*,
                               float*, float*, int, float);

ClusterKernel cluster_kernel(int loga) {
  switch (loga) {
    case 3: return leaft_cluster<3, LOG_ROWS>;
    case 4: return leaft_cluster<4, LOG_ROWS>;
    case 5: return leaft_cluster<5, LOG_ROWS>;
    case 6: return leaft_cluster<6, LOG_ROWS>;
    default: return leaft_cluster<7, LOG_ROWS>;
  }
}

}  // namespace

// cre, cim: (batch, A, n1, 128); f1r/f1i: (A, A) F(A); f2r/f2i: (128, 128)
// F(128); cr/ci: (A, 128) W_n2^(kA*iM); ore, oim: (batch, n) with
// n = A*128*n1, n1 a multiple of 8; batch * n1/8 clusters of A/8 blocks,
// at most 2^31 - 1 blocks; out_scale: the factor of every output (1, or 1/N
// where this pass ends an inverse). Returns the CUDA error code of the
// launch (0 on success).
extern "C" int phastft_leaft(const float* cre, const float* cim, const float* f1r,
                             const float* f1i, const float* f2r, const float* f2i,
                             const float* cr, const float* ci, float* ore, float* oim,
                             long long batch, int n1, int na, double out_scale,
                             void* stream) {
  if (batch < 1 || n1 < 1 || n1 > (1 << 20) || n1 % (1 << LOG_ROWS) ||
      !phastft::is_pow2(na) || na < 8 || na > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const int loga = phastft::ilog2(na);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int logc = cluster_log(loga, LOG_ROWS);
  static int resident[8] = {};  // per log2(A), queried on first use
  const long long blocks = (batch * (n1 >> LOG_ROWS)) << logc;
  return phastft::launch_clusters(cluster_kernel(loga), 1 << logc, blocks, THREADS,
                                  cluster_smem_bytes(na), s, resident[loga], cre, cim, f1r,
                                  f1i, f2r, f2i, cr, ci, ore, oim, n1,
                                  static_cast<float>(out_scale));
}

// The clusters of the R-row design at A = na (8..128: 1..16 blocks) the
// current device holds at once (the CUDA occupancy query), or minus the
// CUDA error code.
extern "C" int phastft_leaft_clusters(int na) {
  if (!phastft::is_pow2(na) || na < 8 || na > 128)
    return -static_cast<int>(cudaErrorInvalidValue);
  const int loga = phastft::ilog2(na);
  return phastft::resident_clusters(cluster_kernel(loga), 1 << cluster_log(loga, LOG_ROWS),
                                    THREADS, cluster_smem_bytes(na));
}
