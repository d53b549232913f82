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
// Design against that bound: one block per row keeps the whole row (up to
// 16384 complex = 128 KB) in shared memory, so both factors and the twiddle
// run with device memory touched once each way. Reads are contiguous: for
// fixed (iA, k1) 128 floats, loaded as float4. The stores are the known
// limit of this version: the contiguous output axis is k1, the row index,
// so each store writes one float per 32-byte sector and relies on the L2
// to merge the neighbouring rows' writes. A later version keeps several
// rows per block and stages the stores.
//
// Twiddles come from the planner's tables, so this kernel computes from the
// same bits as the plain version: W_A^k is row 1 of F(A), W_128^k row 1 of
// F(128), and W_n2^(kA*iM) the (A, 128) correction table.
#include <cuda_runtime.h>

#include "fft_smem.cuh"

using phastft::bitrev;
using phastft::pad;
using phastft::padded_words;

namespace {

__global__ void __launch_bounds__(512)
leaft_kernel(const float* __restrict__ cre, const float* __restrict__ cim,
             const float* __restrict__ f1r, const float* __restrict__ f1i,
             const float* __restrict__ f2r, const float* __restrict__ f2i,
             const float* __restrict__ cr, const float* __restrict__ ci,
             float* __restrict__ ore, float* __restrict__ oim, int loga, int n1) {
  extern __shared__ float4 smem4[];
  const int na = 1 << loga;
  const int words = padded_words(na * 128);
  float* sr = reinterpret_cast<float*>(smem4);
  float* si = sr + words;
  float2* twa = reinterpret_cast<float2*>(si + words);  // W_A^k, k < A/2
  float2* twm = twa + na / 2;                           // W_128^k, k < 64

  // the batch is folded into gridDim.x: block = b * n1 + k1
  const int k1 = static_cast<int>(blockIdx.x % static_cast<unsigned>(n1));
  const long long b = blockIdx.x / static_cast<unsigned>(n1);
  const long long n = static_cast<long long>(na) * 128 * n1;

  for (int k = threadIdx.x; k < na / 2; k += blockDim.x)
    twa[k] = make_float2(f1r[na + k], f1i[na + k]);
  for (int k = threadIdx.x; k < 64; k += blockDim.x)
    twm[k] = make_float2(f2r[128 + k], f2i[128 + k]);
#pragma unroll 4
  for (int e = threadIdx.x; e < na * 32; e += blockDim.x) {
    const int ia = e >> 5, v = e & 31;
    const long long off = ((b * na + ia) * n1 + k1) * 128 + 4 * v;
    const int w = pad(ia * 128 + 4 * v);
    *reinterpret_cast<float4*>(sr + w) = __ldg(reinterpret_cast<const float4*>(cre + off));
    *reinterpret_cast<float4*>(si + w) = __ldg(reinterpret_cast<const float4*>(cim + off));
  }
  __syncthreads();

  // F(A) over iA: 128 sequences (one per iM, the contiguous axis), stride 128
  phastft::dif_fft(sr, si, loga, 7, 1, 128, true, twa);

  // row p now holds kA = bitrev(p): apply W_n2^(kA*iM)
  for (int e = threadIdx.x; e < na * 128; e += blockDim.x) {
    const int im_ = e & 127;
    const int ka = bitrev(e >> 7, loga);
    const float c = __ldg(cr + ka * 128 + im_), s = __ldg(ci + ka * 128 + im_);
    const int w = pad(e);
    const float x = sr[w], y = si[w];
    sr[w] = x * c - y * s;
    si[w] = x * s + y * c;
  }
  __syncthreads();

  // F(128) along each row: A sequences of 128 contiguous elements
  phastft::dif_fft(sr, si, 7, loga, 128, 1, false, twm);

  for (int e = threadIdx.x; e < na * 128; e += blockDim.x) {
    const int ka = e & (na - 1), km = e >> loga;
    const int w = pad(bitrev(ka, loga) * 128 + bitrev(km, 7));
    const long long o = b * n + (static_cast<long long>(km) * na + ka) * n1 + k1;
    ore[o] = sr[w];
    oim[o] = si[w];
  }
}

}  // namespace

// cre, cim: (batch, A, n1, 128); f1r/f1i: (A, A) F(A); f2r/f2i: (128, 128)
// F(128); cr/ci: (A, 128) W_n2^(kA*iM); ore, oim: (batch, n) with
// n = A*128*n1; batch * n1 blocks, at most 2^31 - 1. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int phastft_leaft(const float* cre, const float* cim, const float* f1r,
                             const float* f1i, const float* f2r, const float* f2i,
                             const float* cr, const float* ci, float* ore, float* oim,
                             long long batch, int n1, int na, void* stream) {
  if (batch < 1 || n1 < 1 || n1 > (1 << 20) || batch * n1 > 0x7fffffffLL ||
      !phastft::is_pow2(na) || na < 8 || na > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const int loga = phastft::ilog2(na);
  const size_t smem =
      2 * sizeof(float) * padded_words(na * 128) + sizeof(float2) * (na / 2 + 64);
  cudaError_t err = cudaFuncSetAttribute(
      leaft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = na >= 64 ? 512 : 256;
  const unsigned grid = static_cast<unsigned>(batch * n1);
  leaft_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      cre, cim, f1r, f1i, f2r, f2i, cr, ci, ore, oim, loga, n1);
  return static_cast<int>(cudaGetLastError());
}
