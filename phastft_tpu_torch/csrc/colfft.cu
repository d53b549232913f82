// Column pass of the fused two-pass four-step FFT, planar f32, for sm_90a.
//
// Replaces: phastft_tpu/ops/pallas_col.py, colfft_pallas(..., out3d=True)
// (the column DFT fused with the split twiddle, landed in the (A, n1, 128)
// relayout that the row kernel reads).
//
// For every batch b and column i2 of x viewed (n1, n2):
//   c3[b, i2/128, k1, i2%128] = W_n^(k1*i2) * sum_i1 W_n1^(k1*i1) x[b, i1, i2]
//
// Bound: memory. Each element is read once and written once, 16 B per
// complex element per pass, against ~5*log2(n1) flops per element; at
// 3.35 TB/s the bytes take several times longer than the flops.
//
// Design against that bound:
// - A block owns T neighbouring columns (T = 16, or 8 at n1 = 2048 so the
//   (n1, T) slab fits the 227 KB of shared memory; the TPU kernel's
//   (n1, 512) slab does not). Rows of T floats are read with float4 loads,
//   neighbouring threads on neighbouring addresses.
// - The whole size-n1 DFT runs in shared memory, three radix-2 stages per
//   trip (fft_smem.cuh), so device memory is touched once each way.
// - The store needs no transpose: for fixed k1 the T columns land
//   contiguously inside one 128-wide row of the relayout (float4 stores).
// - The split twiddle is formed from the exact phase m = (k1*i2) mod n in
//   64-bit integers and sincospi(-2m/n) in double, rounded once to float:
//   an f32 angle k1*i2 would lose the phase at n = 2^25. The in-block
//   twiddles W_n1^k are formed the same way into shared memory.
#include <cuda_runtime.h>

#include "fft_smem.cuh"

using phastft::bitrev;
using phastft::pad;
using phastft::padded_words;

namespace {

template <int T>
__global__ void __launch_bounds__(512)
colfft_out3d_kernel(const float* __restrict__ re, const float* __restrict__ im,
                    float* __restrict__ ore, float* __restrict__ oim,
                    int logn1, int n2) {
  constexpr int V = T / 4;  // float4 per slab row
  constexpr int LOGT = T == 16 ? 4 : 3;
  extern __shared__ float4 smem4[];
  const int n1 = 1 << logn1;
  const int words = padded_words(n1 * T);
  float* sr = reinterpret_cast<float*>(smem4);
  float* si = sr + words;
  float2* tw = reinterpret_cast<float2*>(si + words);

  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const long long n = static_cast<long long>(n1) * n2;
  const float* xr = re + b * n + static_cast<long long>(j) * T;
  const float* xi = im + b * n + static_cast<long long>(j) * T;

  for (int k = threadIdx.x; k < n1 / 2; k += blockDim.x) {
    double s, c;
    sincospi(-2.0 * k / n1, &s, &c);
    tw[k] = make_float2(static_cast<float>(c), static_cast<float>(s));
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < n1 * V; e += blockDim.x) {
    const int i1 = e / V, v = e % V;
    const long long off = static_cast<long long>(i1) * n2 + 4 * v;
    const int w = pad(i1 * T + 4 * v);
    *reinterpret_cast<float4*>(sr + w) = __ldg(reinterpret_cast<const float4*>(xr + off));
    *reinterpret_cast<float4*>(si + w) = __ldg(reinterpret_cast<const float4*>(xi + off));
  }
  __syncthreads();

  // column q of the slab is the contiguous axis: sequences are neighbours
  phastft::dif_fft(sr, si, logn1, LOGT, 1, T, true, tw);

  const int na = n2 >> 7;
#pragma unroll 2
  for (int e = threadIdx.x; e < n1 * V; e += blockDim.x) {
    const int k1 = e / V, v = e % V;
    const int w = pad(bitrev(k1, logn1) * T + 4 * v);
    const float4 a = *reinterpret_cast<const float4*>(sr + w);
    const float4 c = *reinterpret_cast<const float4*>(si + w);
    const float vr[4] = {a.x, a.y, a.z, a.w};
    const float vi[4] = {c.x, c.y, c.z, c.w};
    const int i2 = j * T + 4 * v;
    float outr[4], outi[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long m = (static_cast<long long>(k1) * (i2 + u)) & (n - 1);
      double s, cs;
      sincospi(-2.0 * static_cast<double>(m) / static_cast<double>(n), &s, &cs);
      const float wr = static_cast<float>(cs), wi = static_cast<float>(s);
      outr[u] = vr[u] * wr - vi[u] * wi;
      outi[u] = vr[u] * wi + vi[u] * wr;
    }
    const long long o =
        ((static_cast<long long>(b) * na + (i2 >> 7)) * n1 + k1) * 128 + (i2 & 127);
    *reinterpret_cast<float4*>(ore + o) = make_float4(outr[0], outr[1], outr[2], outr[3]);
    *reinterpret_cast<float4*>(oim + o) = make_float4(outi[0], outi[1], outi[2], outi[3]);
  }
}

template <int T>
int launch(const float* re, const float* im, float* ore, float* oim, int batch,
           int n1, int n2, cudaStream_t stream) {
  const int logn1 = phastft::ilog2(n1);
  const size_t smem = 2 * sizeof(float) * padded_words(n1 * T) + sizeof(float2) * (n1 / 2);
  cudaError_t err = cudaFuncSetAttribute(colfft_out3d_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = n1 * T / 8 >= 512 ? 512 : 256;
  const dim3 grid(n2 / T, batch);
  colfft_out3d_kernel<T><<<grid, threads, smem, stream>>>(re, im, ore, oim, logn1, n2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// re, im: (batch, n1, n2); ore, oim: (batch, n2/128, n1, 128). Returns the
// CUDA error code of the launch (0 on success).
extern "C" int phastft_colfft_out3d(const float* re, const float* im, float* ore,
                                    float* oim, int batch, int n1, int n2,
                                    void* stream) {
  if (batch < 1 || batch > 65535 || !phastft::is_pow2(n1) || n1 < 8 || n1 > 2048 ||
      !phastft::is_pow2(n2) || n2 < 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n1 >= 2048) return launch<8>(re, im, ore, oim, batch, n1, n2, s);
  return launch<16>(re, im, ore, oim, batch, n1, n2, s);
}
