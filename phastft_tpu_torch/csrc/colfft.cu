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
// Design against that bound:
// - A block owns T neighbouring columns. The out3d mode takes T = 16 (8 at
//   n1 = 2048 so the (n1, T) slab fits the 227 KB of shared memory; the TPU
//   kernel's (n1, 512) slab does not). The classic mode runs shallow
//   columns (n1 = 32 at the outer level of 2^26), so it widens T as n1
//   shrinks to keep a slab of about 8 K points: rows of T floats are read
//   with float4 loads, neighbouring threads on neighbouring addresses, and
//   a row segment is T * 4 contiguous bytes.
// - The whole size-n1 DFT runs in shared memory, three radix-2 stages per
//   trip (fft_smem.cuh), so device memory is touched once each way.
// - The store needs no transpose: for fixed k1 the T columns land
//   contiguously in either layout (float4 stores).
// - The split twiddle is formed from the exact phase m = (k1*i2') mod N in
//   64-bit integers and sincospi(-2m/N) in double, rounded once to float:
//   an f32 angle k1*i2 would lose the phase past n = 2^24. The in-block
//   twiddles W_n1^k are formed the same way into shared memory.
// - The classic and nocorr modes take any n2 >= 4 (a shard's column block
//   can be narrower than the 16-column slab: the slab is then n2 wide).
// - The batch is folded into gridDim.x (up to 2^31 - 1 blocks) and every
//   device-memory offset is 64-bit: the inner level of a nested plan has a
//   batch of 32..512 per transform, and one transform of 2^30 points
//   already reaches offsets of 2^30.
#include <cuda_runtime.h>

#include "fft_smem.cuh"

using phastft::bitrev;
using phastft::pad;
using phastft::padded_words;

namespace {

enum Mode { CLASSIC = 0, OUT3D = 1, NOCORR = 2 };

// LOGT > 0 fixes log2 of the slab width when the kernel is compiled (the
// out3d mode's 16 and 8 columns: index arithmetic folds into constants);
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

  const int na = n2 >> 7;
#pragma unroll 2
  for (int e = threadIdx.x; e < n1 * V; e += blockDim.x) {
    const int k1 = e >> logv, v = e & (V - 1);
    const int w = pad(bitrev(k1, logn1) * T + 4 * v);
    const float4 a = *reinterpret_cast<const float4*>(sr + w);
    const float4 c = *reinterpret_cast<const float4*>(si + w);
    const float vr[4] = {a.x, a.y, a.z, a.w};
    const float vi[4] = {c.x, c.y, c.z, c.w};
    const int i2 = j * T + 4 * v;
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
    const long long o =
        MODE == OUT3D ? ((b * na + (i2 >> 7)) * n1 + k1) * 128 + (i2 & 127)
                      : b * n + static_cast<long long>(k1) * n2 + i2;
    *reinterpret_cast<float4*>(ore + o) = make_float4(outr[0], outr[1], outr[2], outr[3]);
    *reinterpret_cast<float4*>(oim + o) = make_float4(outi[0], outi[1], outi[2], outi[3]);
  }
}

// Columns per block. out3d: 16, or 8 at n1 = 2048. Classic and nocorr: a
// slab of about 8 K points, so 512 columns at n1 <= 16 down to 16 at
// n1 = 512 and 1024. Never more than n2.
int slab_columns(int n1, int n2, bool out3d) {
  int t = n1 >= 2048 ? 8 : 16;
  if (!out3d)
    while (t < 512 && n1 * t < 8192) t *= 2;
  return t < n2 ? t : n2;
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
  const int t = slab_columns(n1, n2, mode == OUT3D);
  if (mode == CLASSIC)
    return launch<CLASSIC, 0>(re, im, ore, oim, batch, n1, n2, t, n_total, col_base, s);
  if (mode == NOCORR)
    return launch<NOCORR, 0>(re, im, ore, oim, batch, n1, n2, t, n_total, col_base, s);
  if (t == 16) return launch<OUT3D, 4>(re, im, ore, oim, batch, n1, n2, t, n_total, col_base, s);
  return launch<OUT3D, 3>(re, im, ore, oim, batch, n1, n2, t, n_total, col_base, s);
}
