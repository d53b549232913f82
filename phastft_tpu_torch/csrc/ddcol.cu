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
// Bound: near the balance point. A pass moves 32 B per complex element; the
// DFT costs 47 flops per element per radix-2 stage and the correction 100
// (dd.cuh), so n1 = 256 is 476 flops per element against the card's ~20
// flops per byte: bytes and operations are within a factor of two of each
// other at every depth, and most dd operations are adds, which run at half
// the fused-multiply-add rate.
//
// Design:
// - A block owns T neighbouring columns of one entry as four planes in
//   shared memory, 4 K points (8 K from n1 = 1024, so that a row segment
//   stays 16 B wide at n1 = 2048), and runs the whole size-n1 DFT there:
//   device memory is touched once each way. When a whole entry is smaller
//   than the slab (the split leaf's passes: n1 * n2 of 256..64 K points), a
//   block owns R entries, laid out (i1, r, c), so one radix pass serves all
//   of them; the last block masks its missing entries.
// - Step twiddles W_n1^k are dd pairs from a table the wrapper builds on the
//   host in f64; no trigonometry runs in the kernel.
// - The DIF leaves X[k1] at row bitrev(k1), which the store index undoes.
// - The batch is folded into gridDim.x and every device offset is 64-bit.
#include <cuda_runtime.h>

#include "dd.cuh"

using phastft::bitrev;
using phastft::pad;
using phastft::padded_words;
namespace ddk = phastft::ddk;

namespace {

constexpr int MAX_THREADS = 512;

template <bool CORR>
__global__ void __launch_bounds__(MAX_THREADS)
ddcol_kernel(ddk::ConstQuad x, const float* __restrict__ twt, ddk::ConstQuad t1,
             ddk::ConstQuad t2, ddk::Quad out, long long batch, int logn1, int n2,
             int logT, int logR, int logt) {
  extern __shared__ float4 smem4[];
  const int n1 = 1 << logn1;
  const int T = 1 << logT;
  const int logM = logT + logR;  // sequences per block: R entries x T columns
  const int M = 1 << logM;
  const int points = n1 << logM;
  const int words = padded_words(points);
  const ddk::Planes s = ddk::make_planes(reinterpret_cast<float*>(smem4), words);
  float4* tw = reinterpret_cast<float4*>(s.p[0] + 4 * words);

  // block -> (first entry b0, slab j); n2 / T slabs per entry, a power of two
  const unsigned nblk = static_cast<unsigned>(n2 >> logT);
  const int j = static_cast<int>(blockIdx.x & (nblk - 1));
  const long long b0 = static_cast<long long>(blockIdx.x >> (31 - __clz(nblk))) << logR;
  const long long n = static_cast<long long>(n1) * n2;
  const int col0 = j << logT;

  ddk::load_twiddles(tw, n1, twt);
  if (T >= 4) {
    for (int f = 4 * threadIdx.x; f < points; f += 4 * blockDim.x) {
      const int c = f & (T - 1), r = (f >> logT) & ((1 << logR) - 1), i1 = f >> logM;
      const int w = pad(f);
      const bool live = b0 + r < batch;
      const long long off = (b0 + r) * n + static_cast<long long>(i1) * n2 + col0 + c;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live) v = __ldg(reinterpret_cast<const float4*>(x.p[p] + off));
        *reinterpret_cast<float4*>(s.p[p] + w) = v;
      }
    }
  } else {
    for (int f = threadIdx.x; f < points; f += blockDim.x) {
      const int c = f & (T - 1), r = (f >> logT) & ((1 << logR) - 1), i1 = f >> logM;
      const int w = pad(f);
      const bool live = b0 + r < batch;
      const long long off = (b0 + r) * n + static_cast<long long>(i1) * n2 + col0 + c;
#pragma unroll
      for (int p = 0; p < 4; ++p) s.p[p][w] = live ? __ldg(x.p[p] + off) : 0.f;
    }
  }
  __syncthreads();

  // the (r, c) axis is the contiguous one: sequences are neighbours
  ddk::dif_fft(s, logn1, logM, 1, M, true, tw);

  const int t1cols = n2 >> logt;  // columns of T1
  for (int f = threadIdx.x; f < points; f += blockDim.x) {
    // shared row f >> logM holds k1 = bitrev(row): threads walk shared memory
    // in order and store T contiguous floats per row
    const int c = f & (T - 1), r = (f >> logT) & ((1 << logR) - 1);
    const int k1 = bitrev(f >> logM, logn1);
    if (b0 + r >= batch) continue;
    ddk::ddc v = ddk::load(s, pad(f));
    const int i2 = col0 + c;
    if (CORR) {
      const long long a1 = static_cast<long long>(k1) * t1cols + (i2 >> logt);
      const long long a2 = (static_cast<long long>(k1) << logt) + (i2 & ((1 << logt) - 1));
      const ddk::ddc w1{ddk::dd{__ldg(t1.p[0] + a1), __ldg(t1.p[1] + a1)},
                        ddk::dd{__ldg(t1.p[2] + a1), __ldg(t1.p[3] + a1)}};
      const ddk::ddc w2{ddk::dd{__ldg(t2.p[0] + a2), __ldg(t2.p[1] + a2)},
                        ddk::dd{__ldg(t2.p[2] + a2), __ldg(t2.p[3] + a2)}};
      v = ddk::cmul(ddk::cmul(v, w1), w2);
    }
    const long long o = (b0 + r) * n + static_cast<long long>(k1) * n2 + i2;
    out.p[0][o] = v.re.hi;
    out.p[1][o] = v.re.lo;
    out.p[2][o] = v.im.hi;
    out.p[3][o] = v.im.lo;
  }
}

template <bool CORR>
int launch(ddk::ConstQuad x, const float* twt, ddk::ConstQuad t1, ddk::ConstQuad t2,
           ddk::Quad out, long long batch, int n1, int n2, int logt,
           cudaStream_t stream) {
  const int logn1 = phastft::ilog2(n1);
  const int points = n1 >= 1024 ? 8192 : 4096;
  int t = points / n1;
  if (t > n2) t = n2;
  int r = 1;  // entries per block, when a whole entry is below the slab
  if (t == n2)
    while (n1 * t * r < points && r < batch) r *= 2;
  const int logr = phastft::ilog2(r);
  const long long per_entry = n2 / t;
  const long long blocks = ((batch + r - 1) >> logr) * per_entry;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      4 * sizeof(float) * padded_words(n1 * t * r) + sizeof(float4) * (n1 / 2 + 1);
  cudaError_t err =
      cudaFuncSetAttribute(ddcol_kernel<CORR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = n1 * t * r >= 8192 ? 512 : 256;
  ddcol_kernel<CORR><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      x, twt, t1, t2, out, batch, logn1, n2, phastft::ilog2(t), logr, logt);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(long long batch, int n1, int n2) {
  return batch >= 1 && phastft::is_pow2(n1) && n1 >= 2 && n1 <= 2048 &&
         phastft::is_pow2(n2) && n2 >= 2;
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
// arrays; n1 = 2..2048 and n2 >= 2, powers of two. twt: four planes of n1/2
// floats, W_n1^k. t1*: (n1, n2 / t) and t2*: (n1, t) with t = min(256, n2),
// the factored correction. Returns the CUDA error code of the launch (0 on
// success).
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

// a, b: n floats; s + e = a + b and p + pe = a * b, each exactly.
extern "C" int phastft_dd_exact(const float* a, const float* b, float* s, float* e,
                                float* p, float* pe, long long n, void* stream) {
  if (n < 1 || n > 0x7fffffffLL * 256) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  dd_exact_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(a, b, s, e, p, pe, n);
  return static_cast<int>(cudaGetLastError());
}
