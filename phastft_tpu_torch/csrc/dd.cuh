// Double-float (dd) device arithmetic and in-place radix-4 DIF FFTs over dd
// complex sequences held in shared memory, shared by the dd column kernel
// (ddcol.cu) and the dd leaf kernel (ddleaf.cu).
//
// A dd value is an unevaluated sum hi + lo of two floats (~48 significand
// bits). A dd complex array is four float planes: re_hi, re_lo, im_hi,
// im_lo. Every operation of an error-free transform is written with the
// round-to-nearest intrinsics (__fadd_rn, __fsub_rn, __fmul_rn, __fmaf_rn),
// which the compiler never contracts or reorders, so TwoSum and TwoProd are
// exact whatever the build's --fmad setting. TwoProd takes its error term
// from one fused multiply-add, fma(a, b, -a*b): the same exact term that
// Dekker's split product (17 operations) yields in the plain version.
//
// Every sum and product renormalises its result, so values in shared memory
// are always normalised pairs.
#pragma once

#include <cuda_runtime.h>

#include "fft_smem.cuh"

namespace phastft {
namespace ddk {

struct dd {
  float hi, lo;
};

struct ddc {
  dd re, im;
};

// Four device pointers, one per plane (re_hi, re_lo, im_hi, im_lo).
struct Quad {
  float* p[4];
};

struct ConstQuad {
  const float* p[4];
};

// s + e == a + b exactly (Knuth).
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// p + e == a * b exactly.
__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  p = __fmul_rn(a, b);
  e = __fmaf_rn(a, b, -p);
}

__device__ __forceinline__ dd renorm(float s, float e) {
  dd r;
  r.hi = __fadd_rn(s, e);
  r.lo = __fsub_rn(e, __fsub_rn(r.hi, s));
  return r;
}

__device__ __forceinline__ dd neg(dd a) { return dd{-a.hi, -a.lo}; }

// 11 flops: TwoSum of the his, the los folded in, one renormalisation. The
// operands need not be normalised.
__device__ __forceinline__ dd add(dd a, dd b) {
  float s, e;
  two_sum(a.hi, b.hi, s, e);
  e = __fadd_rn(e, __fadd_rn(a.lo, b.lo));
  return renorm(s, e);
}

__device__ __forceinline__ dd sub(dd a, dd b) { return add(a, neg(b)); }

// 7 flops: the unnormalised product (p, e); only a.lo * b.lo is dropped.
__device__ __forceinline__ dd mul_lazy(dd a, dd b) {
  float p, e;
  two_prod(a.hi, b.hi, p, e);
  e = __fadd_rn(e, __fmaf_rn(a.hi, b.lo, __fmul_rn(a.lo, b.hi)));
  return dd{p, e};
}

// 50 flops: four lazy products, one renormalised sum per component.
__device__ __forceinline__ ddc cmul(ddc a, ddc w) {
  const dd t1 = mul_lazy(a.re, w.re);
  const dd t2 = mul_lazy(a.im, w.im);
  const dd t3 = mul_lazy(a.re, w.im);
  const dd t4 = mul_lazy(a.im, w.re);
  ddc r;
  r.re = sub(t1, t2);
  r.im = add(t3, t4);
  return r;
}

__device__ __forceinline__ ddc cadd(ddc a, ddc b) {
  return ddc{add(a.re, b.re), add(a.im, b.im)};
}

__device__ __forceinline__ ddc csub(ddc a, ddc b) {
  return ddc{sub(a.re, b.re), sub(a.im, b.im)};
}

__device__ __forceinline__ ddc from_float4(float4 v) {
  return ddc{dd{v.x, v.y}, dd{v.z, v.w}};
}

// The four planes of a block's slab in shared memory, `words` floats each.
struct Planes {
  float* p[4];
};

__device__ __forceinline__ Planes make_planes(float* base, int words) {
  Planes s;
#pragma unroll
  for (int c = 0; c < 4; ++c) s.p[c] = base + c * words;
  return s;
}

__device__ __forceinline__ ddc load(const Planes& s, int w) {
  return ddc{dd{s.p[0][w], s.p[1][w]}, dd{s.p[2][w], s.p[3][w]}};
}

__device__ __forceinline__ void store(const Planes& s, int w, ddc v) {
  s.p[0][w] = v.re.hi;
  s.p[1][w] = v.re.lo;
  s.p[2][w] = v.im.hi;
  s.p[3][w] = v.im.lo;
}

// tw[k] = W_m^k as (re_hi, re_lo, im_hi, im_lo) for k < m/2, from the
// wrapper's table `t` of four planes of m/2 floats (exact f64 angles, split
// on the host).
__device__ __forceinline__ void load_twiddles(float4* tw, int m, const float* t) {
  const int h = m / 2;
  for (int k = threadIdx.x; k < h; k += blockDim.x)
    tw[k] = make_float4(__ldg(t + k), __ldg(t + h + k), __ldg(t + 2 * h + k),
                        __ldg(t + 3 * h + k));
}

// ---- radix-4 passes (ddleaf.cu, ddcol.cu) ----------------------------------
//
// A radix-4 DIF butterfly equals two radix-2 DIF stages with the outputs in
// their bit-reversed places: on x0..x3 at r, r + Q, r + 2Q, r + 3Q of a span
// L = 4Q, a = x0 + x2, b = x1 + x3, c = x0 - x2, d = -i(x1 - x3), out
// a + b, (a - b) W_L^(2r), (c + d) W_L^r, (c - d) W_L^(3r). A product by -i
// is a swap and a sign (exact); a butterfly of span 4 has r = 0 and drops
// its products. Per point: 8 dd complex sums and 3 products over 4 points
// (75.5 FP32 instructions, 81.5 flops), 44 at span 4, where two radix-2
// stages with a product each take 2 * 43 (94 flops).
//
// The twiddles come from one table of W_W^k, k < W/2, W = 2^logW >= the
// sequence length N: a kernel whose factors share a table (ddcol.cu's
// P x Q split reads W_P, W_Q and W_n1 from the W_n1 table) passes its own
// logW; W_W^(k W/N) is W_N^k exactly (the table's f64 angles differ by a
// power of two).

__device__ __forceinline__ ddc mul_neg_i(ddc a) { return ddc{a.im, neg(a.re)}; }

// W_N^k for 0 <= k < N, N = 2^logN, from the table of k < N/2:
// W_N^(k + N/2) = -W_N^k, exact.
__device__ __forceinline__ ddc twiddle(const float4* tw, int k, int logN) {
  const int h = 1 << (logN - 1);
  const ddc w = from_float4(tw[k & (h - 1)]);
  return (k & h) ? ddc{neg(w.re), neg(w.im)} : w;
}

__device__ __forceinline__ ddc table_at(const ConstQuad& t, int i) {
  return ddc{dd{__ldg(t.p[0] + i), __ldg(t.p[1] + i)},
             dd{__ldg(t.p[2] + i), __ldg(t.p[3] + i)}};
}

// k: the index of W_L^r in the length-2^logW table; trivial: r = 0.
__device__ __forceinline__ void radix4(ddc& x0, ddc& x1, ddc& x2, ddc& x3, int k,
                                       int logW, const float4* tw, bool trivial) {
  const ddc a = cadd(x0, x2), b = cadd(x1, x3);
  const ddc c = csub(x0, x2), d = mul_neg_i(csub(x1, x3));
  x0 = cadd(a, b);
  if (trivial) {
    x1 = csub(a, b);
    x2 = cadd(c, d);
    x3 = csub(c, d);
  } else {
    x1 = cmul(csub(a, b), twiddle(tw, 2 * k, logW));
    x2 = cmul(cadd(c, d), twiddle(tw, k, logW));
    x3 = cmul(csub(c, d), twiddle(tw, 3 * k, logW));
  }
}

__device__ __forceinline__ void radix2(ddc& x0, ddc& x1, int k, int logW,
                                       const float4* tw, bool trivial) {
  const ddc a = x0, b = x1;
  x0 = cadd(a, b);
  x1 = trivial ? csub(a, b) : cmul(csub(a, b), twiddle(tw, k, logW));
}

// S radix-2 DIF stages on one group in registers, indexed as
// phastft::dif_group's (fft_smem.cuh), taken as radix-4 butterflies and,
// for an odd S, a last radix-2 stage; tw is the table of W_W^k, W = 2^logW.
template <int S>
__device__ __forceinline__ void dif4_group(ddc (&x)[1 << S], int r, int logR, int logW,
                                           int logL, const float4* tw) {
#pragma unroll
  for (int t = 0; t + 2 <= S; t += 2) {
    const int h = 1 << (S - 2 - t);
    const int shift = logW - logL + t;
    const bool trivial = logL - t == 2;
#pragma unroll
    for (int j = 0; j < (1 << S); ++j) {
      if (j & (3 * h)) continue;
      const int q = r + ((j & (h - 1)) << logR);
      radix4(x[j], x[j + h], x[j + 2 * h], x[j + 3 * h], q << shift, logW, tw, trivial);
    }
  }
  if (S & 1) {
    const int shift = logW - logL + S - 1;
    const bool trivial = logL - (S - 1) == 1;
#pragma unroll
    for (int j = 0; j < (1 << S); j += 2) radix2(x[j], x[j + 1], r << shift, logW, tw, trivial);
  }
}

// One pass of S stages over 2^logM sequences of length 2^logN; element i of
// sequence q sits at pad(q*qs + i*is) of every plane, and `qfast` puts
// neighbouring threads on neighbouring sequences. With `last` (the pass
// that ends the transform, logL == S), each output is then replaced in
// registers by fold(x, k, q): k the bit reverse of its position (the index
// of the DFT output it holds), q its sequence.
template <int S, class Fold>
__device__ __forceinline__ void dif4_pass(const Planes& s, int logN, int logL, int logM,
                                          int qs, int is, bool qfast, const float4* tw,
                                          int logW, const Fold& fold, bool last) {
  const int logR = logL - S;
  const int logG = logN - S;
  const int items = 1 << (logG + logM);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    int q, grp;
    if (qfast) {
      q = it & ((1 << logM) - 1);
      grp = it >> logM;
    } else {
      grp = it & ((1 << logG) - 1);
      q = it >> logG;
    }
    const int r = grp & ((1 << logR) - 1);
    const int base = ((grp >> logR) << logL) + r;
    ddc x[1 << S];
    int a[1 << S];
#pragma unroll
    for (int j = 0; j < (1 << S); ++j) {
      a[j] = pad(q * qs + (base + (j << logR)) * is);
      x[j] = load(s, a[j]);
    }
    dif4_group<S>(x, r, logR, logW, logL, tw);
    if (last) {
#pragma unroll
      for (int j = 0; j < (1 << S); ++j) x[j] = fold(x[j], bitrev(base + j, logN), q);
    }
#pragma unroll
    for (int j = 0; j < (1 << S); ++j) store(s, a[j], x[j]);
  }
}

// The stages from span 2^logL down of an in-place DIF FFT of every
// sequence (logL = logN: the whole FFT): radix-4 trips, the last one of an
// odd count a radix-8 (radix-4 then radix-2) in registers. With `folds`,
// `fold` is applied in the last trip (dif4_pass). The caller synchronises
// before; this function synchronises after every pass.
template <class Fold>
__device__ __forceinline__ void dif4_fft(const Planes& s, int logN, int logL, int logM,
                                         int qs, int is, bool qfast, const float4* tw,
                                         int logW, const Fold& fold, bool folds) {
  while (logL > 0) {
    const int S = logL == 3 ? 3 : logL == 1 ? 1 : 2;
    const bool last = folds && logL == S;
    if (S == 3)
      dif4_pass<3>(s, logN, logL, logM, qs, is, qfast, tw, logW, fold, last);
    else if (S == 1)
      dif4_pass<1>(s, logN, logL, logM, qs, is, qfast, tw, logW, fold, last);
    else
      dif4_pass<2>(s, logN, logL, logM, qs, is, qfast, tw, logW, fold, last);
    logL -= S;
    __syncthreads();
  }
}

}  // namespace ddk
}  // namespace phastft
