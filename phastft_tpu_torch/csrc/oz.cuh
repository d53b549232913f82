// Ozaki bf16-slice contractions, shared by the column kernel (ozcol.cu) and
// the row kernel (ozleaft.cu) of the "df64-oz" engine.
//
// Counterpart of phastft_tpu/ops/ozaki.py (and of the port's plain
// ops/ozaki.py). A dd operand is cut into NSLICES 8-bit fixed-point slices
// on grids 2^-(7+8j) of a power-of-two scale; every slice is an integer
// |s| <= 128, exact in bf16. A product of two slice arrays over a depth of
// at most 512 is then a sum of integers below 2^24, which the tensor cores
// (bf16 in, f32 accumulate) return exactly, whatever the order of the sums.
// So the kernels and the plain versions compute the same tier integers, and
// every tier may be accumulated in one f32 accumulator over all its slice
// pairs. The Karatsuba fold of the tiers into a dd value, and the dd
// products and sums around the contractions, follow the plain versions
// operation for operation, with the round-to-nearest intrinsics of dd.cuh,
// which are never contracted; slices round with rintf (half to even, as
// torch.round and jnp.round). A kernel and its plain version then agree bit
// for bit.
//
// The product is mma.sync.m16n8k16 (bf16, f32 accumulate). Fragment layout
// (PTX ISA), g = lane / 4, t = lane % 4: A (16 x 16, row-major) rows g and
// g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9; B (16 x 8) rows (the depth)
// 2t, 2t + 1 and 2t + 8, 2t + 9 of column g; D rows g and g + 8, columns 2t,
// 2t + 1. Slices are stored as the upper 16 bits of their float (exact for
// integers of 8 significant bits), two per 32-bit word along the depth.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "dd.cuh"

namespace phastft {
namespace oz {

constexpr int NSLICES = 5;
constexpr int MAXTIER = 4;
// Operands of the Karatsuba product: Re, Im and Re + Im.
constexpr int NOPS = 3;
constexpr int NSETS = NOPS * NSLICES;

// Slices of a table, in the flat order of ozcol/ozleaft_tables_host: the
// NSLICES slices of Fr, then of Fi, then of Fr + Fi.
struct SliceSet {
  const uint16_t* p[NSETS];
};

__device__ __forceinline__ uint16_t to_bf16(float integer) {
  return static_cast<uint16_t>(__float_as_uint(integer) >> 16);
}

// oz_sigma: sigma > maxabs >= 0 and inv = 1 / sigma, exact powers of two,
// from the exponent bits.
__device__ __forceinline__ void sigma_of(float maxabs, float& sigma, float& inv) {
  int e = (__float_as_int(maxabs) >> 23) & 0xFF;
  e = min(max(e, 1), 252) + 1;
  sigma = __int_as_float(e << 23);
  inv = __int_as_float((254 - e) << 23);
}

// oz_slice_data: the slices of the dd value (vh, vl) scaled by inv.
__device__ __forceinline__ void slice_data(float vh, float vl, float inv,
                                           float (&s)[NSLICES]) {
  constexpr float K[NSLICES] = {0x1p7f, 0x1p15f, 0x1p23f, 0x1p31f, 0x1p39f};
  constexpr float IK[NSLICES] = {0x1p-7f, 0x1p-15f, 0x1p-23f, 0x1p-31f, 0x1p-39f};
  float r = __fmul_rn(vh, inv);
#pragma unroll
  for (int j = 0; j < NSLICES; ++j) {
    const float sj = rintf(__fmul_rn(r, K[j]));
    s[j] = sj;
    r = __fsub_rn(r, __fmul_rn(sj, IK[j]));
    if (j == 2) r = __fadd_rn(r, __fmul_rn(vl, inv));
  }
}

// oz_slice_complex for one element: the slices of re, im and of their
// exact dd sum (against inv / 2), written as bf16 to dst[set * stride].
__device__ __forceinline__ void slice_complex(const ddk::ddc& x, float inv, uint16_t* dst,
                                              int stride) {
  float s[NSLICES];
  slice_data(x.re.hi, x.re.lo, inv, s);
#pragma unroll
  for (int j = 0; j < NSLICES; ++j) dst[j * stride] = to_bf16(s[j]);
  slice_data(x.im.hi, x.im.lo, inv, s);
#pragma unroll
  for (int j = 0; j < NSLICES; ++j) dst[(NSLICES + j) * stride] = to_bf16(s[j]);
  const float sh = __fadd_rn(x.re.hi, x.im.hi);
  const float b = __fsub_rn(sh, x.re.hi);
  const float sl = __fadd_rn(__fadd_rn(__fsub_rn(x.re.hi, __fsub_rn(sh, b)),
                                       __fsub_rn(x.im.hi, b)),
                             __fadd_rn(x.re.lo, x.im.lo));
  slice_data(sh, sl, __fmul_rn(inv, 0.5f), s);
#pragma unroll
  for (int j = 0; j < NSLICES; ++j) dst[(2 * NSLICES + j) * stride] = to_bf16(s[j]);
}

// oz_contract_sliced's fold of one output: a, b, c are its tier sums of
// Fr x re, Fi x im and (Fr + Fi) x (re + im); sigma its column scale.
__device__ __forceinline__ ddk::ddc fold(const float (&a)[MAXTIER + 1],
                                         const float (&b)[MAXTIER + 1],
                                         const float (&c)[MAXTIER + 1], float sigma) {
  constexpr float TK[MAXTIER + 1] = {1.0f, 0x1p-8f, 0x1p-16f, 0x1p-24f, 0x1p-32f};
  const float scale = __fmul_rn(sigma, 0x1p-14f);
  float reh = 0.f, rel = 0.f, imh = 0.f, iml = 0.f, rrest = 0.f, irest = 0.f;
#pragma unroll
  for (int s = 0; s <= MAXTIER; ++s) {
    const float k = __fmul_rn(scale, TK[s]);
    const float re_v = __fmul_rn(__fsub_rn(a[s], b[s]), k);
    const float im_v =
        __fmul_rn(__fsub_rn(__fsub_rn(__fmul_rn(4.0f, c[s]), a[s]), b[s]), k);
    if (s == 0) {
      reh = re_v;
      imh = im_v;
    } else if (s == 1) {
      float t;
      ddk::two_sum(reh, re_v, t, rel);
      reh = t;
      ddk::two_sum(imh, im_v, t, iml);
      imh = t;
    } else if (s == 2) {
      rrest = re_v;
      irest = im_v;
    } else {
      rrest = __fadd_rn(rrest, re_v);
      irest = __fadd_rn(irest, im_v);
    }
  }
  return ddk::ddc{ddk::renorm(reh, __fadd_rn(rel, rrest)),
                  ddk::renorm(imh, __fadd_rn(iml, irest))};
}

// The plain versions' dd arithmetic (ops/df64.py: dd_cmul with Veltkamp
// splits, and the lazy sums of _dft_regs_dd), operation for operation, so
// that a kernel's dd values equal its plain version's bit for bit. The
// slicing rounds at its last slice, and there a difference of one unit in
// the last place of its input moves the contraction by ~1e-13 of its scale.
__device__ __forceinline__ void veltkamp(float a, float& hi, float& lo) {
  const float c = __fmul_rn(a, 4097.0f);
  hi = __fsub_rn(c, __fsub_rn(c, a));
  lo = __fsub_rn(a, hi);
}

// _prod_presplit: the lazy product of a and b given their hi splits.
__device__ __forceinline__ ddk::dd prod_presplit(ddk::dd a, float ah, float al, ddk::dd b,
                                                 float bh, float bl) {
  const float p = __fmul_rn(a.hi, b.hi);
  const float e = __fadd_rn(
      __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ah, bh), p), __fmul_rn(ah, bl)), __fmul_rn(al, bh)),
      __fmul_rn(al, bl));
  return ddk::dd{p, __fadd_rn(e, __fadd_rn(__fmul_rn(a.hi, b.lo), __fmul_rn(a.lo, b.hi)))};
}

__device__ __forceinline__ ddk::dd add_lazy(ddk::dd a, ddk::dd b) {
  float s, e;
  ddk::two_sum(a.hi, b.hi, s, e);
  return ddk::dd{s, __fadd_rn(e, __fadd_rn(a.lo, b.lo))};
}

__device__ __forceinline__ ddk::dd sub_lazy(ddk::dd a, ddk::dd b) {
  return add_lazy(a, ddk::neg(b));
}

__device__ __forceinline__ ddk::ddc cadd_lazy(const ddk::ddc& a, const ddk::ddc& b) {
  return ddk::ddc{add_lazy(a.re, b.re), add_lazy(a.im, b.im)};
}

__device__ __forceinline__ ddk::ddc csub_lazy(const ddk::ddc& a, const ddk::ddc& b) {
  return ddk::ddc{sub_lazy(a.re, b.re), sub_lazy(a.im, b.im)};
}

// dd_cmul: a * b, one renormalisation per component at the end.
__device__ __forceinline__ ddk::ddc cmul(const ddk::ddc& a, const ddk::ddc& b) {
  float arh, arl, aih, ail, brh, brl, bih, bil;
  veltkamp(a.re.hi, arh, arl);
  veltkamp(a.im.hi, aih, ail);
  veltkamp(b.re.hi, brh, brl);
  veltkamp(b.im.hi, bih, bil);
  const ddk::dd t1 = prod_presplit(a.re, arh, arl, b.re, brh, brl);
  const ddk::dd t2 = prod_presplit(a.im, aih, ail, b.im, bih, bil);
  const ddk::dd t3 = prod_presplit(a.re, arh, arl, b.im, bih, bil);
  const ddk::dd t4 = prod_presplit(a.im, aih, ail, b.re, brh, brl);
  const ddk::dd re = sub_lazy(t1, t2), im = add_lazy(t3, t4);
  return ddk::ddc{ddk::renorm(re.hi, re.lo), ddk::renorm(im.hi, im.lo)};
}

// D += A x B on the tensor cores, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p, bool global) {
  return global ? __ldg(reinterpret_cast<const unsigned int*>(p))
                : *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of rows r0.., depth k0.. of a row-major bf16 matrix (leading
// dimension ld) in device memory (GLOBAL) or shared memory; depth past
// `depth` reads as zero (a depth of 8 fills half a step).
template <bool GLOBAL>
__device__ __forceinline__ void load_a(uint32_t (&f)[4], const uint16_t* m, int ld, int r0,
                                       int k0, int depth) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const uint16_t* p = m + static_cast<long long>(r0 + g) * ld + k0 + 2 * t;
  const bool upper = k0 + 8 < depth;
  f[0] = ld32(p, GLOBAL);
  f[1] = ld32(p + 8 * ld, GLOBAL);
  f[2] = upper ? ld32(p + 8, GLOBAL) : 0u;
  f[3] = upper ? ld32(p + 8 * ld + 8, GLOBAL) : 0u;
}

// B fragment of columns n0.., depth k0.., the matrix stored column by
// column (column n at m + n * ld, the depth contiguous).
template <bool GLOBAL>
__device__ __forceinline__ void load_b(uint32_t (&f)[2], const uint16_t* m, int ld, int n0,
                                       int k0, int depth) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const uint16_t* p = m + static_cast<long long>(n0 + g) * ld + k0 + 2 * t;
  f[0] = ld32(p, GLOBAL);
  f[1] = k0 + 8 < depth ? ld32(p + 8, GLOBAL) : 0u;
}

// Tier sums of one 16 x 8 output tile: acc[op][s][e], e the D fragment's
// four elements.
struct Tiers {
  float v[NOPS][MAXTIER + 1][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int op = 0; op < NOPS; ++op)
#pragma unroll
      for (int s = 0; s <= MAXTIER; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[op][s][e] = 0.f;
  }

  // The fold of element e of the tile.
  __device__ __forceinline__ ddk::ddc fold_at(int e, float sigma) const {
    float a[MAXTIER + 1], b[MAXTIER + 1], c[MAXTIER + 1];
#pragma unroll
    for (int s = 0; s <= MAXTIER; ++s) {
      a[s] = v[0][s][e];
      b[s] = v[1][s][e];
      c[s] = v[2][s][e];
    }
    return fold(a, b, c, sigma);
  }
};

// One depth step of the 15 slice-pair products (i + j <= MAXTIER) of the
// three operands, slice i of the A side against slice j of the B side.
// `bf[op][j]` holds the B fragments; `fetch_a(op, i, frag)` fetches A's.
template <typename LoadA>
__device__ __forceinline__ void tier_step(Tiers& acc, const uint32_t (&bf)[NOPS][NSLICES][2],
                                          LoadA fetch_a) {
#pragma unroll
  for (int i = 0; i < NSLICES; ++i) {
#pragma unroll
    for (int op = 0; op < NOPS; ++op) {
      uint32_t af[4];
      fetch_a(op, i, af);
#pragma unroll
      for (int j = 0; i + j <= MAXTIER && j < NSLICES; ++j) mma(acc.v[op][i + j], af, bf[op][j]);
    }
  }
}

}  // namespace oz
}  // namespace phastft
