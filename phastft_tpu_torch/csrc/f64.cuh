// Complex double arithmetic and in-place radix-4 DIF FFTs over complex
// double sequences held in shared memory, for the native f64 engine's column
// kernel (col64.cu) and leaf kernel (leaf64.cu). The schedule is dd.cuh's,
// in plain double arithmetic on the FP64 units.
//
// A point is one double2 (re, im) in shared memory: 16 bytes, so a warp's
// access is served a quarter-warp (8 lanes, 128 bytes) at a time, and it is
// free of bank conflicts when the 8 lanes of each quarter touch 8 different
// 16-byte slots modulo 8. Slots are padded with one after every 8 (`pad2`).
// Worked out for the two access patterns of the DIF trips below:
// - sequences along the contiguous axis (`qfast`, at least 8 of them): the
//   8 lanes of a quarter take 8 neighbouring sequences, an aligned run of 8
//   slots that the padding shifts as a whole: no conflict;
// - contiguous sequences (rows), neighbouring lanes on neighbouring groups:
//   a trip of S stages at span L has R = L / 2^S. For R >= 8 the lanes read
//   a contiguous run; for R = 1 the lanes read slots 2^S apart, which the
//   padding spreads over 8 banks (4t + t/2, 8t + t); at R = 2 (S = 3) slots
//   16 u + r fall on 8 banks. The schedule of `dif4_fft` picks S so that no
//   trip has R = 4 (it takes the last four stages as 3 + 1): every trip of a
//   row DFT is conflict-free.
// The twiddle table is padded the same way; its reads are broadcasts in the
// `qfast` trips and up to 2-way conflicted in the row trips.
#pragma once

#include <cuda_runtime.h>

#include "fft_smem.cuh"

namespace phastft {
namespace f64k {

using cd = double2;

// Shared-memory slot of point w: one padding slot after every 8.
__host__ __device__ constexpr int pad2(int w) { return w + (w >> 3); }

__device__ __forceinline__ cd cadd(cd a, cd b) { return make_double2(a.x + b.x, a.y + b.y); }

__device__ __forceinline__ cd csub(cd a, cd b) { return make_double2(a.x - b.x, a.y - b.y); }

// a * w, two fused multiply-adds per component.
__device__ __forceinline__ cd cmul(cd a, cd w) {
  return make_double2(fma(a.x, w.x, -a.y * w.y), fma(a.x, w.y, a.y * w.x));
}

__device__ __forceinline__ cd mul_neg_i(cd a) { return make_double2(a.y, -a.x); }

// tw[pad2(k)] = W_m^k for k < m/2, from the wrapper's table of m/2 (re, im)
// pairs (exact f64 angles).
__device__ __forceinline__ void load_twiddles(cd* tw, int m, const cd* t) {
  for (int k = threadIdx.x; k < m / 2; k += blockDim.x) tw[pad2(k)] = __ldg(t + k);
}

// W_N^k for 0 <= k < N, N = 2^logN, from the table of k < N/2:
// W_N^(k + N/2) = -W_N^k, exact.
__device__ __forceinline__ cd twiddle(const cd* tw, int k, int logN) {
  const int h = 1 << (logN - 1);
  const cd w = tw[pad2(k & (h - 1))];
  return (k & h) ? make_double2(-w.x, -w.y) : w;
}

// A radix-4 DIF butterfly, two radix-2 stages with the outputs in their
// bit-reversed places (dd.cuh's): on x0..x3 at r, r + Q, r + 2Q, r + 3Q of a
// span L = 4Q, a = x0 + x2, b = x1 + x3, c = x0 - x2, d = -i(x1 - x3), out
// a + b, (a - b) W_L^(2r), (c + d) W_L^r, (c - d) W_L^(3r). k: the index of
// W_L^r in the length-2^logW table; trivial: r = 0.
__device__ __forceinline__ void radix4(cd& x0, cd& x1, cd& x2, cd& x3, int k, int logW,
                                       const cd* tw, bool trivial) {
  const cd a = cadd(x0, x2), b = cadd(x1, x3);
  const cd c = csub(x0, x2), d = mul_neg_i(csub(x1, x3));
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

__device__ __forceinline__ void radix2(cd& x0, cd& x1, int k, int logW, const cd* tw,
                                       bool trivial) {
  const cd a = x0, b = x1;
  x0 = cadd(a, b);
  x1 = trivial ? csub(a, b) : cmul(csub(a, b), twiddle(tw, k, logW));
}

// S radix-2 DIF stages on one group in registers, indexed as
// phastft::dif_group's (fft_smem.cuh): element j of the group sits at
// position g*L + r + j*R of its sequence, R = 2^logR, L = 2^logL = R * 2^S;
// taken as radix-4 butterflies and, for an odd S, a last radix-2 stage. tw
// is the table of W_W^k, W = 2^logW >= the sequence length (W_W^(k W/N) is
// W_N^k exactly).
template <int S>
__device__ __forceinline__ void dif4_group(cd (&x)[1 << S], int r, int logR, int logW,
                                           int logL, const cd* tw) {
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

// One trip of S stages over 2^logM sequences of length 2^logN; element i of
// sequence q sits at slot pad2(q*qs + i*is), and `qfast` puts neighbouring
// threads on neighbouring sequences. With `last` (the trip that ends the
// transform, logL == S), each output is then replaced in registers by
// fold(x, k, q): k the bit reverse of its position (the index of the DFT
// output it holds), q its sequence.
template <int S, class Fold>
__device__ __forceinline__ void dif4_pass(cd* s, int logN, int logL, int logM, int qs,
                                          int is, bool qfast, const cd* tw, int logW,
                                          const Fold& fold, bool last) {
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
    cd x[1 << S];
    int a[1 << S];
#pragma unroll
    for (int j = 0; j < (1 << S); ++j) {
      a[j] = pad2(q * qs + (base + (j << logR)) * is);
      x[j] = s[a[j]];
    }
    dif4_group<S>(x, r, logR, logW, logL, tw);
    if (last) {
#pragma unroll
      for (int j = 0; j < (1 << S); ++j) x[j] = fold(x[j], bitrev(base + j, logN), q);
    }
#pragma unroll
    for (int j = 0; j < (1 << S); ++j) s[a[j]] = x[j];
  }
}

// The trip size at span 2^logL: radix-4 trips, the last four stages as a
// radix-8 and a radix-2 (no trip with R = 4, see the padding above), a last
// three as one radix-8.
__device__ __forceinline__ int trip_stages(int logL) {
  return logL == 3 || logL == 4 ? 3 : logL == 1 ? 1 : 2;
}

// The stages from span 2^logL down of an in-place DIF FFT of every sequence
// (logL = logN: the whole FFT). With `folds`, `fold` is applied in the last
// trip (dif4_pass). The caller synchronises before; this function
// synchronises after every trip.
template <class Fold>
__device__ __forceinline__ void dif4_fft(cd* s, int logN, int logL, int logM, int qs, int is,
                                         bool qfast, const cd* tw, int logW, const Fold& fold,
                                         bool folds) {
  while (logL > 0) {
    const int S = trip_stages(logL);
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

// The identity fold, for a trip sequence that folds nothing.
struct NoFold {
  __device__ __forceinline__ cd operator()(cd v, int, int) const { return v; }
};

}  // namespace f64k
}  // namespace phastft
