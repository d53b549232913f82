// In-place radix-2 DIF FFTs over sequences held in shared memory, shared by
// the column kernel (colfft.cu), the row kernel (leaft.cu) and the leaf
// kernels (leaf.cu, leaf3.cu; leaf.cu and leaft.cu through dif_fft16, up to
// four stages a trip with the correction folded into the last).
//
// A pass retires up to three radix-2 stages in registers: each thread loads
// a group of 2^S elements, runs the S stages on them and stores them back,
// so a length-2^11 transform makes four trips through shared memory instead
// of eleven. Natural order goes in; X[k] comes out at position bitrev(k),
// which the kernels undo for free in their store index.
//
// Shared memory is padded with 4 words after every 32 (`pad`). Worked out
// over every pass of both kernels' shapes, this keeps the strided butterfly
// accesses at most 2-way bank-conflicted, and keeps every 4-aligned word
// 16-byte aligned for float4 access.
#pragma once

#include <cuda_runtime.h>

namespace phastft {

__host__ __device__ constexpr int padded_words(int words) {
  return words + (words >> 5) * 4;
}

__device__ __forceinline__ int pad(int w) { return w + ((w >> 5) << 2); }

// v times s, lane by lane: a store's output scale (1, or 1/N where the
// kernel ends an inverse: the same bits as a separate multiply after it).
__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

__device__ __forceinline__ int bitrev(int k, int logn) {
  return logn ? static_cast<int>(__brev(static_cast<unsigned>(k)) >> (32 - logn))
              : 0;
}

// S radix-2 DIF stages on one group held in registers. Element j of the
// group sits at position g*L + r + j*R of its sequence, R = 2^logR,
// L = 2^logL = R * 2^S. Stage t works at span L >> t; its pair is
// (j, j + 2^(S-1-t)) and its twiddle W_{L>>t}^q = tw[q << (logN - logL + t)],
// tw[k] = W_N^k for k < N/2.
template <int S>
__device__ __forceinline__ void dif_group(float (&xr)[1 << S], float (&xi)[1 << S],
                                          int r, int logR, int logN, int logL,
                                          const float2* tw) {
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const int half = 1 << (S - 1 - t);
    const int shift = logN - logL + t;
#pragma unroll
    for (int j = 0; j < (1 << S); ++j) {
      if (j & half) continue;
      const int q = r + ((j & (2 * half - 1)) << logR);
      const float2 w = tw[q << shift];
      const float ar = xr[j], ai = xi[j];
      const float br = xr[j + half], bi = xi[j + half];
      xr[j] = ar + br;
      xi[j] = ai + bi;
      const float dr = ar - br, di = ai - bi;
      xr[j + half] = dr * w.x - di * w.y;
      xi[j + half] = dr * w.y + di * w.x;
    }
  }
}

// One pass of S stages, spans 2^logL .. 2^(logL-S+1), over 2^logM sequences
// of length 2^logN. Element i of sequence q sits at pad(q*qs + i*is).
// `qfast` puts neighbouring threads on neighbouring sequences (use it when
// the sequences are the contiguous axis), else on neighbouring groups.
template <int S>
__device__ __forceinline__ void dif_pass(float* sr, float* si, int logN, int logL,
                                         int logM, int qs, int is, bool qfast,
                                         const float2* tw) {
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
    float xr[1 << S], xi[1 << S];
    int a[1 << S];
#pragma unroll
    for (int j = 0; j < (1 << S); ++j) {
      a[j] = pad(q * qs + (base + (j << logR)) * is);
      xr[j] = sr[a[j]];
      xi[j] = si[a[j]];
    }
    dif_group<S>(xr, xi, r, logR, logN, logL, tw);
#pragma unroll
    for (int j = 0; j < (1 << S); ++j) {
      sr[a[j]] = xr[j];
      si[a[j]] = xi[j];
    }
  }
}

// Whole in-place DIF FFT of every sequence: natural order in, X[k] at
// position bitrev(k) out. The caller synchronises before; this function
// synchronises after every pass.
__device__ __forceinline__ void dif_fft(float* sr, float* si, int logN, int logM,
                                        int qs, int is, bool qfast,
                                        const float2* tw) {
  for (int logL = logN; logL > 0;) {
    if (logL >= 3) {
      dif_pass<3>(sr, si, logN, logL, logM, qs, is, qfast, tw);
      logL -= 3;
    } else if (logL == 2) {
      dif_pass<2>(sr, si, logN, logL, logM, qs, is, qfast, tw);
      logL -= 2;
    } else {
      dif_pass<1>(sr, si, logN, logL, logM, qs, is, qfast, tw);
      logL -= 1;
    }
    __syncthreads();
  }
}

// One pass as dif_pass; with `fold` (the last pass of a leaf's F(n1),
// logL == S) each output is then multiplied in registers by the correction
// (cr, ci)[k1 * 128 + i2], k1 the bit reverse of its position and
// i2 = col0 + (q & colmask) (sequences that are rows of several 128-column
// blocks pass a smaller mask). For leaf.cu and leaft.cu.
template <int S>
__device__ __forceinline__ void dif_pass_fold(float* sr, float* si, int logN, int logL,
                                              int logM, int qs, int is, bool qfast,
                                              const float2* tw, const float* cr,
                                              const float* ci, bool fold, int col0,
                                              int colmask = 127) {
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
    float xr[1 << S], xi[1 << S];
    int a[1 << S];
#pragma unroll
    for (int j = 0; j < (1 << S); ++j) {
      a[j] = pad(q * qs + (base + (j << logR)) * is);
      xr[j] = sr[a[j]];
      xi[j] = si[a[j]];
    }
    dif_group<S>(xr, xi, r, logR, logN, logL, tw);
    if (fold) {
      const int i2 = col0 + (q & colmask);
#pragma unroll
      for (int j = 0; j < (1 << S); ++j) {
        const int t = (bitrev(base + j, logN) << 7) + i2;
        const float c = __ldg(cr + t), s = __ldg(ci + t);
        const float x = xr[j], y = xi[j];
        xr[j] = x * c - y * s;
        xi[j] = x * s + y * c;
      }
    }
#pragma unroll
    for (int j = 0; j < (1 << S); ++j) {
      sr[a[j]] = xr[j];
      si[a[j]] = xi[j];
    }
  }
}

// The stages from span 2^logL down of an in-place DIF FFT of every
// sequence (logL = logN: the whole FFT) in the fewest trips of at most four
// stages, balanced: F(128) as 4 + 3, F(256) as 4 + 4, F(64) as 3 + 3.
// `fold` folds the correction into the last trip (dif_pass_fold, with
// `colmask`). The caller synchronises before; this function synchronises
// after every pass.
__device__ __forceinline__ void dif_fft16(float* sr, float* si, int logN, int logL,
                                          int logM, int qs, int is, bool qfast,
                                          const float2* tw, const float* cr,
                                          const float* ci, bool fold, int col0,
                                          int colmask = 127) {
  while (logL > 0) {
    const int trips = (logL + 3) >> 2;
    const int S = (logL + trips - 1) / trips;
    const bool last = fold && logL == S;
    if (S == 4)
      dif_pass_fold<4>(sr, si, logN, logL, logM, qs, is, qfast, tw, cr, ci, last, col0,
                         colmask);
    else if (S == 3)
      dif_pass_fold<3>(sr, si, logN, logL, logM, qs, is, qfast, tw, cr, ci, last, col0,
                         colmask);
    else if (S == 2)
      dif_pass_fold<2>(sr, si, logN, logL, logM, qs, is, qfast, tw, cr, ci, last, col0,
                         colmask);
    else
      dif_pass_fold<1>(sr, si, logN, logL, logM, qs, is, qfast, tw, cr, ci, last, col0,
                         colmask);
    logL -= S;
    __syncthreads();
  }
}

// tw[k] = W_m^k for k < m/2, the table dif_fft reads: row 1 of the
// planner's F(m) (fr, fi), or with fr = NULL formed from the exact phase,
// sincospi in double rounded once to float.
__device__ __forceinline__ void load_twiddles(float2* tw, int m, const float* fr,
                                              const float* fi) {
  for (int k = threadIdx.x; k < m / 2; k += blockDim.x) {
    if (fr != nullptr) {
      tw[k] = make_float2(fr[m + k], fi[m + k]);
    } else {
      double s, c;
      sincospi(-2.0 * k / m, &s, &c);
      tw[k] = make_float2(static_cast<float>(c), static_cast<float>(s));
    }
  }
}

inline int ilog2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

inline bool is_pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace phastft
