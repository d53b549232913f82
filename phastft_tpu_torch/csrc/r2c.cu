// The four streaming passes of the real transforms (R2C / C2R), for sm_90a,
// in f32 and f64.
//
// Stands for: no TPU kernel. The JAX package runs these passes as XLA code in
// phastft_tpu/ops/r2c.py: _deinterleave (:302), _untangle (:65),
// _pre_untangle (:96) and _scale_interleave (:451). In eager PyTorch each
// would be a chain of ~10-27 launches (flips, concatenations, products), each
// moving N/4 to N/2 points, and together would cost more than the
// half-length transform they wrap; one pass each keeps R2C near half a C2C.
//
//   deinterleave      x (rows, N) reals -> even, odd (rows, H), H = N / 2
//   untangle          z = FFT_H(even + i odd) -> the bins X[k0 .. k0 + L)
//                     (and X[H] with `nyq`)
//   pre_untangle      the bins X -> z, the input of the inverse FFT_H
//   interleave_scale  re, im (rows, H) * scale -> x (rows, N) reals
//
// The untangles. Both combine bin k with its mirror, z[(H - k) mod H] (the
// forward) or X[H - k] (the inverse). With m = conj(mirror) and tw = 0.5 W_N^k
// from the quarter table Q[0 .. H/2] (tw[k] = Q[k] for k <= H/2, else
// -conj(Q[H - k])), in both directions:
//
//   s = a + m, d = a - m
//   forward:  X = s/2 - i tw[k] d
//   inverse:  z = s/2 + i conj(tw[k]) d
//   forward, Nyquist:  X[H] = Re z[0] - Im z[0]
//
// For k <= H/2 this is the JAX package's formula as written; for k > H/2 its
// second half, X[H - k] = conj(s)/2 - i conj(u), rewritten per bin (the same
// products and sums, so the same bits). The products are rounded as written
// (__fmul_rn / __fadd_rn: no contraction into FMA), so each kernel and its
// plain torch version (phastft_tpu_torch/ops/r2c.py) agree bit for bit.
//
// Two forms, one per-bin function (`bin`):
//
// * The paired form (`untangle_pair_kernel` and `untangle_pair_vec_kernel`,
//   one device). A row's work is
//   the pairs (k, H - k), 1 <= k < H/2: one thread reads z[k], z[H - k] and
//   Q[k] once and writes both bins, X[k] = bin(z[k], z[H - k], Q[k]) and
//   X[H - k] = bin(z[H - k], z[k], -conj(Q[k])); the bins that pair with
//   themselves (k = 0 with z[0] or X[H], k = H/2) take one thread a row.
//   Consecutive lanes take consecutive k, so the rising loads and the falling
//   ones are each one span a warp. Two schedules: scalar (each lane one pair
//   of four planes' elements, kPairItems pairs in flight a thread), and
//   vector (each lane V = 16 / sizeof(T) consecutive k, 16-byte loads and
//   stores: the falling run H - Vt - V + 1 .. H - Vt is one element off
//   alignment, so a lane moves the aligned run below it and trades its end
//   element with the neighbouring lane by a warp shuffle; rows of H + 1
//   start aligned only at every V-th row, and the other rows' side of H + 1
//   goes element by element). z, the quarter table and the bins each cross
//   HBM once: the bound (on an H100, 83-84% of it at f32 / f64 2^26 and 77%
//   at f32 2^32; the vector schedule on one row, the scalar one on a batch,
//   where the forward's unaligned rows make the vector one the slower).
// * The mirror form (`untangle_kernel`, the distributed real transforms,
//   phastft_tpu_torch/parallel/real_dist.py). The mirror is a pointer of its
//   own: `p` (row stride `sp`) holds the mirror of element j >= 1 at
//   p[L - j], `w` (row stride `sw`) the mirror of element 0; p is the partner
//   rank's shard and w one element of another rank. One bin a thread and step,
//   the mirror read in reverse (still one coalesced span a warp).
//
// Bound: memory. No pass does more than ~14 flops per point against 16-40
// bytes. deinterleave and interleave_scale read each element once and write it
// once (16-byte loads or stores on the interleaved side, 8- or 16-byte on the
// planar side). Every pass is a grid-stride loop with 64-bit offsets.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

// Rounded as written: no FMA contraction.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

int g_blocks_cap = 0;

// Blocks of a grid-stride launch over `work` items: enough for every SM to
// hold 8 blocks of 256 threads four times over, no more.
unsigned grid_for(long long work) {
  if (g_blocks_cap == 0) {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    g_blocks_cap = sms * 32;
  }
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > g_blocks_cap) blocks = g_blocks_cap;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

// even[i] = x[2i], odd[i] = x[2i + 1]; two outputs of each plane a thread and
// step (x as 2 x 2 values, the planes as pairs).
template <typename T>
__global__ void __launch_bounds__(kThreads)
deinterleave_kernel(const T* __restrict__ x, T* __restrict__ even, T* __restrict__ odd,
                    long long pairs) {
  using V = typename Vec2<T>::type;
  const V* xv = reinterpret_cast<const V*>(x);
  V* ev = reinterpret_cast<V*>(even);
  V* ov = reinterpret_cast<V*>(odd);
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; t < pairs;
       t += step) {
    const V a = __ldg(xv + 2 * t), b = __ldg(xv + 2 * t + 1);
    V e, o;
    e.x = a.x;
    e.y = b.x;
    o.x = a.y;
    o.y = b.y;
    ev[t] = e;
    ov[t] = o;
  }
}

// x[2i] = re[i] * scale, x[2i + 1] = im[i] * scale.
template <typename T>
__global__ void __launch_bounds__(kThreads)
interleave_kernel(const T* __restrict__ re, const T* __restrict__ im, T* __restrict__ x,
                  long long pairs, T scale) {
  using V = typename Vec2<T>::type;
  const V* rv = reinterpret_cast<const V*>(re);
  const V* iv = reinterpret_cast<const V*>(im);
  V* xv = reinterpret_cast<V*>(x);
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; t < pairs;
       t += step) {
    const V r = __ldg(rv + t), i = __ldg(iv + t);
    V a, b;
    a.x = mul(r.x, scale);
    a.y = mul(i.x, scale);
    b.x = mul(r.y, scale);
    b.y = mul(i.y, scale);
    xv[2 * t] = a;
    xv[2 * t + 1] = b;
  }
}

// One bin of the forward untangle (Inverse = false) or the inverse's
// pre-untangle (Inverse = true): input a, mirror b (not yet conjugated),
// twiddle (tr, ti) = tw[k].
template <typename T, bool Inverse>
__device__ __forceinline__ void bin(T ar, T ai, T br, T bi, T tr, T ti, T& xr, T& xi) {
  const T h = T(0.5);
  const T sr = add(ar, br), si = sub(ai, bi);
  const T dr = sub(ar, br), di = add(ai, bi);
  if (Inverse) {  // p = conj(tw) d; z = s/2 + i p
    const T pr = add(mul(tr, dr), mul(ti, di));
    const T pi = sub(mul(tr, di), mul(ti, dr));
    xr = sub(mul(h, sr), pi);
    xi = add(mul(h, si), pr);
  } else {  // u = tw d; X = s/2 - i u
    const T ur = sub(mul(tr, dr), mul(ti, di));
    const T ui = add(mul(tr, di), mul(ti, dr));
    xr = add(mul(h, sr), ui);
    xi = sub(mul(h, si), ur);
  }
}

// The mirror form of `rows` rows of L = 2^logl elements, bins k = k0 + j.
template <typename T, bool Inverse>
__global__ void __launch_bounds__(kThreads)
untangle_kernel(const T* __restrict__ a_re, const T* __restrict__ a_im, long long sa,
                const T* __restrict__ p_re, const T* __restrict__ p_im, long long sp,
                const T* __restrict__ w_re, const T* __restrict__ w_im, long long sw,
                const T* __restrict__ tw_re, const T* __restrict__ tw_im,
                T* __restrict__ o_re, T* __restrict__ o_im, long long so, long long rows,
                int logl, long long k0, long long half, int nyq) {
  const long long len = 1LL << logl;
  const long long total = rows << logl;
  const long long quarter = half >> 1;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long idx = first; idx < total; idx += step) {
    const long long row = idx >> logl, j = idx & (len - 1);
    const T ar = __ldg(a_re + row * sa + j), ai = __ldg(a_im + row * sa + j);
    T mr, mi;
    if (j == 0) {
      mr = __ldg(w_re + row * sw);
      mi = __ldg(w_im + row * sw);
    } else {
      mr = __ldg(p_re + row * sp + len - j);
      mi = __ldg(p_im + row * sp + len - j);
    }
    const long long k = k0 + j;
    T tr, ti;
    if (k <= quarter) {
      tr = __ldg(tw_re + k);
      ti = __ldg(tw_im + k);
    } else {
      tr = -__ldg(tw_re + half - k);
      ti = __ldg(tw_im + half - k);
    }
    T xr, xi;
    bin<T, Inverse>(ar, ai, mr, mi, tr, ti, xr, xi);
    o_re[row * so + j] = xr;
    o_im[row * so + j] = xi;
  }
  if (!Inverse && nyq) {
    for (long long row = first; row < rows; row += step) {
      o_re[row * so + len] = sub(__ldg(p_re + row * sp), __ldg(p_im + row * sp));
      o_im[row * so + len] = T(0);
    }
  }
}

// Pairs a thread keeps in flight in the paired form's scalar schedule.
constexpr int kPairItems = 4;

// The bins of a row that pair with themselves: k = 0 against z[0] (the
// forward, which also writes X[H]) or X[H] (the inverse), and k = H/2.
// `a` and `o` point at the row.
template <typename T, bool Inverse>
__device__ __forceinline__ void self_bins(const T* __restrict__ a_re, const T* __restrict__ a_im,
                                          const T* __restrict__ tw_re,
                                          const T* __restrict__ tw_im, T* __restrict__ o_re,
                                          T* __restrict__ o_im, long long half) {
  const T ar = __ldg(a_re), ai = __ldg(a_im);
  const T br = Inverse ? __ldg(a_re + half) : ar, bi = Inverse ? __ldg(a_im + half) : ai;
  T xr, xi;
  bin<T, Inverse>(ar, ai, br, bi, __ldg(tw_re), __ldg(tw_im), xr, xi);
  o_re[0] = xr;
  o_im[0] = xi;
  if (!Inverse) {
    o_re[half] = sub(ar, ai);
    o_im[half] = T(0);
  }
  const long long q = half >> 1;
  const T cr = __ldg(a_re + q), ci = __ldg(a_im + q);
  bin<T, Inverse>(cr, ci, cr, ci, __ldg(tw_re + q), __ldg(tw_im + q), xr, xi);
  o_re[q] = xr;
  o_im[q] = xi;
}

// The paired form, scalar schedule: H/2 items a row of H = 2^logh bins,
// item j >= 1 the pair (j, H - j), item 0 the row's self-paired bins. The
// input's rows are H long (the forward) or H + 1 (the inverse), the
// output's the other.
template <typename T, bool Inverse>
__global__ void __launch_bounds__(kThreads)
untangle_pair_kernel(const T* __restrict__ a_re, const T* __restrict__ a_im,
                     const T* __restrict__ tw_re, const T* __restrict__ tw_im,
                     T* __restrict__ o_re, T* __restrict__ o_im, long long rows, int logh) {
  const long long half = 1LL << logh;
  const long long sa = Inverse ? half + 1 : half, so = Inverse ? half : half + 1;
  const long long per_row = half >> 1;
  const long long total = rows << (logh - 1);
  const long long chunk = static_cast<long long>(kThreads) * kPairItems;
  const long long step = static_cast<long long>(gridDim.x) * chunk;
  for (long long base = static_cast<long long>(blockIdx.x) * chunk + threadIdx.x; base < total;
       base += step) {
    T ar[kPairItems], ai[kPairItems], br[kPairItems], bi[kPairItems], tr[kPairItems],
        ti[kPairItems];
#pragma unroll
    for (int u = 0; u < kPairItems; ++u) {
      const long long idx = base + u * kThreads;
      if (idx >= total) break;
      const long long row = idx >> (logh - 1), j = idx & (per_row - 1);
      if (j == 0) continue;
      const T* ra = a_re + row * sa;
      const T* ia = a_im + row * sa;
      ar[u] = __ldg(ra + j);
      ai[u] = __ldg(ia + j);
      br[u] = __ldg(ra + half - j);
      bi[u] = __ldg(ia + half - j);
      tr[u] = __ldg(tw_re + j);
      ti[u] = __ldg(tw_im + j);
    }
#pragma unroll
    for (int u = 0; u < kPairItems; ++u) {
      const long long idx = base + u * kThreads;
      if (idx >= total) break;
      const long long row = idx >> (logh - 1), j = idx & (per_row - 1);
      T* ro = o_re + row * so;
      T* io = o_im + row * so;
      if (j == 0) {
        self_bins<T, Inverse>(a_re + row * sa, a_im + row * sa, tw_re, tw_im, ro, io, half);
        continue;
      }
      T xr, xi;
      bin<T, Inverse>(ar[u], ai[u], br[u], bi[u], tr[u], ti[u], xr, xi);
      ro[j] = xr;
      io[j] = xi;
      bin<T, Inverse>(br[u], bi[u], ar[u], ai[u], -tr[u], ti[u], xr, xi);
      ro[half - j] = xr;
      io[half - j] = xi;
    }
  }
}

template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec4<double> {
  using type = double2;
  static constexpr int n = 2;
};

template <typename V, typename T>
__device__ __forceinline__ T& lane_of(V& v, int i) {
  return reinterpret_cast<T*>(&v)[i];
}

// The paired form, vector schedule: H / (2V) items a row, item t the bins
// k = lo .. lo + V - 1 (lo = Vt) and their mirrors H - k (t = 0 starts with
// the self-paired k = 0; the row's last item also takes k = H/2). Each side
// moves as a rising run in[lo .. lo + V) and the aligned falling run
// in[hi .. hi + V), hi = H - lo - V: the mirrors in[H - lo - i] are the
// falling run's elements V - i for i >= 1, and in[H - lo] is the element 0
// of the lane before (a shuffle; lane 0 loads it, and t = 0 takes z[0] or
// X[H]). The output's falling run holds the bins y[V - e] (y[i] at
// H - lo - i) and at e = 0 the next lane's y[0] (the last item: the bin
// H/2); lane 31 leaves that element to the next warp's lane 0, which stores
// its y[0] alone. The side of rows of H (the forward's input, the inverse's
// output) moves in 16-byte vectors; the side of rows of H + 1 does where a
// row starts 16-byte aligned (`wide`: that side's planes are aligned, and
// the row is a multiple of V), element by element elsewhere. Needs H >= 2V
// and the H side's planes and the table 16-byte aligned.
template <typename T, bool Inverse>
__global__ void __launch_bounds__(kThreads)
untangle_pair_vec_kernel(const T* __restrict__ a_re, const T* __restrict__ a_im,
                         const T* __restrict__ tw_re, const T* __restrict__ tw_im,
                         T* __restrict__ o_re, T* __restrict__ o_im, long long rows,
                         int logh, int wide) {
  using V = typename Vec4<T>::type;
  constexpr int kV = Vec4<T>::n;
  constexpr unsigned kAll = 0xffffffffu;
  const long long half = 1LL << logh;
  const long long sa = Inverse ? half + 1 : half, so = Inverse ? half : half + 1;
  const int log_items = logh - 1 - (kV == 4 ? 2 : 1);  // log2(H / (2V))
  const long long per_row = 1LL << log_items;
  const long long total = rows << log_items;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  const int lane = threadIdx.x & 31;
  // `base` is uniform over the block, so every lane of a warp shuffles
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads; base < total;
       base += step) {
    const long long idx = base + threadIdx.x;
    const bool valid = idx < total;
    const long long row = valid ? idx >> log_items : 0;
    const long long t = idx & (per_row - 1);
    const long long lo = t * kV;
    const long long hi = half - lo - kV;
    const bool last = t == per_row - 1;
    const bool aligned_row = wide && row % kV == 0;
    const bool in_vec = !Inverse || aligned_row, out_vec = Inverse || aligned_row;
    const T* ra = a_re + row * sa;
    const T* ia = a_im + row * sa;
    T* ro = o_re + row * so;
    T* io = o_im + row * so;
    V qr = {}, qi = {}, vr = {}, vi = {}, wr = {}, wi = {};
    if (valid) {
      qr = __ldg(reinterpret_cast<const V*>(tw_re + lo));
      qi = __ldg(reinterpret_cast<const V*>(tw_im + lo));
      if (in_vec) {
        vr = __ldg(reinterpret_cast<const V*>(ra + lo));
        vi = __ldg(reinterpret_cast<const V*>(ia + lo));
        wr = __ldg(reinterpret_cast<const V*>(ra + hi));
        wi = __ldg(reinterpret_cast<const V*>(ia + hi));
      } else {
#pragma unroll
        for (int i = 0; i < kV; ++i) {
          lane_of<V, T>(vr, i) = __ldg(ra + lo + i);
          lane_of<V, T>(vi, i) = __ldg(ia + lo + i);
          lane_of<V, T>(wr, i) = __ldg(ra + hi + i);
          lane_of<V, T>(wi, i) = __ldg(ia + hi + i);
        }
      }
    }
    T ur = __shfl_up_sync(kAll, lane_of<V, T>(wr, 0), 1);
    T ui = __shfl_up_sync(kAll, lane_of<V, T>(wi, 0), 1);
    if (valid && t == 0) {
      ur = Inverse ? __ldg(ra + half) : lane_of<V, T>(vr, 0);
      ui = Inverse ? __ldg(ia + half) : lane_of<V, T>(vi, 0);
    } else if (valid && lane == 0) {
      ur = __ldg(ra + half - lo);
      ui = __ldg(ia + half - lo);
    }
    // the bins: x[i] at lo + i, y[i] at H - lo - i, m at H/2 (the last item)
    T xr[kV], xi[kV], yr[kV], yi[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const T tr = lane_of<V, T>(qr, i), ti = lane_of<V, T>(qi, i);
      const T ar = lane_of<V, T>(vr, i), ai = lane_of<V, T>(vi, i);
      const T br = i == 0 ? ur : lane_of<V, T>(wr, kV - i);
      const T bi = i == 0 ? ui : lane_of<V, T>(wi, kV - i);
      bin<T, Inverse>(ar, ai, br, bi, tr, ti, xr[i], xi[i]);
      bin<T, Inverse>(br, bi, ar, ai, -tr, ti, yr[i], yi[i]);
    }
    T mr = T(0), mi = T(0);
    if (valid && last) {
      const T cr = lane_of<V, T>(wr, 0), ci = lane_of<V, T>(wi, 0);
      bin<T, Inverse>(cr, ci, cr, ci, __ldg(tw_re + hi), __ldg(tw_im + hi), mr, mi);
    }
    const T dr = __shfl_down_sync(kAll, yr[0], 1);
    const T di = __shfl_down_sync(kAll, yi[0], 1);
    if (!valid) continue;
    V xv, xw, yv, yw;  // the rising and the falling output runs, re and im
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      lane_of<V, T>(xv, i) = xr[i];
      lane_of<V, T>(xw, i) = xi[i];
    }
    lane_of<V, T>(yv, 0) = last ? mr : dr;
    lane_of<V, T>(yw, 0) = last ? mi : di;
#pragma unroll
    for (int e = 1; e < kV; ++e) {
      lane_of<V, T>(yv, e) = yr[kV - e];
      lane_of<V, T>(yw, e) = yi[kV - e];
    }
    const bool whole = last || lane != 31;  // else the next warp's lane 0 stores e = 0
    if (out_vec) {
      *reinterpret_cast<V*>(ro + lo) = xv;
      *reinterpret_cast<V*>(io + lo) = xw;
      if (whole) {
        *reinterpret_cast<V*>(ro + hi) = yv;
        *reinterpret_cast<V*>(io + hi) = yw;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        ro[lo + i] = lane_of<V, T>(xv, i);
        io[lo + i] = lane_of<V, T>(xw, i);
      }
      if (whole) {
        ro[hi] = lane_of<V, T>(yv, 0);
        io[hi] = lane_of<V, T>(yw, 0);
      }
    }
    if (!whole || !out_vec) {
#pragma unroll
      for (int e = 1; e < kV; ++e) {
        ro[hi + e] = lane_of<V, T>(yv, e);
        io[hi + e] = lane_of<V, T>(yw, e);
      }
    }
    if (lane == 0 && t > 0) {
      ro[half - lo] = yr[0];
      io[half - lo] = yi[0];
    }
    if (!Inverse && t == 0) {  // X[H]
      ro[half] = sub(lane_of<V, T>(vr, 0), lane_of<V, T>(vi, 0));
      io[half] = T(0);
    }
  }
}

int log2_exact(long long v) {
  int l = 0;
  while ((1LL << l) < v) ++l;
  return (1LL << l) == v ? l : -1;
}

template <typename T>
int launch_untangle(bool inverse, const void* a_re, const void* a_im, long long sa,
                    const void* p_re, const void* p_im, long long sp, const void* w_re,
                    const void* w_im, long long sw, const void* tw_re, const void* tw_im,
                    void* o_re, void* o_im, long long so, long long rows, long long len,
                    long long k0, long long half, int nyq, cudaStream_t stream) {
  const int logl = log2_exact(len);
  if (rows < 1 || logl < 0 || len > half || k0 < 0 || k0 + len > half ||
      log2_exact(half) < 1 || (rows << logl) >> logl != rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = grid_for(rows << logl);
  const T* ar = static_cast<const T*>(a_re);
  const T* ai = static_cast<const T*>(a_im);
  const T* pr = static_cast<const T*>(p_re);
  const T* pi = static_cast<const T*>(p_im);
  const T* wr = static_cast<const T*>(w_re);
  const T* wi = static_cast<const T*>(w_im);
  const T* tr = static_cast<const T*>(tw_re);
  const T* ti = static_cast<const T*>(tw_im);
  T* orr = static_cast<T*>(o_re);
  T* oi = static_cast<T*>(o_im);
  if (inverse)
    untangle_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        ar, ai, sa, pr, pi, sp, wr, wi, sw, tr, ti, orr, oi, so, rows, logl, k0, half, 0);
  else
    untangle_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        ar, ai, sa, pr, pi, sp, wr, wi, sw, tr, ti, orr, oi, so, rows, logl, k0, half, nyq);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_untangle_pair(bool inverse, const void* a_re, const void* a_im, const void* tw_re,
                         const void* tw_im, void* o_re, void* o_im, long long rows,
                         long long half, int schedule, cudaStream_t stream) {
  const int logh = log2_exact(half);
  if (rows < 1 || logh < 1 || (rows << logh) >> logh != rows)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kV = Vec4<T>::n;
  auto aligned = [](const void* ptr) {
    return reinterpret_cast<unsigned long long>(ptr) % 16 == 0;
  };
  const bool vec = schedule == 1 && half >= 2 * kV && aligned(inverse ? o_re : a_re) &&
                   aligned(inverse ? o_im : a_im) && aligned(tw_re) && aligned(tw_im);
  const int wide = aligned(inverse ? a_re : o_re) && aligned(inverse ? a_im : o_im);
  const T* ar = static_cast<const T*>(a_re);
  const T* ai = static_cast<const T*>(a_im);
  const T* tr = static_cast<const T*>(tw_re);
  const T* ti = static_cast<const T*>(tw_im);
  T* orr = static_cast<T*>(o_re);
  T* oi = static_cast<T*>(o_im);
  if (vec) {
    const unsigned blocks = grid_for(rows * (half / (2 * kV)));
    if (inverse)
      untangle_pair_vec_kernel<T, true><<<blocks, kThreads, 0, stream>>>(ar, ai, tr, ti, orr,
                                                                         oi, rows, logh, wide);
    else
      untangle_pair_vec_kernel<T, false><<<blocks, kThreads, 0, stream>>>(ar, ai, tr, ti, orr,
                                                                          oi, rows, logh, wide);
  } else {
    const unsigned blocks = grid_for((rows * (half / 2) + kPairItems - 1) / kPairItems);
    if (inverse)
      untangle_pair_kernel<T, true><<<blocks, kThreads, 0, stream>>>(ar, ai, tr, ti, orr, oi,
                                                                     rows, logh);
    else
      untangle_pair_kernel<T, false><<<blocks, kThreads, 0, stream>>>(ar, ai, tr, ti, orr, oi,
                                                                      rows, logh);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: `pairs` * 4 reals (f64 != 0: doubles, else floats), 16-byte aligned;
// even, odd: `pairs` * 2 values each, aligned to two values. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int phastft_r2c_deinterleave(int f64, const void* x, void* even, void* odd,
                                        long long pairs, void* stream) {
  if (pairs < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    deinterleave_kernel<double><<<grid_for(pairs), kThreads, 0, s>>>(
        static_cast<const double*>(x), static_cast<double*>(even), static_cast<double*>(odd),
        pairs);
  else
    deinterleave_kernel<float><<<grid_for(pairs), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(even), static_cast<float*>(odd),
        pairs);
  return static_cast<int>(cudaGetLastError());
}

// re, im: `pairs` * 2 values each; x: `pairs` * 4 reals, 16-byte aligned;
// x = interleave(re, im) * scale.
extern "C" int phastft_r2c_interleave(int f64, const void* re, const void* im, void* x,
                                      long long pairs, double scale, void* stream) {
  if (pairs < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    interleave_kernel<double><<<grid_for(pairs), kThreads, 0, s>>>(
        static_cast<const double*>(re), static_cast<const double*>(im),
        static_cast<double*>(x), pairs, scale);
  else
    interleave_kernel<float><<<grid_for(pairs), kThreads, 0, s>>>(
        static_cast<const float*>(re), static_cast<const float*>(im), static_cast<float*>(x),
        pairs, static_cast<float>(scale));
  return static_cast<int>(cudaGetLastError());
}

// The untangle (inverse = 0) or pre-untangle (inverse = 1) of `rows` rows of
// `len` elements (a power of two): input a (row stride sa), mirror p (stride
// sp) and w (stride sw), twiddles tw (the quarter table, half / 2 + 1
// entries), output o (stride so),
// bins k0 .. k0 + len - 1 of a half-length transform of `half` points; with
// nyq (forward only) also o[len] = Re p[0] - Im p[0] per row.
extern "C" int phastft_r2c_untangle(int f64, int inverse, const void* a_re, const void* a_im,
                                    long long sa, const void* p_re, const void* p_im,
                                    long long sp, const void* w_re, const void* w_im,
                                    long long sw, const void* tw_re, const void* tw_im,
                                    void* o_re, void* o_im, long long so, long long rows,
                                    long long len, long long k0, long long half, int nyq,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    return launch_untangle<double>(inverse != 0, a_re, a_im, sa, p_re, p_im, sp, w_re, w_im,
                                   sw, tw_re, tw_im, o_re, o_im, so, rows, len, k0, half, nyq,
                                   s);
  return launch_untangle<float>(inverse != 0, a_re, a_im, sa, p_re, p_im, sp, w_re, w_im, sw,
                                tw_re, tw_im, o_re, o_im, so, rows, len, k0, half, nyq, s);
}

// The paired one-device untangle (inverse = 0: rows of `half` elements a in,
// rows of half + 1 bins o out, the last the Nyquist bin) or pre-untangle
// (inverse = 1: rows of half + 1 bins in, half elements out), contiguous
// rows, on the quarter table tw (half / 2 + 1 entries); `half` a power of
// two >= 2. schedule 1: the vector schedule where half >= 2V and the side of
// rows of `half` and the table are 16-byte aligned, else (and with
// schedule 0) the scalar one (phastft_tpu_torch/ops/r2c.py's pair_schedule
// picks).
extern "C" int phastft_r2c_untangle_pair(int f64, int inverse, const void* a_re,
                                         const void* a_im, const void* tw_re,
                                         const void* tw_im, void* o_re, void* o_im,
                                         long long rows, long long half, int schedule,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    return launch_untangle_pair<double>(inverse != 0, a_re, a_im, tw_re, tw_im, o_re, o_im,
                                        rows, half, schedule, s);
  return launch_untangle_pair<float>(inverse != 0, a_re, a_im, tw_re, tw_im, o_re, o_im, rows,
                                     half, schedule, s);
}
