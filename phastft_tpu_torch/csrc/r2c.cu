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
// The mirror. Both untangles pair bin k with z[(H - k) mod H] (or X[H - k]).
// Each takes the mirror's source as pointers of its own: `p` (row stride
// `sp`) holds the mirror of element j >= 1 at p[L - j], and `w` (row stride
// `sw`) the mirror of element 0. On one device p is the input itself and w
// its first element (the forward) or its bin H (the inverse); in the
// distributed real transforms p is the partner rank's shard and w one element
// of another rank (phastft_tpu_torch/parallel/real_dist.py), so both paths
// run this kernel. With m = conj(mirror):
//
//   s = a + m, d = a - m
//   forward:  X = s/2 - i tw[k] d     tw = 0.5 W_N^k from the quarter table
//             Q[0 .. H/2]: tw[k] = Q[k] for k <= H/2, else -conj(Q[H - k])
//   inverse:  z = s/2 + i conj(tw[k]) d,  tw the full table (H entries)
//   forward, nyq:  X[H] = Re p[0] - Im p[0]   (p[0] = z[0])
//
// For k <= H/2 this is the JAX package's formula as written; for k > H/2 its
// second half, X[H - k] = conj(s)/2 - i conj(u), rewritten per bin (the same
// products and sums, so the same bits). The products are rounded as written
// (__fmul_rn / __fadd_rn: no contraction into FMA), so each kernel and its
// plain torch version (phastft_tpu_torch/ops/r2c.py) agree bit for bit.
//
// Bound: memory. No pass does more than ~10 flops per point against 16-40
// bytes. deinterleave and interleave_scale read each element once and write it
// once (16-byte loads or stores on the interleaved side, 8- or 16-byte on the
// planar side); the untangles read the input, the mirror (in reverse order,
// still one coalesced span per warp) and the twiddle, and write the output,
// one element a thread and step. On one device the mirror is the input, so
// these loads ask for z twice and a table entry per bin, above the bound of z
// once and the quarter table that a k / H - k pairing would reach. Every pass is a grid-stride loop over the
// flat element index with 64-bit offsets.
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

// The forward untangle (Inverse = false) and the inverse's pre-untangle
// (Inverse = true) of `rows` rows of L = 2^logl elements, bins k = k0 + j.
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
  const T h = T(0.5);
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
    const T sr = add(ar, mr), si = sub(ai, mi);
    const T dr = sub(ar, mr), di = add(ai, mi);
    const long long k = k0 + j;
    T tr, ti;
    if (Inverse || k <= quarter) {
      tr = __ldg(tw_re + k);
      ti = __ldg(tw_im + k);
    } else {
      tr = -__ldg(tw_re + half - k);
      ti = __ldg(tw_im + half - k);
    }
    T xr, xi;
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
// sp) and w (stride sw), twiddles tw (the quarter table of half / 2 + 1
// entries, or with inverse the full table of `half`), output o (stride so),
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
