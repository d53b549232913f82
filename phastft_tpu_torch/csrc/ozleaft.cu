// Row pass of the Ozaki dd engine ("df64-oz"), four f32 planes per complex
// array, for sm_90a; and the tensor-core product alone, for the on-card
// exactness check.
//
// Replaces: phastft_tpu/ops/pallas_ozdd.py, ozleaft_pallas (_ozleaft_kernel).
//
// Over the column pass's relayout c[b, i_A, k1, i_M] (A = 8..64 rows of 128)
// it computes, for every row k1, the length-n2 = A*128 dd DFT of
// x[i_A, i_M] = c[b, i_A, k1, i_M], the contractions error-free bf16-slice
// products (oz.cuh):
//   stage 1: t[k_A, i_M] = sum_i_A F_A[k_A, i_A] x[i_A, i_M]  (one scale per i_M)
//            v = t * W_n2^(k_A*i_M)
//   stage 2: w[k_A, k_M] = sum_i_M F_128[k_M, i_M] v[k_A, i_M] (one scale per k_A)
// and stores out[b, k1 + n1*(k_A + A*k_M)] = w[k_A, k_M]: the final natural
// order, the four-step transpose being the store index.
//
// Bound: the tensor cores, 90 * (A + 128) flops per element (the JAX
// kernel's own count): 0.29 ms of bf16 tensor-core time at n = 2^24 (A = 64)
// against 0.16 ms for its 32 B of traffic.
//
// Design (a first version, right before fast):
// - A block holds 64/A whole rows (8192 points, 128 KB of dd values) in
//   shared memory, one row after the other: stage 1 slices 1024-value
//   chunks of the row's columns (sigma by a shared-memory max), eight warps
//   each run one 16 x 8 tile of the product, fold, apply the correction and
//   write v into the row's slot; stage 2 slices eight k_A rows at a time
//   (one warp per row finds its scale) and writes w over the same rows.
// - The output's contiguous axis is the row index k1, so the block stores
//   its rows last, as runs of 64/A consecutive floats: whole 32-byte sectors
//   at A = 8, one float per sector at A = 64.
// - The DFT matrices' slices are read from device memory (L2-resident).
#include <cstdint>

#include <cuda_runtime.h>

#include "oz.cuh"

namespace ddk = phastft::ddk;
namespace oz = phastft::oz;

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 128;         // the second factor M
constexpr int BLOCK_POINTS = 8192;  // 64 / A rows of A * 128 points
constexpr int CHUNK = 1024;        // values sliced at a time in stage 1
constexpr int LD2 = LANES + 8;     // padded slice row of stage 2
constexpr int S2_ROWS = 8;         // k_A rows sliced at a time in stage 2

struct Tabs {
  oz::SliceSet fa;       // F(A) slices, (A, A)
  oz::SliceSet fm;       // F(128) slices, (128, 128)
  const float* corr[4];  // W_n2^(k_A*i_M), (A, 128)
};

__host__ __device__ constexpr int max_i(int a, int b) { return a > b ? a : b; }

// bf16 words of the slice buffer: the larger of stage 1 (15 sets of
// CHUNK / A columns of A + 8 values, largest at A = 8) and stage 2.
constexpr int SLICE_WORDS =
    max_i(oz::NSETS * (CHUNK / 8) * (8 + 8), oz::NSETS * S2_ROWS * LD2);

__global__ void __launch_bounds__(THREADS, 1)
ozleaft_kernel(ddk::ConstQuad x, Tabs tabs, ddk::Quad out, int a, int n1) {
  extern __shared__ float4 smem4[];
  const int rows = BLOCK_POINTS / (a * LANES);
  const ddk::Planes v = ddk::make_planes(reinterpret_cast<float*>(smem4), BLOCK_POINTS);
  uint16_t* xs = reinterpret_cast<uint16_t*>(v.p[0] + 4 * BLOCK_POINTS);
  unsigned* cmax = reinterpret_cast<unsigned*>(xs + SLICE_WORDS);
  float* csig = reinterpret_cast<float*>(cmax + LANES);

  const int groups = n1 / rows;
  const long long b = blockIdx.x / groups;
  const int r0 = static_cast<int>(blockIdx.x % groups) * rows;
  const long long n = static_cast<long long>(n1) * a * LANES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ci = CHUNK / a;  // stage 1: columns per chunk, 16..128
  const int ld1 = a + 8;

  for (int rr = 0; rr < rows; ++rr) {
    const int row = rr * a * LANES;  // the row's slot in v
    const long long xrow = (b * a * n1 + r0 + rr) * LANES;  // x[b, 0, r, 0]

    // ---- stage 1: F(A) over i_A, then the correction
    for (int c0 = 0; c0 < LANES; c0 += ci) {
      if (tid < ci) cmax[tid] = 0u;
      __syncthreads();
      const int col = tid % ci;  // 256 is a multiple of ci: one column a thread
      float mx = 0.f;
      for (int e = tid; e < CHUNK; e += THREADS) {
        const long long o = xrow + static_cast<long long>(e / ci) * n1 * LANES + c0 + col;
        mx = fmaxf(mx, fmaxf(fabsf(__ldg(x.p[0] + o)), fabsf(__ldg(x.p[2] + o))));
      }
      atomicMax(cmax + col, __float_as_uint(mx));
      __syncthreads();
      float sig, inv;
      oz::sigma_of(__uint_as_float(cmax[col]), sig, inv);
      if (tid < ci) csig[tid] = sig;
      for (int e = tid; e < CHUNK; e += THREADS) {
        const int ia = e / ci;
        const long long o = xrow + static_cast<long long>(ia) * n1 * LANES + c0 + col;
        const ddk::ddc xv{ddk::dd{__ldg(x.p[0] + o), __ldg(x.p[1] + o)},
                          ddk::dd{__ldg(x.p[2] + o), __ldg(x.p[3] + o)}};
        oz::slice_complex(xv, inv, xs + col * ld1 + ia, ci * ld1);
      }
      __syncthreads();
      {
        // one 16 (i_M) x 8 (k_A) tile a warp: the data is the A side
        const int mt = ci / 16;
        const int mtile = warp % mt, ntile = warp / mt;
        oz::Tiers acc;
        acc.zero();
        for (int k0 = 0; k0 < a; k0 += 16) {
          uint32_t bf[oz::NOPS][oz::NSLICES][2];
#pragma unroll
          for (int op = 0; op < oz::NOPS; ++op)
#pragma unroll
            for (int j = 0; j < oz::NSLICES; ++j)
              oz::load_b<true>(bf[op][j], tabs.fa.p[op * oz::NSLICES + j], a, ntile * 8, k0, a);
          oz::tier_step(acc, bf, [&](int op, int i, uint32_t(&af)[4]) {
            oz::load_a<false>(af, xs + (op * oz::NSLICES + i) * ci * ld1, ld1, mtile * 16, k0, a);
          });
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = mtile * 16 + g + (e >= 2 ? 8 : 0);
          const int ka = ntile * 8 + 2 * t + (e & 1);
          const int c = ka * LANES + c0 + il;
          const ddk::ddc w{ddk::dd{__ldg(tabs.corr[0] + c), __ldg(tabs.corr[1] + c)},
                           ddk::dd{__ldg(tabs.corr[2] + c), __ldg(tabs.corr[3] + c)}};
          ddk::store(v, row + c, oz::cmul(acc.fold_at(e, csig[il]), w));
        }
      }
      __syncthreads();
    }

    // ---- stage 2: F(128) over i_M, eight k_A rows at a time
    for (int k0a = 0; k0a < a; k0a += S2_ROWS) {
      {
        // warp w finds the scale of row k0a + w and slices it
        const int vr = row + (k0a + warp) * LANES;
        float mx = 0.f;
        for (int im = lane; im < LANES; im += 32)
          mx = fmaxf(mx, fmaxf(fabsf(v.p[0][vr + im]), fabsf(v.p[2][vr + im])));
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, s));
        float sig, inv;
        oz::sigma_of(mx, sig, inv);
        if (lane == 0) csig[warp] = sig;
        for (int im = lane; im < LANES; im += 32)
          oz::slice_complex(ddk::load(v, vr + im), inv, xs + warp * LD2 + im, S2_ROWS * LD2);
      }
      __syncthreads();
      {
        // one 16 (k_M) x 8 (k_A) tile a warp: F(128) is the A side
        oz::Tiers acc;
        acc.zero();
        for (int k0 = 0; k0 < LANES; k0 += 16) {
          uint32_t bf[oz::NOPS][oz::NSLICES][2];
#pragma unroll
          for (int op = 0; op < oz::NOPS; ++op)
#pragma unroll
            for (int j = 0; j < oz::NSLICES; ++j)
              oz::load_b<false>(bf[op][j], xs + (op * oz::NSLICES + j) * S2_ROWS * LD2, LD2, 0,
                                k0, LANES);
          oz::tier_step(acc, bf, [&](int op, int i, uint32_t(&af)[4]) {
            oz::load_a<true>(af, tabs.fm.p[op * oz::NSLICES + i], LANES, warp * 16, k0, LANES);
          });
        }
        // the chunk's rows were sliced before the barrier: w goes over them
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int km = warp * 16 + g + (e >= 2 ? 8 : 0);
          const int kl = 2 * t + (e & 1);
          ddk::store(v, row + (k0a + kl) * LANES + km, acc.fold_at(e, csig[kl]));
        }
      }
      __syncthreads();
    }
  }

  // out[b, k_M, k_A, r0 + rr]: runs of `rows` consecutive floats
  for (int e = tid; e < BLOCK_POINTS; e += THREADS) {
    const int rr = e % rows, ka = (e / rows) % a, km = e / (rows * a);
    const long long o = b * n + static_cast<long long>(km * a + ka) * n1 + r0 + rr;
    const ddk::ddc w = ddk::load(v, (rr * a + ka) * LANES + km);
    out.p[0][o] = w.re.hi;
    out.p[1][o] = w.re.lo;
    out.p[2][o] = w.im.hi;
    out.p[3][o] = w.im.lo;
  }
}

// d (rows x cols) = a (rows x depth) x bt^T (bt: cols x depth), bf16 in, f32
// out: one warp per 16 x 8 tile.
__global__ void oz_exact_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ bt,
                                float* __restrict__ d, int cols, int depth) {
  const int tiles_n = cols / 8;
  const int r0 = (blockIdx.x / tiles_n) * 16, n0 = (blockIdx.x % tiles_n) * 8;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < depth; k0 += 16) {
    uint32_t af[4], bf[2];
    oz::load_a<true>(af, a, depth, r0, k0, depth);
    oz::load_b<true>(bf, bt, depth, n0, k0, depth);
    oz::mma(acc, af, bf);
  }
  const int g = threadIdx.x >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    d[static_cast<long long>(r0 + g + (e >= 2 ? 8 : 0)) * cols + n0 + 2 * t + (e & 1)] = acc[e];
}

}  // namespace

// ptrs: the four input planes of (batch, A, n1, 128); the 15 F(A) and the
// 15 F(128) slice arrays (bf16); the correction (A, 128) 4-tuple (f32); the
// four output planes of (batch, n1 * A * 128): 42 device pointers in the
// order of ops/ozdd.py's ozleaft. A = 8..64 and n1 = 128..2048, powers of
// two. Returns the CUDA error code of the launch.
extern "C" int phastft_ozleaft(void* const* ptrs, long long batch, int a, int n1,
                               void* stream) {
  if (batch < 1 || !phastft::is_pow2(a) || a < 8 || a > 64 || !phastft::is_pow2(n1) ||
      n1 < 128 || n1 > 2048)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = BLOCK_POINTS / (a * LANES);
  const long long blocks = batch * (n1 / rows);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int k = 0;
  auto next = [&]() { return ptrs[k++]; };
  ddk::ConstQuad x;
  for (auto& q : x.p) q = static_cast<const float*>(next());
  Tabs tabs;
  for (auto& q : tabs.fa.p) q = static_cast<const uint16_t*>(next());
  for (auto& q : tabs.fm.p) q = static_cast<const uint16_t*>(next());
  for (auto& q : tabs.corr) q = static_cast<const float*>(next());
  ddk::Quad out;
  for (auto& q : out.p) q = static_cast<float*>(next());
  const size_t smem = 4 * sizeof(float) * BLOCK_POINTS + sizeof(uint16_t) * SLICE_WORDS +
                      2 * LANES * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ozleaft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ozleaft_kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
                   static_cast<cudaStream_t>(stream)>>>(x, tabs, out, a, n1);
  return static_cast<int>(cudaGetLastError());
}

// a (rows x depth) and bt (cols x depth): integer-valued bf16 arrays;
// d (rows x cols) f32 = a x bt^T by the tensor-core product of oz.cuh alone.
// rows a multiple of 16, cols of 8, depth of 16.
extern "C" int phastft_oz_exact(const void* a, const void* bt, float* d, int rows, int cols,
                                int depth, void* stream) {
  if (rows < 16 || rows % 16 || cols < 8 || cols % 8 || depth < 16 || depth % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  oz_exact_kernel<<<(rows / 16) * (cols / 8), 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(bt), d, cols, depth);
  return static_cast<int>(cudaGetLastError());
}
