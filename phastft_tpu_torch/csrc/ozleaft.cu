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
// Design: a block holds 64/A whole rows k1 (8192 points, v as 128 KB of dd
// values in shared memory), and a cluster of A/8 blocks holds 8
// consecutive rows, so that the store writes whole 32-byte sectors. Both
// stages run the wgmma products of oz.cuh on tiles staged a depth chunk at
// a time, each warpgroup holding a 64 x 16 (at A = 8: 64 x 8) tile of 15
// tier sums, in passes of up to 2048 outputs. The DFT matrices' tiles come
// whole from the card table (ops/ozdd.py ozleaft_card) by one bulk copy
// each, two buffers; the data's are sliced by the threads:
// - stage 1: a pass takes COLS columns (k1, i_M) against KB = min(A, 32)
//   rows k_A of F(A); a group of COLS columns finds its scales once (a
//   max over i_A from device memory) and runs A/KB passes, each chunk's
//   loads started before the previous chunk's products. Its output, times
//   the correction, goes to v.
// - stage 2: 64 rows (k1, k_A) of v, scaled by a max over i_M, against 32
//   rows k_M of F(128) a pass, four passes: each F(128) tile serves the
//   block's 64 rows, each sliced value of v 32 rows k_M.
// - after each stage-2 pass the block folds its 64 x 32 results into a
//   buffer laid out (k_M, k_A, row); after a cluster barrier each block
//   gathers, for its share of the pass's (k_A, k_M), the 8 rows from the
//   cluster's blocks (distributed shared memory, float4 reads: a block's
//   share is contiguous in every block's buffer) and stores them as two
//   float4s a plane. A second barrier frees the buffer.
// - One block (226 KB of shared memory) an SM.
#include <cooperative_groups.h>
#include <cstdint>

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "oz.cuh"

namespace cg = cooperative_groups;
namespace ddk = phastft::ddk;
namespace oz = phastft::oz;

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 128;          // the second factor M
constexpr int BLOCK_POINTS = 8192;  // 64 / A rows of A * 128 points
constexpr int VROWS = BLOCK_POINTS / LANES;  // rows (k1, k_A) of stage 2
constexpr int ROWS = 8;             // rows k1 a cluster: one 32-byte sector
constexpr int KM_PASS = 32;         // rows k_M of F(128) a stage-2 pass
// Shared memory in words: two constant tiles of up to 32 rows of a 16-deep
// chunk; the data region: two stage-2 tiles of 64 rows, the pass's result
// buffer over the second, and stage 1's one or two tiles.
constexpr int F_WORDS = oz::NSETS * 32 * 8;
constexpr int V_WORDS = oz::NSETS * VROWS * 8;
constexpr int W_WORDS = 4 * KM_PASS * VROWS;
constexpr int D_REGION = V_WORDS + W_WORDS;
constexpr int MAX_COLS = 128;
constexpr size_t SMEM = sizeof(float) * (4 * BLOCK_POINTS + 2 * F_WORDS + D_REGION +
                                         3 * MAX_COLS);

struct Tabs {
  oz::SliceSet fa;        // F(A) slices, (A, A)
  oz::SliceSet fm;        // F(128) slices, (128, 128)
  const float* corr[4];   // W_n2^(k_A*i_M), (A, 128)
  const uint16_t* card;   // the F(A) and F(128) tiles of ops/ozdd.py ozleaft_card
};

// Stage 1's passes at A: KB rows k_A of F(A) against COLS columns (k1, i_M),
// the two warpgroups splitting the rows k_A (KB = 32: N = 16 each) or the
// columns (64 each, N = KB); G column groups of H passes; depth chunks of CH.
template <int A>
struct Stage1 {
  static constexpr int KB = A < 32 ? A : 32;
  static constexpr int N = KB == 32 ? 16 : KB;
  static constexpr bool SPLIT_N = KB == 32;
  static constexpr int COLS = SPLIT_N ? 64 : 128;
  static constexpr int G = BLOCK_POINTS / A / COLS;
  static constexpr int H = A / KB;
  static constexpr int CH = A < 16 ? A : 16;
  static constexpr int TILE = oz::NSETS * COLS * 8;
  static constexpr int NBUF = 2 * TILE <= D_REGION ? 2 : 1;
  // half-words of stage 1's tiles in the card table (H x A / CH tiles)
  static constexpr long long CARD = static_cast<long long>(H) * (A / CH) * oz::NSETS * KB * 16;
  static_assert(TILE <= D_REGION && KB <= 32, "stage 1 tiles");
};

template <int A>
__global__ void __launch_bounds__(THREADS, 1)
ozleaft_kernel(ddk::ConstQuad x, Tabs tabs, ddk::Quad out, int n1) {
  using S1 = Stage1<A>;
  constexpr int RB = BLOCK_POINTS / (A * LANES);  // rows k1 a block
  constexpr int C = ROWS / RB;                    // blocks a cluster
  extern __shared__ float4 smem4[];
  __shared__ __align__(8) uint64_t full[2];  // the two constant tiles' fills
  const ddk::Planes v = ddk::make_planes(reinterpret_cast<float*>(smem4), BLOCK_POINTS);
  uint32_t* fbuf = reinterpret_cast<uint32_t*>(v.p[0] + 4 * BLOCK_POINTS);  // [2][F_WORDS]
  uint32_t* dreg = fbuf + 2 * F_WORDS;
  float* wbuf = reinterpret_cast<float*>(dreg + V_WORDS);  // over the second stage-2 tile
  float* csig = reinterpret_cast<float*>(dreg + D_REGION);
  float* cinv = csig + MAX_COLS;
  unsigned* cmax = reinterpret_cast<unsigned*>(cinv + MAX_COLS);

  const int rank = C > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const long long cid = blockIdx.x / C;
  const int clusters_per_entry = n1 / ROWS;
  const long long b = cid / clusters_per_entry;
  const int k1c = static_cast<int>(cid % clusters_per_entry) * ROWS;  // the cluster's rows
  const int r0 = k1c + rank * RB;                                      // the block's rows
  const long long n = static_cast<long long>(n1) * A * LANES;
  const long long plane = static_cast<long long>(n1) * LANES;  // x[.., i_A + 1, ..]
  const long long xrow0 = b * n + static_cast<long long>(r0) * LANES;  // x[b, 0, r0, 0]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;

  if (tid < 2) oz::mbar_init(full + tid);
  if (S1::CH == 8) {
    // a depth of 8: the upper core matrices of the data tile stay zero (the
    // card's F(8) tiles hold their zeros)
    for (int w = tid; w < S1::TILE; w += THREADS) dreg[w] = 0u;
  }
  oz::mbar_fence_init();
  // thread 0 starts a constant tile's bulk copy; every thread waits for
  // buffer buf's next fill (fills[buf] counts them: the phase parity)
  unsigned fills[2] = {0u, 0u};
  auto start = [&](int buf, const uint16_t* src, uint32_t bytes) {
    if (tid == 0) {
      oz::mbar_expect(full + buf, bytes);
      oz::bulk_copy(fbuf + buf * F_WORDS, src, bytes, full + buf);
    }
  };
  auto wait = [&](int buf) { oz::mbar_wait(full + buf, fills[buf]++ & 1); };

  // ---- stage 1: F(A) over i_A for the block's RB*128 columns, then the correction
  {
    const int a0 = S1::SPLIT_N ? 0 : 64 * wg, b0 = S1::SPLIT_N ? 16 * wg : 0;
    constexpr int W1 = S1::CH / 2;  // words a tile row holds of a chunk
    constexpr int ITS = S1::COLS * W1 / THREADS;  // (column, depth pair)s a thread
    ddk::ddc pre[ITS][2];
    for (int grp = 0; grp < S1::G; ++grp) {
      const int cbase = grp * S1::COLS;
      if (tid < S1::COLS) cmax[tid] = 0u;
      __syncthreads();
      {
        constexpr int PER = THREADS / S1::COLS;  // threads a column
        const int c = tid % S1::COLS;
        float mx = 0.f;
#pragma unroll 4
        for (int ia = tid / S1::COLS; ia < A; ia += PER) {
          const long long o = xrow0 + ia * plane + cbase + c;
          mx = fmaxf(mx, fmaxf(fabsf(__ldg(x.p[0] + o)), fabsf(__ldg(x.p[2] + o))));
        }
        atomicMax(cmax + c, __float_as_uint(mx));  // mx >= 0
      }
      __syncthreads();
      if (tid < S1::COLS) oz::sigma_of(__uint_as_float(cmax[tid]), csig[tid], cinv[tid]);
      for (int h = 0; h < S1::H; ++h) {
        oz::Tiers<S1::N / 2> acc;
        acc.zero();
        auto copy = [&](int c, int buf) {
          start(buf, tabs.card + (h * (A / S1::CH) + c) * oz::NSETS * S1::KB * 16,
                oz::tile_bytes(S1::KB));
        };
        // part 0 loads the chunk's values of the thread's ITS (column,
        // depth pair)s, part 1 slices them
        auto fill = [&](int c, int buf, int part) {
#pragma unroll
          for (int it = 0; it < ITS; ++it) {
            const int j = lane % W1;
            const int col = lane / W1 + (32 / W1) * (warp + 8 * it);
            if (part == 0) {
              const long long o = xrow0 + (c * S1::CH + 2 * j) * plane + cbase + col;
#pragma unroll
              for (int h = 0; h < 2; ++h)
                pre[it][h] = ddk::ddc{ddk::dd{__ldg(x.p[0] + o + h * plane),
                                              __ldg(x.p[1] + o + h * plane)},
                                      ddk::dd{__ldg(x.p[2] + o + h * plane),
                                              __ldg(x.p[3] + o + h * plane)}};
            } else {
              if (c == 0 && it == 0) __syncthreads();  // the scales, before the first barrier
              oz::put_pair(dreg + buf * S1::TILE, S1::COLS, col, j, pre[it][0], pre[it][1],
                           cinv[col]);
            }
          }
        };
        auto tiles = [&](int buf) {
          return oz::tile_pair(dreg + buf * S1::TILE, S1::COLS, a0, fbuf + buf * F_WORDS, S1::KB,
                               b0);
        };
        oz::depth_loop<S1::NBUF, true>(A / S1::CH, acc, copy, wait, fill, tiles);
#pragma unroll
        for (int e = 0; e < S1::N / 2; ++e) {
          const int cl = a0 + oz::acc_row(e);
          const int cc = cbase + cl;
          const int rr = cc / LANES, im = cc % LANES;
          const int ka = h * S1::KB + b0 + oz::acc_col(e);
          const int k = ka * LANES + im;
          const ddk::ddc w{ddk::dd{__ldg(tabs.corr[0] + k), __ldg(tabs.corr[1] + k)},
                           ddk::dd{__ldg(tabs.corr[2] + k), __ldg(tabs.corr[3] + k)}};
          ddk::store(v, rr * A * LANES + k, oz::cmul(acc.fold_at(e, csig[cl]), w));
        }
        __syncthreads();  // the tiles and scales are rewritten next
      }
    }
  }

  // ---- stage 2: F(128) over i_M for the block's 64 rows (k1, k_A), 32 k_M a pass
  for (int vr = warp; vr < VROWS; vr += THREADS / 32) {
    float mx = 0.f;
    for (int im = lane; im < LANES; im += 32)
      mx = fmaxf(mx, fmaxf(fabsf(v.p[0][vr * LANES + im]), fabsf(v.p[2][vr * LANES + im])));
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, s));
    if (lane == 0) oz::sigma_of(mx, csig[vr], cinv[vr]);
  }
  for (int pass = 0; pass < LANES / KM_PASS; ++pass) {
    oz::Tiers<8> acc;
    acc.zero();
    auto copy = [&](int c, int buf) {
      start(buf, tabs.card + S1::CARD + (pass * (LANES / 16) + c) * oz::NSETS * KM_PASS * 16,
            oz::tile_bytes(KM_PASS));
    };
    auto fill = [&](int c, int buf, int it) {  // two parts: one row group of 32 each
      if (c == 0 && it == 0) __syncthreads();  // v's scales, before the first barrier
      {
        const int j = lane & 7;
        const int vr = (lane >> 3) + 4 * (warp + 8 * it);
        const int at = vr * LANES + c * 16 + 2 * j;
        oz::put_pair(dreg + buf * V_WORDS, VROWS, vr, j, ddk::load(v, at), ddk::load(v, at + 1),
                     cinv[vr]);
      }
    };
    auto tiles = [&](int buf) {
      return oz::tile_pair(dreg + buf * V_WORDS, VROWS, 0, fbuf + buf * F_WORDS, KM_PASS, 16 * wg);
    };
    oz::depth_loop<2, false>(LANES / 16, acc, copy, wait, fill, tiles);
    __syncthreads();  // the result buffer lies over the last chunk's tile

    // fold into (k_M, k_A, row) order: the 8 rows of one (k_A, k_M) of a
    // cluster are RB-float runs of its C blocks
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int vr = oz::acc_row(e);
      const int kml = 16 * wg + oz::acc_col(e);
      const int rr = vr / A, ka = vr % A;
      const ddk::ddc w = acc.fold_at(e, csig[vr]);
      const int at = kml * VROWS + ka * RB + rr;
      wbuf[at] = w.re.hi;
      wbuf[W_WORDS / 4 + at] = w.re.lo;
      wbuf[2 * W_WORDS / 4 + at] = w.im.hi;
      wbuf[3 * W_WORDS / 4 + at] = w.im.lo;
    }
    if (C > 1) cg::this_cluster().sync(); else __syncthreads();

    // this block's share of the pass's (k_A, k_M): pairs q = 256 rank ..
    // 256 rank + 255 (k_M = q / A, k_A = q % A), whose RB words a block
    // holds at q * RB. Thread (plane, f) takes pairs q0 .. q0 + 3: RB
    // float4s from each of the C blocks, then 8 contiguous rows a pair.
    {
      const int pl = tid >> 6, q0 = rank * THREADS + 4 * (tid & 63);
      float val[4][ROWS];
#pragma unroll
      for (int jb = 0; jb < C; ++jb) {
        const float* src = wbuf;
        if (C > 1) src = cg::this_cluster().map_shared_rank(wbuf, jb);
        src += pl * (W_WORDS / 4) + q0 * RB;
#pragma unroll
        for (int v4 = 0; v4 < RB; ++v4) {
          const float4 t = *reinterpret_cast<const float4*>(src + 4 * v4);
          const float u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) val[(4 * v4 + e) / RB][jb * RB + (4 * v4 + e) % RB] = u[e];
        }
      }
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        const int q = q0 + pp, kml = q / A, ka = q % A;
        const long long o =
            b * n + static_cast<long long>((pass * KM_PASS + kml) * A + ka) * n1 + k1c;
        float4* dst = reinterpret_cast<float4*>(out.p[pl] + o);
        dst[0] = make_float4(val[pp][0], val[pp][1], val[pp][2], val[pp][3]);
        dst[1] = make_float4(val[pp][4], val[pp][5], val[pp][6], val[pp][7]);
      }
    }
    if (C > 1) cg::this_cluster().sync(); else __syncthreads();  // the buffer is free
  }
}

using Kernel = void (*)(ddk::ConstQuad, Tabs, ddk::Quad, int);

Kernel kernel_for(int a) {
  switch (a) {
    case 8: return ozleaft_kernel<8>;
    case 16: return ozleaft_kernel<16>;
    case 32: return ozleaft_kernel<32>;
    default: return ozleaft_kernel<64>;
  }
}

// d (rows x cols) = sum_q a_q (rows x depth) x bt_q^T (bt_q: cols x depth),
// bf16 in, f32 out, by the kernels' own product path: each 16-deep chunk
// of every pair copied with cp.async into shared-memory tiles in the
// kernels' layout, A loaded with ldmatrix, and wgmma m64n16k16 (B from a
// descriptor) accumulating all pairs and chunks
// in place in one accumulator, chunk after chunk and pair after pair, as a
// tier's slice pairs are. One warpgroup a 64 x 16 tile.
constexpr int EXACT_MAX_PAIRS = 5;

__global__ void oz_exact_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ bt,
                                float* __restrict__ d, int pairs, int rows, int cols, int depth) {
  __shared__ __align__(128) uint32_t ta[EXACT_MAX_PAIRS * 64 * 8];
  __shared__ __align__(128) uint32_t tb[EXACT_MAX_PAIRS * 16 * 8];
  const int tiles_n = cols / 16;
  const int r0 = (blockIdx.x / tiles_n) * 64, n0 = (blockIdx.x % tiles_n) * 16;
  float acc[8] = {};
  const uint32_t ab = oz::smem_addr(ta);
  const uint32_t bb = oz::smem_addr(tb);
  for (int k0 = 0; k0 < depth; k0 += 16) {
    for (int q = threadIdx.x; q < pairs * 80 * 2; q += blockDim.x) {
      const int s = q / 160, r = (q / 2) % 80, h = q % 2;
      if (r < 64)
        oz::cp_async16(ta + s * 64 * 8 + oz::tile_word(r, 4 * h),
                       a + (static_cast<long long>(s) * rows + r0 + r) * depth + k0 + 8 * h);
      else
        oz::cp_async16(tb + s * 16 * 8 + oz::tile_word(r - 64, 4 * h),
                       bt + (static_cast<long long>(s) * cols + n0 + r - 64) * depth + k0 + 8 * h);
    }
    oz::cp_async_commit();
    oz::cp_async_wait_all();
    oz::fence_async_smem();
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 8; ++e) asm volatile("" : "+f"(acc[e])::"memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int s = 0; s < pairs; ++s) {
      uint32_t af[4];
      oz::ldmatrix_a(af, ab + s * 64 * 32);
      oz::wgmma(acc, af, oz::desc(bb + s * 16 * 32));
    }
    oz::wgmma_commit();
    oz::wgmma_wait();
#pragma unroll
    for (int e = 0; e < 8; ++e) asm volatile("" : "+f"(acc[e])::"memory");
    __syncthreads();
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    d[static_cast<long long>(r0 + oz::acc_row(e)) * cols + n0 + oz::acc_col(e)] = acc[e];
}

int log2_of(int a) { return a == 8 ? 3 : a == 16 ? 4 : a == 32 ? 5 : 6; }

}  // namespace

// ptrs: the four input planes of (batch, A, n1, 128); the 15 F(A) and the
// 15 F(128) slice arrays (bf16); the correction (A, 128) 4-tuple (f32); the
// four output planes of (batch, n1 * A * 128); the card table of the F(A)
// and F(128) tiles (ops/ozdd.py ozleaft_card): 43 device pointers in the
// order of ops/ozdd.py's ozleaft. A = 8..64 and n1 = 128..2048, powers of
// two: batch * n1/8 clusters of A/8 blocks. Returns the CUDA error code of
// the launch; a cluster shape that does not fit the device is refused.
extern "C" int phastft_ozleaft(void* const* ptrs, long long batch, int a, int n1,
                               void* stream) {
  if (batch < 1 || !phastft::is_pow2(a) || a < 8 || a > 64 || !phastft::is_pow2(n1) ||
      n1 < 128 || n1 > 2048)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = BLOCK_POINTS / (a * LANES);
  const long long blocks = batch * (n1 / rows);
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
  tabs.card = static_cast<const uint16_t*>(next());
  static int resident[7] = {};
  return phastft::launch_clusters(kernel_for(a), a / 8, blocks, THREADS, SMEM,
                                  static_cast<cudaStream_t>(stream), resident[log2_of(a)], x,
                                  tabs, out, n1);
}

// The clusters of ozleaft at A (8..64: 1..8 blocks) the current device
// holds at once (the CUDA occupancy query), or minus the CUDA error code.
extern "C" int phastft_ozleaft_clusters(int a) {
  if (a != 8 && a != 16 && a != 32 && a != 64) return -static_cast<int>(cudaErrorInvalidValue);
  return phastft::resident_clusters(kernel_for(a), a / 8, THREADS, SMEM);
}

// a (pairs x rows x depth) and bt (pairs x cols x depth): integer-valued
// bf16 arrays; d (rows x cols) f32 = sum over the pairs of a_q x bt_q^T by
// the tensor-core product path of the oz kernels alone. pairs 1..5, rows a
// multiple of 64, cols and depth of 16.
extern "C" int phastft_oz_exact(const void* a, const void* bt, float* d, int pairs, int rows,
                                int cols, int depth, void* stream) {
  if (pairs < 1 || pairs > EXACT_MAX_PAIRS || rows < 64 || rows % 64 || cols < 16 ||
      cols % 16 || depth < 16 || depth % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  oz_exact_kernel<<<(rows / 64) * (cols / 16), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(bt), d, pairs, rows, cols,
      depth);
  return static_cast<int>(cudaGetLastError());
}
