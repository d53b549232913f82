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
// which are never contracted; slices round half to even, as torch.round
// and jnp.round. A kernel and its plain version then agree bit for bit.
//
// The products are wgmma.m64n16k16 (m64n8k16 for F(8)), bf16 in, f32
// accumulated in place, on operands that a block stages in shared memory
// one depth chunk at a time (16 values, or 8 when the depth is 8) as
// "tiles": for each of the NSETS slice arrays, `rows` rows of 8 32-bit
// words, two bf16 of the depth per word (the lower half the even depth), in
// wgmma's K-major layout without swizzle (tile_word). The data tile is a
// warpgroup's 64 rows (its A operand, each warp's 16 rows loaded into
// registers with ldmatrix), the constant tile its N rows (B, read through a
// shared-memory descriptor). Slices are stored as the upper 16 bits of
// their float (exact for integers of 8 significant bits).
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
  // rint(r * K) as (r * K + 1.5 * 2^23) - 1.5 * 2^23: |r * K| <= 129, so
  // the sum rounds to an integer, half to even, as rintf does (a zero may
  // come out +0 where rintf gives -0: the same slice value). r * K and
  // s * IK are exact (powers of two), so the fused forms round as the
  // separate operations do.
  constexpr float MAGIC = 12582912.0f;
  float r = __fmul_rn(vh, inv);
#pragma unroll
  for (int j = 0; j < NSLICES; ++j) {
    const float sj = __fsub_rn(__fmaf_rn(r, K[j], MAGIC), MAGIC);
    s[j] = sj;
    r = __fmaf_rn(-sj, IK[j], r);
    if (j == 2) r = __fadd_rn(r, __fmul_rn(vl, inv));
  }
}

// oz_slice_complex for one element: the bf16 bits of the slices of re, im
// and of their exact dd sum (against inv / 2), in set order.
__device__ __forceinline__ void slice_bits(const ddk::ddc& x, float inv, uint32_t (&w)[NSETS]) {
  float s[NSLICES];
  slice_data(x.re.hi, x.re.lo, inv, s);
#pragma unroll
  for (int j = 0; j < NSLICES; ++j) w[j] = to_bf16(s[j]);
  slice_data(x.im.hi, x.im.lo, inv, s);
#pragma unroll
  for (int j = 0; j < NSLICES; ++j) w[NSLICES + j] = to_bf16(s[j]);
  const float sh = __fadd_rn(x.re.hi, x.im.hi);
  const float b = __fsub_rn(sh, x.re.hi);
  const float sl = __fadd_rn(__fadd_rn(__fsub_rn(x.re.hi, __fsub_rn(sh, b)),
                                       __fsub_rn(x.im.hi, b)),
                             __fadd_rn(x.re.lo, x.im.lo));
  slice_data(sh, sl, __fmul_rn(inv, 0.5f), s);
#pragma unroll
  for (int j = 0; j < NSLICES; ++j) w[2 * NSLICES + j] = to_bf16(s[j]);
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

// Word j (depth 2j, 2j + 1) of row r of a tile slice array: the canonical
// K-major layout of wgmma without swizzle, core matrices of 8 rows x 16
// bytes (8 depths), the two core matrices of a 16-deep chunk 128 bytes
// apart (LBO), groups of 8 rows 256 bytes apart (SBO).
__device__ __forceinline__ int tile_word(int r, int j) {
  return (r >> 3) * 64 + (j >> 2) * 32 + (r & 7) * 4 + (j & 3);
}

// Writes the slices of two dd values of consecutive depth (2j, 2j + 1) of
// row r into a tile of `rows` rows: one word per slice array.
__device__ __forceinline__ void put_pair(uint32_t* tile, int rows, int r, int j,
                                         const ddk::ddc& x0, const ddk::ddc& x1, float inv) {
  uint32_t a[NSETS], b[NSETS];
  slice_bits(x0, inv, a);
  slice_bits(x1, inv, b);
  const int at = tile_word(r, j);
#pragma unroll
  for (int s = 0; s < NSETS; ++s) tile[s * rows * 8 + at] = a[s] | (b[s] << 16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A thread's asynchronous copies into shared memory, in groups it commits
// and waits for itself (ozcol's raw values, oz_exact's tiles).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// Waits until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// mbarriers for bulk copies: one arrival (the thread that starts a fill,
// with the bytes to expect), completed by the copies' transactions.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Waits for the phase of the given parity (the fill's count mod 2).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// A bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// device memory into this block's shared memory, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Bytes of a tile of `rows` rows (the card tables of ops/ozdd.py hold the
// tiles in this layout, one after the other).
__host__ __device__ constexpr uint32_t tile_bytes(int rows) { return NSETS * rows * 32; }

// Tier sums of a warpgroup's 64 x N output tile, E = N / 2 accumulator
// elements a thread (wgmma's layout: element e of warp w's lane (g, t) is
// row 16w + g + 8 * ((e >> 1) & 1), column 8 * (e >> 2) + 2t + (e & 1)).
template <int E>
struct Tiers {
  float v[NOPS][MAXTIER + 1][E];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int op = 0; op < NOPS; ++op)
#pragma unroll
      for (int s = 0; s <= MAXTIER; ++s)
#pragma unroll
        for (int e = 0; e < E; ++e) v[op][s][e] = 0.f;
  }

  // Keeps the compiler from moving accumulator reads or writes across the
  // asynchronous products.
  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int op = 0; op < NOPS; ++op)
#pragma unroll
      for (int s = 0; s <= MAXTIER; ++s)
#pragma unroll
        for (int e = 0; e < E; ++e) asm volatile("" : "+f"(v[op][s][e])::"memory");
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

// Row and column of accumulator element e in a warpgroup's tile.
__device__ __forceinline__ int acc_row(int e) {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) + 8 * ((e >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int e) {
  return 8 * (e >> 2) + 2 * (threadIdx.x & 3) + (e & 1);
}

// Shared-memory matrix descriptor of a tile slice array from byte address
// addr: no swizzle, LBO 128 bytes, SBO 256 bytes (tile_word).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// d += A x B^T on the tensor cores: a warpgroup's m64nNk16, bf16 in, f32
// accumulate, A (the warp's 16 rows of the 64) from registers in the
// m16n8k16 A fragment layout, B K-major from a shared-memory descriptor.
__device__ __forceinline__ void wgmma(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The warp's A fragment (its 16 rows of a warpgroup's 64) of one slice
// array of a tile from byte address base (row 0): four core matrices.
__device__ __forceinline__ void ldmatrix_a(uint32_t (&f)[4], uint32_t base) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  const uint32_t at = base + (2 * ((threadIdx.x >> 5) & 3) + (mi & 1)) * 256 + (mi >> 1) * 128 +
                      (lane & 7) * 16;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
               : "r"(at));
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Orders this thread's shared-memory writes (stores and cp.async) before
// the tensor cores' reads of them; a barrier then orders the block's.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory byte addresses of a warpgroup's operand tiles: the data
// tile a (64 rows from a0, a_rows rows a slice array) and the constant tile
// b (N rows from b0, b_rows rows a slice array).
struct TilePair {
  uint32_t a, b;
  int a_set, b_set;  // bytes a slice array
};

__device__ __forceinline__ TilePair tile_pair(const uint32_t* a, int a_rows, int a0,
                                              const uint32_t* b, int b_rows, int b0) {
  return TilePair{smem_addr(a) + (a0 >> 3) * 256, smem_addr(b) + (b0 >> 3) * 256,
                  a_rows * 32, b_rows * 32};
}

// Opens a depth chunk's products: the accumulators are the tensor cores'
// from here to finish_products.
template <int E>
__device__ __forceinline__ void begin_products(Tiers<E>& acc) {
  acc.fence();
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Issues (without waiting) operand op's share of a depth chunk's products:
// the warp's rows of the data tile's five slices of op into registers a
// (which must stay as they are until the products are done), then the 15
// slice pairs (i + j <= MAXTIER), data slice j against constant slice i,
// each tier accumulated in place in one f32 accumulator (exact: integers
// below 2^24, oz_exact). A warpgroup issues the three operands in turn,
// other work between them, then commits.
template <int E>
__device__ __forceinline__ void products_op(Tiers<E>& acc, const TilePair& t, int op,
                                            uint32_t (&a)[NSLICES][4]) {
#pragma unroll
  for (int j = 0; j < NSLICES; ++j) ldmatrix_a(a[j], t.a + (op * NSLICES + j) * t.a_set);
#pragma unroll
  for (int i = 0; i < NSLICES; ++i)
#pragma unroll
    for (int j = 0; i + j <= MAXTIER && j < NSLICES; ++j)
      wgmma(acc.v[op][i + j], a[j], desc(t.b + (op * NSLICES + i) * t.b_set));
}

// Waits for the warpgroup's committed products.
template <int E>
__device__ __forceinline__ void finish_products(Tiers<E>& acc) {
  wgmma_wait();
  acc.fence();
}

// The depth loop of a block: `chunks` chunks, each a constant tile that
// copy(c, buf) starts (a bulk copy) and wait(buf) waits for, and a data
// tile that fill(c, buf, part) makes in two parts; tiles(buf) gives the
// warpgroup's TilePair. With two buffers the next chunk's copy is started
// and its two fill parts run beside the three operands' products of this
// one, one barrier a chunk: between the batches, or with PREFETCH (a fill
// whose first part starts loads from device memory that its second part
// uses) the first part before the products and the second after. With one
// buffer, two barriers a chunk. Returns with the products done.
template <int NBUF, bool PREFETCH, int E, typename Copy, typename Wait, typename Fill,
          typename Tiles>
__device__ __forceinline__ void depth_loop(int chunks, Tiers<E>& acc, Copy copy, Wait wait,
                                           Fill fill, Tiles tiles) {
  if (NBUF == 2) {
    copy(0, 0);
    fill(0, 0, 0);
    fill(0, 0, 1);
    for (int c = 0; c < chunks; ++c) {
      wait(c & 1);
      fence_async_smem();
      __syncthreads();
      const bool next = c + 1 < chunks;
      if (next) copy(c + 1, (c + 1) & 1);
      const TilePair t = tiles(c & 1);
      uint32_t a[NOPS][NSLICES][4];
      if (PREFETCH && next) fill(c + 1, (c + 1) & 1, 0);
      begin_products(acc);
      products_op(acc, t, 0, a[0]);
      if (!PREFETCH && next) fill(c + 1, (c + 1) & 1, 0);
      products_op(acc, t, 1, a[1]);
      if (!PREFETCH && next) fill(c + 1, (c + 1) & 1, 1);
      products_op(acc, t, 2, a[2]);
      wgmma_commit();
      if (PREFETCH && next) fill(c + 1, (c + 1) & 1, 1);
      finish_products(acc);
    }
  } else {
    for (int c = 0; c < chunks; ++c) {
      copy(c, 0);
      fill(c, 0, 0);
      fill(c, 0, 1);
      wait(0);
      fence_async_smem();
      __syncthreads();
      const TilePair t = tiles(0);
      uint32_t a[NOPS][NSLICES][4];
      begin_products(acc);
      products_op(acc, t, 0, a[0]);
      products_op(acc, t, 1, a[1]);
      products_op(acc, t, 2, a[2]);
      wgmma_commit();
      finish_products(acc);
      __syncthreads();
    }
  }
}

}  // namespace oz
}  // namespace phastft
