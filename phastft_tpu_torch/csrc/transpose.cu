// Paired transpose, the four-step's output reordering, f32, for sm_90a.
//
// Replaces: phastft_tpu/ops/pallas_transpose.py, transpose2_pallas (two f32
// arrays (R, C) -> (C, R) in one launch, 256-square tiles in VMEM).
//
// For both arrays and every batch b:  out[b, c, r] = in[b, r, c].
//
// Bound: memory, and nothing else: 4 B read and 4 B written per float, no
// arithmetic but one multiply a value by out_scale on the way out (1, or
// 1/N where this transpose ends an inverse: the same bits as a separate
// multiply after the kernel, without its second pass over memory). All the
// design can do is keep both sides of the copy contiguous.
//
// Design: a block moves one (TR, TC) tile of each array through shared
// memory. It reads rows of TC contiguous floats, neighbouring threads on
// neighbouring addresses, and writes rows of TR contiguous floats the same
// way. A tile holds at most 4096 floats: TR = min(R, 64) and
// TC = min(C, 4096 / TR), so for
// the shallow outer levels of the nested plans (R = 32 at 2^26, R = 2 on a
// classic plan of 2^17) the tile covers all of R: its TC output rows are
// one contiguous span of TC * R floats, and its reads are segments of
// TC * 4 bytes (512 B at R = 32). Unlike the TPU kernel it takes a batch
// and every power-of-two R, C >= 1; tiles divide the arrays exactly.
//
// Shared-memory rows are padded so that the transposed read (thread ->
// r fastest, then c) touches 32 different banks: for TR >= 32 a row stride
// of TC + 1, for TR < 32 a stride of TC + 32/TR (a warp then reads TR rows
// at 32/TR neighbouring columns, and r * 32/TR + c is one bank each).
//
// The batch and the tile grid are folded into gridDim.x (up to 2^31 - 1
// blocks); device-memory offsets are 64-bit.
#include <cuda_runtime.h>

#include "fft_smem.cuh"

namespace {

constexpr int kLogTile = 12;  // floats of one array per block
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
transpose2_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ oa, float* __restrict__ ob, int logr,
                  int logc, int logtr, int logtc, int stride, float out_scale) {
  extern __shared__ float tile[];
  float* ta = tile;
  float* tb = tile + (stride << logtr);
  const int tc = 1 << logtc, tr = 1 << logtr;

  // block -> (batch, row tile, column tile), column tiles fastest
  unsigned blk = blockIdx.x;
  const long long c0 = static_cast<long long>(blk & ((1u << (logc - logtc)) - 1)) << logtc;
  blk >>= logc - logtc;
  const long long r0 = static_cast<long long>(blk & ((1u << (logr - logtr)) - 1)) << logtr;
  const long long base = static_cast<long long>(blk >> (logr - logtr)) << (logr + logc);

  for (int e = threadIdx.x; e < (1 << (logtr + logtc)); e += kThreads) {
    const int r = e >> logtc, c = e & (tc - 1);
    const long long off = base + ((r0 + r) << logc) + c0 + c;
    ta[r * stride + c] = __ldg(a + off);
    tb[r * stride + c] = __ldg(b + off);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < (1 << (logtr + logtc)); e += kThreads) {
    const int c = e >> logtr, r = e & (tr - 1);
    const long long off = base + ((c0 + c) << logr) + r0 + r;
    oa[off] = ta[r * stride + c] * out_scale;
    ob[off] = tb[r * stride + c] * out_scale;
  }
}

}  // namespace

// a, b: (batch, rows, cols); oa, ob: (batch, cols, rows); rows and cols
// powers of two up to 2^30, batch * rows * cols < 2^62; out_scale: the
// factor of every output. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int phastft_transpose2(const float* a, const float* b, float* oa,
                                  float* ob, long long batch, long long rows,
                                  long long cols, double out_scale, void* stream) {
  if (batch < 1 || rows < 1 || cols < 1 || (rows & (rows - 1)) || (cols & (cols - 1)) ||
      rows > (1LL << 30) || cols > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int logr = phastft::ilog2(static_cast<int>(rows));
  const int logc = phastft::ilog2(static_cast<int>(cols));
  const int logtr = logr < 6 ? logr : 6;
  const int logtc = logc < kLogTile - logtr ? logc : kLogTile - logtr;
  const int stride = (1 << logtc) + (logtr < 5 ? 32 >> logtr : 1);
  const long long blocks = batch << (logr - logtr + logc - logtc);
  if (blocks > 0x7fffffffLL || (blocks >> (logr - logtr + logc - logtc)) != batch)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * sizeof(float) * (static_cast<size_t>(stride) << logtr);
  transpose2_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(a, b, oa, ob, logr, logc,
                                                           logtr, logtc, stride,
                                                           static_cast<float>(out_scale));
  return static_cast<int>(cudaGetLastError());
}
