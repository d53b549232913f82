// Paired transpose on 64-bit words, the native f64 engine's four-step output
// reordering, for sm_90a.
//
// Stands for: the XLA transpose of the JAX package's native f64 engine,
// _out_transpose (phastft_tpu/ops/fourstep.py:149), on each classic split
// level. transpose.cu moves 32-bit words for the f32 pipeline; this is its
// counterpart for doubles, with no TPU kernel behind it.
//
// For both arrays and every batch b:  out[b, c, r] = in[b, r, c].
//
// Bound: memory, and nothing else: 8 B read and 8 B written per double, no
// arithmetic but one multiply a value by out_scale on the way out (1, or
// 1/N where this transpose ends an inverse: the same bits as a separate
// multiply after the kernel, without its second pass over memory). All the
// design can do is keep both sides of the copy contiguous.
//
// Design (transpose.cu's, for 8-byte words): a block moves one (TR, TC) tile
// of each array through shared memory. It reads rows of TC contiguous
// doubles, neighbouring threads on neighbouring addresses, and writes rows
// of TR contiguous doubles the same way. A tile holds at most 2048 doubles
// of each array (16 KB, as transpose.cu's 4096 floats): TR = min(R, 32) and
// TC = min(C, 2048 / TR), so for the shallow column factors of the native
// plans (R = n1 = 2..512) the tile covers all of R when R < 32: its TC
// output rows are one contiguous span of TC * R doubles. Tiles divide the
// arrays exactly.
//
// Padding for 8-byte words: a warp's 8-byte access is served a half-warp
// (16 lanes, 128 bytes) at a time, so the transposed read (thread -> r
// fastest, then c) must touch 16 different 8-byte banks in each half. For
// TR >= 16 a row stride of TC + 1 does it (r * (TC + 1) + c is one bank per
// r); for TR < 16 a half-warp reads TR rows at 16/TR neighbouring columns,
// and a stride of TC + 16/TR makes r * 16/TR + c one bank each.
//
// The batch and the tile grid are folded into gridDim.x (up to 2^31 - 1
// blocks); device-memory offsets are 64-bit.
#include <cuda_runtime.h>

#include "fft_smem.cuh"

namespace {

constexpr int kLogTile = 11;  // doubles of one array per block
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
transpose2_64_kernel(const double* __restrict__ a, const double* __restrict__ b,
                     double* __restrict__ oa, double* __restrict__ ob, int logr, int logc,
                     int logtr, int logtc, int stride, double out_scale) {
  extern __shared__ double tile64[];
  double* ta = tile64;
  double* tb = tile64 + (stride << logtr);
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

// a, b: (batch, rows, cols) doubles; oa, ob: (batch, cols, rows); rows and
// cols powers of two up to 2^30, batch * rows * cols < 2^62; out_scale: the
// factor of every output. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int phastft_transpose2_64(const double* a, const double* b, double* oa, double* ob,
                                     long long batch, long long rows, long long cols,
                                     double out_scale, void* stream) {
  if (batch < 1 || rows < 1 || cols < 1 || (rows & (rows - 1)) || (cols & (cols - 1)) ||
      rows > (1LL << 30) || cols > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int logr = phastft::ilog2(static_cast<int>(rows));
  const int logc = phastft::ilog2(static_cast<int>(cols));
  const int logtr = logr < 5 ? logr : 5;
  const int logtc = logc < kLogTile - logtr ? logc : kLogTile - logtr;
  const int stride = (1 << logtc) + (logtr < 4 ? 16 >> logtr : 1);
  const long long blocks = batch << (logr - logtr + logc - logtc);
  if (blocks > 0x7fffffffLL || (blocks >> (logr - logtr + logc - logtc)) != batch)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * sizeof(double) * (static_cast<size_t>(stride) << logtr);
  transpose2_64_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(a, b, oa, ob, logr, logc, logtr,
                                                              logtc, stride, out_scale);
  return static_cast<int>(cudaGetLastError());
}
