// Block-local exclusive row prefix: for each block of `blk` rows of a
// row-major (nb * blk, d) float32 matrix, optionally masked row by row,
// the exclusive prefix sum of its rows and its total; one more block of
// zero prefixes after the last.
//
// Replaces goi_tpu/raster/pallas_blend.py `_prefix_kernel` (launched by
// `_prefix_blocks` inside `_blocked_segment_reduce`), which ran the scan
// as strict-lower triangular matmuls on the MXU in 128-row pieces. The
// prefix never leaves its block: the segment reduce reads a segment's
// sum as a difference of two block-local prefixes plus whole-block
// totals, so rounding scales with one block's magnitude, not the
// stream's (PARITY.md deviation 9).
//
// Bound on the H100: bytes. It reads the rows (and mask) once and writes
// the prefixes and totals once, with one add per element. The design
// serves that: a block of blk rows goes through shared memory,
// column-major with a skew, so the loads and stores of device memory
// are coalesced row-major and the scan reads are free of bank
// conflicts. Warp w scans columns w, w + 8, ...: lane l sums its run of
// blk / 32 consecutive rows, a shuffle scan over the 32 lanes gives each
// run its offset, and the lane writes its run's exclusive prefix. The
// order is fixed, so the result is the same on every run.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
prefix_kernel(const float* __restrict__ rows, const float* __restrict__ okf,
              int d, int nb, int blk, float* __restrict__ inner,
              float* __restrict__ tot) {
  extern __shared__ float sh[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = blk * d;
  float* out = inner + (long long)b * n;
  if (b == nb) {  // the trailing zero block
    for (int e = tid; e < n; e += THREADS) out[e] = 0.f;
    return;
  }
  const int run = blk / 32;
  // column c, row r at c * stride + r + r / run: the skew makes both the
  // row-major fill (neighbouring columns) and the scan (lanes run + 1
  // apart) hit distinct banks
  const int stride = blk + 33;
  const float* in = rows + (long long)b * n;
  for (int e = tid; e < n; e += THREADS) {
    const int r = e / d;
    const int c = e - r * d;
    float x = in[e];
    if (okf != nullptr) x *= okf[(long long)b * blk + r];
    sh[c * stride + r + r / run] = x;
  }
  __syncthreads();
  const int lane = tid & 31;
  for (int c = tid >> 5; c < d; c += THREADS / 32) {
    float* col = sh + c * stride + lane * (run + 1);
    float s = 0.f;
    for (int i = 0; i < run; ++i) s += col[i];
    float incl = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += y;
    }
    float acc = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) acc = 0.f;
    for (int i = 0; i < run; ++i) {
      const float x = col[i];
      col[i] = acc;
      acc += x;
    }
    if (lane == 31) tot[(long long)b * d + c] = acc;
  }
  __syncthreads();
  for (int e = tid; e < n; e += THREADS) {
    const int r = e / d;
    const int c = e - r * d;
    out[e] = sh[c * stride + r + r / run];
  }
}

}  // namespace

// rows (nb * blk, d), okf (nb * blk) or null, inner ((nb + 1) * blk, d),
// tot (nb, d); blk a multiple of 32. Returns cudaErrorInvalidValue for
// a shape the kernel does not take (shared memory past the card's limit).
extern "C" int goi_prefix_blocks(const void* rows, const void* okf, int d,
                                 int nb, int blk, void* inner, void* tot,
                                 void* stream) {
  if (blk <= 0 || blk % 32 != 0 || d <= 0 || nb < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)d * (size_t)(blk + 33);
  cudaError_t err = cudaFuncSetAttribute(
      prefix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  prefix_kernel<<<nb + 1, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(rows), static_cast<const float*>(okf), d,
      nb, blk, static_cast<float*>(inner), static_cast<float*>(tot));
  return (int)cudaGetLastError();
}
