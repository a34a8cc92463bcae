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
// serves that: a block of blk rows goes through shared memory, skewed so
// that the loads and stores of device memory are coalesced row-major and
// the scan reads are free of bank conflicts (csrc/block_scan.cuh, shared
// with csrc/prefix_boundary.cu). The order is fixed, so the result is
// the same on every run.

#include <cuda_runtime.h>
#include <cstdint>

#include "block_scan.cuh"

namespace {

constexpr int THREADS = goi_scan::THREADS;

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
  goi_scan::exclusive_scan(
      rows + (long long)b * n,
      okf == nullptr ? nullptr : okf + (long long)b * blk, d, blk, sh,
      tot + (long long)b * d);
  for (int e = tid; e < n; e += THREADS) {
    const int r = e / d;
    const int c = e - r * d;
    out[e] = sh[goi_scan::slot(r, c, blk)];
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
  const size_t smem = goi_scan::smem_bytes(d, blk);
  cudaError_t err = cudaFuncSetAttribute(
      prefix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  prefix_kernel<<<nb + 1, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(rows), static_cast<const float*>(okf), d,
      nb, blk, static_cast<float*>(inner), static_cast<float*>(tot));
  return (int)cudaGetLastError();
}
