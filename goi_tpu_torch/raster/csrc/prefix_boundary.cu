// Block prefix fused with the segment reduce's boundary read-out: for
// each block of `blk` rows of a row-major (nb * blk, d) float32 matrix,
// its exclusive row prefix (kept in shared memory, never written out),
// then lb[g] = that prefix at row p[g] for every boundary g with p[g] in
// the block, and the block's totals. Boundaries at nb * blk (the stream's
// end) read the trailing zero block: lb[g] = 0.
//
// Replaces goi_tpu/raster/pallas_blend.py `_prefix_boundary_kernel`
// (launched by `_dense_boundary_reduce`), which compacted a block's
// boundary values by a rank one-hot matmul on the MXU and DMA'd the
// compacted tile to the block's first boundary index, split over two
// parity outputs with 8-sublane pads. None of that carries over: a block
// finds its boundaries [g0, g1) by a binary search of p and writes each
// one's row directly. p only has to be non-decreasing, so repeated
// bounds (the chain's clamp at m - 1 and m under a budget overflow) need
// nothing special, and no segment-start indicator is needed.
//
// The scan is csrc/block_scan.cuh, the same code and order as
// csrc/prefix.cu, so lb equals prefix_blocks' inner[p] bit for bit and
// the reduce built on it equals blocked_segment_reduce's.
//
// Bound on the H100: bytes. It reads the rows and the bounds once and
// writes lb (n + 1, d) and the totals once, with one add per element;
// against prefix.cu + the boundary gather it saves the full (nb + 1) *
// blk * d prefix write and its read back.

#include <cuda_runtime.h>
#include <cstdint>

#include "block_scan.cuh"

namespace {

constexpr int THREADS = goi_scan::THREADS;

// first g in [0, n) with p[g] >= v (n if none), p non-decreasing
__device__ int first_at_least(const long long* __restrict__ p, int n,
                               long long v) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (p[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
prefix_boundary_kernel(const float* __restrict__ rows, int d, int nb,
                       int blk, const long long* __restrict__ p,
                       int n_bounds, float* __restrict__ lb,
                       float* __restrict__ tot) {
  extern __shared__ float sh[];
  __shared__ int range[2];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long first = (long long)b * blk;
  if (tid == 0) {
    range[0] = first_at_least(p, n_bounds, first);
    range[1] =
        b == nb ? n_bounds : first_at_least(p, n_bounds, first + blk);
  }
  __syncthreads();
  const int g0 = range[0];
  const long long count = (long long)(range[1] - g0) * d;
  float* out = lb + (long long)g0 * d;
  if (b == nb) {  // boundaries at the stream's end: the zero block
    for (long long e = tid; e < count; e += THREADS) out[e] = 0.f;
    return;
  }
  goi_scan::exclusive_scan(rows + first * d, nullptr, d, blk, sh,
                           tot + (long long)b * d);
  for (long long e = tid; e < count; e += THREADS) {
    const int g = (int)(e / d);
    const int c = (int)(e - (long long)g * d);
    const int r = (int)(p[g0 + g] - first);
    out[e] = sh[goi_scan::slot(r, c, blk)];
  }
}

}  // namespace

// rows (nb * blk, d), p (n_bounds,) int64 non-decreasing in [0, nb * blk],
// lb (n_bounds, d), tot (nb, d); blk a multiple of 32. Returns
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int goi_prefix_boundary(const void* rows, int d, int nb, int blk,
                                   const void* p, int n_bounds, void* lb,
                                   void* tot, void* stream) {
  if (blk <= 0 || blk % 32 != 0 || d <= 0 || nb < 0 || n_bounds < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = goi_scan::smem_bytes(d, blk);
  cudaError_t err = cudaFuncSetAttribute(
      prefix_boundary_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  prefix_boundary_kernel<<<nb + 1, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(rows), d, nb, blk,
      static_cast<const long long*>(p), n_bounds, static_cast<float*>(lb),
      static_cast<float*>(tot));
  return (int)cudaGetLastError();
}
