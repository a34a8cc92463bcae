// Block-local exclusive row scan, shared by csrc/prefix.cu and
// csrc/prefix_boundary.cu so that both produce the same bits.
//
// A block of `blk` rows of a row-major (blk, d) float32 matrix goes
// through shared memory column-major with a skew: column c, row r at
// c * (blk + 33) + r + r / run, run = blk / 32. The row-major fill
// (neighbouring columns) and the scan (lanes run + 1 apart) both hit
// distinct banks. Warp w scans columns w, w + 8, ...: lane l sums its run
// of blk / 32 consecutive rows, a shuffle scan over the 32 lanes gives
// each run its offset, and the lane writes its run's exclusive prefix in
// place. The order is fixed, so the result is the same on every run.

#pragma once

#include <cuda_runtime.h>

namespace goi_scan {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline size_t smem_bytes(int d, int blk) {
  return sizeof(float) * (size_t)d * (size_t)(blk + 33);
}

__device__ __forceinline__ int slot(int r, int c, int blk) {
  return c * (blk + 33) + r + r / (blk / 32);
}

// Loads the block's rows (scaled by okf[r] when okf is not null) into
// sh, replaces them by their exclusive prefix and writes the block's
// column totals to tot (d floats). Every thread of the block must call
// it; it ends with a barrier, after which sh holds the prefix.
__device__ __forceinline__ void exclusive_scan(const float* __restrict__ in,
                                               const float* __restrict__ okf,
                                               int d, int blk, float* sh,
                                               float* __restrict__ tot) {
  const int tid = threadIdx.x;
  const int n = blk * d;
  const int run = blk / 32;
  for (int e = tid; e < n; e += THREADS) {
    const int r = e / d;
    const int c = e - r * d;
    float x = in[e];
    if (okf != nullptr) x *= okf[r];
    sh[slot(r, c, blk)] = x;
  }
  __syncthreads();
  const int lane = tid & 31;
  for (int c = tid >> 5; c < d; c += THREADS / 32) {
    float* col = sh + c * (blk + 33) + lane * (run + 1);
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
    if (lane == 31) tot[c] = acc;
  }
  __syncthreads();
}

}  // namespace goi_scan
