// Block-local exclusive row scan, shared by csrc/prefix.cu and
// csrc/prefix_boundary.cu so that both produce the same bits (each loads
// the rows its own way and calls scan_columns).
//
// A block of `blk` rows of a row-major (blk, d) float32 matrix goes
// through shared memory column-major with a skew: column c, row r at
// c * (blk + 33) + r + r / run, run = blk / 32. The row-major fill
// (neighbouring columns) and the scan (lanes run + 1 apart) both hit
// distinct banks. Of a CTA of NT threads, warp w scans columns w, w +
// NT / 32, ...: lane l sums its run of blk / 32 consecutive rows, a
// shuffle scan over the 32 lanes gives each run its offset, and the lane
// writes its run's exclusive prefix in place. Which warp takes a column
// does not change its sums, so the result is the same for every NT and
// on every run.

#pragma once

#include <cuda_runtime.h>

namespace goi_scan {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline size_t smem_bytes(int d, int blk) {
  return sizeof(float) * (size_t)d * (size_t)(blk + 33);
}

// RUN = blk / 32 when the caller knows it at compile time (the skew's
// division becomes a shift, the scan's loops have a constant trip count
// and unroll; the same order of sums), 0 otherwise.
template <int RUN = 0>
__device__ __forceinline__ int slot(int r, int c, int blk) {
  const int run = RUN > 0 ? RUN : blk / 32;
  return c * (blk + 33) + r + r / run;
}

// Replaces the block's rows, loaded into sh at slot(r, c, blk), by their
// exclusive prefix and writes the block's column totals to tot (d
// floats). Every thread of the block (NT threads) must call it after a
// barrier that follows the loads; it ends with a barrier, after which sh
// holds the prefix.
template <int RUN = 0, int NT = THREADS>
__device__ __forceinline__ void scan_columns(int d, int blk, float* sh,
                                             float* __restrict__ tot) {
  const int tid = threadIdx.x;
  const int run = RUN > 0 ? RUN : blk / 32;
  const int lane = tid & 31;
  for (int c = tid >> 5; c < d; c += NT / 32) {
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
