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
// reads its boundaries [first[b], first[b + 1]) from a table and writes
// each one's row directly. p only has to be non-decreasing, so repeated
// bounds (the chain's clamp at m - 1 and m under a budget overflow) need
// nothing special, and no segment-start indicator is needed.
//
// The scan is csrc/block_scan.cuh's scan_columns, the same code and order
// as csrc/prefix.cu, so lb equals prefix_blocks' inner[p] bit for bit and
// the reduce built on it equals blocked_segment_reduce's.
//
// Bound on the H100: bytes. It reads the rows and the bounds once and
// writes lb (n + 1, d) and the totals once, with one add per element;
// against prefix.cu + the boundary gather it saves the full (nb + 1) *
// blk * d prefix write and its read back.
//
// Design. The first version ran one CTA per block: thread 0 binary-
// searched the 1M int64 bounds twice (~40 dependent loads) while the
// other 255 threads waited, then load, scan and read-out ran strictly in
// turn, and the read-out divided in 64 bits per element (0.469 ms
// against a bound of 0.143, PERF.md). Now:
// - first_bounds_kernel writes first[b] = the number of bounds below
//   b * blk for b in [0, nb + 1], one thread per bound filling the
//   blocks that start after its predecessor and at or before it (every
//   entry once, no search; raster/reduce.py `block_first_bounds_plain`
//   is its plain twin); the wrapper launches it once per call, before
//   the prefix kernel's one launch per column slice;
// - persistent CTAs (as many as fit on the card: 4 per SM at d = 20)
//   take blocks b, b + grid, ...; the rows stream into shared memory by
//   cp.async, all of a thread's copies in flight at once;
// - the copies go straight to the scan's skewed slots, a thread
//   stepping its (row, column) by the block size;
// - the scan is block_scan.cuh's scan_columns, prefix.cu's code, with
//   the run blk / 32 a compile-time constant for blocks of 128, 256 and
//   512 rows (the skew a shift, the loops unrolled, the same order of
//   sums; ahead of the runtime run by 10-25% at d = 20, PERF.md);
// - the block's bounds are loaded one per thread while its rows land,
//   so the read-out waits on no global load; a block of up to 256 bounds
//   and 4096 values reads its values into registers, lets the next
//   block's copies start, then stores them, coalesced (others: warp per
//   bound, lane per column); all in 32-bit indices (the wrapper keeps
//   every array under 2^31 elements).
// Lost on the H100 (PERF.md): a second shared buffer per CTA that takes
// the next block while the current one is scanned (2 CTAs per SM at
// d = 20, against 4 with one).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "block_scan.cuh"

namespace {

constexpr int THREADS = goi_scan::THREADS;
constexpr int WARPS = THREADS / 32;

// first[b] = g for the blocks b with p[g - 1] < b * blk <= p[g] (p[-1] =
// -inf, p[n] = +inf), so first[b] counts the bounds below b * blk.
__global__ void first_bounds_kernel(const long long* __restrict__ p, int n,
                                    int nb, int blk, int* __restrict__ first) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g > n) return;
  const int lo = g == 0 ? 0 : max((int)p[g - 1] / blk + 1, 0);
  const int hi = g == n ? nb + 1 : min((int)p[g] / blk, nb + 1);
  for (int b = lo; b <= hi; ++b) first[b] = g;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy this thread issued has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// This thread's copies of block b's rows into buf at slot(r, c): element
// e = r * d + c for e = tid, tid + THREADS, ...
template <int RUN>
__device__ __forceinline__ void load_block(const float* __restrict__ rows,
                                           int d, int blk, int b,
                                           float* buf) {
  const float* src = rows + b * blk * d;
  const int n = blk * d;
  const int dr = THREADS / d;
  const int dc = THREADS - dr * d;
  int r = threadIdx.x / d;
  int c = threadIdx.x - r * d;
  for (int e = threadIdx.x; e < n; e += THREADS) {
    cp_async4(buf + goi_scan::slot<RUN>(r, c, blk), src + e);
    r += dr;
    c += dc;
    if (c >= d) {
      c -= d;
      ++r;
    }
  }
}

constexpr int OUT_REGS = 16;   // read-out values a thread holds

// RUN = blk / 32 as a compile-time constant (block_scan.cuh), 0 for any
// block size.
template <int RUN>
__global__ void __launch_bounds__(THREADS)
prefix_boundary_kernel(const float* __restrict__ rows, int d, int nb,
                       int blk, const long long* __restrict__ p,
                       int n_bounds, const int* __restrict__ first,
                       float* __restrict__ lb, float* __restrict__ tot) {
  extern __shared__ float sh[];
  __shared__ int at[THREADS];   // a round of bounds' rows, as slot bases
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int b = blockIdx.x;
  if (b < nb) {
    load_block<RUN>(rows, d, blk, b, sh);
    cp_async_commit();
  }
  for (; b < nb; b += gridDim.x) {
    const int nxt = b + gridDim.x;
    // the block's first round of bounds, loaded while its rows land
    const int g0 = first[b];
    const int count = first[b + 1] - g0;
    const int row0 = b * blk;
    const long long pv = tid < count ? p[g0 + tid] : 0;
    cp_async_wait_all();
    if (tid < count) at[tid] = goi_scan::slot<RUN>((int)pv - row0, 0, blk);
    __syncthreads();
    goi_scan::scan_columns<RUN>(d, blk, sh, tot + b * d);
    if (count <= THREADS && count * d <= THREADS * OUT_REGS) {
      // the read-out in registers, so that the next block's rows are on
      // their way while this one's bounds are stored: element e =
      // k * THREADS + tid of the block's (count, d) rows of lb
      const int n_e = count * d;
      const int dg = THREADS / d;
      const int dc = THREADS - dg * d;
      int g = tid / d;
      int c = tid - g * d;
      float v[OUT_REGS];
#pragma unroll
      for (int k = 0; k < OUT_REGS; ++k) {
        if (k * THREADS + tid < n_e) v[k] = sh[c * (blk + 33) + at[g]];
        g += dg;
        c += dc;
        if (c >= d) {
          c -= d;
          ++g;
        }
      }
      __syncthreads();
      if (nxt < nb) {
        load_block<RUN>(rows, d, blk, nxt, sh);
        cp_async_commit();
      }
      float* o = lb + g0 * d;
#pragma unroll
      for (int k = 0; k < OUT_REGS; ++k)
        if (k * THREADS + tid < n_e) o[k * THREADS + tid] = v[k];
      continue;
    }
    // warp per bound, lane per column; rounds of THREADS bounds
    for (int k0 = 0; k0 < count; k0 += THREADS) {
      if (k0 > 0) {
        __syncthreads();
        if (tid < count - k0)
          at[tid] =
              goi_scan::slot<RUN>((int)p[g0 + k0 + tid] - row0, 0, blk);
        __syncthreads();
      }
      const int kn = min(THREADS, count - k0);
      for (int k = warp; k < kn; k += WARPS) {
        const float* src = sh + at[k];
        float* o = lb + (g0 + k0 + k) * d;
        for (int c = lane; c < d; c += 32) o[c] = src[c * (blk + 33)];
      }
    }
    __syncthreads();
    if (nxt < nb) {
      load_block<RUN>(rows, d, blk, nxt, sh);
      cp_async_commit();
    }
  }
  // boundaries at the stream's end: the zero block
  for (int g = first[nb] + blockIdx.x * WARPS + warp; g < n_bounds;
       g += gridDim.x * WARPS)
    for (int c = lane; c < d; c += 32) lb[g * d + c] = 0.f;
}

// The prefix kernel for blocks of 32 * RUN rows (RUN = 0: any), on as
// many persistent CTAs as fit.
template <int RUN>
int launch(const void* rows, int d, int nb, int blk, const void* p,
           int n_bounds, const void* first, void* lb, void* tot,
           size_t smem, int sms, void* stream) {
  // the attribute belongs to the current device: set it on every launch
  cudaError_t err = cudaFuncSetAttribute(
      prefix_boundary_kernel<RUN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, prefix_boundary_kernel<RUN>, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = std::max(1, std::min(nb, sms * std::max(per_sm, 1)));
  prefix_boundary_kernel<RUN><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(rows), d, nb, blk,
      static_cast<const long long*>(p), n_bounds,
      static_cast<const int*>(first), static_cast<float*>(lb),
      static_cast<float*>(tot));
  return (int)cudaGetLastError();
}

}  // namespace

// first (nb + 2,) int32 <- the block first-bound table of p (n_bounds,)
// int64 non-decreasing in [0, nb * blk].
extern "C" int goi_first_bounds(const void* p, int n_bounds, int nb,
                                int blk, void* first, void* stream) {
  if (blk <= 0 || nb < 0 || n_bounds < 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  first_bounds_kernel<<<n_bounds / threads + 1, threads, 0,
                        (cudaStream_t)stream>>>(
      static_cast<const long long*>(p), n_bounds, nb, blk,
      static_cast<int*>(first));
  return (int)cudaGetLastError();
}

// rows (nb * blk, d), p (n_bounds,) int64 non-decreasing in [0, nb * blk],
// first (nb + 2,) int32 its table from goi_first_bounds, lb (n_bounds,
// d), tot (nb, d); blk a multiple of 32, every array under 2^31
// elements. Runs the prefix kernel on as many persistent CTAs as fit.
// Returns cudaErrorInvalidValue for a shape the kernel does not take (a
// block past the card's shared memory).
extern "C" int goi_prefix_boundary(const void* rows, int d, int nb, int blk,
                                   const void* p, int n_bounds,
                                   const void* first, void* lb, void* tot,
                                   void* stream) {
  if (blk <= 0 || blk % 32 != 0 || d <= 0 || nb < 0 || n_bounds < 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  int sms = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = goi_scan::smem_bytes(d, blk);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  switch (blk / 32) {   // the blocks of 128, 256 and 512 rows unrolled
    case 4: return launch<4>(rows, d, nb, blk, p, n_bounds, first, lb, tot,
                             smem, sms, stream);
    case 8: return launch<8>(rows, d, nb, blk, p, n_bounds, first, lb, tot,
                             smem, sms, stream);
    case 16: return launch<16>(rows, d, nb, blk, p, n_bounds, first, lb,
                               tot, smem, sms, stream);
    default: return launch<0>(rows, d, nb, blk, p, n_bounds, first, lb, tot,
                              smem, sms, stream);
  }
}
