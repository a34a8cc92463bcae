// Block-windowed monotone row gather: for a row-major (n, c) float32
// table and a non-decreasing index idx (m,), block b of `blk` indices
// has the window lo = min(idx[b * blk], n - span), and
//   out[i, :] = table[idx[i], :]  if 0 <= idx[i] - lo < span, else 0,
// bit-exact.
//
// Replaces examples/micro_sortpayload.py `_mono_kernel` (the JAX
// package's micro-benchmark, blk = 1024, span = 2048), which DMA'd the
// block's span-row window into VMEM and gathered from it by a (blk x
// span) one-hot matmul on the MXU, so an index past the window produced
// a zero row. The zero row is kept as the function's semantics; the
// window copy and the one-hot product are not: a GPU gathers natively.
//
// Bound on the H100: bytes. It reads the index once and the table rows
// it names, writes m * c floats, and does no arithmetic.
//
// Design. The first version ran one thread per output float with two
// 64-bit divisions (a software routine of dozens of instructions each on
// the GPU) and two dependent index loads before each 4-byte copy (0.363
// ms against a bound of 0.102, PERF.md). Now one CTA takes one block of
// blk indices: it reads the window start lo once, then its threads copy
// the block's rows in 16-byte pieces (24 floats are 6 float4s), a thread
// stepping its (row, piece) by the CTA's width without a division and
// issuing UNROLL index loads, then UNROLL row loads, then UNROLL
// streaming stores, so that many loads are in flight. All index math is
// 32-bit (the wrapper keeps n * c and m * c under 2^31). When c is not a
// multiple of 4 or a pointer is not 16-byte aligned, the same kernel
// copies single floats (V = float).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// cv: a row's width in V; the table (n, cv) and out (m, cv) in V.
template <typename V>
__global__ void __launch_bounds__(THREADS)
mono_rows_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                 V* __restrict__ out, int cv, int n, int m, int blk,
                 int span) {
  const int i0 = blockIdx.x * blk;
  const int first = idx[i0];
  const int lo = first < n - span ? first : n - span;
  const int rows = min(blk, m - i0);
  const int total = rows * cv;
  // this thread's pieces e = tid + k * THREADS: row e / cv, piece e % cv
  const int dr = THREADS / cv;
  const int dq = THREADS - dr * cv;
  int r = threadIdx.x / cv;
  int q = threadIdx.x - r * cv;
  for (int e0 = threadIdx.x; e0 < total; e0 += THREADS * UNROLL) {
    int at[UNROLL];    // the piece's place in out
    int pq[UNROLL];    // its piece of the row
    int ix[UNROLL];    // its table row (lo - 1, outside the window, past
                       // the block's end)
    V v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      at[u] = (i0 + r) * cv + q;
      pq[u] = q;
      ix[u] = e0 + u * THREADS < total ? idx[i0 + r] : lo - 1;
      r += dr;
      q += dq;
      if (q >= cv) {
        q -= cv;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int local = ix[u] - lo;    // 0 <= local < span: in the window
      v[u] = local >= 0 && local < span ? __ldg(table + ix[u] * cv + pq[u])
                                        : zero<V>();
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (e0 + u * THREADS < total) __stcs(out + at[u], v[u]);
  }
}

}  // namespace

// table (n, c) and out (m, c) float32 row-major, idx (m,) int32; n * c
// and m * c under 2^31. vec: copy float4s (c % 4 == 0 and table and out
// 16-byte aligned) or single floats.
extern "C" int goi_mono_rows(const void* table, const void* idx, void* out,
                             int c, int n, int m, int blk, int span, int vec,
                             void* stream) {
  if (c <= 0 || blk <= 0 || span <= 0 || n < 0 || m < 0)
    return (int)cudaErrorInvalidValue;
  if (m > 0) {
    const unsigned grid = (unsigned)((m + blk - 1) / blk);
    const cudaStream_t st = (cudaStream_t)stream;
    const int* ix = static_cast<const int*>(idx);
    if (vec) {
      mono_rows_kernel<float4><<<grid, THREADS, 0, st>>>(
          static_cast<const float4*>(table), ix, static_cast<float4*>(out),
          c / 4, n, m, blk, span);
    } else {
      mono_rows_kernel<float><<<grid, THREADS, 0, st>>>(
          static_cast<const float*>(table), ix, static_cast<float*>(out), c,
          n, m, blk, span);
    }
  }
  return (int)cudaGetLastError();
}
