// The read-out and whole-block term of the blocked segment reduce: for
// non-decreasing bounds p (n + 1,) int64 and q = p / blk,
//
//   out[g, c] = (L[hi, c] - L[lo, c]) + sum_{q[g] <= b < q[g + 1]} tot[b, c]
//
// where L is the block-local exclusive prefix read at the segment's two
// bounds and tot the row blocks' totals. L comes in one of two forms:
// - indexed: the prefix of every row, inner ((nb + 1) * blk, d) from
//   csrc/prefix.cu, read at rows (lo, hi) = (p[g], p[g + 1]);
// - not indexed: lb (n + 1, d) from csrc/prefix_boundary.cu, already read
//   out at the bounds, so (lo, hi) = (g, g + 1).
//
// Replaces the glue around the prefix kernels in goi_tpu/raster/
// pallas_blend.py `_blocked_segment_reduce` and `_dense_boundary_reduce`:
// the boundary gather `inner.at[p]` (:367-378), the difference `lb[1:] -
// lb[:-1]` and the block owners' `jax.ops.segment_sum(tot, gb)` (:382-389,
// :622-629), which XLA runs as a scatter-add on the TPU. Float atomics
// would make the sums' order change from run to run, so every (g, c) has
// one thread that
// adds its segment's block totals itself: one fp32 accumulator from +0.0,
// in ascending b, then (L diff) + accumulator. raster/reduce.py
// `owner_sums_plain` adds in the same order, so the two agree bit for bit.
// Repeated bounds (the chain's clamp under a budget overflow) give an
// empty block term; a segment may span any number of blocks.
//
// Bound on the H100: bytes. Per (g, c) it reads two values of L and the
// totals of its segment's blocks and writes one value, with one add per
// block. A warp's loads of L's rows, of the bounds and of tot[b] and its
// stores are coalesced: (g, c) runs c fastest (the second read of a row
// of L, as the next segment's lo, mostly hits L1 or L2); all in 32-bit
// indices (the wrapper keeps every array under 2^31 elements).
//
// Design. The first version ran one thread per (g, c): its loads of the
// bounds, then of L, then of the totals depend on one another, and with
// one value a thread the card ran ~74 waves of that chain of latencies
// at the main path's 1M x 20 (0.144 ms against a bound of 0.050,
// PERF.md). Now a thread takes ITEMS values a block-width apart and
// issues each stage's loads for all of them before it waits on any; its
// divisions by d and by blk (~20 instructions each as a 32-bit division,
// four a value) are a multiply-high and a shift by the host's constants.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;   // (g, c) values a thread reads and writes

// x / div for 0 <= x < 2^31 as (x * mul) >> (32 + shift), with mul =
// ceil(2^(31 + l) / div) and l = ceil(log2(div)) (division by an
// invariant integer, Granlund and Montgomery): x mul / 2^(31 + l) exceeds
// x / div by less than x / 2^(31 + l) < 1 / div, so the floor is exact.
struct FastDiv {
  unsigned mul, shift, div;
};

FastDiv fast_div(unsigned div) {
  FastDiv f{0u, 0u, div};
  if (div == 1) return f;
  unsigned l = 0;
  while ((1u << l) < div) ++l;
  f.mul = (unsigned)(((1ull << (31 + l)) + div - 1) / div);
  f.shift = l - 1;
  return f;
}

__device__ __forceinline__ int quo(int x, FastDiv f) {
  return f.div == 1 ? x : (int)(__umulhi((unsigned)x, f.mul) >> f.shift);
}

__global__ void __launch_bounds__(THREADS)
owner_sums_kernel(const float* __restrict__ L, int indexed,
                  const long long* __restrict__ p, int n, FastDiv d,
                  const float* __restrict__ tot, FastDiv blk,
                  float* __restrict__ out) {
  // unsigned: a last block's values may run past 2^31 - 1
  const unsigned total = (unsigned)n * d.div;
  const unsigned base = blockIdx.x * (THREADS * ITEMS) + threadIdx.x;
  int g[ITEMS], c[ITEMS], p0[ITEMS], p1[ITEMS];
  float hi[ITEMS], lo[ITEMS];
  // past the end a thread reads the last value again and stores nothing
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int e = (int)min(base + k * THREADS, total - 1);
    g[k] = quo(e, d);
    c[k] = e - g[k] * d.div;
    p0[k] = (int)p[g[k]];
    p1[k] = (int)p[g[k] + 1];
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    hi[k] = L[(indexed ? p1[k] : g[k] + 1) * d.div + c[k]];
    lo[k] = L[(indexed ? p0[k] : g[k]) * d.div + c[k]];
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const unsigned e = base + k * THREADS;
    if (e >= total) break;
    float acc = 0.f;
    const int q1 = quo(p1[k], blk);
    for (int b = quo(p0[k], blk); b < q1; ++b) acc += tot[b * d.div + c[k]];
    out[e] = (hi[k] - lo[k]) + acc;
  }
}

}  // namespace

// L (rows, d) float32: inner ((nb + 1) * blk, d) if indexed, else lb
// (n + 1, d); p (n + 1,) int64 non-decreasing in [0, nb * blk]; tot (nb,
// d); out (n, d); every array under 2^31 elements. Returns
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int goi_owner_sums(const void* L, int indexed, const void* p,
                              int n, int d, const void* tot, int blk,
                              void* out, void* stream) {
  if (n < 0 || d < 0 || blk <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)n * d;
  if (total == 0) return (int)cudaSuccess;
  const long long per_block = THREADS * ITEMS;
  owner_sums_kernel<<<(unsigned)((total + per_block - 1) / per_block),
                      THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(L), indexed,
      static_cast<const long long*>(p), n, fast_div(d),
      static_cast<const float*>(tot), fast_div(blk),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
