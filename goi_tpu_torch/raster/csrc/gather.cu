// Expansion gathers, feature-major: out[c, r] = table[c, g(r)], bit-exact.
//
// `goi_expand_gather` replaces two pieces of the TPU binning at once:
// goi_tpu/raster/gather.py `_kernel` (launched by `monotone_gather`, a
// block-diagonal one-hot matmul on the MXU) and the slot -> Gaussian map
// that feeds it, a scatter of each Gaussian's first slot plus a cummax
// (goi_tpu/raster/binning.py:414-416), which the TPU took because a
// binary search costs log(N) serialized gather rounds there. On the GPU
// the map is a search: with cb(g) = min(base[g], m - 1) the clamped
// exclusive slot bases (non-decreasing, cb(0) = 0),
//   g(r) = (number of g with cb(g) <= r) - 1,
// which equals the cummax of the amax scatter bit for bit, overflow
// included: every Gaussian clamped onto slot m - 1 makes g(m - 1) = N - 1,
// the highest id, as amax keeps. `goi_monotone_gather` is the same copy
// with g read from an index stream (the public `monotone_gather`).
//
// Bound on the H100: bytes (no arithmetic). The fused kernel reads the
// (C, N) table and the int64 bases once and writes g_stream (m int32)
// and the (C, m) rows once. The design serves that:
// - a block owns SLOTS = 1024 consecutive slots. Every Gaussian has at
//   least one slot, so those slots span at most SLOTS + 1 Gaussians
//   from the block's first one, g0 = g(r0): warp 0 finds g0 by a 32-way
//   search of the bases in device memory (4 rounds for N = 1M), the
//   block stages the window cb(g0 .. g0 + SLOTS) in shared memory, and
//   each thread resolves its 4 consecutive slots there (one binary
//   search, then a step per slot);
// - each thread writes its 4 slots of g_stream and of every feature row
//   as one 16-byte store (a warp writes 512 contiguous bytes a row);
//   scalar stores when m is not a multiple of 4;
// - table reads go through the read-only path; consecutive slots map to
//   the same or neighbouring Gaussians, so a warp's reads of a row fall
//   in one or two cache lines.
// No cummax, no scatter and no (m,) mark buffer remain.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;                    // slots per thread
constexpr int SLOTS = THREADS * VEC;      // slots per block
constexpr unsigned FULL = 0xffffffffu;

// out[k, r + q] = table[k, g[q]] for every row k; VEC_STORE: one 16-byte
// store per row (needs m % 4 == 0 and r + VEC <= m).
template <bool VEC_STORE>
__device__ __forceinline__ void copy_rows(const float* __restrict__ table,
                                          long long n, int c,
                                          const int (&g)[VEC],
                                          float* __restrict__ out,
                                          long long m, long long r) {
#pragma unroll 2
  for (int k = 0; k < c; ++k) {
    const float* t = table + (long long)k * n;
    float v[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) v[q] = __ldg(t + g[q]);
    float* o = out + (long long)k * m + r;
    if (VEC_STORE) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q)
        if (r + q < m) o[q] = v[q];
    }
  }
}

template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
monotone_gather_kernel(const float* __restrict__ table,
                       const int* __restrict__ idx, float* __restrict__ out,
                       int c, long long n, long long m) {
  const long long r = ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (r >= m) return;
  int g[VEC];
  if (ALIGNED && r + VEC <= m) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(idx + r));
    g[0] = v.x; g[1] = v.y; g[2] = v.z; g[3] = v.w;
    copy_rows<true>(table, n, c, g, out, m, r);
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q) g[q] = __ldg(idx + min(r + q, m - 1));
    copy_rows<false>(table, n, c, g, out, m, r);
  }
}

__device__ __forceinline__ long long clamped_base(
    const long long* __restrict__ base, long long g, long long m) {
  return min(__ldg(base + g), m - 1);
}

template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
expand_gather_kernel(const float* __restrict__ table,
                     const long long* __restrict__ base,
                     int* __restrict__ g_stream, float* __restrict__ out,
                     int c, long long n, long long m) {
  __shared__ long long first;
  __shared__ int win[SLOTS + 1];   // cb(first + i); INT_MAX past N
  const long long r0 = (long long)blockIdx.x * SLOTS;
  const int tid = threadIdx.x;

  // the block's first Gaussian: the last g with cb(g) <= r0, by a 32-way
  // search (lanes probe 32 evenly spaced ids; cb(0) = 0 <= r0, so lane 0
  // always qualifies and the answer stays in [lo, hi))
  if (tid < 32) {
    long long lo = 0;
    long long hi = n;
    while (hi - lo > 1) {
      const long long stride = (hi - lo + 31) / 32;
      const long long probe = lo + tid * stride;
      const bool le = probe < hi && clamped_base(base, probe, m) <= r0;
      const int last = 31 - __clz(__ballot_sync(FULL, le));
      lo += last * stride;
      hi = min(hi, lo + stride);
    }
    if (tid == 0) first = lo;
  }
  __syncthreads();
  const long long g0 = first;
  for (int i = tid; i <= SLOTS; i += THREADS) {
    const long long g = g0 + i;
    win[i] = g < n ? (int)clamped_base(base, g, m) : INT_MAX;
  }
  __syncthreads();

  const long long r = r0 + (long long)tid * VEC;
  if (r >= m) return;
  // the last window index with win[i] <= r (win[0] <= r0 <= r); a slot
  // below m - 1 lies at most r - r0 Gaussians past g0, so the window
  // holds its answer and the next base above it
  int lo = 0;
  int hi = min(tid * VEC, SLOTS - 1) + 1;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (win[mid] <= r) lo = mid; else hi = mid;
  }
  int g[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    const long long rq = min(r + q, m - 1);
    if (rq == m - 1) {
      // every Gaussian based at or past m - 1 is clamped onto that
      // slot: the last id owns it
      g[q] = (int)(n - 1);
    } else {
      while (win[lo + 1] <= rq) ++lo;
      g[q] = (int)(g0 + lo);
    }
  }
  if (ALIGNED && r + VEC <= m) {
    *reinterpret_cast<int4*>(g_stream + r) = make_int4(g[0], g[1], g[2],
                                                       g[3]);
    copy_rows<true>(table, n, c, g, out, m, r);
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q)
      if (r + q < m) g_stream[r + q] = g[q];
    copy_rows<false>(table, n, c, g, out, m, r);
  }
}

unsigned blocks(long long m, long long per_block) {
  return (unsigned)((m + per_block - 1) / per_block);
}

}  // namespace

// aligned: m % 4 == 0 and idx 16-byte aligned (the wrapper checks).
extern "C" int goi_monotone_gather(const void* table, const void* idx,
                                   void* out, int c, long long n,
                                   long long m, int aligned, void* stream) {
  if (m > 0 && c > 0) {
    const float* t = static_cast<const float*>(table);
    const int* i = static_cast<const int*>(idx);
    float* o = static_cast<float*>(out);
    cudaStream_t st = (cudaStream_t)stream;
    const unsigned grid = blocks(m, SLOTS);
    if (aligned)
      monotone_gather_kernel<true><<<grid, THREADS, 0, st>>>(t, i, o, c, n,
                                                             m);
    else
      monotone_gather_kernel<false><<<grid, THREADS, 0, st>>>(t, i, o, c, n,
                                                              m);
  }
  return (int)cudaGetLastError();
}

// base: (n,) int64 exclusive slot bases of counts >= 1 (non-decreasing,
// base[0] = 0), clamped here to m - 1; m < 2^31; aligned: m % 4 == 0.
extern "C" int goi_expand_gather(const void* table, const void* base,
                                 void* g_stream, void* out, int c,
                                 long long n, long long m, int aligned,
                                 void* stream) {
  if (m > 0 && n > 0) {
    const float* t = static_cast<const float*>(table);
    const long long* b = static_cast<const long long*>(base);
    int* g = static_cast<int*>(g_stream);
    float* o = static_cast<float*>(out);
    cudaStream_t st = (cudaStream_t)stream;
    const unsigned grid = blocks(m, SLOTS);
    if (aligned)
      expand_gather_kernel<true><<<grid, THREADS, 0, st>>>(t, b, g, o, c, n,
                                                           m);
    else
      expand_gather_kernel<false><<<grid, THREADS, 0, st>>>(t, b, g, o, c,
                                                            n, m);
  }
  return (int)cudaGetLastError();
}
