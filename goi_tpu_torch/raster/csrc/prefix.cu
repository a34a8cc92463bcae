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
// the prefixes and totals once, with one add per element: at the main
// path's (4,857,856, 20) as many bytes as a device-to-device copy of the
// rows. The order of the sums is csrc/block_scan.cuh's scan_columns, the
// same code as csrc/prefix_boundary.cu's, so prefix_boundary's lb equals
// inner[p] bit for bit.
//
// Design. One CTA a block that loads, scans and stores in turn, with a
// division per element, reaches about half the bound, so:
// - persistent CTAs (as many as fit: one an SM at d = 20, where the ring
//   and the scan buffer take 130 KB of its 228) walk blocks b =
//   blockIdx.x, + gridDim.x, ...;
// - a block's rows are one contiguous run of blk * d * 4 bytes: one
//   thread brings it into a dense, row-major stage with one bulk copy of
//   the Tensor Memory Accelerator (cp.async.bulk, completion counted in
//   bytes on the stage's mbarrier), the mask (blk floats) with a second;
//   a ring of two stages keeps the next block in flight while one is
//   scanned, and the copies cost the threads no instructions;
// - the threads copy a stage into the scan's skewed slots (applying the
//   mask), scan_columns runs unchanged, and the threads copy the prefix
//   back, row-major, into the stage just consumed, which one bulk store
//   (cp.async.bulk.global.shared::cta) writes out; the stage is refilled
//   only after that store has read it (cp.async.bulk.wait_group.read);
// - rows too wide for the ring beside the scan buffer (d > 36 at 512-row
//   blocks) skip the stages: the threads load straight into the slots
//   and store straight from them, on the same persistent CTAs (two an SM
//   where two scan buffers fit), so a width the scan buffer takes is one
//   launch (the wrapper slices only past that, d > 106 at 512);
// - the run blk / 32 is a compile-time constant for blocks of 128, 256
//   and 512 rows (other sizes a runtime loop), and so is d for the main
//   path's 20 through the ring; a thread steps its (row, column) by the
//   CTA size, so no element divides, and every index is
//   32-bit (the wrapper keeps (nb + 1) * blk * d under 2^31);
// - the trailing zero block is written by the same launch, spread over
//   the CTAs, so one call is one launch.
// A bulk copy needs 16-byte-aligned addresses and sizes: blk % 32 == 0
// gives the sizes, and the entry point refuses a misaligned rows or okf.
// On the H100 at d = 20, rings of three and four stages and CTAs of 256
// threads were slower than two stages of 512 threads, and 1024 threads
// tied (PERF.md).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "block_scan.cuh"

namespace {

constexpr int STAGES = 2;   // the ring's depth
constexpr int NT = 512;     // threads a CTA: 20 columns in two warp rounds

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// the one arrival of the stage's phase, with the bytes its copies bring
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// returns once the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

// every committed bulk store has read its shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// every committed bulk store has completed
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// the threads' writes to shared memory, seen by the bulk store after the
// next barrier
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The ring's shared memory: STAGES row stages (blk * d floats each), then
// STAGES mask stages (blk floats), STAGES mbarriers and the scan buffer
// (block_scan.cuh smem_bytes). Every stage starts 16-byte aligned (blk *
// 4 is a multiple of 128).
__host__ __device__ inline size_t ring_bytes(int d, int blk) {
  return STAGES * (sizeof(float) * (size_t)blk * (size_t)(d + 1) +
                   sizeof(uint64_t)) +
         goi_scan::smem_bytes(d, blk);
}

// Element e = r * d + c of a row-major (blk, d) block, for e = tid, tid +
// NT, ...: the thread's (r, c) steps by NT without a division.
struct Walk {
  int r, c, dr, dc;
  __device__ __forceinline__ Walk(int d)
      : r(threadIdx.x / d), c(threadIdx.x - (threadIdx.x / d) * d),
        dr(NT / d), dc(NT - (NT / d) * d) {}
  __device__ __forceinline__ void step(int d) {
    r += dr;
    c += dc;
    if (c >= d) {
      c -= d;
      ++r;
    }
  }
};

// RUN = blk / 32 and D = d as compile-time constants (0: from the
// arguments). RING: the rows come in and go out through the ring's
// stages by bulk copies; otherwise the threads load and store them
// directly (and two CTAs an SM may fit).
template <int RUN, int D, bool RING>
__global__ void __launch_bounds__(NT, RING ? 1 : 2)
prefix_kernel(const float* __restrict__ rows, const float* __restrict__ okf,
              int d_arg, int nb, int blk_arg, float* __restrict__ inner,
              float* __restrict__ tot) {
  const int d = D > 0 ? D : d_arg;
  const int blk = RUN > 0 ? 32 * RUN : blk_arg;
  const int n = blk * d;   // floats a block
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  float* mask = stage + (RING ? STAGES * n : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(mask + (RING ? STAGES * blk
                                                            : 0));
  float* sh = reinterpret_cast<float*>(full + (RING ? STAGES : 0));
  const int tid = threadIdx.x;

  // the trailing zero block, spread over the CTAs (n % 4 == 0)
  float4* zero = reinterpret_cast<float4*>(inner + nb * n);
  for (int i = blockIdx.x * NT + tid; i < n / 4; i += gridDim.x * NT)
    zero[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  // this CTA's blocks: b_k = blockIdx.x + k * gridDim.x, k < trips
  const int trips =
      blockIdx.x < nb ? (nb - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const uint32_t bytes = 4u * (n + (okf != nullptr ? blk : 0));
  auto load = [&](int k) {   // thread 0: block b_k into stage k % STAGES
    const int s = k % STAGES;
    const int b = blockIdx.x + k * gridDim.x;
    mbar_expect(&full[s], bytes);
    bulk_load(stage + s * n, rows + b * n, 4u * n, &full[s]);
    if (okf != nullptr)
      bulk_load(mask + s * blk, okf + b * blk, 4u * blk, &full[s]);
  };
  if (RING && tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < min(STAGES - 1, trips); ++k) load(k);
  }
  __syncthreads();

  const Walk start(d);
  for (int k = 0; k < trips; ++k) {
    const int s = k % STAGES;
    const int b = blockIdx.x + k * gridDim.x;
    // the block's rows and mask: its stage, or global memory
    const float* in = RING ? stage + s * n : rows + b * n;
    const float* m = okf == nullptr ? nullptr
                     : RING         ? mask + s * blk
                                    : okf + b * blk;
    if (RING) mbar_wait(&full[s], (uint32_t)(k / STAGES) & 1u);
    // the rows into the scan's skewed slots, masked
    Walk w = start;
#pragma unroll 4
    for (int e = tid; e < n; e += NT) {
      float x = in[e];
      if (m != nullptr) x *= m[w.r];
      sh[goi_scan::slot<RUN>(w.r, w.c, blk)] = x;
      w.step(d);
    }
    __syncthreads();
    // the ring's next block into the stage block b_{k-1} left: its store
    // must have read it first
    if (RING && tid == 0 && k + STAGES - 1 < trips) {
      bulk_wait_read();
      load(k + STAGES - 1);
    }
    goi_scan::scan_columns<RUN, NT>(d, blk, sh, tot + b * d);
    // the prefix back, row-major: into the stage and out in one store, or
    // straight out
    float* out = RING ? stage + s * n : inner + b * n;
    w = start;
#pragma unroll 4
    for (int e = tid; e < n; e += NT) {
      out[e] = sh[goi_scan::slot<RUN>(w.r, w.c, blk)];
      w.step(d);
    }
    if (RING) fence_async_shared();
    __syncthreads();   // the slots are free for the next block
    if (RING && tid == 0) bulk_store(inner + b * n, out, 4u * n);
  }
  if (RING && tid == 0) bulk_wait();
}

template <int RUN, int D, bool RING>
int launch(const void* rows, const void* okf, int d, int nb, int blk,
           void* inner, void* tot, size_t smem, int sms, void* stream) {
  // the attribute belongs to the current device: set it on every launch
  cudaError_t err = cudaFuncSetAttribute(
      prefix_kernel<RUN, D, RING>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, prefix_kernel<RUN, D, RING>, NT, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = std::max(1, std::min(nb, sms * std::max(per_sm, 1)));
  prefix_kernel<RUN, D, RING><<<grid, NT, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(rows), static_cast<const float*>(okf), d, nb,
      blk, static_cast<float*>(inner), static_cast<float*>(tot));
  return (int)cudaGetLastError();
}

// The ring where it fits the card beside the scan buffer, else direct
// loads and stores. The main path's d = 20 (10 semantic channels and
// their 10 geometric and colour terms) has its own instance: 0.7% less
// device time on the H100 than the runtime width (PERF.md).
template <int RUN>
int launch_run(const void* rows, const void* okf, int d, int nb, int blk,
               void* inner, void* tot, int optin, int sms, void* stream) {
  const size_t ring = ring_bytes(d, blk);
  if (ring > (size_t)optin)
    return launch<RUN, 0, false>(rows, okf, d, nb, blk, inner, tot,
                                 goi_scan::smem_bytes(d, blk), sms, stream);
  if (d == 20)
    return launch<RUN, 20, true>(rows, okf, d, nb, blk, inner, tot, ring,
                                 sms, stream);
  return launch<RUN, 0, true>(rows, okf, d, nb, blk, inner, tot, ring, sms,
                              stream);
}

}  // namespace

// rows (nb * blk, d), okf (nb * blk) or null, inner ((nb + 1) * blk, d),
// tot (nb, d); blk a multiple of 32, rows and okf 16-byte aligned,
// (nb + 1) * blk * d < 2^31. Runs on as many persistent CTAs as fit.
// Returns cudaErrorInvalidValue for a shape the kernel does not take (a
// scan buffer past the card's shared memory), cudaErrorMisalignedAddress
// for a misaligned pointer.
extern "C" int goi_prefix_blocks(const void* rows, const void* okf, int d,
                                 int nb, int blk, void* inner, void* tot,
                                 void* stream) {
  if (blk <= 0 || blk % 32 != 0 || d <= 0 || nb < 0 ||
      (long long)(nb + 1) * blk * d >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)rows % 16 != 0 || (uintptr_t)okf % 16 != 0 ||
      (uintptr_t)inner % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
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
  if (goi_scan::smem_bytes(d, blk) > (size_t)optin)
    return (int)cudaErrorInvalidValue;
  switch (blk / 32) {   // the blocks of 128, 256 and 512 rows unrolled
    case 4: return launch_run<4>(rows, okf, d, nb, blk, inner, tot, optin,
                                 sms, stream);
    case 8: return launch_run<8>(rows, okf, d, nb, blk, inner, tot, optin,
                                 sms, stream);
    case 16: return launch_run<16>(rows, okf, d, nb, blk, inner, tot, optin,
                                   sms, stream);
    default: return launch_run<0>(rows, okf, d, nb, blk, inner, tot, optin,
                                  sms, stream);
  }
}
