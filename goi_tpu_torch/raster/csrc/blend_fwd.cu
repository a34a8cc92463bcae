// Forward tiled alpha blend: one CTA per 16x16 tile, one thread per pixel.
//
// Replaces goi_tpu/raster/pallas_blend.py `_fwd_kernel` (launched by
// `_blend_core_fwd`), the TPU form of renderCUDA
// (ref:cuda_rasterizer/forward.cu:261-386). Each tile blends RGB, S
// semantic channels and depth of its depth-sorted instance range
// [tile_start, tile_end) front to back with csrc/walk.cuh's step (the
// 1/255 skip, the 0.99 clamp, the sticky T < 1e-4 stop with the stopping
// splat excluded), acc += alpha T f, and writes the sums, the
// blended-only T (the caller composites the background), and per pixel
// the number of instances it walked and blended.
//
// The TPU kernel evaluated all pixel x instance pairs of a 256-wide
// chunk at once: the exponent as a moment-basis matmul with a +1e-4
// guard and the transmittance as a log-space triangular-matmul cumprod
// (MXU workarounds, PARITY.md deviations 8 and 3). Neither carries over:
// a thread walks its pixel's instances in order with the exact per-pixel
// expressions, as the CUDA reference does.
//
// Bound on the H100: operations, the pixel x instance pairs walked, each
// a few fp32 multiplies and one expf, plus a multiply-add per output
// channel for every blended pair; feature bytes are small beside that
// (each instance is read once per tile that holds it). The binning culls
// per 16x16 tile, so on a seeded 1M-Gaussian frame two thirds of the
// walked pairs only skip (PERF.md). The design:
// - a batch of up to 256 instances is loaded cooperatively into shared
//   memory (one coalesced row per feature, plus the cull's terms);
// - each warp (an 8x4 pixel block) culls the batch against its block
//   (walk.cuh) and walks only the instances it keeps, in order: every
//   thread reads the same shared word (a broadcast, no bank conflicts);
// - the 4 + S accumulators and T live in registers (S is a template
//   parameter), the walked count comes from the stopping position;
// - a warp whose 32 pixels are done stops walking, and the CTA stops
//   loading batches once all 256 are (__syncthreads_count vote).
// Widths: S in {0, 3, 8, 10, 16} keep the batch in static shared memory
// (30 KB at S = 16); S = 32 and 64 (raster/cuda_blend.py pads other
// widths up to S_MAX = 64 with zero rows) need 49 and 82 KB, past the
// 48 KB static cap, so their kernel (blend_fwd_wide_kernel, the same
// walk) takes it as dynamic shared memory.
// expf is the accurate one: the library is built without
// --use_fast_math.

#include <cuda_runtime.h>
#include <cstdint>

#include "walk.cuh"

namespace {

using namespace walk;

// One tile's walk: sh holds the batch ((10 + S + CULL_ROWS) x BATCH
// floats), lists the warps' cull lists (WARPS x BATCH bytes); out per
// pixel (at ly * 16 + lx): 4+S sums, T, walked, blended.
template <int S>
__device__ __forceinline__ void blend_tile(float* sh, uint32_t* lists,
                                           const float* __restrict__ feat,
                                           long long ld,
                                           const int* __restrict__ starts,
                                           const int* __restrict__ ends,
                                           int grid_x,
                                           float* __restrict__ out) {
  constexpr int NF = 10 + S;
  constexpr int NOUT = 4 + S;
  constexpr int OUTC = NOUT + 3;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int lx = pixel_x(p);
  const int ly = pixel_y(p);
  const float tx0 = (float)((t % grid_x) * TILE);
  const float ty0 = (float)((t / grid_x) * TILE);
  const float fx = tx0 + (float)lx;
  const float fy = ty0 + (float)ly;
  const float bx0 = tx0 + (float)((warp & 1) * BLOCK_W);
  const float by0 = ty0 + (float)((warp >> 1) * BLOCK_H);
  const int start = starts[t];
  const int end = ends[t];
  uint8_t* list = reinterpret_cast<uint8_t*>(lists + warp * (BATCH / 4));

  Pixel<NOUT> px(end);
  for (int base = start; base < end; base += BATCH) {
    // also the barrier that protects sh from the previous batch's reads
    if (__syncthreads_count(px.done) == PIX) break;
    const int n = min(BATCH, end - base);
    load_batch<NF>(sh, feat, ld, base, n, p);
    __syncthreads();
    if (__all_sync(FULL, px.done)) continue;
    const int cnt = cull<NF>(sh, n, bx0, by0, list, lane);
    walk_list<NOUT>(sh, list, cnt, base, fx, fy, 1.f, px,
                    [](int, bool) {});
  }

  px.write(out + ((long long)t * PIX + ly * TILE + lx) * OUTC, start);
}

// S <= 16: the batch in static shared memory.
template <int S>
__global__ void __launch_bounds__(PIX)
blend_fwd_kernel(const float* __restrict__ feat, long long ld,
                 const int* __restrict__ starts,
                 const int* __restrict__ ends, int grid_x,
                 float* __restrict__ out) {
  __shared__ float sh[(10 + S + CULL_ROWS) * BATCH];
  __shared__ uint32_t lists[WARPS * (BATCH / 4)];   // a byte per entry
  blend_tile<S>(sh, lists, feat, ld, starts, ends, grid_x, out);
}

// Bytes of a wide instance's batch and cull lists.
template <int S>
constexpr size_t wide_smem_bytes() {
  return sizeof(float) * (10 + S + CULL_ROWS) * BATCH +
         sizeof(uint32_t) * WARPS * (BATCH / 4);
}

// S = 32 and 64: the batch in dynamic shared memory (past the 48 KB a
// CTA may declare statically).
template <int S>
__global__ void __launch_bounds__(PIX)
blend_fwd_wide_kernel(const float* __restrict__ feat, long long ld,
                      const int* __restrict__ starts,
                      const int* __restrict__ ends, int grid_x,
                      float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);
  blend_tile<S>(sh,
                reinterpret_cast<uint32_t*>(sh + (10 + S + CULL_ROWS) * BATCH),
                feat, ld, starts, ends, grid_x, out);
}

template <int S>
int launch(const float* feat, long long ld, const int* starts,
           const int* ends, int num_tiles, int grid_x, float* out,
           cudaStream_t stream) {
  if constexpr (S <= 16) {
    blend_fwd_kernel<S><<<num_tiles, PIX, 0, stream>>>(feat, ld, starts,
                                                       ends, grid_x, out);
  } else {
    constexpr size_t bytes = wide_smem_bytes<S>();
    // the attribute belongs to the current device: set it on every launch
    const cudaError_t err = cudaFuncSetAttribute(
        blend_fwd_wide_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    blend_fwd_wide_kernel<S><<<num_tiles, PIX, bytes, stream>>>(
        feat, ld, starts, ends, grid_x, out);
  }
  return (int)cudaSuccess;
}

}  // namespace

// Semantic widths the library is built for (raster/cuda_blend.py
// SEM_DIMS); the Python wrapper pads any other width up to one of them
// and raises above the widest before calling.
extern "C" int goi_blend_fwd(int s_dim, const void* feat, long long ld,
                             const void* starts, const void* ends,
                             int num_tiles, int grid_x, void* out,
                             void* stream) {
  const float* f = static_cast<const float*>(feat);
  const int* s = static_cast<const int*>(starts);
  const int* e = static_cast<const int*>(ends);
  float* o = static_cast<float*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  int err = 0;
  if (num_tiles > 0) {
    switch (s_dim) {
      case 0: err = launch<0>(f, ld, s, e, num_tiles, grid_x, o, st); break;
      case 3: err = launch<3>(f, ld, s, e, num_tiles, grid_x, o, st); break;
      case 8: err = launch<8>(f, ld, s, e, num_tiles, grid_x, o, st); break;
      case 10: err = launch<10>(f, ld, s, e, num_tiles, grid_x, o, st);
        break;
      case 16: err = launch<16>(f, ld, s, e, num_tiles, grid_x, o, st);
        break;
      case 32: err = launch<32>(f, ld, s, e, num_tiles, grid_x, o, st);
        break;
      case 64: err = launch<64>(f, ld, s, e, num_tiles, grid_x, o, st);
        break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return err ? err : (int)cudaGetLastError();
}
