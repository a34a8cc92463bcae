// Fused forward blend + 2D->3D feature lift: one CTA per 16x16 tile, one
// thread per pixel, one lifted row per sorted instance.
//
// Replaces goi_tpu/raster/pallas_blend.py `_trace_kernel` (launched by
// `trace_tiles_pallas`), the TPU form of traceCUDA
// (ref:cuda_rasterizer/forward.cu:422-583). Each pixel walks its tile's
// depth-sorted instance range [tile_start, tile_end) front to back with
// csrc/walk.cuh, the walk of csrc/blend_fwd.cu (same step, cull, stop
// rule and accumulation), so the embedded render is render()'s bit for
// bit, in the same raw layout (4+S sums, T, walked, blended). Every
// instance that the pixel blends with alpha > 0.005 (strict,
// ref:forward.cu:512) also takes the pixel's augmented feature
// a = [img (sa - 1 channels), 1]: the trailing ones channel counts the
// hits, and the caller zeroes the whole vector outside the image, so
// padding pixels walk (they are in the render) but lift nothing.
//
// The TPU kernel built the lift as a (PIX x K) hit matrix times the
// feature tile on the MXU, wrote feature-major padded rows with the
// Gaussian id transported in an extra row and double-buffered them by
// DMA. None of that carries over: rows are indexed by sorted position
// and summed per Gaussian by raster/reduce.py.
//
// Bound on the H100: operations. Per walked pixel x instance pair the
// forward's ~16 fp32 operations and an expf, per blended pair a
// multiply-add per output channel, and per hit one add per lifted field.
// Bytes are the packed features once per tile, the (T, 256, sa) feature
// tile, the raw output and the (M, sa) rows once each.
//
// Design. The first version kept a's 32 fields in registers and summed
// each instance per warp (a 31-shuffle transpose per warp and hit
// instance, eight warp partials in 32 KB of shared memory, batches of
// 32); that structure cost csrc/blend_bwd.cu a third of its time. A
// pixel's per-pair datum here is only its hit bit, so:
// - the tile's a (256 x sa) goes to shared memory once per CTA, rows in
//   thread order with an odd stride, so a warp reading one field of 32
//   pixels hits 32 banks;
// - the walk of a batch of 256 (the forward's, with its cull and
//   per-warp early exit) writes one hit ballot per (warp, instance),
//   zero for an instance the warp culled or never reached: one barrier
//   pair per batch;
// - in the reduce phase one owner warp per instance sums a over the set
//   bits: lane l adds pixel l of each warp group whose ballot holds it,
//   then one transpose-reduction over CAP = 16 or 32 fields leaves lane
//   f with field f (16 fields: four shuffle steps and one across the
//   half-warps). The order of the sums is fixed and there are no float
//   atomics, so the rows are the same bits on every run; hit counts are
//   sums of ones, exact in float32;
// - every row of [0, M) is written: zeros for an instance no pixel hit,
//   for a tile's rows past its CTA's stop, and for the tail past the last
//   tile's range (positions no tile holds; the ranges tile [0, ends[T-1])
//   in order, as the binning gives them) by extra zeroing blocks, so the
//   wrapper allocates with torch.empty.
// - past 32 fields (sa up to SA_MAX = 127: 126 channels and the ones
//   channel) the owner warp lifts in groups of 32 fields, one
//   transpose-reduction a group; sa <= 16 and sa <= 32 keep their
//   one-transpose paths.
// Shared memory per CTA: features (NF + 4) x 256, a 256 x (sa | 1),
// ballots 8 x 256, the warps' cull lists 8 x 256 bytes: 45 KB at
// S = 10, sa = 11; 215 KB at S = 64, sa = 127, the widest the wrapper
// takes (S_MAX = 64 in raster/cuda_blend.py). Lane = pixel with one
// transpose per instance beat lane = field looping over the set bits,
// and at sa = 11 the 16-field transpose beat the 32-field one by 1.6 ms
// on the H100, likely by its fewer registers (PERF.md). Built with
// -fmad=false, as the forward.

#include <cuda_runtime.h>
#include <cstdint>

#include "walk.cuh"

namespace {

using namespace walk;

constexpr int SA_MAX = 127;         // lifted fields, in groups of 32
constexpr int WIDE = 0;             // CAP of the grouped path
constexpr int TAIL_BLOCKS = 264;    // blocks that zero the untiled rows
constexpr float HIT_ALPHA = 0.005f;

// One step of the warp transpose-reduction: lanes whose bit OFF is set
// keep the upper half of their OFF * 2 live values, the others the lower
// half, each adding its partner's copy of the half it keeps.
template <int OFF, int CAP>
__device__ __forceinline__ void transpose_step(float (&v)[CAP], int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = upper ? v[i] : v[i + OFF];
    const float keep = upper ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, OFF);
  }
}

// Lane l < CAP ends with the warp's sum of v[l].
template <int CAP>
__device__ __forceinline__ float warp_field_sum(float (&v)[CAP], int lane) {
  if constexpr (CAP == 32) transpose_step<16>(v, lane);
  transpose_step<8>(v, lane);
  transpose_step<4>(v, lane);
  transpose_step<2>(v, lane);
  transpose_step<1>(v, lane);
  float s = v[0];
  if constexpr (CAP == 16) s += __shfl_xor_sync(FULL, s, 16);
  return s;
}

// Odd row stride of a in shared memory.
__host__ __device__ constexpr int aug_stride(int sa) { return sa | 1; }

template <int S>
constexpr size_t smem_bytes(int sa) {
  return sizeof(float) * ((10 + S + CULL_ROWS) * BATCH +
                          PIX * aug_stride(sa)) +
         sizeof(unsigned) * WARPS * BATCH + WARPS * BATCH;
}

// Zero rows [lo, hi) of the (., sa) row buffer, threads of one block or
// of a grid striding by `step` from `first`.
__device__ __forceinline__ void zero_rows(float* rows, int sa, long long lo,
                                          long long hi, long long first,
                                          long long step) {
  for (long long e = lo * sa + first; e < hi * sa; e += step) rows[e] = 0.f;
}

// feat (NF, m) packed instances; aug (T, 256, sa) per pixel; out per
// pixel: 4+S sums, T, walked, blended; rows (m, sa). CAP: 16 or 32
// fields in one transpose (sa <= CAP), or WIDE: groups of 32.
template <int S, int CAP>
__global__ void __launch_bounds__(PIX)
trace_kernel(const float* __restrict__ feat, long long m,
             const int* __restrict__ starts, const int* __restrict__ ends,
             int num_tiles, int grid_x, const float* __restrict__ aug,
             int sa, float* __restrict__ out, float* __restrict__ rows) {
  constexpr int NF = 10 + S;
  constexpr int NOUT = 4 + S;
  constexpr int OUTC = NOUT + 3;
  extern __shared__ float4 smem4[];
  const int astride = aug_stride(sa);
  float* fsh = reinterpret_cast<float*>(smem4);       // [NF + 4][BATCH]
  float* ash = fsh + (NF + CULL_ROWS) * BATCH;        // [PIX][astride]
  unsigned* ballots =
      reinterpret_cast<unsigned*>(ash + PIX * astride);  // [WARPS][BATCH]
  uint8_t* lists =
      reinterpret_cast<uint8_t*>(ballots + WARPS * BATCH);  // [WARPS][BATCH]

  const int p = threadIdx.x;
  if (blockIdx.x < TAIL_BLOCKS) {
    // the positions past the last tile's range belong to no tile
    zero_rows(rows, sa, ends[num_tiles - 1], m,
              (long long)blockIdx.x * PIX + p, (long long)TAIL_BLOCKS * PIX);
    return;
  }
  const int t = blockIdx.x - TAIL_BLOCKS;
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
  uint8_t* list = lists + warp * BATCH;
  unsigned* ballot_row = ballots + warp * BATCH;

  // the tile's a, coalesced, each pixel's row at its thread's slot
  // (ordered before its reads by the loop's first barrier)
  const float* at = aug + (long long)t * PIX * sa;
  for (int e = p; e < PIX * sa; e += PIX) {
    const int q = e / sa;
    const int x = q % TILE;
    const int y = q / TILE;
    const int tq = ((y / BLOCK_H) * 2 + x / BLOCK_W) * 32 +
                   (y % BLOCK_H) * BLOCK_W + x % BLOCK_W;
    ash[tq * astride + e % sa] = at[e];
  }

  Pixel<NOUT> px(end);
  int cur = start;    // the first row of the range not yet written

  for (int base = start; base < end; base += BATCH) {
    // also the barrier after the last batch's reduce
    if (__syncthreads_count(px.done) == PIX) break;
    const int n = min(BATCH, end - base);
    load_batch<NF>(fsh, feat, m, base, n, p);
    for (int j = lane; j < n; j += 32) ballot_row[j] = 0u;
    __syncthreads();

    // walk phase: ballots of the hits, per warp
    if (!__all_sync(FULL, px.done)) {
      const int cnt = cull<NF>(fsh, n, bx0, by0, list, lane);
      walk_list<NOUT>(fsh, list, cnt, base, fx, fy, HIT_ALPHA, px,
                      [&](int j, bool hit) {
                        const unsigned b = __ballot_sync(FULL, hit);
                        if (lane == 0 && b) ballot_row[j] = b;
                      });
    }
    __syncthreads();

    // reduce phase: warp w owns instances w, w + 8, ...
    for (int j = warp; j < n; j += WARPS) {
      float* o = rows + (long long)(base + j) * sa;
      unsigned group[WARPS];
      unsigned any = 0u;
#pragma unroll
      for (int g = 0; g < WARPS; ++g) {
        group[g] = ballots[g * BATCH + j];
        any |= group[g];
      }
      if (!any) {
        for (int f = lane; f < sa; f += 32) o[f] = 0.f;
        continue;
      }
      if constexpr (CAP == WIDE) {
        for (int f0 = 0; f0 < sa; f0 += 32) {
          float v[32];
#pragma unroll
          for (int c = 0; c < 32; ++c) v[c] = 0.f;
#pragma unroll
          for (int g = 0; g < WARPS; ++g) {
            if ((group[g] >> lane) & 1u) {
              const float* a = ash + (g * 32 + lane) * astride + f0;
#pragma unroll
              for (int c = 0; c < 32; ++c)
                if (f0 + c < sa) v[c] += a[c];
            }
          }
          const float s = warp_field_sum<32>(v, lane);
          if (f0 + lane < sa) o[f0 + lane] = s;
        }
      } else {
        float v[CAP];
#pragma unroll
        for (int c = 0; c < CAP; ++c) v[c] = 0.f;
#pragma unroll
        for (int g = 0; g < WARPS; ++g) {
          if ((group[g] >> lane) & 1u) {
            const float* a = ash + (g * 32 + lane) * astride;
#pragma unroll
            for (int c = 0; c < CAP; ++c)
              if (c < sa) v[c] += a[c];
          }
        }
        const float s = warp_field_sum<CAP>(v, lane);
        if (lane < sa) o[lane] = s;
      }
    }
    cur = base + n;
  }
  // the CTA stopped early: its remaining rows are zero
  zero_rows(rows, sa, cur, end, p, PIX);

  px.write(out + ((long long)t * PIX + ly * TILE + lx) * OUTC, start);
}

template <int S, int CAP>
int launch(const float* feat, long long m, const int* starts,
           const int* ends, int num_tiles, int grid_x, const float* aug,
           int sa, float* out, float* rows, cudaStream_t stream) {
  // the attribute belongs to the current device: set it on every launch
  const cudaError_t err = cudaFuncSetAttribute(
      trace_kernel<S, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<S>(CAP == WIDE ? SA_MAX : 32));
  if (err != cudaSuccess) return (int)err;
  trace_kernel<S, CAP><<<TAIL_BLOCKS + num_tiles, PIX, smem_bytes<S>(sa),
                         stream>>>(feat, m, starts, ends, num_tiles, grid_x,
                                   aug, sa, out, rows);
  return (int)cudaSuccess;
}

template <int S>
int launch_lift(const float* feat, long long m, const int* starts,
                const int* ends, int num_tiles, int grid_x, const float* aug,
                int sa, float* out, float* rows, cudaStream_t stream) {
  if (sa <= 16)
    return launch<S, 16>(feat, m, starts, ends, num_tiles, grid_x, aug, sa,
                         out, rows, stream);
  if (sa <= 32)
    return launch<S, 32>(feat, m, starts, ends, num_tiles, grid_x, aug, sa,
                         out, rows, stream);
  return launch<S, WIDE>(feat, m, starts, ends, num_tiles, grid_x, aug, sa,
                         out, rows, stream);
}

}  // namespace

// Semantic widths of the render (those of blend_fwd.cu) and 1..SA_MAX
// lifted fields; the Python wrapper pads other semantic widths up to one
// of them and raises on any other lift width before calling. feat is
// (10 + S, m) and rows (m, sa): every row is written, so rows may be
// uninitialised.
extern "C" int goi_trace_fwd(int s_dim, const void* feat, long long m,
                             const void* starts, const void* ends,
                             int num_tiles, int grid_x, const void* aug,
                             int sa, void* out, void* rows, void* stream) {
  if (sa < 1 || sa > SA_MAX) return (int)cudaErrorInvalidValue;
  const float* f = static_cast<const float*>(feat);
  const int* s = static_cast<const int*>(starts);
  const int* e = static_cast<const int*>(ends);
  const float* a = static_cast<const float*>(aug);
  float* o = static_cast<float*>(out);
  float* r = static_cast<float*>(rows);
  cudaStream_t st = (cudaStream_t)stream;
  int err = 0;
  if (num_tiles == 0) {
    err = (int)cudaMemsetAsync(r, 0, sizeof(float) * m * sa, st);
  } else {
    const int n = num_tiles;
    switch (s_dim) {
      case 0: err = launch_lift<0>(f, m, s, e, n, grid_x, a, sa, o, r, st);
        break;
      case 3: err = launch_lift<3>(f, m, s, e, n, grid_x, a, sa, o, r, st);
        break;
      case 8: err = launch_lift<8>(f, m, s, e, n, grid_x, a, sa, o, r, st);
        break;
      case 10: err = launch_lift<10>(f, m, s, e, n, grid_x, a, sa, o, r, st);
        break;
      case 16: err = launch_lift<16>(f, m, s, e, n, grid_x, a, sa, o, r, st);
        break;
      case 32: err = launch_lift<32>(f, m, s, e, n, grid_x, a, sa, o, r, st);
        break;
      case 64: err = launch_lift<64>(f, m, s, e, n, grid_x, a, sa, o, r, st);
        break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return err ? err : (int)cudaGetLastError();
}
