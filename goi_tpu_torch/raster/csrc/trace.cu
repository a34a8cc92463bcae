// Fused forward blend + 2D->3D feature lift: one CTA per 16x16 tile, one
// thread per pixel, one lifted row per sorted instance.
//
// Replaces goi_tpu/raster/pallas_blend.py `_trace_kernel` (launched by
// `trace_tiles_pallas`), the TPU form of traceCUDA
// (ref:cuda_rasterizer/forward.cu:422-583). Each pixel walks its tile's
// depth-sorted instance range [tile_start, tile_end) front to back with
// the forward blend's exact expressions and stop rule (csrc/blend_fwd.cu:
// the 1/255 skip, the 0.99 clamp, the sticky T < 1e-4 stop with the
// stopping splat excluded), so the embedded render is render()'s, in the
// same raw layout (4+S sums, T, walked, blended). Every instance that
// the pixel blends with alpha > 0.005 (strict, ref:forward.cu:512) also
// takes the pixel's augmented feature a = [img (sa - 1 channels), 1]:
// the trailing ones channel counts the hits, and the caller zeroes the
// whole vector outside the image, so padding pixels walk (they are in
// the render) but lift nothing. An instance's row is the sum of a over
// the tile's 256 pixels, taken as in csrc/blend_bwd.cu: a warp
// transpose-reduction (31 shuffles leave lane l with the warp's sum of
// field l), the eight warps' partials in shared memory, then one thread
// per (instance, field) adds them in warp order. No float atomics, so
// the rows are the same bits on every run; hit counts are sums of ones,
// exact in float32. Rows of the tile's range are written by this block
// alone; the wrapper zeroes the buffer, so instances past a tile's stop
// keep zero rows.
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
// tile, the raw output and the (M, sa) rows once each. What the design
// adds on top is the per-instance reduction, 31 shuffles per warp,
// skipped (zeros written) by a warp none of whose pixels hit the
// instance. Built with -fmad=false, as the forward, so every product
// rounds as in the plain version and render().

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int WARPS = PIX / 32;
constexpr int BATCH = 32;
constexpr int MAX_SA = 32;  // lifted fields: one per lane
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_CLAMP = 0.99f;
constexpr float T_EPS = 1e-4f;
constexpr float HIT_ALPHA = 0.005f;

// One step of the warp transpose-reduction: lanes whose bit OFF is set
// keep the upper half of their OFF * 2 live values, the others the lower
// half, each adding its partner's copy of the half it keeps.
template <int OFF>
__device__ __forceinline__ void transpose_step(float (&v)[MAX_SA],
                                               int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = upper ? v[i] : v[i + OFF];
    const float keep = upper ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, OFF);
  }
}

// After the five steps lane l holds the warp's sum of v[l].
__device__ __forceinline__ float warp_transpose_sum(float (&v)[MAX_SA],
                                                    int lane) {
  transpose_step<16>(v, lane);
  transpose_step<8>(v, lane);
  transpose_step<4>(v, lane);
  transpose_step<2>(v, lane);
  transpose_step<1>(v, lane);
  return v[0];
}

// feat rows: 0 x, 1 y, 2 conic a, 3 conic b, 4 conic c, 5 opacity,
// 6..8 rgb, 9..8+S semantics, 9+S depth. aug (T, 256, sa) per pixel.
// out per pixel: 4+S sums, T, walked, blended. rows (M, sa).
template <int S>
__global__ void __launch_bounds__(PIX)
trace_kernel(const float* __restrict__ feat, long long ld,
             const int* __restrict__ starts, const int* __restrict__ ends,
             int grid_x, const float* __restrict__ aug, int sa,
             float* __restrict__ out, float* __restrict__ rows) {
  constexpr int NF = 10 + S;
  constexpr int NOUT = 4 + S;
  constexpr int OUTC = NOUT + 3;
  __shared__ float sh[NF][BATCH];
  __shared__ float part[WARPS][BATCH][MAX_SA];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float fx = (float)((t % grid_x) * TILE + p % TILE);
  const float fy = (float)((t / grid_x) * TILE + p / TILE);
  const int start = starts[t];
  const int end = ends[t];

  float a[MAX_SA];
  const float* ap = aug + ((long long)t * PIX + p) * sa;
#pragma unroll
  for (int f = 0; f < MAX_SA; ++f) a[f] = f < sa ? ap[f] : 0.f;

  float acc[NOUT];
#pragma unroll
  for (int f = 0; f < NOUT; ++f) acc[f] = 0.f;
  float T = 1.f;
  bool done = false;
  int walked = 0;
  int blended = 0;

  for (int base = start; base < end; base += BATCH) {
    // also the barrier that protects sh and part from the last batch
    if (__syncthreads_count(done) == PIX) break;
    const int n = min(BATCH, end - base);
    for (int e = p; e < NF * BATCH; e += PIX) {
      const int r = e / BATCH;
      const int j = e % BATCH;
      if (j < n) sh[r][j] = feat[r * ld + base + j];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      bool hit = false;
      if (!done) {
        ++walked;
        const float dx = sh[0][j] - fx;
        const float dy = sh[1][j] - fy;
        const float power =
            -0.5f * (sh[2][j] * dx * dx + sh[4][j] * dy * dy) -
            sh[3][j] * dx * dy;
        if (!(power > 0.f)) {  // blend_fwd.cu's skip test, NaN included
          const float alpha = fminf(sh[5][j] * expf(power), ALPHA_CLAMP);
          if (alpha >= ALPHA_MIN) {
            const float test_T = T * (1.f - alpha);
            if (test_T < T_EPS) {
              done = true;
            } else {
              const float w = alpha * T;
#pragma unroll
              for (int f = 0; f < NOUT; ++f) acc[f] += w * sh[6 + f][j];
              T = test_T;
              ++blended;
              hit = alpha > HIT_ALPHA;
            }
          }
        }
      }
      // warp-uniform branch: a warp none of whose pixels hit the
      // instance writes zeros
      float s = 0.f;
      if (__any_sync(FULL, hit)) {
        float v[MAX_SA];
#pragma unroll
        for (int f = 0; f < MAX_SA; ++f) v[f] = hit ? a[f] : 0.f;
        s = warp_transpose_sum(v, lane);
      }
      if (lane < sa) part[warp][j][lane] = s;
    }
    __syncthreads();
    float* o = rows + (long long)base * sa;
    for (int e = p; e < n * sa; e += PIX) {
      const int j = e / sa;
      const int f = e % sa;
      float s = part[0][j][f];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += part[w][j][f];
      o[e] = s;
    }
  }

  float* o = out + ((long long)t * PIX + p) * OUTC;
#pragma unroll
  for (int f = 0; f < NOUT; ++f) o[f] = acc[f];
  o[NOUT] = T;
  o[NOUT + 1] = (float)walked;
  o[NOUT + 2] = (float)blended;
}

template <int S>
void launch(const float* feat, long long ld, const int* starts,
            const int* ends, int num_tiles, int grid_x, const float* aug,
            int sa, float* out, float* rows, cudaStream_t stream) {
  trace_kernel<S><<<num_tiles, PIX, 0, stream>>>(feat, ld, starts, ends,
                                                 grid_x, aug, sa, out, rows);
}

}  // namespace

// Semantic widths of the render (those of blend_fwd.cu) and 1..32 lifted
// fields; the Python wrapper raises on any other before calling. rows
// must be zeroed by the caller.
extern "C" int goi_trace_fwd(int s_dim, const void* feat, long long ld,
                             const void* starts, const void* ends,
                             int num_tiles, int grid_x, const void* aug,
                             int sa, void* out, void* rows, void* stream) {
  if (sa < 1 || sa > MAX_SA) return (int)cudaErrorInvalidValue;
  const float* f = static_cast<const float*>(feat);
  const int* s = static_cast<const int*>(starts);
  const int* e = static_cast<const int*>(ends);
  const float* a = static_cast<const float*>(aug);
  float* o = static_cast<float*>(out);
  float* r = static_cast<float*>(rows);
  cudaStream_t st = (cudaStream_t)stream;
  if (num_tiles > 0) {
    const int n = num_tiles;
    switch (s_dim) {
      case 0: launch<0>(f, ld, s, e, n, grid_x, a, sa, o, r, st); break;
      case 3: launch<3>(f, ld, s, e, n, grid_x, a, sa, o, r, st); break;
      case 8: launch<8>(f, ld, s, e, n, grid_x, a, sa, o, r, st); break;
      case 10: launch<10>(f, ld, s, e, n, grid_x, a, sa, o, r, st); break;
      case 16: launch<16>(f, ld, s, e, n, grid_x, a, sa, o, r, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
