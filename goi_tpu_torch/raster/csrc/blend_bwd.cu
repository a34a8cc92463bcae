// Backward of the tiled alpha blend: one CTA per 16x16 tile, one thread
// per pixel, one gradient row per sorted instance.
//
// Replaces goi_tpu/raster/pallas_blend.py `_bwd_kernel` (launched by
// `_blend_core_bwd`), the TPU form of renderCUDA's backward
// (ref:cuda_rasterizer/backward.cu:413-625). Each pixel re-walks its
// tile's instances front to back with the forward's exact expressions
// and stop rule (csrc/blend_fwd.cu), and for every instance it blends:
//   total   = sum_c g_c out_c + g_T T_final        (once per pixel)
//   prefix += w (f . g)                            (w = alpha T_before)
//   R       = total - prefix                       (the suffix after it)
//   dalpha  = T_before (f . g) - R / (1 - alpha)
//   dpow    = raw dalpha where raw = opa exp(power) < 0.99, else 0
// and contributes to the instance's row (width 10 + S, the packed
// feature layout):
//   0,1  mean2d:  dpow * -(ca dx + cb dy), dpow * -(cc dy + cb dx)
//   2-4  conic:   -0.5 dpow dx^2, -dpow dx dy, -0.5 dpow dy^2
//   5    opacity: sum(dpow) / opa   (dpow = opa G dalpha; 0 if opa == 0)
//   6..  color, semantics, depth: w g_c
// with dx, dy the mean minus the pixel. The row is the sum over the
// tile's 256 pixels, taken inside the block in a fixed order: a warp
// transpose-reduction (31 shuffles leave lane l with the warp's sum of
// field l), the eight warps' partials in shared memory, then one thread
// per (instance, field) adds them in warp order and writes the row. No
// float atomics: every run gives the same bits. Rows of the tile's
// range [start, end) are written by this block alone (ranges are
// disjoint); the wrapper zeroes the buffer, so instances past a tile's
// stop keep zero rows.
//
// The TPU kernel wrote (tile, chunk)-indexed rows with the Gaussian id
// transported in an extra row, because its DMAs moved whole 256-lane
// chunks; it summed the geometric terms as pixel moments on the MXU and
// built the transmittance as a log-space cumprod (PARITY.md deviations
// 3 and 8). None of that carries over: rows are indexed by sorted
// position, and the per-pixel terms are the CUDA reference's.
//
// Bound on the H100: operations. Per walked pixel x instance pair the
// forward recompute (~16 fp32 ops and an expf); per blended pair the
// suffix, dalpha, six geometric terms and a product per output channel
// (~20 + 3 (4 + S)). Bytes are the packed features once per tile, the
// raw output and its gradient once, and the (M, 10 + S) rows once. What
// the design adds on top is the per-instance reduction, 31 shuffles per
// warp, skipped (zeros written) by a warp whose 32 pixels all missed the
// instance. Built with -fmad=false, as the forward, so the threshold
// tests decide as in the plain version.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int WARPS = PIX / 32;
constexpr int BATCH = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_CLAMP = 0.99f;
constexpr float T_EPS = 1e-4f;

// One step of the warp transpose-reduction: lanes whose bit OFF is set
// keep the upper half of their OFF * 2 live values, the others the lower
// half, each adding its partner's copy of the half it keeps.
template <int OFF>
__device__ __forceinline__ void transpose_step(float (&v)[32], int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = upper ? v[i] : v[i + OFF];
    const float keep = upper ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, OFF);
  }
}

// After the five steps lane l holds the warp's sum of v[l].
__device__ __forceinline__ float warp_transpose_sum(float (&v)[32],
                                                    int lane) {
  transpose_step<16>(v, lane);
  transpose_step<8>(v, lane);
  transpose_step<4>(v, lane);
  transpose_step<2>(v, lane);
  transpose_step<1>(v, lane);
  return v[0];
}

// feat rows: 0 x, 1 y, 2 conic a, 3 conic b, 4 conic c, 5 opacity,
// 6..8 rgb, 9..8+S semantics, 9+S depth. raw and grad per pixel: 4+S
// sums, T, walked, blended (the gradient of the counts is ignored).
template <int S>
__global__ void __launch_bounds__(PIX)
blend_bwd_kernel(const float* __restrict__ feat, long long ld,
                 const int* __restrict__ starts,
                 const int* __restrict__ ends, int grid_x,
                 const float* __restrict__ raw,
                 const float* __restrict__ grad,
                 float* __restrict__ rows) {
  constexpr int NF = 10 + S;
  constexpr int NOUT = 4 + S;
  constexpr int OUTC = NOUT + 3;
  static_assert(NF <= 32, "one gradient field per lane");
  __shared__ float sh[NF][BATCH];
  __shared__ float part[WARPS][BATCH][NF];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float fx = (float)((t % grid_x) * TILE + p % TILE);
  const float fy = (float)((t / grid_x) * TILE + p / TILE);
  const int start = starts[t];
  const int end = ends[t];

  const float* o = raw + ((long long)t * PIX + p) * OUTC;
  const float* gp = grad + ((long long)t * PIX + p) * OUTC;
  float g[NOUT];
  float total = 0.f;
#pragma unroll
  for (int f = 0; f < NOUT; ++f) {
    g[f] = gp[f];
    total += g[f] * o[f];
  }
  total += gp[NOUT] * o[NOUT];

  float T = 1.f;
  float prefix = 0.f;
  bool done = false;

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
      float v[32];
#pragma unroll
      for (int f = 0; f < 32; ++f) v[f] = 0.f;
      bool act = false;
      if (!done) {
        const float dx = sh[0][j] - fx;
        const float dy = sh[1][j] - fy;
        const float ca = sh[2][j];
        const float cb = sh[3][j];
        const float cc = sh[4][j];
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) -
                            cb * dx * dy;
        if (power <= 0.f) {
          const float ra = sh[5][j] * expf(power);
          const float alpha = fminf(ra, ALPHA_CLAMP);
          if (alpha >= ALPHA_MIN) {
            const float test_T = T * (1.f - alpha);
            if (test_T < T_EPS) {
              done = true;
            } else {
              act = true;
              const float w = alpha * T;
              float fdotg = 0.f;
#pragma unroll
              for (int f = 0; f < NOUT; ++f) fdotg += sh[6 + f][j] * g[f];
              prefix += w * fdotg;
              const float dalpha = T * fdotg - (total - prefix) /
                                                   (1.f - alpha);
              const float dpow = ra < ALPHA_CLAMP ? ra * dalpha : 0.f;
              v[0] = dpow * -(ca * dx + cb * dy);
              v[1] = dpow * -(cc * dy + cb * dx);
              v[2] = -0.5f * dpow * dx * dx;
              v[3] = -dpow * dx * dy;
              v[4] = -0.5f * dpow * dy * dy;
              v[5] = dpow;
#pragma unroll
              for (int f = 0; f < NOUT; ++f) v[6 + f] = w * g[f];
              T = test_T;
            }
          }
        }
      }
      // warp-uniform branch: a warp none of whose pixels blended the
      // instance writes zeros
      const float s = __any_sync(FULL, act) ? warp_transpose_sum(v, lane)
                                            : 0.f;
      if (lane < NF) part[warp][j][lane] = s;
    }
    __syncthreads();
    float* out = rows + (long long)base * NF;
    for (int e = p; e < n * NF; e += PIX) {
      const int j = e / NF;
      const int f = e % NF;
      float s = part[0][j][f];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += part[w][j][f];
      if (f == 5) {
        const float opa = sh[5][j];
        s = opa > 0.f ? s / opa : 0.f;
      }
      out[e] = s;
    }
  }
}

template <int S>
void launch(const float* feat, long long ld, const int* starts,
            const int* ends, int num_tiles, int grid_x, const float* raw,
            const float* grad, float* rows, cudaStream_t stream) {
  blend_bwd_kernel<S><<<num_tiles, PIX, 0, stream>>>(
      feat, ld, starts, ends, grid_x, raw, grad, rows);
}

}  // namespace

// Semantic widths the library is built for (those of blend_fwd.cu); the
// Python wrapper raises on any other before calling. rows must be
// zeroed by the caller.
extern "C" int goi_blend_bwd(int s_dim, const void* feat, long long ld,
                             const void* starts, const void* ends,
                             int num_tiles, int grid_x, const void* raw,
                             const void* grad, void* rows, void* stream) {
  const float* f = static_cast<const float*>(feat);
  const int* s = static_cast<const int*>(starts);
  const int* e = static_cast<const int*>(ends);
  const float* r = static_cast<const float*>(raw);
  const float* g = static_cast<const float*>(grad);
  float* o = static_cast<float*>(rows);
  cudaStream_t st = (cudaStream_t)stream;
  if (num_tiles > 0) {
    switch (s_dim) {
      case 0: launch<0>(f, ld, s, e, num_tiles, grid_x, r, g, o, st); break;
      case 3: launch<3>(f, ld, s, e, num_tiles, grid_x, r, g, o, st); break;
      case 8: launch<8>(f, ld, s, e, num_tiles, grid_x, r, g, o, st); break;
      case 10:
        launch<10>(f, ld, s, e, num_tiles, grid_x, r, g, o, st);
        break;
      case 16:
        launch<16>(f, ld, s, e, num_tiles, grid_x, r, g, o, st);
        break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
