// Forward tiled alpha blend: one CTA per 16x16 tile, one thread per pixel.
//
// Replaces goi_tpu/raster/pallas_blend.py `_fwd_kernel` (launched by
// `_blend_core_fwd`), the TPU form of renderCUDA
// (ref:cuda_rasterizer/forward.cu:261-386). Each tile blends RGB, S
// semantic channels and depth of its depth-sorted instance range
// [tile_start, tile_end) front to back:
//   power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy ; skip if power > 0
//   alpha = min(0.99, opa exp(power))           ; skip if alpha < 1/255
//   test_T = T (1 - alpha) ; stop (sticky, splat excluded) if < 1e-4
//   acc += alpha T f ; T = test_T
// and writes the sums, the blended-only T (the caller composites the
// background), and per pixel the number of instances it walked and
// blended.
//
// The TPU kernel evaluated all pixel x instance pairs of a 256-wide
// chunk at once: the exponent as a moment-basis matmul with a +1e-4
// guard and the transmittance as a log-space triangular-matmul cumprod
// (MXU workarounds, PARITY.md deviations 8 and 3). Neither carries over:
// a thread walks its pixel's instances in order with the exact per-pixel
// expressions above, as the CUDA reference does.
//
// Bound on the H100: the pixel x instance pairs walked, each a few fp32
// multiplies and one expf, plus a multiply-add per output channel for
// every blended pair; feature bytes are small beside that (each instance
// is read once per tile that holds it). The design keeps the pair loop
// lean: a batch of up to 256 instances is loaded cooperatively into
// shared memory (one coalesced row per feature), every thread then reads
// the same shared word (a broadcast, no bank conflicts), the 4 + S
// accumulators and T live in registers (S is a template parameter), and
// the CTA stops at the next batch once every pixel is done
// (__syncthreads_count vote). expf is the accurate one: the library is
// built without --use_fast_math, and with -fmad=false so every product
// rounds as the plain PyTorch version's does.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int BATCH = 256;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_CLAMP = 0.99f;
constexpr float T_EPS = 1e-4f;

// feat rows: 0 x, 1 y, 2 conic a, 3 conic b, 4 conic c, 5 opacity,
// 6..8 rgb, 9..8+S semantics, 9+S depth. out per pixel: 4+S sums, T,
// walked, blended.
template <int S>
__global__ void __launch_bounds__(PIX)
blend_fwd_kernel(const float* __restrict__ feat, long long ld,
                 const int* __restrict__ starts,
                 const int* __restrict__ ends, int grid_x,
                 float* __restrict__ out) {
  constexpr int NF = 10 + S;
  constexpr int NOUT = 4 + S;
  constexpr int OUTC = NOUT + 3;
  __shared__ float sh[NF][BATCH];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float fx = (float)((t % grid_x) * TILE + p % TILE);
  const float fy = (float)((t / grid_x) * TILE + p / TILE);
  const int start = starts[t];
  const int end = ends[t];

  float acc[NOUT];
#pragma unroll
  for (int f = 0; f < NOUT; ++f) acc[f] = 0.f;
  float T = 1.f;
  bool done = false;
  int walked = 0;
  int blended = 0;

  for (int base = start; base < end; base += BATCH) {
    // also the barrier that protects sh from the previous batch's reads
    if (__syncthreads_count(done) == PIX) break;
    const int n = min(BATCH, end - base);
    if (p < n) {
#pragma unroll
      for (int r = 0; r < NF; ++r) sh[r][p] = feat[r * ld + base + p];
    }
    __syncthreads();
    for (int j = 0; j < n && !done; ++j) {
      ++walked;
      const float dx = sh[0][j] - fx;
      const float dy = sh[1][j] - fy;
      const float power =
          -0.5f * (sh[2][j] * dx * dx + sh[4][j] * dy * dy) -
          sh[3][j] * dx * dy;
      if (power > 0.f) continue;
      const float alpha = fminf(sh[5][j] * expf(power), ALPHA_CLAMP);
      if (alpha < ALPHA_MIN) continue;
      const float test_T = T * (1.f - alpha);
      if (test_T < T_EPS) {
        done = true;
        break;
      }
      const float w = alpha * T;
#pragma unroll
      for (int f = 0; f < NOUT; ++f) acc[f] += w * sh[6 + f][j];
      T = test_T;
      ++blended;
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
            const int* ends, int num_tiles, int grid_x, float* out,
            cudaStream_t stream) {
  blend_fwd_kernel<S><<<num_tiles, PIX, 0, stream>>>(feat, ld, starts, ends,
                                                     grid_x, out);
}

}  // namespace

// Semantic widths the library is built for; the Python wrapper raises
// on any other before calling.
extern "C" int goi_blend_fwd(int s_dim, const void* feat, long long ld,
                             const void* starts, const void* ends,
                             int num_tiles, int grid_x, void* out,
                             void* stream) {
  const float* f = static_cast<const float*>(feat);
  const int* s = static_cast<const int*>(starts);
  const int* e = static_cast<const int*>(ends);
  float* o = static_cast<float*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  if (num_tiles > 0) {
    switch (s_dim) {
      case 0: launch<0>(f, ld, s, e, num_tiles, grid_x, o, st); break;
      case 3: launch<3>(f, ld, s, e, num_tiles, grid_x, o, st); break;
      case 8: launch<8>(f, ld, s, e, num_tiles, grid_x, o, st); break;
      case 10: launch<10>(f, ld, s, e, num_tiles, grid_x, o, st); break;
      case 16: launch<16>(f, ld, s, e, num_tiles, grid_x, o, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
