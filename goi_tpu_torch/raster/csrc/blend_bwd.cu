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
// tile's 256 pixels, taken inside the block in a fixed order, with no
// float atomics: every run gives the same bits.
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
// raw output and its gradient once, and the (M, 10 + S) rows once.
//
// Design. On the H100 the first version, one 31-shuffle warp
// transpose-reduction per warp and instance that any lane blended and
// eight warp partials summed after it, spent a third of its time in
// that reduction (PERF.md). So:
// - Batches of 256 instances in shared memory, as the forward, walked
//   in sub-batches of SUB = 16. In the walk phase each pixel thread
//   stages its (w, dpow) of every sub-batch instance in shared memory;
//   a warp none of whose 32 pixels blended an instance stores nothing
//   and clears that instance's bit in a per-(instance, warp) ballot,
//   and a warp whose pixels have all stopped skips the walk.
// - In the reduce phase one owner warp per instance sums its row over
//   the tile's pixels: lane l takes pixel l of every warp group whose
//   ballot is set (recomputing dx, dy from the pixel), then ONE
//   transpose-reduction per instance (31 shuffles leave lane f with
//   field f) writes the row. An instance no pixel blended is written as
//   zeros.
// - Warps cover 8x4 pixel blocks, not 16x2 rows, so a small splat falls
//   in fewer warp groups.
// - The walk is written with __fmul_rn / __fadd_rn / __fsub_rn, which
//   nvcc never contracts, so it decides exactly as the forward built
//   with -fmad=false (expf gives the same bits either way, checked on
//   every negative float on the H100); this file is built with
//   contraction allowed, so the gradient math uses FMA.
// - Every row of [0, M) is written: a tile's rows past its CTA's stop
//   as zeros, and the tail past the last tile's range (positions no
//   tile holds; the ranges tile [0, ends[T - 1]) in order, as the
//   binning gives them) by extra zeroing blocks, so the wrapper
//   allocates with torch.empty.
// Shared memory per CTA: features NF x 256, gradients 256 x GS, staged
// (w, dpow) SUB x 256, ballots SUB x 8: 73.7 KB at S = 10, so 3 CTAs
// (24 warps) per SM; 2 at S = 16 and 32; 1 at S = 64 (175 KB).
// Widths: the owner warp sums a row's 10 + S fields in groups of 32, one
// transpose-reduction per group, the geometric terms in the first; S in
// {0, 3, 8, 10, 16} take one group, S = 32 and 64 (the wrapper pads other
// widths up to S_MAX = 64 with zero rows, whose gradients are zero and
// dropped) two and three. Each field's sum has the same order as in a
// narrower instance, so padded channels change no other bits.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int WARPS = PIX / 32;
constexpr int BATCH = 256;
constexpr int SUB = 16;
constexpr int TAIL_BLOCKS = 264;   // blocks that zero the untiled rows
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

// The first step when only v[0 .. NF) are live: a pair whose upper slot
// is dead is summed into both halves, so lanes NF and up (read by no
// one) end with copies instead of zeros, at one shuffle and no selects.
template <int NF>
__device__ __forceinline__ void first_step(float (&v)[32], int lane) {
  const bool upper = (lane & 16) != 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (i + 16 < NF) {
      const float send = upper ? v[i] : v[i + 16];
      const float keep = upper ? v[i + 16] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, 16);
    } else {
      v[i] += __shfl_xor_sync(FULL, v[i], 16);
    }
  }
}

// After the five steps lane l < NF holds the warp's sum of v[l].
template <int NF>
__device__ __forceinline__ float warp_transpose_sum(float (&v)[32],
                                                    int lane) {
  first_step<NF>(v, lane);
  transpose_step<8>(v, lane);
  transpose_step<4>(v, lane);
  transpose_step<2>(v, lane);
  transpose_step<1>(v, lane);
  return v[0];
}

// Row stride of the staged gradients: NOUT rounded up to a multiple of 4
// with an odd number of float4s, so a warp's 16-byte reads of 32
// consecutive pixels' rows hit distinct banks.
__host__ __device__ constexpr int grad_stride(int nout) {
  return ((nout + 3) / 4) % 2 == 1 ? (nout + 3) / 4 * 4
                                   : (nout + 3) / 4 * 4 + 4;
}

template <int S>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((10 + S) * BATCH + PIX * grad_stride(4 + S)) +
         sizeof(float2) * SUB * PIX + sizeof(unsigned) * SUB * WARPS;
}

// Zero rows [lo, hi) of the (., nf) row buffer, threads of one block or
// of a grid striding by `step` from `first`.
__device__ __forceinline__ void zero_rows(float* rows, int nf, long long lo,
                                          long long hi, long long first,
                                          long long step) {
  for (long long e = lo * nf + first; e < hi * nf; e += step) rows[e] = 0.f;
}

// The owner warp's row of NF fields, group GRP of 32 fields at a time
// (one group up to S = 16): lane l sums pixel l of every warp group whose
// ballot is set (the first group: dpow dx, dpow dy, dpow dx^2, dpow dx dy,
// dpow dy^2, dpow, then w g_c), then one transpose-reduction leaves field
// GRP * 32 + l on lane l; the first group combines its lanes 0 and 1 (the
// mean sums) with the instance's conic into the geometric terms.
template <int NF, int GRP>
__device__ __forceinline__ void reduce_fields(
    const unsigned (&group)[WARPS], const float2* wd_j, const float* gsh,
    int gs, const float* fsh, int k, float xj, float yj, float tx0,
    float ty0, int lane, float* out) {
  constexpr int NOUT = NF - 6;
  constexpr int F0 = GRP * 32;                 // first field of the group
  constexpr int LIVE = NF - F0 < 32 ? NF - F0 : 32;
  float v[32];
#pragma unroll
  for (int f = 0; f < 32; ++f) v[f] = 0.f;
#pragma unroll
  for (int gw = 0; gw < WARPS; ++gw) {
    if (!group[gw]) continue;
    const int q = gw * 32 + lane;
    const float2 e = wd_j[q];
    if constexpr (GRP == 0) {
      const float dx = xj - (tx0 + (float)((gw & 1) * 8 + (lane & 7)));
      const float dy = yj - (ty0 + (float)((gw >> 1) * 4 + (lane >> 3)));
      const float pdx = e.y * dx;
      const float pdy = e.y * dy;
      v[0] += pdx;
      v[1] += pdy;
      v[2] += pdx * dx;
      v[3] += pdx * dy;
      v[4] += pdy * dy;
      v[5] += e.y;
    }
    const float4* gq = reinterpret_cast<const float4*>(gsh + q * gs);
#pragma unroll
    for (int c4 = 0; c4 < (NOUT + 3) / 4; ++c4) {
      // channel c is field 6 + c: only this group's are read
      if (6 + c4 * 4 + 3 < F0 || 6 + c4 * 4 >= F0 + LIVE) continue;
      const float4 gg = gq[c4];
      const float gv[4] = {gg.x, gg.y, gg.z, gg.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = 6 + c4 * 4 + i;
        if (c4 * 4 + i < NOUT && f >= F0 && f < F0 + LIVE)
          v[f - F0] += e.x * gv[i];
      }
    }
  }
  const float s = warp_transpose_sum<LIVE>(v, lane);
  if constexpr (GRP == 0) {
    const float sx = __shfl_sync(FULL, s, 0);
    const float sy = __shfl_sync(FULL, s, 1);
    const float ca = fsh[2 * BATCH + k];
    const float cb = fsh[3 * BATCH + k];
    const float cc = fsh[4 * BATCH + k];
    const float opa = fsh[5 * BATCH + k];
    float r = s;
    if (lane == 0) r = -(ca * sx + cb * sy);
    if (lane == 1) r = -(cc * sy + cb * sx);
    if (lane == 2 || lane == 4) r = -0.5f * s;
    if (lane == 3) r = -s;
    if (lane == 5) r = opa > 0.f ? s / opa : 0.f;
    if (lane < LIVE) out[lane] = r;
  } else {
    if (lane < LIVE) out[F0 + lane] = s;
  }
  if constexpr (F0 + 32 < NF)
    reduce_fields<NF, GRP + 1>(group, wd_j, gsh, gs, fsh, k, xj, yj, tx0,
                               ty0, lane, out);
}

// feat rows: 0 x, 1 y, 2 conic a, 3 conic b, 4 conic c, 5 opacity,
// 6..8 rgb, 9..8+S semantics, 9+S depth. raw and grad per pixel: 4+S
// sums, T, walked, blended (the gradient of the counts is ignored).
template <int S>
__global__ void __launch_bounds__(PIX, S <= 10 ? 3 : (S <= 32 ? 2 : 1))
blend_bwd_kernel(const float* __restrict__ feat, long long m,
                 const int* __restrict__ starts,
                 const int* __restrict__ ends, int num_tiles, int grid_x,
                 const float* __restrict__ raw,
                 const float* __restrict__ grad,
                 float* __restrict__ rows) {
  constexpr int NF = 10 + S;
  constexpr int NOUT = 4 + S;
  constexpr int OUTC = NOUT + 3;
  constexpr int GS = grad_stride(NOUT);
  extern __shared__ float4 smem4[];
  float* fsh = reinterpret_cast<float*>(smem4);          // [NF][BATCH]
  float* gsh = fsh + NF * BATCH;                         // [PIX][GS]
  float2* wd = reinterpret_cast<float2*>(gsh + PIX * GS);  // [SUB][PIX]
  unsigned* ballots = reinterpret_cast<unsigned*>(wd + SUB * PIX);

  const int p = threadIdx.x;
  if (blockIdx.x < TAIL_BLOCKS) {
    // the positions past the last tile's range belong to no tile
    zero_rows(rows, NF, ends[num_tiles - 1], m,
              (long long)blockIdx.x * PIX + p, (long long)TAIL_BLOCKS * PIX);
    return;
  }
  const int t = blockIdx.x - TAIL_BLOCKS;
  const int lane = p & 31;
  const int warp = p >> 5;
  // warp w covers the 8x4 pixel block (w % 2, w / 2) of the tile
  const int lx = (warp & 1) * 8 + (lane & 7);
  const int ly = (warp >> 1) * 4 + (lane >> 3);
  const float tx0 = (float)((t % grid_x) * TILE);
  const float ty0 = (float)((t / grid_x) * TILE);
  const float fx = tx0 + (float)lx;
  const float fy = ty0 + (float)ly;
  const int start = starts[t];
  const int end = ends[t];

  const long long pix = (long long)t * PIX + ly * TILE + lx;
  const float* o = raw + pix * OUTC;
  const float* gp = grad + pix * OUTC;
  float g[NOUT];
  float total = 0.f;
#pragma unroll
  for (int f = 0; f < NOUT; ++f) {
    g[f] = gp[f];
    gsh[p * GS + f] = g[f];
    total += g[f] * o[f];
  }
  total += gp[NOUT] * o[NOUT];

  float T = 1.f;
  float prefix = 0.f;
  bool done = false;
  int cur = start;   // the first row of the range not yet written

  for (int base = start; base < end && cur == base; base += BATCH) {
    const int n = min(BATCH, end - base);
    __syncthreads();   // the last batch's reduce has read fsh
    if (p < n) {
#pragma unroll
      for (int r = 0; r < NF; ++r) fsh[r * BATCH + p] = feat[r * m + base + p];
    }
    for (int s0 = 0; s0 < n; s0 += SUB) {
      // the barrier after the loads, and before wd and ballots are
      // rewritten; the CTA stops once every pixel has
      if (__syncthreads_count(done) == PIX) break;
      const int ns = min(SUB, n - s0);

      // walk phase: stage (w, dpow) of the sub-batch; a warp whose
      // pixels have all stopped only clears its ballots
      if (__all_sync(FULL, done)) {
        if (lane < ns) ballots[lane * WARPS + warp] = 0u;
      } else {
        for (int j = 0; j < ns; ++j) {
          const int k = s0 + j;
          float w = 0.f;
          float dpow = 0.f;
          bool act = false;
          if (!done) {
            const float ca = fsh[2 * BATCH + k];
            const float cb = fsh[3 * BATCH + k];
            const float cc = fsh[4 * BATCH + k];
            const float dx = __fsub_rn(fsh[k], fx);
            const float dy = __fsub_rn(fsh[BATCH + k], fy);
            // the forward's -0.5 (a dx dx + c dy dy) - b dx dy, each
            // operation rounded in the same order
            const float power = __fsub_rn(
                __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                                           __fmul_rn(__fmul_rn(cc, dy), dy))),
                __fmul_rn(__fmul_rn(cb, dx), dy));
            if (!(power > 0.f)) {
              const float ra = __fmul_rn(fsh[5 * BATCH + k], expf(power));
              const float alpha = fminf(ra, ALPHA_CLAMP);
              if (alpha >= ALPHA_MIN) {
                const float one_minus = __fsub_rn(1.f, alpha);
                const float test_T = __fmul_rn(T, one_minus);
                if (test_T < T_EPS) {
                  done = true;
                } else {
                  act = true;
                  w = __fmul_rn(alpha, T);
                  float fdotg = 0.f;
#pragma unroll
                  for (int f = 0; f < NOUT; ++f)
                    fdotg += fsh[(6 + f) * BATCH + k] * g[f];
                  prefix += w * fdotg;
                  const float dalpha =
                      T * fdotg - (total - prefix) / one_minus;
                  dpow = ra < ALPHA_CLAMP ? ra * dalpha : 0.f;
                  T = test_T;
                }
              }
            }
          }
          const unsigned ballot = __ballot_sync(FULL, act);
          if (ballot) wd[j * PIX + p] = make_float2(w, dpow);
          if (lane == 0) ballots[j * WARPS + warp] = ballot;
        }
      }
      __syncthreads();

      // reduce phase: warp w owns instances w and w + 8 of the sub-batch
      for (int j = warp; j < ns; j += WARPS) {
        const int k = s0 + j;
        float* out = rows + (long long)(base + k) * NF;
        const uint4 b0 = *reinterpret_cast<const uint4*>(
            ballots + j * WARPS);
        const uint4 b1 = *reinterpret_cast<const uint4*>(
            ballots + j * WARPS + 4);
        const unsigned group[WARPS] = {b0.x, b0.y, b0.z, b0.w,
                                       b1.x, b1.y, b1.z, b1.w};
        if (!(b0.x | b0.y | b0.z | b0.w | b1.x | b1.y | b1.z | b1.w)) {
          for (int f = lane; f < NF; f += 32) out[f] = 0.f;
          continue;
        }
        const float xj = fsh[k];
        const float yj = fsh[BATCH + k];
        reduce_fields<NF, 0>(group, wd + j * PIX, gsh, GS, fsh, k, xj, yj,
                             tx0, ty0, lane, out);
      }
      cur = base + s0 + ns;
    }
  }
  // the CTA stopped early: its remaining rows are zero
  zero_rows(rows, NF, cur, end, p, PIX);
}

template <int S>
int launch(const float* feat, long long m, const int* starts,
           const int* ends, int num_tiles, int grid_x, const float* raw,
           const float* grad, float* rows, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<S>();
  // the attribute belongs to the current device: set it on every launch
  const cudaError_t err = cudaFuncSetAttribute(
      blend_bwd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  blend_bwd_kernel<S><<<TAIL_BLOCKS + num_tiles, PIX, bytes, stream>>>(
      feat, m, starts, ends, num_tiles, grid_x, raw, grad, rows);
  return (int)cudaSuccess;
}

}  // namespace

// Semantic widths the library is built for (those of blend_fwd.cu); the
// Python wrapper pads any other width up to one of them and raises above
// the widest before calling. feat is (10 + S, m)
// and rows (m, 10 + S): every row is written, so rows may be
// uninitialised.
extern "C" int goi_blend_bwd(int s_dim, const void* feat, long long m,
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
  int err = 0;
  if (num_tiles > 0 && m > 0) {
    switch (s_dim) {
      case 0: err = launch<0>(f, m, s, e, num_tiles, grid_x, r, g, o, st);
        break;
      case 3: err = launch<3>(f, m, s, e, num_tiles, grid_x, r, g, o, st);
        break;
      case 8: err = launch<8>(f, m, s, e, num_tiles, grid_x, r, g, o, st);
        break;
      case 10: err = launch<10>(f, m, s, e, num_tiles, grid_x, r, g, o, st);
        break;
      case 16: err = launch<16>(f, m, s, e, num_tiles, grid_x, r, g, o, st);
        break;
      case 32: err = launch<32>(f, m, s, e, num_tiles, grid_x, r, g, o, st);
        break;
      case 64: err = launch<64>(f, m, s, e, num_tiles, grid_x, r, g, o, st);
        break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return err ? err : (int)cudaGetLastError();
}
