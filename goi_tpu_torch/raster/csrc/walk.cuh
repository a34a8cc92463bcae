// The per-pixel blend walk shared by csrc/blend_fwd.cu and csrc/trace.cu:
// the exact per-pair step, a per-warp sub-tile cull and the pixel layout.
//
// Layout. One CTA per 16x16 tile, one thread per pixel. Warp w covers
// the 8x4 pixel block (w % 2, w / 2) of the tile, as in csrc/blend_bwd.cu,
// so a splat that covers a corner of the tile reaches few warps. A batch
// of up to 256 instances sits in shared memory, feature-major: row r of
// instance j at f[r * BATCH + j], rows 0..NF-1 the packed features
// (0 x, 1 y, 2-4 conic a b c, 5 opacity, 6.. colour, semantics, depth),
// then CULL_ROWS rows the cull's per-instance terms.
//
// The step (`pair_alpha`, then `walk_list`'s transmittance step) is the
// forward's expression for one pixel and one instance, written in
// __fmul_rn / __fadd_rn / __fsub_rn in the order
//   power = -0.5 (a dx dx + c dy dy) - b dx dy    (dx = x - px, ...)
//   skip if power > 0 (a NaN power goes on)
//   alpha = min(0.99, opa expf(power)); skip if alpha < 1/255
//   test_T = T (1 - alpha); stop (sticky, splat excluded) if < 1e-4
//   acc += (alpha T) f, unfused; T = test_T
// nvcc never contracts these intrinsics, so every kernel that walks
// decides every pair the same way whatever its -fmad flag (expf gives
// the same bits under both).
//
// The cull. Before a warp walks a batch, lane i tests instances
// i, i + 32, ..., i + 224 against the warp's 8x4 block: an instance can
// blend a pixel only where Q(d) = a dx^2 + 2 b dx dy + c dy^2 (power =
// -Q / 2) is at most q_cut = 2 ln(255 opa), so it is dropped when the
// exact minimum of Q over the block's pixel box (preprocess.cell_min_q's
// form: 0 if the mean lies in the box, else the least of the four edges'
// clamped stationary points) exceeds q_cut + margin, with
//   margin = 2^-18 (S + |q_cut| + 1),
//   S = a Dx^2 + c Dy^2 + 2 |b| Dx Dy,
// Dx, Dy the largest |dx|, |dy| over the box. S bounds the sum of the
// magnitudes of the power's three terms at every pixel of the block, and
// they cancel for thin rotated ellipses, so the rounding error of the
// step's Q is up to ~7u S (u = 2^-24: the rounded dx, dy and five
// products and sums) and that of the box minimum ~7u S (its evaluation
// and the rounded box bounds); q_cut's logf and the product 255 opa add
// ~2u (|q_cut| + 1), and expf's 2 ulp, the product opa expf and the
// rounded 1/255 ~12u. The margin is 64u (S + |q_cut| + 1), about four
// times their sum, so the cull never drops a pair that the step would
// blend (tests/test_torch_block_cull.py holds the plain twin,
// raster/blend.py `block_cull_plain`, to that on seeded scenes and
// adversarial splats). An instance the test cannot decide is kept: a
// field that is not finite (a NaN power blends at alpha 0.99), opacity
// <= 0, a conic that is not positive definite (preprocess's `pd` test),
// or coefficients and distances so large that a term could overflow
// (max(a, |b|, c) max(1, Dx, Dy)^2 >= 1e30). Culled instances only
// skip, so they still count as walked: a pixel's walked count is its
// stopping instance's position - start + 1, or end - start.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace walk {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int WARPS = PIX / 32;
constexpr int BATCH = 256;          // instances per batch: one per thread
constexpr int BLOCK_W = 8;          // a warp's pixel block
constexpr int BLOCK_H = 4;
constexpr int CULL_ROWS = 4;        // q_cut (or +inf: keep), 1/a, 1/c,
                                    // max(a, |b|, c)
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_CLAMP = 0.99f;
constexpr float T_EPS = 1e-4f;
constexpr float CULL_REL = 1.0f / 262144.0f;   // 2^-18
constexpr float CULL_SAFE = 1e30f;

// Pixel (x, y) within the tile of thread p.
__device__ __forceinline__ int pixel_x(int p) {
  return ((p >> 5) & 1) * BLOCK_W + (p & 7);
}
__device__ __forceinline__ int pixel_y(int p) {
  return (p >> 6) * BLOCK_H + ((p >> 3) & 3);
}

// Thread p < n copies instance base + p's NF feature rows from the
// (NF, ld) matrix into f and derives its cull rows.
template <int NF>
__device__ __forceinline__ void load_batch(float* f, const float* feat,
                                           long long ld, int base, int n,
                                           int p) {
  if (p >= n) return;
  float v[NF];
#pragma unroll
  for (int r = 0; r < NF; ++r) {
    v[r] = feat[r * ld + base + p];
    f[r * BATCH + p] = v[r];
  }
  const float ca = v[2], cb = v[3], cc = v[4], opa = v[5];
  const bool decidable =
      isfinite(v[0]) && isfinite(v[1]) && isfinite(ca) && isfinite(cb) &&
      isfinite(cc) && isfinite(opa) && opa > 0.f && ca > 0.f && cc > 0.f &&
      ca * cc - cb * cb > 0.f;
  f[NF * BATCH + p] =
      decidable ? 2.f * logf(255.f * opa) : __int_as_float(0x7f800000);
  f[(NF + 1) * BATCH + p] = 1.f / ca;
  f[(NF + 2) * BATCH + p] = 1.f / cc;
  f[(NF + 3) * BATCH + p] = fmaxf(fmaxf(ca, fabsf(cb)), cc);
}

__device__ __forceinline__ float quad(float ca, float cb, float cc, float dx,
                                      float dy) {
  return ca * dx * dx + 2.f * cb * dx * dy + cc * dy * dy;
}

// Whether instance j may blend a pixel of the block whose top-left pixel
// is (bx0, by0) (the header's test).
template <int NF>
__device__ __forceinline__ bool block_keep(const float* f, int j, float bx0,
                                           float by0) {
  const float q_cut = f[NF * BATCH + j];
  const float ca = f[2 * BATCH + j];
  const float cb = f[3 * BATCH + j];
  const float cc = f[4 * BATCH + j];
  // d = pixel - mean over the box [lx, ux] x [ly, uy]
  const float lx = bx0 - f[j];
  const float ux = (bx0 + (float)(BLOCK_W - 1)) - f[j];
  const float ly = by0 - f[BATCH + j];
  const float uy = (by0 + (float)(BLOCK_H - 1)) - f[BATCH + j];
  const float dxm = fmaxf(-lx, ux);
  const float dym = fmaxf(-ly, uy);
  const float d = fmaxf(1.f, fmaxf(dxm, dym));
  if (!(f[(NF + 3) * BATCH + j] * d * d < CULL_SAFE)) return true;
  const float s = ca * dxm * dxm + cc * dym * dym + 2.f * fabsf(cb) * dxm * dym;
  const float lim = q_cut + CULL_REL * (s + fabsf(q_cut) + 1.f);
  float min_q = 0.f;
  if (!(lx <= 0.f && ux >= 0.f && ly <= 0.f && uy >= 0.f)) {
    const float ia = f[(NF + 1) * BATCH + j];
    const float ic = f[(NF + 2) * BATCH + j];
    const float dy_l = fminf(fmaxf(-cb * lx * ic, ly), uy);
    const float dy_u = fminf(fmaxf(-cb * ux * ic, ly), uy);
    const float dx_l = fminf(fmaxf(-cb * ly * ia, lx), ux);
    const float dx_u = fminf(fmaxf(-cb * uy * ia, lx), ux);
    min_q = fminf(fminf(quad(ca, cb, cc, lx, dy_l), quad(ca, cb, cc, ux, dy_u)),
                  fminf(quad(ca, cb, cc, dx_l, ly), quad(ca, cb, cc, dx_u, uy)));
  }
  return !(min_q > lim);
}

// The warp's cull of a batch of n instances: writes the batch indices it
// keeps, in order, to `list` (the warp's own, BATCH bytes, 4-byte
// aligned) and returns their count.
template <int NF>
__device__ __forceinline__ int cull(const float* f, int n, float bx0,
                                    float by0, uint8_t* list, int lane) {
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < BATCH / 32; ++k) {
    if (k * 32 >= n) break;
    const int j = k * 32 + lane;
    const bool keep = j < n && block_keep<NF>(f, j, bx0, by0);
    const unsigned b = __ballot_sync(FULL, keep);
    if (keep) list[cnt + __popc(b & ((1u << lane) - 1u))] = (uint8_t)j;
    cnt += __popc(b);
  }
  __syncwarp();
  return cnt;
}

// The part of the step that does not depend on T: whether pixel (fx, fy)
// passes instance j's two skip tests, with its clamped alpha.
__device__ __forceinline__ bool pair_alpha(const float* f, int j, float fx,
                                           float fy, float& alpha) {
  const float dx = __fsub_rn(f[j], fx);
  const float dy = __fsub_rn(f[BATCH + j], fy);
  const float power = __fsub_rn(
      __fmul_rn(-0.5f,
                __fadd_rn(__fmul_rn(__fmul_rn(f[2 * BATCH + j], dx), dx),
                          __fmul_rn(__fmul_rn(f[4 * BATCH + j], dy), dy))),
      __fmul_rn(__fmul_rn(f[3 * BATCH + j], dx), dy));
  alpha = fminf(__fmul_rn(f[5 * BATCH + j], expf(power)), ALPHA_CLAMP);
  return !(power > 0.f) && alpha >= ALPHA_MIN;
}

// Per-pixel state of the walk over the range [start, end).
template <int NOUT>
struct Pixel {
  float acc[NOUT];
  float T = 1.f;
  bool done = false;
  int last;       // one past the last instance walked (end if not done)
  int blended = 0;

  __device__ explicit Pixel(int end) : last(end) {
#pragma unroll
    for (int c = 0; c < NOUT; ++c) acc[c] = 0.f;
  }

  // The raw output row: NOUT sums, T, walked, blended.
  __device__ void write(float* o, int start) const {
#pragma unroll
    for (int c = 0; c < NOUT; ++c) o[c] = acc[c];
    o[NOUT] = T;
    o[NOUT + 1] = (float)(last - start);
    o[NOUT + 2] = (float)blended;
  }
};

// One pixel's walk over the warp's list of cnt kept batch indices (the
// batch starts at position base), UNROLL at a time: the alphas of a
// group first (independent of T, so their loads and expf overlap), then
// the group's transmittance steps in order. after(j, hit) runs on every
// lane for every listed instance, in order (hit: blended with alpha >
// hit_alpha). The warp stops after a group once all its pixels are done.
constexpr int UNROLL = 4;
static_assert(UNROLL == sizeof(uint32_t), "a group is one aligned word "
              "of the byte list");

template <int NOUT, typename After>
__device__ __forceinline__ void walk_list(const float* f,
                                          const uint8_t* list, int cnt,
                                          int base, float fx, float fy,
                                          float hit_alpha, Pixel<NOUT>& px,
                                          After after) {
  for (int i0 = 0; i0 < cnt; i0 += UNROLL) {
    // entries past cnt are stale batch indices: read, never used
    const uint32_t group = *reinterpret_cast<const uint32_t*>(list + i0);
    int js[UNROLL];
    float alpha[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      js[u] = (group >> (8 * u)) & 0xffu;
      ok[u] = pair_alpha(f, js[u], fx, fy, alpha[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (i0 + u >= cnt) break;
      const int j = js[u];
      bool hit = false;
      if (!px.done && ok[u]) {
        const float test_T = __fmul_rn(px.T, __fsub_rn(1.f, alpha[u]));
        if (test_T < T_EPS) {
          px.done = true;
          px.last = base + j + 1;
        } else {
          const float w = __fmul_rn(alpha[u], px.T);
#pragma unroll
          for (int c = 0; c < NOUT; ++c)
            px.acc[c] = __fadd_rn(px.acc[c],
                                  __fmul_rn(w, f[(6 + c) * BATCH + j]));
          px.T = test_T;
          ++px.blended;
          hit = alpha[u] > hit_alpha;
        }
      }
      after(j, hit);
    }
    if (__all_sync(FULL, px.done)) break;
  }
}

}  // namespace walk
