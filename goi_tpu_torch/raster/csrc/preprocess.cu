// The rasterization preprocess, one Gaussian a thread: the near cull, the
// world covariance, the EWA projection, conic and radius, the
// opacity-aware tile rectangle with its exact per-cell counts (cell_sel)
// and the SH colour; every field of raster/preprocess.py's Splats but the
// semantics, which stay a PyTorch expression (their gradient is the one
// the distillation trains).
//
// Replaces no Pallas kernel: goi_tpu/raster/preprocess.py is a chain of
// (N,) array operations that XLA fuses into one pass on the TPU. Eager
// PyTorch runs the same chain (raster/preprocess.py `preprocess_plain`,
// this kernel's plain version) as ~1,700 aten operations a call, each a
// pass over device memory and a launch from the host.
//
// Bit for bit the plain version on the card. Built with -fmad=false, every
// expression here is evaluated in the plain version's order and
// association, with IEEE division and square root and the expf / logf
// that PyTorch's kernels call. A Python number meets a float32 tensor as a
// float32 (rounded once, in the host's double -> float conversion), and
// `number / tensor` is reciprocal(tensor) * number in PyTorch, so the
// focal lengths are (1 / (2 tan)) * width here too. torch.clamp,
// torch.maximum and torch.minimum return a NaN operand where fmaxf /
// fminf would drop it (the helpers below), the tile coordinates are
// clamped in float before their int32 conversion (a NaN converts to 0 in
// both), and cell_sel's nibbles are packed in float32.
//
// Bound on the H100: bytes. A Gaussian reads 237 B (xyz 12, scaling 12,
// rotation 16, opacity 4, SH 16 x 12 at degree 3, valid 1) and writes 73 B
// (mean2d 8, depth 4, conic 12, opacity 4, colour 12, radius 4, the two
// int32 rectangles 16, tiles 4, valid 1, cell_sel 8): 310 B, so 5.8M
// Gaussians need at least 0.54 ms at 3.35 TB/s, while their ~1,000 float
// operations each need ~0.09 ms at 67 TFLOP/s. Design: a block of THREADS
// Gaussians copies its rows wider than 16 B (features_rest, 180 B at
// degree 3, and cov3d_precomp's 24 B) into shared memory with coalesced
// 16-byte loads while each thread loads its own narrow rows; then each
// thread evaluates its Gaussian from registers and shared memory and
// writes each output once. Nothing is read twice from device memory.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_REST = 15;       // SH coefficients past the DC at degree 3
constexpr int CAM_FLOATS = 40;     // world_view 16, full_proj 16, centre 3,
                                   // tan_fovx, tan_fovy (padded to 16 B)
constexpr int N_SH = 14;           // C0, C1, C2[0..4], C3[0..6]
constexpr float TILE = 16.0f;      // raster/preprocess.py TILE
constexpr float INV_TILE = 0.0625f;
constexpr float NEAR_Z = 0.2f;

struct Args {
  const float* xyz;
  const float* scaling;
  const float* rotation;
  const float* opacity;
  const float* dc;
  const float* rest;
  const unsigned char* valid;
  const float* cov3d;              // nullable: cov3d_precomp (N, 6)
  const float* override_color;     // nullable: (N, 3), no SH
  const float* world_view;
  const float* full_proj;
  const float* center;
  const float* tan_fovx;
  const float* tan_fovy;
  float* mean2d;
  float* depth;
  float* conic;
  float* opa;
  float* color;
  int* radius;
  int* rect_min;
  int* rect_max;
  int* tiles;
  unsigned char* valid_out;
  float* cell_sel;
  long long n;
  int width, height, grid_x, grid_y, deg, rest_rows;
  float modifier;
  int rot16, rest16, cov16;        // 16-byte aligned rows
  float sh[N_SH];
};

// torch.clamp with number bounds: a NaN input comes out as it went in
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_hi(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp_lohi(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
// torch.clamp with tensor bounds: a NaN input, then a NaN bound, wins
__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}
// torch.maximum / torch.minimum: a NaN operand wins, the first first
__device__ __forceinline__ float t_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float t_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// raster/preprocess.py _tile_floor: int32(clip(floor(v), 0, grid)), the
// clip in float first so that far values saturate
__device__ __forceinline__ int tile_floor(float v, int grid) {
  return (int)clamp_lohi(floorf(v), 0.0f, (float)grid);
}

struct Rect {
  int x0, y0, x1, y1;              // tiles [x0, x1) x [y0, y1)
};

// The tile rectangle of a disc of radius r about (px, py) (preprocess's
// rect_min / rect_max with r = r_bin, and its 3-sigma test with r =
// radius): the one place its formula lives in this kernel
__device__ __forceinline__ Rect tile_rect(float px, float py, float r,
                                          int gx, int gy) {
  Rect t;
  t.x0 = tile_floor((px - r) * INV_TILE, gx);
  t.y0 = tile_floor((py - r) * INV_TILE, gy);
  t.x1 = tile_floor((((px + r) + TILE) - 1.0f) * INV_TILE, gx);
  t.y1 = tile_floor((((py + r) + TILE) - 1.0f) * INV_TILE, gy);
  return t;
}

__device__ __forceinline__ float q_at(float ca, float cb, float cc, float dx,
                                      float dy) {
  return ((ca * dx) * dx + ((2.0f * cb) * dx) * dy) + (cc * dy) * dy;
}

// raster/preprocess.py cell_min_q: the exact min of the conic quadratic
// over the box [lx, ux] x [ly, uy] (0 if the origin is inside, else the
// least of the four edges' clamped stationary points)
__device__ float cell_min_q(float lx, float ux, float ly, float uy, float ca,
                            float cb, float cc) {
  const bool inside = (lx <= 0.0f) & (ux >= 0.0f) & (ly <= 0.0f) &
                      (uy >= 0.0f);
  const float ca_s = clamp_lo(ca, 1e-20f);
  const float cc_s = clamp_lo(cc, 1e-20f);
  const float ncb = -cb;
  const float dy_l = t_min(t_max((ncb * lx) / cc_s, ly), uy);
  const float dy_u = t_min(t_max((ncb * ux) / cc_s, ly), uy);
  const float dx_l = t_min(t_max((ncb * ly) / ca_s, lx), ux);
  const float dx_u = t_min(t_max((ncb * uy) / ca_s, lx), ux);
  const float min_q =
      t_min(t_min(q_at(ca, cb, cc, lx, dy_l), q_at(ca, cb, cc, ux, dy_u)),
            t_min(q_at(ca, cb, cc, dx_l, ly), q_at(ca, cb, cc, dx_u, uy)));
  return inside ? 0.0f : min_q;
}

// count floats from src (device) to dst (shared), 16 bytes a load where
// src is 16-byte aligned, four loads a thread in flight
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int count, int vec) {
  int done = 0;
  if (vec) {
    const int n4 = count >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n4; i += 4 * THREADS) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i + u * THREADS < n4) v[u] = __ldg(s4 + i + u * THREADS);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i + u * THREADS < n4) d4[i + u * THREADS] = v[u];
    }
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < count; i += THREADS)
    dst[i] = __ldg(src + i);
}

__global__ void __launch_bounds__(THREADS)
preprocess_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const bool need_sh = a.deg > 0 && a.override_color == nullptr;
  const int r3 = a.rest_rows * 3;
  float* s_rest = reinterpret_cast<float*>(smem4);
  float* s_cov = s_rest + (need_sh ? THREADS * r3 : 0);
  float* s_cam = s_cov + (a.cov3d != nullptr ? THREADS * 6 : 0);
  const int t = threadIdx.x;
  const long long g0 = (long long)blockIdx.x * THREADS;
  const int nb = (int)min((long long)THREADS, a.n - g0);
  const long long g = g0 + t;
  const bool live = t < nb;

  // the thread's own narrow rows first, so that they are in flight
  // during the block's copies
  float x = 0.f, y = 0.f, z = 0.f, sc0 = 0.f, sc1 = 0.f, sc2 = 0.f;
  float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
  float op = 0.f, f0r = 0.f, f0g = 0.f, f0b = 0.f;
  bool valid_in = false;
  if (live) {
    x = __ldg(a.xyz + 3 * g);
    y = __ldg(a.xyz + 3 * g + 1);
    z = __ldg(a.xyz + 3 * g + 2);
    if (a.cov3d == nullptr) {
      sc0 = __ldg(a.scaling + 3 * g);
      sc1 = __ldg(a.scaling + 3 * g + 1);
      sc2 = __ldg(a.scaling + 3 * g + 2);
      if (a.rot16) {
        q = __ldg(reinterpret_cast<const float4*>(a.rotation) + g);
      } else {
        q = make_float4(__ldg(a.rotation + 4 * g), __ldg(a.rotation + 4 * g + 1),
                        __ldg(a.rotation + 4 * g + 2),
                        __ldg(a.rotation + 4 * g + 3));
      }
    }
    op = __ldg(a.opacity + g);
    if (a.override_color == nullptr) {
      f0r = __ldg(a.dc + 3 * g);
      f0g = __ldg(a.dc + 3 * g + 1);
      f0b = __ldg(a.dc + 3 * g + 2);
    }
    valid_in = __ldg(a.valid + g) != 0;
  }
  if (need_sh) stage(s_rest, a.rest + g0 * r3, nb * r3, a.rest16);
  if (a.cov3d != nullptr) stage(s_cov, a.cov3d + g0 * 6, nb * 6, a.cov16);
  if (t < 16) {
    s_cam[t] = __ldg(a.world_view + t);
    s_cam[16 + t] = __ldg(a.full_proj + t);
  } else if (t < 19) {
    s_cam[16 + t] = __ldg(a.center + (t - 16));   // s_cam[32..34]
  } else if (t == 19) {
    s_cam[35] = __ldg(a.tan_fovx);
  } else if (t == 20) {
    s_cam[36] = __ldg(a.tan_fovy);
  }
  __syncthreads();
  if (!live) return;
  const float* V = s_cam;          // world_view, row-major
  const float* P = s_cam + 16;     // full_proj
  const float tan_x = s_cam[35], tan_y = s_cam[36];

  // ---- projection (preprocess) ----
  const float pc0 = ((P[0] * x + P[1] * y) + P[2] * z) + P[3];
  const float pc1 = ((P[4] * x + P[5] * y) + P[6] * z) + P[7];
  const float pc3 = ((P[12] * x + P[13] * y) + P[14] * z) + P[15];
  const float p_view_z = ((V[8] * x + V[9] * y) + V[10] * z) + V[11];
  const bool in_front = p_view_z > NEAR_Z;
  const float p_w = 1.0f / (in_front ? pc3 + 1e-7f : 1.0f);

  // ---- world covariance (_cov3d_scalar, or cov3d_precomp) ----
  float c0, c1, c2, c3, c4, c5;
  if (a.cov3d != nullptr) {
    const float* c = s_cov + 6 * t;
    c0 = c[0]; c1 = c[1]; c2 = c[2]; c3 = c[3]; c4 = c[4]; c5 = c[5];
  } else {
    const float s0 = expf(sc0) * a.modifier;
    const float s1 = expf(sc1) * a.modifier;
    const float s2 = expf(sc2) * a.modifier;
    const float n2 = ((q.x * q.x + q.y * q.y) + q.z * q.z) + q.w * q.w;
    const float inv_n = 1.0f / sqrtf(clamp_lo(n2, 1e-24f));
    const float r = q.x * inv_n, i = q.y * inv_n, j = q.z * inv_n,
                k = q.w * inv_n;
    const float r00 = 1.0f - 2.0f * (j * j + k * k);
    const float r01 = 2.0f * (i * j - r * k);
    const float r02 = 2.0f * (i * k + r * j);
    const float r10 = 2.0f * (i * j + r * k);
    const float r11 = 1.0f - 2.0f * (i * i + k * k);
    const float r12 = 2.0f * (j * k - r * i);
    const float r20 = 2.0f * (i * k - r * j);
    const float r21 = 2.0f * (j * k + r * i);
    const float r22 = 1.0f - 2.0f * (i * i + j * j);
    const float v0 = s0 * s0, v1 = s1 * s1, v2 = s2 * s2;
    c0 = ((r00 * r00) * v0 + (r01 * r01) * v1) + (r02 * r02) * v2;
    c1 = ((r00 * r10) * v0 + (r01 * r11) * v1) + (r02 * r12) * v2;
    c2 = ((r00 * r20) * v0 + (r01 * r21) * v1) + (r02 * r22) * v2;
    c3 = ((r10 * r10) * v0 + (r11 * r11) * v1) + (r12 * r12) * v2;
    c4 = ((r10 * r20) * v0 + (r11 * r21) * v1) + (r12 * r22) * v2;
    c5 = ((r20 * r20) * v0 + (r21 * r21) * v1) + (r22 * r22) * v2;
  }

  // ---- EWA projection (_cov2d_scalar) ----
  const float t0 = ((V[0] * x + V[1] * y) + V[2] * z) + V[3];
  const float t1 = ((V[4] * x + V[5] * y) + V[6] * z) + V[7];
  const float lim_x = 1.3f * tan_x;
  const float lim_y = 1.3f * tan_y;
  const float tz = in_front ? p_view_z : 1.0f;
  const float tx = clamp_t(t0 / tz, -lim_x, lim_x) * tz;
  const float ty = clamp_t(t1 / tz, -lim_y, lim_y) * tz;
  const float fx = (1.0f / (2.0f * tan_x)) * (float)a.width;
  const float fy = (1.0f / (2.0f * tan_y)) * (float)a.height;
  const float inv_z = 1.0f / tz;
  const float inv_z2 = inv_z * inv_z;
  const float j00 = fx * inv_z;
  const float j02 = ((-fx) * tx) * inv_z2;
  const float j11 = fy * inv_z;
  const float j12 = ((-fy) * ty) * inv_z2;
  const float m00 = j00 * V[0] + j02 * V[8];
  const float m01 = j00 * V[1] + j02 * V[9];
  const float m02 = j00 * V[2] + j02 * V[10];
  const float m10 = j11 * V[4] + j12 * V[8];
  const float m11 = j11 * V[5] + j12 * V[9];
  const float m12 = j11 * V[6] + j12 * V[10];
  const float s00 = (m00 * c0 + m01 * c1) + m02 * c2;
  const float s01 = (m00 * c1 + m01 * c3) + m02 * c4;
  const float s02 = (m00 * c2 + m01 * c4) + m02 * c5;
  const float s10 = (m10 * c0 + m11 * c1) + m12 * c2;
  const float s11 = (m10 * c1 + m11 * c3) + m12 * c4;
  const float s12 = (m10 * c2 + m11 * c4) + m12 * c5;
  const float cov_xx = ((s00 * m00 + s01 * m01) + s02 * m02) + 0.3f;
  const float cov_xy = (s00 * m10 + s01 * m11) + s02 * m12;
  const float cov_yy = ((s10 * m10 + s11 * m11) + s12 * m12) + 0.3f;

  // ---- conic, radius, opacity ----
  const float det = cov_xx * cov_yy - cov_xy * cov_xy;
  const bool det_ok = det != 0.0f;
  const float det_inv = 1.0f / (det_ok ? det : 1.0f);
  const float conic_a = cov_yy * det_inv;
  const float conic_b = (-cov_xy) * det_inv;
  const float conic_c = cov_xx * det_inv;
  const float mid = 0.5f * (cov_xx + cov_yy);
  const float disc = sqrtf(clamp_lo(mid * mid - det, 0.1f));
  const float lam_max = mid + disc;
  const float lam_pos = clamp_lo(lam_max, 0.0f);
  const float radius_f = ceilf(3.0f * sqrtf(lam_pos));
  const float opacity = 1.0f / (1.0f + expf(-op));
  const float q_cut = 2.0f * logf(clamp_lo(opacity, 1e-12f) * 255.0f);
  const float qc = clamp_lo(q_cut, 0.0f) * (float)(1.0 + 1e-6);
  const float r_bin = ceilf(sqrtf(clamp_hi(qc, 9.0f) * lam_pos));
  const float px = (((pc0 * p_w) + 1.0f) * (float)a.width - 1.0f) * 0.5f;
  const float py = (((pc1 * p_w) + 1.0f) * (float)a.height - 1.0f) * 0.5f;

  // ---- tile rectangle, validity ----
  const Rect rb = tile_rect(px, py, r_bin, a.grid_x, a.grid_y);
  const Rect r3s = tile_rect(px, py, radius_f, a.grid_x, a.grid_y);
  const int area = (rb.x1 - rb.x0) * (rb.y1 - rb.y0);
  const bool valid = valid_in & in_front & det_ok &
                     ((r3s.x1 - r3s.x0) * (r3s.y1 - r3s.y0) > 0);
  int tiles = valid ? area : 0;

  // ---- exact per-cell counts of rectangles up to 3x3 (cell_sel) ----
  const int w_r = rb.x1 - rb.x0, h_r = rb.y1 - rb.y0;
  const bool pd = (conic_a > 0.0f) & (conic_c > 0.0f) &
                  (conic_a * conic_c - conic_b * conic_b > 0.0f);
  float sel_lo = -1.0f, sel_hi = -1.0f;
  if ((w_r <= 3) & (h_r <= 3) & pd) {
    int cnt = 0;
    float p16 = 1.0f;              // 16^(cnt mod 6)
    sel_lo = 0.0f;
    sel_hi = 0.0f;
    for (int jc = 0; jc < 9; ++jc) {
      const int dxc = jc % 3, dyc = jc / 3;
      if (dxc >= w_r || dyc >= h_r) continue;
      const float lx = (float)((rb.x0 + dxc) * 16) - px;
      const float ly = (float)((rb.y0 + dyc) * 16) - py;
      if (cell_min_q(lx, lx + 15.0f, ly, ly + 15.0f, conic_a, conic_b,
                     conic_c) <= qc) {
        const float nib = (float)jc * p16;
        if (cnt < 6) sel_lo = sel_lo + nib;
        else sel_hi = sel_hi + nib;
        ++cnt;
        p16 = cnt == 6 ? 1.0f : p16 * 16.0f;
      }
    }
    tiles = valid ? cnt : 0;
  }

  // ---- SH colour (_sh_color_scalar), or override_color ----
  float rgb[3];
  if (a.override_color != nullptr) {
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = __ldg(a.override_color + 3 * g + c);
  } else {
    float dx = x - s_cam[32], dy = y - s_cam[33], dz = z - s_cam[34];
    const float inv_len =
        1.0f / clamp_lo(sqrtf((dx * dx + dy * dy) + dz * dz), 1e-12f);
    dx = dx * inv_len;
    dy = dy * inv_len;
    dz = dz * inv_len;
    const float* C = a.sh;
    float b[16];
    b[0] = C[0];
    const int nbasis = (a.deg + 1) * (a.deg + 1);
    if (a.deg > 0) {
      b[1] = (-C[1]) * dy;
      b[2] = C[1] * dz;
      b[3] = (-C[1]) * dx;
      if (a.deg > 1) {
        const float xx = dx * dx, yy = dy * dy, zz = dz * dz;
        b[4] = (C[2] * dx) * dy;
        b[5] = (C[3] * dy) * dz;
        b[6] = C[4] * ((2.0f * zz - xx) - yy);
        b[7] = (C[5] * dx) * dz;
        b[8] = C[6] * (xx - yy);
        if (a.deg > 2) {
          b[9] = (C[7] * dy) * (3.0f * xx - yy);
          b[10] = ((C[8] * dx) * dy) * dz;
          b[11] = (C[9] * dy) * ((4.0f * zz - xx) - yy);
          b[12] = (C[10] * dz) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
          b[13] = (C[11] * dx) * ((4.0f * zz - xx) - yy);
          b[14] = (C[12] * dz) * (xx - yy);
          b[15] = (C[13] * dx) * (xx - 3.0f * yy);
        }
      }
    }
    const float f0[3] = {f0r, f0g, f0b};
    const float* fr = s_rest + t * r3;   // coefficient k >= 1 at 3 (k - 1)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = b[0] * f0[c];
#pragma unroll
      for (int k = 1; k < 16; ++k)
        if (k < nbasis) acc = acc + b[k] * fr[3 * (k - 1) + c];
      rgb[c] = clamp_lo(acc + 0.5f, 0.0f);
    }
  }

  // ---- outputs, each written once ----
  reinterpret_cast<float2*>(a.mean2d)[g] = make_float2(px, py);
  a.depth[g] = p_view_z;
  a.conic[3 * g] = conic_a;
  a.conic[3 * g + 1] = conic_b;
  a.conic[3 * g + 2] = conic_c;
  a.opa[g] = opacity;
#pragma unroll
  for (int c = 0; c < 3; ++c) a.color[3 * g + c] = rgb[c];
  a.radius[g] = valid ? (int)radius_f : 0;
  reinterpret_cast<int2*>(a.rect_min)[g] = make_int2(rb.x0, rb.y0);
  reinterpret_cast<int2*>(a.rect_max)[g] = make_int2(rb.x1, rb.y1);
  a.tiles[g] = tiles;
  a.valid_out[g] = valid ? 1 : 0;
  reinterpret_cast<float2*>(a.cell_sel)[g] = make_float2(sel_lo, sel_hi);
}

}  // namespace

extern "C" int goi_preprocess(
    const void* xyz, const void* scaling, const void* rotation,
    const void* opacity, const void* dc, const void* rest, const void* valid,
    const void* cov3d, const void* override_color, const void* world_view,
    const void* full_proj, const void* center, const void* tan_fovx,
    const void* tan_fovy, void* mean2d, void* depth, void* conic, void* opa,
    void* color, void* radius, void* rect_min, void* rect_max, void* tiles,
    void* valid_out, void* cell_sel, long long n, int width, int height,
    int deg, int rest_rows, float modifier, const float* sh_consts,
    void* stream) {
  if (n < 0 || width <= 0 || height <= 0 || deg < 0 || deg > 3 ||
      rest_rows < 0 || rest_rows > MAX_REST ||
      (override_color == nullptr && (deg + 1) * (deg + 1) - 1 > rest_rows))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Args a;
  a.xyz = static_cast<const float*>(xyz);
  a.scaling = static_cast<const float*>(scaling);
  a.rotation = static_cast<const float*>(rotation);
  a.opacity = static_cast<const float*>(opacity);
  a.dc = static_cast<const float*>(dc);
  a.rest = static_cast<const float*>(rest);
  a.valid = static_cast<const unsigned char*>(valid);
  a.cov3d = static_cast<const float*>(cov3d);
  a.override_color = static_cast<const float*>(override_color);
  a.world_view = static_cast<const float*>(world_view);
  a.full_proj = static_cast<const float*>(full_proj);
  a.center = static_cast<const float*>(center);
  a.tan_fovx = static_cast<const float*>(tan_fovx);
  a.tan_fovy = static_cast<const float*>(tan_fovy);
  a.mean2d = static_cast<float*>(mean2d);
  a.depth = static_cast<float*>(depth);
  a.conic = static_cast<float*>(conic);
  a.opa = static_cast<float*>(opa);
  a.color = static_cast<float*>(color);
  a.radius = static_cast<int*>(radius);
  a.rect_min = static_cast<int*>(rect_min);
  a.rect_max = static_cast<int*>(rect_max);
  a.tiles = static_cast<int*>(tiles);
  a.valid_out = static_cast<unsigned char*>(valid_out);
  a.cell_sel = static_cast<float*>(cell_sel);
  a.n = n;
  a.width = width;
  a.height = height;
  a.grid_x = (width + 15) / 16;
  a.grid_y = (height + 15) / 16;
  a.deg = deg;
  a.rest_rows = rest_rows;
  a.modifier = modifier;
  a.rot16 = (reinterpret_cast<size_t>(rotation) & 15) == 0;
  a.rest16 = (reinterpret_cast<size_t>(rest) & 15) == 0;
  a.cov16 = (reinterpret_cast<size_t>(cov3d) & 15) == 0;
  for (int i = 0; i < N_SH; ++i) a.sh[i] = sh_consts[i];
  const bool need_sh = deg > 0 && override_color == nullptr;
  const size_t smem =
      sizeof(float) * ((need_sh ? THREADS * rest_rows * 3 : 0) +
                       (cov3d != nullptr ? THREADS * 6 : 0) + CAM_FLOATS);
  const long long blocks = (n + THREADS - 1) / THREADS;
  preprocess_kernel<<<(unsigned)blocks, THREADS, smem,
                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
