// Opacity-weighted Gaussian mixture on a regular grid:
//   grid[i, j, k] = sum_n w_n * 2^(q_n(x_i, y_j, z_k)),
//   q_n(p) = -0.5 * log2(e) * (p - mu_n)^T P_n (p - mu_n),
// P_n = R diag(1 / max(s, 1e-6)^2) R^T, float32, over the grid axes
// (x_i = y_i = z_i = axes[i]). The wrapper (goi_tpu_torch/export/mesh.py
// `mixture_grid`) packs each valid Gaussian as 12 floats:
//   mx my mz w | cxx cxy cyy cxz | cyz czz 0 0
// with the symmetric form's six entries already scaled by -0.5 log2(e)
// (the cross terms also by 2), so that
//   q = dx (cxx dx + cxy dy) + cyy dy dy + dz (cxz dx + cyz dy + czz dz).
//
// Replaces goi_tpu/export/mesh.py `density_grid` (lines 24-71), which the
// JAX package computes in XLA, not Pallas: `jax.lax.map` over batches of
// 4096 grid points, each materialising (4096, N, 3) differences (49 GB at
// N = 1M). Nothing of that shape fits the card; nothing here is stored
// per pair.
//
// Bound on the H100: operations, and among them the exponentials. At the
// main path's 128^3 grid and 1M Gaussians there are 2.1e12 pairs. Each
// pair takes one ex2 on the special-function units: 16 lanes a clock on
// each SM against 128 float32 lanes, so 67e12 / 16 = 4.19e12 a second,
// 0.50 s. The float32 pipe takes per pair one subtraction (dz) and three
// fused multiply-adds (the two steps of the dz polynomial and the
// accumulate), 7 operations, plus the per-Gaussian terms (dx, dy and the
// dz-free parts of q, 9 operations shared by a thread's ZPT points), ~8
// operations a pair: 0.25 s at 67 TFLOP/s. Bytes are nothing beside
// either (48 B a Gaussian read per CTA from L2, 4 B a point written once).
//
// Design: the n-body pattern. One thread owns ZPT points along z that
// share x and y, so dx, dy and the dz-free parts of q are formed once per
// Gaussian for ZPT points; a CTA stages TILE Gaussians at a time in
// shared memory (three 16-byte rows each, read by every thread as a
// broadcast); each point's sum lives in a register and is taken in
// ascending Gaussian order, so the grid is the same bits from run to
// run. The exponential is `ex2.approx.ftz.f32` (relative error ~2^-22 by
// the PTX ISA; a result under 2^-126 flushes to 0, which no point's sum
// can notice), the only special-function operation of a pair. One launch
// covers the whole grid. Built with -fmad=true (_nvcc.CONTRACT): no
// threshold here has to decide as the plain version does.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int TILE = THREADS;  // Gaussians staged per round, one a thread
constexpr int ZPT = 8;         // grid points a thread owns along z

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// gauss (n, 3) float4 rows; axes (r,); grid (r, r, r). Thread t owns the
// row (i, j) = divmod(t / kc, r) and the points k = (t % kc) * ZPT + z.
__global__ void __launch_bounds__(THREADS)
density_grid_kernel(const float4* __restrict__ gauss,
                    const float* __restrict__ axes, float* __restrict__ grid,
                    int n, int r, int kc) {
  __shared__ float4 tile[3][TILE];
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long row = t / kc;
  const int k0 = (int)(t - row * kc) * ZPT;
  const bool owner = row < (long long)r * r;
  const int i = owner ? (int)(row / r) : 0;
  const int j = owner ? (int)(row - (long long)i * r) : 0;
  const float x = axes[i];
  const float y = axes[j];
  float z[ZPT], acc[ZPT];
#pragma unroll
  for (int q = 0; q < ZPT; ++q) {
    z[q] = axes[min(k0 + q, r - 1)];
    acc[q] = 0.f;
  }
  for (int base = 0; base < n; base += TILE) {
    const int g = base + threadIdx.x;
    if (g < n) {
      tile[0][threadIdx.x] = gauss[3LL * g];
      tile[1][threadIdx.x] = gauss[3LL * g + 1];
      tile[2][threadIdx.x] = gauss[3LL * g + 2];
    }
    __syncthreads();
    const int count = min(TILE, n - base);
#pragma unroll 2
    for (int s = 0; s < count; ++s) {
      const float4 a = tile[0][s];   // mx my mz w
      const float4 b = tile[1][s];   // cxx cxy cyy cxz
      const float4 c = tile[2][s];   // cyz czz
      const float dx = x - a.x;
      const float dy = y - a.y;
      const float qa = dx * (b.x * dx + b.y * dy) + b.z * (dy * dy);
      const float qb = b.w * dx + c.x * dy;
#pragma unroll
      for (int q = 0; q < ZPT; ++q) {
        const float dz = z[q] - a.z;
        acc[q] += a.w * ex2(qa + dz * (qb + c.y * dz));
      }
    }
    __syncthreads();
  }
  if (owner) {
    float* out = grid + row * r;
#pragma unroll
    for (int q = 0; q < ZPT; ++q)
      if (k0 + q < r) out[k0 + q] = acc[q];
  }
}

}  // namespace

// gauss: (n, 12) float32 rows as above (16-byte aligned); axes (r,);
// grid (r, r, r) written whole. n may be 0 (a grid of zeros).
extern "C" int goi_density_grid(const void* gauss, const void* axes,
                                void* grid, int n, int r, void* stream) {
  if (n < 0 || r <= 0) return (int)cudaErrorInvalidValue;
  const int kc = (r + ZPT - 1) / ZPT;
  const long long threads = (long long)r * r * kc;
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  density_grid_kernel<<<(unsigned)blocks, THREADS, 0,
                        (cudaStream_t)stream>>>(
      static_cast<const float4*>(gauss), static_cast<const float*>(axes),
      static_cast<float*>(grid), n, r, kc);
  return (int)cudaGetLastError();
}
