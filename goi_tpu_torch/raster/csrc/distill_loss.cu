// The distillation loss's per-pixel work (semantic/losses.py
// `distillation_loss`), forward and backward in one pass over the pixels'
// rows, between two fp32 GEMMs that PyTorch runs:
//
//   sim  = gtl @ u^T                    (P, K)   before the rows
//   rows: this file's row kernels        read sim, write dsim over it
//   R    = dsim^T @ gtl                 (K, C)   in the backward
//
// with gtl the unit rows of the (P, C) ground-truth features g, L the
// (K, C) codebook, n_k = max(|L_k|, 1e-8) and u_k = L_k / n_k, each made
// by the composition's own operations, so that sim is the composition's
// bit for bit: a k-means codebook holds rows that tie exactly in sim, and
// the label (sim == its row's max) must tie as the composition's does.
// A row kernel has the decoder's logits z = W sem_p + b (computed from W
// (K, S) in shared memory by `rows_kernel`, or computed by the caller and
// read by `wide_kernel`), and takes their softmax q, the argmax of q
// (first index on ties), the max of sim and its tied codes, the annealed
// softmax of t sim and its entropy, and recc's cosine n_c sim[p, c] /
// (|L_c| |gtl_p| + 1e-12) at the argmax code c. It adds up the four
// terms, and writes the gradients of the total (grad_output 1; the
// backward scales): dsem = W^T dz (S, P), dW and db as per-block partials
// (`rows_kernel`) or dz itself (`wide_kernel`), and over sim's row
//
//   dsim[p, k] = -[k tied] / (P cnt_p) - 0.3 t / P s_k (log s_k + H_p)
//                + [k = c_p] alpha_p n_c,   alpha_p = -1 / (P D_p)
//
// recc's gradient to L_c is sum_p alpha_p gtl_p + beta_p L_c / |L_c|
// (beta_p = N_p |gtl_p| / (P D_p^2)), taken directly, not through u; the
// alpha_p n_c term rides in the GEMM through u's Jacobian (I - u u^T) /
// n_c, and the per-code sums A_c = sum alpha_p sim[p, c] (what the
// projection takes off along u_c) and B_c = sum beta_p give it back in
// the backward's epilogue. A clamped norm (|L_c| < 1e-8) has no
// projection. Every sum across pixels is a per-block partial, summed over
// the blocks in their order by `finish_kernel` (no float atomics): two
// runs give the same bits.
//
// Replaces no Pallas kernel: the loss was XLA in goi_tpu (a fused chain
// around two MXU products). Eager PyTorch ran it as ~20 passes over fp32
// (P, 300) tensors forward and backward, and two more products of P x
// 256 x 300 that pick LUT rows by a one-hot matrix.
//
// Bound on the H100: the two GEMMs, 2 x 2 P K C flops (385 GFLOP at the
// main path's 1.25M pixels, 5.75 ms at 67 TFLOP/s fp32), run by cuBLAS.
// The row kernel reads sim once and writes dsim once (3 GB at 1.25M x
// 300, 0.9 ms at 3.35 TB/s) and evaluates two exponentials a code; the
// softmaxes' exponentials are __expf and their divisions one reciprocal a
// row. Design of `rows_kernel` (the main path: a one-layer decoder, K <=
// KMAX codes): a block of 10 warps takes tiles of 40 pixels; the tile's
// logits are a small product done with a thread per code (its W row in
// registers, the pixels' features broadcast from shared memory), the row
// reductions a warp per pixel (lanes own codes lane + 32 j, butterfly
// shuffles, so every lane holds each sum), and the per-code sums of dW,
// db, A and B a thread per code over the tile's dz in shared memory.
// `wide_kernel` (any other decoder, any K) walks each row four times in
// strides of 32 codes instead of holding it in registers. Blocks take
// contiguous runs of tiles, ROW_BLOCKS of them at most (two on each of
// the card's 132 SMs), so the per-block partials are few.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NT = 320;              // threads of a row block: 10 warps
constexpr int WARPS = NT / 32;
constexpr int PPW = 4;               // pixels a warp takes in a tile
constexpr int TILE = WARPS * PPW;    // 40 pixels
constexpr int J = 10;                // codes a lane holds in rows_kernel
constexpr int KMAX = 32 * J;         // rows_kernel's codes: a thread each
constexpr int ROW_BLOCKS = 264;      // semantic/losses.py ROW_BLOCKS
constexpr int NLOSS = 4;             // the terms' sums: lab, max, H, cos
constexpr int RED = 256;             // threads of the small kernels

static_assert(KMAX == NT, "rows_kernel gives each thread one code");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// the larger value, the smaller index on ties: the same pair in every lane
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, o);
    const int oi = __shfl_xor_sync(FULL, i, o);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// a block's sum of one value a thread, in a fixed tree order
__device__ __forceinline__ float block_sum(float v, float* buf) {
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int h = RED / 2; h > 0; h >>= 1) {
    if ((int)threadIdx.x < h) buf[threadIdx.x] += buf[threadIdx.x + h];
    __syncthreads();
  }
  const float out = buf[0];
  __syncthreads();
  return out;
}

struct RowArgs {
  float* sim;              // (P, K): gtl @ u^T in; dsim out (do_lut)
  const float* logits;     // (P, K) wide_kernel
  float* dlogits;          // (P, K) wide_kernel's gradient, or null
  const float* sem;        // (P, S) at strides (sem_sp, sem_ss): rows_kernel
  long long sem_sp, sem_ss;
  const float* w;          // (K, S) rows_kernel
  const float* b;          // (K,) or null
  float* dsem;             // (S, P) or null
  const float* gnorm;      // (P,) |g_p|: |gtl_p| = |g_p| / max(|g_p|, 1e-8)
  const float* lnorm;      // (K,) |L_k|
  float* part;             // (gridDim.x, ncol) per-block partials
  int P, K, S, ncol;
  float t, inv_p, c_lab, c_sl1;
  int do_lut, do_dw;
};

// columns of a block's partials: the four sums, dW (K x S) from NLOSS,
// then db, A and B from col_db
__host__ __device__ __forceinline__ int col_db(int K, int S) {
  return NLOSS + K * S;
}

// the tiles [t0, t1) of this block: contiguous runs, in block order
__device__ __forceinline__ void block_tiles(int tiles, int& t0, int& t1) {
  t0 = (int)((long long)blockIdx.x * tiles / gridDim.x);
  t1 = (int)((long long)(blockIdx.x + 1) * tiles / gridDim.x);
}

// a pixel's recc term: its cosine's numerator n_c sim[p, c] and
// denominator |L_c| |gtl_p| + 1e-12
struct Recc {
  float nc, num, den;
};

__device__ __forceinline__ Recc recc_at(const RowArgs& a, int code,
                                        float sc, float gunit) {
  const float lc = a.lnorm[code];
  const float nc = fmaxf(lc, 1e-8f);
  return {nc, nc * sc, lc * gunit + 1e-12f};
}

// the shared rows of W and of the tile's features: SM floats padded to
// whole float4s, and to an odd number of them, so that eight lanes'
// 16-byte loads of eight rows fall in distinct banks
template <int SM>
__host__ __device__ constexpr int padded() {
  return (SM + 3) / 4 % 2 ? (SM + 3) / 4 * 4 : (SM + 3) / 4 * 4 + 4;
}

template <int SM>
constexpr int row_smem_floats() {
  return TILE * KMAX + (KMAX + 2 * TILE) * padded<SM>() + 3 * TILE +
         WARPS * NLOSS;
}

// a warp's sums of N values a lane (N = 16 or 32) by halving exchanges:
// lane l ends with the whole sum of value l >> 1 (N = 16) or l (N = 32)
template <int N, int O>
struct HalvingSum {
  __device__ __forceinline__ static void run(float* v, int lane) {
    const bool up = lane & O;
#pragma unroll
    for (int m = 0; m < N / 2; ++m) {
      const float send = up ? v[m] : v[m + N / 2];
      const float keep = up ? v[m + N / 2] : v[m];
      v[m] = keep + __shfl_xor_sync(FULL, send, O);
    }
    HalvingSum<N / 2, O / 2>::run(v, lane);
  }
};

template <int O>
struct HalvingSum<1, O> {
  __device__ __forceinline__ static void run(float* v, int lane) {
    v[0] += __shfl_xor_sync(FULL, v[0], O);
    HalvingSum<1, O / 2>::run(v, lane);
  }
};

template <>
struct HalvingSum<1, 0> {
  __device__ __forceinline__ static void run(float*, int) {}
};

// The main path: the decoder's logits in the kernel, S <= SM (10 or 32),
// K <= KMAX, a thread a code k = threadIdx.x.
template <int SM>
__global__ void __launch_bounds__(NT, 2)
rows_kernel(RowArgs a, int tiles) {
  constexpr int SP = padded<SM>(), SQ = SP / 4;
  constexpr int NV = SM <= 16 ? 16 : 32;      // dsem's halving sums
  extern __shared__ float smem[];
  float* zt = smem;                                   // [TILE][KMAX]
  float* wk = zt + TILE * KMAX;                       // [KMAX][SP] W
  float* semt = wk + KMAX * SP;                       // [TILE][SP]
  float* dsemt = semt + TILE * SP;                    // [TILE][SP]
  float* pa = dsemt + TILE * SP;                      // [TILE] alpha sim_c
  float* pb = pa + TILE;                              // [TILE] beta
  int* pc = reinterpret_cast<int*>(pb + TILE);        // [TILE] code
  float* red = reinterpret_cast<float*>(pc + TILE);   // [WARPS][NLOSS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = a.K, S = a.S;
  const int k = tid;                                  // this thread's code
  const bool own = k < K;
  const bool need_dz = a.dsem != nullptr || a.do_dw;
  for (int e = tid; e < KMAX * SP; e += NT) {
    const int kk = e / SP, s = e - kk * SP;
    wk[e] = (s < S && kk < K) ? a.w[(long long)kk * S + s] : 0.f;
  }
  const float breg = (a.b != nullptr && own) ? a.b[k] : 0.f;
  float dw[SM], db = 0.f, sa = 0.f, sb = 0.f;
#pragma unroll
  for (int s = 0; s < SM; ++s) dw[s] = 0.f;
  // the warp's sums over its pixels (the same in every lane)
  float s_lab = 0.f, s_max = 0.f, s_h = 0.f, s_cos = 0.f;
  int t0, t1;
  block_tiles(tiles, t0, t1);
  __syncthreads();

  for (int tile = t0; tile < t1; ++tile) {
    const int p0 = tile * TILE;
    const int np = min(TILE, a.P - p0);
    for (int e = tid; e < TILE * SP; e += NT) {
      const int s = e / TILE, i = e - s * TILE;
      semt[i * SP + s] = (i < np && s < S)
          ? a.sem[(long long)(p0 + i) * a.sem_sp + (long long)s * a.sem_ss]
          : 0.f;
    }
    __syncthreads();
    // the tile's logits, a thread a code
    if (own) {
      float4 wr[SQ];
#pragma unroll
      for (int q = 0; q < SQ; ++q)
        wr[q] = reinterpret_cast<const float4*>(wk + k * SP)[q];
      for (int i = 0; i < np; ++i) {
        const float4* x4 = reinterpret_cast<const float4*>(semt + i * SP);
        float z = 0.f;
#pragma unroll
        for (int q = 0; q < SQ; ++q) {
          const float4 x = x4[q];
          z += wr[q].x * x.x + wr[q].y * x.y + wr[q].z * x.z + wr[q].w * x.w;
        }
        zt[i * KMAX + k] = z + breg;
      }
    }
    __syncthreads();

    // a warp a pixel
    for (int r = 0; r < PPW; ++r) {
      const int i = warp * PPW + r;
      if (i >= np) break;
      const long long p = p0 + i;
      float* srow = a.sim + p * K;
      float s[J], z[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int kj = lane + 32 * j;
        const bool ok = kj < K;
        s[j] = ok ? srow[kj] : -INFINITY;
        z[j] = ok ? zt[i * KMAX + kj] : -INFINITY;
      }
      const float gn = a.gnorm[p];
      const float gunit = gn / fmaxf(gn, 1e-8f);

      // the decoder's softmax q and its argmax
      float zmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < J; ++j) zmax = fmaxf(zmax, z[j]);
      zmax = warp_max(zmax);
      float q[J], zsum = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        q[j] = (lane + 32 * j < K) ? __expf(z[j] - zmax) : 0.f;
        zsum += q[j];
      }
      const float zinv = 1.f / warp_sum(zsum);
      float best = -INFINITY;
      int code = K;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        q[j] *= zinv;
        if (lane + 32 * j < K && q[j] > best) {
          best = q[j];
          code = lane + 32 * j;
        }
      }
      warp_argmax(best, code);
      code = min(code, K - 1);   // a row of NaN logits picks no code

      // sim's row, its max and the tied codes
      float smax = -INFINITY;
#pragma unroll
      for (int j = 0; j < J; ++j) smax = fmaxf(smax, s[j]);
      smax = warp_max(smax);
      float cnt = 0.f, lab = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (lane + 32 * j >= K) continue;
        const float l = s[j] == smax ? 1.f : 0.f;
        const float d = q[j] - l;
        cnt += l;
        lab += d * d;
      }
      cnt = warp_sum(cnt);
      lab = warp_sum(lab);

      // the annealed softmax and its entropy H
      float amax = -INFINITY;
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (lane + 32 * j < K) amax = fmaxf(amax, a.t * s[j]);
      amax = warp_max(amax);
      // e2: the softmax's numerators, then the softmax; ls: its log
      float e2[J], ls[J], esum = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const bool ok = lane + 32 * j < K;
        ls[j] = ok ? a.t * s[j] - amax : 0.f;
        e2[j] = ok ? __expf(ls[j]) : 0.f;
        esum += e2[j];
      }
      esum = warp_sum(esum);
      const float lse = logf(esum), einv = 1.f / esum;
      float h = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        e2[j] *= einv;
        ls[j] -= lse;
        h -= e2[j] * ls[j];
      }
      h = warp_sum(h);

      // recc's cosine at the argmax code
      float sc = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (lane + 32 * j == code) sc = s[j];
      sc = __shfl_sync(FULL, sc, code & 31);
      const Recc rc = recc_at(a, code, sc, gunit);
      s_lab += lab;
      s_max += smax;
      s_h += h;
      s_cos += rc.num / rc.den;

      if (a.do_lut) {
        const float alpha = -a.inv_p / rc.den;
        const float tie = a.inv_p / cnt;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int kj = lane + 32 * j;
          if (kj >= K) continue;
          float g = (s[j] == smax ? -tie : 0.f)
                    - a.c_sl1 * e2[j] * (ls[j] + h);
          if (kj == code) g += alpha * rc.nc;
          srow[kj] = g;
        }
        if (lane == 0) {
          pc[i] = code;
          pa[i] = alpha * sc;
          pb[i] = a.inv_p * rc.num * gunit / (rc.den * rc.den);
        }
      }
      if (need_dz) {
        float dz[J], qdq = 0.f;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const bool ok = lane + 32 * j < K;
          const float l = (ok && s[j] == smax) ? 1.f : 0.f;
          dz[j] = ok ? a.c_lab * (q[j] - l) : 0.f;
          qdq += q[j] * dz[j];
        }
        qdq = warp_sum(qdq);
#pragma unroll
        for (int j = 0; j < J; ++j) dz[j] = q[j] * (dz[j] - qdq);
        if (a.do_dw) {
#pragma unroll
          for (int j = 0; j < J; ++j)
            if (lane + 32 * j < K) zt[i * KMAX + lane + 32 * j] = dz[j];
        }
        if (a.dsem != nullptr) {
          float v[NV];
#pragma unroll
          for (int s2 = 0; s2 < NV; ++s2) v[s2] = 0.f;
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const float4* w4 =
                reinterpret_cast<const float4*>(wk + (lane + 32 * j) * SP);
#pragma unroll
            for (int q4 = 0; q4 < SQ; ++q4) {
              const float4 x = w4[q4];
              const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
              for (int c = 0; c < 4; ++c)
                if (4 * q4 + c < SM) v[4 * q4 + c] += xs[c] * dz[j];
            }
          }
          HalvingSum<NV, 16>::run(v, lane);
          const int s2 = NV == 16 ? lane >> 1 : lane;
          if ((NV == 32 || (lane & 1) == 0) && s2 < SM)
            dsemt[i * SP + s2] = v[0];
        }
      }
    }
    __syncthreads();

    // the tile's per-code sums, a thread a code, in pixel order
    if (own) {
      for (int i = 0; i < np; ++i) {
        if (a.do_dw) {
          const float d = zt[i * KMAX + k];
          db += d;
#pragma unroll
          for (int q4 = 0; q4 < SQ; ++q4) {
            const float4 x = reinterpret_cast<const float4*>(
                semt + i * SP)[q4];
            const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (4 * q4 + c < SM) dw[4 * q4 + c] += d * xs[c];
          }
        }
        if (a.do_lut && pc[i] == k) {
          sa += pa[i];
          sb += pb[i];
        }
      }
    }
    if (a.dsem != nullptr) {
      for (int e = tid; e < TILE * SM; e += NT) {
        const int s = e / TILE, i = e - s * TILE;
        if (i < np && s < S)
          a.dsem[(long long)s * a.P + p0 + i] = dsemt[i * SP + s];
      }
    }
    __syncthreads();
  }

  // the block's partials
  if (lane == 0) {
    red[warp * NLOSS + 0] = s_lab;
    red[warp * NLOSS + 1] = s_max;
    red[warp * NLOSS + 2] = s_h;
    red[warp * NLOSS + 3] = s_cos;
  }
  __syncthreads();
  float* out = a.part + (long long)blockIdx.x * a.ncol;
  if (tid < NLOSS) {
    float v = 0.f;
    for (int w2 = 0; w2 < WARPS; ++w2) v += red[w2 * NLOSS + tid];
    out[tid] = v;
  }
  const int cdb = col_db(K, S);
  if (own) {
    if (a.do_dw) {
#pragma unroll
      for (int s = 0; s < SM; ++s)
        if (s < S) out[NLOSS + k * S + s] = dw[s];
      out[cdb + k] = db;
    }
    if (a.do_lut) {
      out[cdb + K + k] = sa;
      out[cdb + 2 * K + k] = sb;
    }
  }
}

// Any other decoder, any K: the logits (P, K) come from the caller and
// their gradient dz goes to dlogits. A warp a pixel walks its two rows
// in strides of 32 codes four times (the maxima; the sums; the terms,
// the softmaxes' argmax and dz's sum; the gradients), reading them again
// each time, and every value a lane adds up it adds in rows_kernel's
// order. The block's per-code sums A and B build up in its own row of
// the partials: a code's owner thread k % NT adds the tile's pixels in
// their order.
__global__ void __launch_bounds__(NT)
wide_kernel(RowArgs a, int tiles) {
  __shared__ float pa[TILE], pb[TILE];
  __shared__ int pc[TILE];
  __shared__ float red[WARPS * NLOSS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = a.K;
  float* out = a.part + (long long)blockIdx.x * a.ncol;
  float* sum_a = out + col_db(K, 0) + K;
  float* sum_b = sum_a + K;
  for (int k = tid; k < K; k += NT)   // db's columns too: no dW here
    out[NLOSS + k] = sum_a[k] = sum_b[k] = 0.f;
  float s_lab = 0.f, s_max = 0.f, s_h = 0.f, s_cos = 0.f;
  int t0, t1;
  block_tiles(tiles, t0, t1);

  for (int tile = t0; tile < t1; ++tile) {
    const int p0 = tile * TILE;
    const int np = min(TILE, a.P - p0);
    for (int r = 0; r < PPW; ++r) {
      const int i = warp * PPW + r;
      if (i >= np) break;
      const long long p = p0 + i;
      float* srow = a.sim + p * K;
      const float* zrow = a.logits + p * K;
      const float gn = a.gnorm[p];
      const float gunit = gn / fmaxf(gn, 1e-8f);

      float zmax = -INFINITY, smax = -INFINITY, amax = -INFINITY;
      for (int k = lane; k < K; k += 32) {
        const float s = srow[k];
        zmax = fmaxf(zmax, zrow[k]);
        smax = fmaxf(smax, s);
        amax = fmaxf(amax, a.t * s);
      }
      zmax = warp_max(zmax);
      smax = warp_max(smax);
      amax = warp_max(amax);

      float zsum = 0.f, esum = 0.f, cnt = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float s = srow[k];
        zsum += __expf(zrow[k] - zmax);
        esum += __expf(a.t * s - amax);
        cnt += s == smax ? 1.f : 0.f;
      }
      const float zinv = 1.f / warp_sum(zsum);
      esum = warp_sum(esum);
      cnt = warp_sum(cnt);
      const float lse = logf(esum), einv = 1.f / esum;

      float best = -INFINITY, lab = 0.f, h = 0.f, qdq = 0.f;
      int code = K;
      for (int k = lane; k < K; k += 32) {
        const float s = srow[k];
        const float q = __expf(zrow[k] - zmax) * zinv;
        const float l = s == smax ? 1.f : 0.f;
        const float x = a.t * s - amax;
        if (q > best) {
          best = q;
          code = k;
        }
        lab += (q - l) * (q - l);
        h -= __expf(x) * einv * (x - lse);
        qdq += q * (a.c_lab * (q - l));
      }
      warp_argmax(best, code);
      code = min(code, K - 1);   // a row of NaN logits picks no code
      lab = warp_sum(lab);
      h = warp_sum(h);
      qdq = warp_sum(qdq);
      const float sc = srow[code];
      __syncwarp();              // every lane has read sc before dsim
      const Recc rc = recc_at(a, code, sc, gunit);
      s_lab += lab;
      s_max += smax;
      s_h += h;
      s_cos += rc.num / rc.den;

      const float alpha = -a.inv_p / rc.den;
      const float tie = a.inv_p / cnt;
      if (a.do_lut || a.dlogits != nullptr) {
        for (int k = lane; k < K; k += 32) {
          const float s = srow[k];
          const bool tied = s == smax;
          if (a.dlogits != nullptr) {
            const float q = __expf(zrow[k] - zmax) * zinv;
            a.dlogits[p * K + k] =
                q * (a.c_lab * (q - (tied ? 1.f : 0.f)) - qdq);
          }
          if (a.do_lut) {
            const float x = a.t * s - amax;
            float g = (tied ? -tie : 0.f)
                      - a.c_sl1 * (__expf(x) * einv) * (x - lse + h);
            if (k == code) g += alpha * rc.nc;
            srow[k] = g;
          }
        }
      }
      if (a.do_lut && lane == 0) {
        pc[i] = code;
        pa[i] = alpha * sc;
        pb[i] = a.inv_p * rc.num * gunit / (rc.den * rc.den);
      }
    }
    __syncthreads();
    if (a.do_lut) {
      for (int i = 0; i < np; ++i) {
        const int k = pc[i];
        if (k % NT == tid) {
          sum_a[k] += pa[i];
          sum_b[k] += pb[i];
        }
      }
    }
    __syncthreads();
  }

  if (lane == 0) {
    red[warp * NLOSS + 0] = s_lab;
    red[warp * NLOSS + 1] = s_max;
    red[warp * NLOSS + 2] = s_h;
    red[warp * NLOSS + 3] = s_cos;
  }
  __syncthreads();
  if (tid < NLOSS) {
    float v = 0.f;
    for (int w2 = 0; w2 < WARPS; ++w2) v += red[w2 * NLOSS + tid];
    out[tid] = v;
  }
}

// every partial's column summed over the blocks in their order; then the
// four terms and the total from the first four columns
__global__ void __launch_bounds__(RED)
finish_kernel(const float* __restrict__ part, int nblk, int ncol, int nsum,
              float inv_p, float inv_pk, float* __restrict__ sums,
              float* __restrict__ total, float* __restrict__ terms) {
  __shared__ float loss[NLOSS];
  const int c = blockIdx.x * RED + threadIdx.x;
  if (c < nsum) {
    float v = 0.f;
    for (int b = 0; b < nblk; ++b) v += part[(long long)b * ncol + c];
    sums[c] = v;
    if (c < NLOSS) loss[c] = v;
  }
  if (blockIdx.x != 0) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    const float lab = loss[0] * inv_pk * 50.0f;
    const float sl = 1.0f - loss[1] * inv_p;
    const float sl1 = loss[2] * inv_p;
    const float recc = 1.0f - loss[3] * inv_p;
    terms[0] = lab;
    terms[1] = sl;
    terms[2] = sl1;
    terms[3] = recc;
    *total = lab + sl + 0.3f * sl1 + recc;
  }
}

// the backward's epilogue, a block a code: grad_output times dW and db,
// and dL_k from R_k = (dsim^T gtl)_k through u's Jacobian with recc's
// per-code corrections (the file's head)
__global__ void __launch_bounds__(RED)
lut_grad_kernel(const float* __restrict__ R, const float* __restrict__ u,
                const float* __restrict__ lut,
                const float* __restrict__ lnorm,
                const float* __restrict__ sums, int K, int C, int S,
                const float* __restrict__ gscale, float* __restrict__ dlut,
                float* __restrict__ dw, float* __restrict__ db) {
  __shared__ float buf[RED];
  const int k = blockIdx.x;
  const float G = *gscale;
  const int cdb = col_db(K, S);
  if (dw != nullptr)
    for (int s = threadIdx.x; s < S; s += RED)
      dw[(long long)k * S + s] = G * sums[NLOSS + k * S + s];
  if (db != nullptr && threadIdx.x == 0) db[k] = G * sums[cdb + k];
  if (R == nullptr) return;
  const float ln = lnorm[k];
  const float n = fmaxf(ln, 1e-8f);
  const float A = sums[cdb + K + k];
  const float B = sums[cdb + 2 * K + k];
  const bool proj = ln >= 1e-8f;
  const long long row = (long long)k * C;
  float acc = 0.f;
  if (proj)
    for (int c = threadIdx.x; c < C; c += RED) acc += u[row + c] * R[row + c];
  const float dot = proj ? block_sum(acc, buf) : 0.f;
  const float bl = ln > 0.f ? B / ln : 0.f;
  for (int c = threadIdx.x; c < C; c += RED) {
    const float uc = u[row + c];
    const float v = proj ? (R[row + c] - uc * dot) / n + uc * A
                         : R[row + c] / n;
    dlut[row + c] = G * (v + bl * lut[row + c]);
  }
}

template <int SM>
int launch_rows(const RowArgs& a, int tiles, int nblk, cudaStream_t st) {
  const size_t bytes = sizeof(float) * row_smem_floats<SM>();
  // the attribute belongs to the current device: set it on every launch
  const cudaError_t e = cudaFuncSetAttribute(
      rows_kernel<SM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  rows_kernel<SM><<<nblk, NT, bytes, st>>>(a, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// The row kernel. Decoder in the kernel (logits null): sem (P, S) at
// strides (sem_sp, sem_ss), w (K, S) contiguous, b (K,) or null, S <= 32,
// K <= 320; dsem (S, P) or null. Logits path: logits (P, K) contiguous,
// dlogits (P, K) or null, S = 0, any K. sim (P, K) contiguous,
// overwritten by dsim when do_lut; gnorm (P,) = |g_p|, lnorm (K,) =
// |L_k|. part holds ROW_BLOCKS rows of ncol = 4 + K (S + 3) floats.
extern "C" int goi_distill_rows(
    void* sim, const void* logits, void* dlogits, const void* sem,
    long long sem_sp, long long sem_ss, const void* w, const void* b,
    void* dsem, const void* gnorm, const void* lnorm, void* part, int P,
    int K, int S, float t, float inv_p, float c_lab, float c_sl1, int do_lut,
    int do_dw, void* stream) {
  const bool fused = logits == nullptr;
  if (P <= 0 || K <= 0 ||
      (fused && (K > KMAX || S <= 0 || S > 32)) || (!fused && S != 0))
    return (int)cudaErrorInvalidValue;
  RowArgs a;
  a.sim = static_cast<float*>(sim);
  a.logits = static_cast<const float*>(logits);
  a.dlogits = static_cast<float*>(dlogits);
  a.sem = static_cast<const float*>(sem);
  a.sem_sp = sem_sp;
  a.sem_ss = sem_ss;
  a.w = static_cast<const float*>(w);
  a.b = static_cast<const float*>(b);
  a.dsem = static_cast<float*>(dsem);
  a.gnorm = static_cast<const float*>(gnorm);
  a.lnorm = static_cast<const float*>(lnorm);
  a.part = static_cast<float*>(part);
  a.P = P;
  a.K = K;
  a.S = S;
  a.ncol = NLOSS + K * (S + 3);
  a.t = t;
  a.inv_p = inv_p;
  a.c_lab = c_lab;
  a.c_sl1 = c_sl1;
  a.do_lut = do_lut;
  a.do_dw = do_dw;
  const int tiles = (P + TILE - 1) / TILE;
  const int nblk = tiles < ROW_BLOCKS ? tiles : ROW_BLOCKS;
  cudaStream_t st = (cudaStream_t)stream;
  if (!fused) {
    wide_kernel<<<nblk, NT, 0, st>>>(a, tiles);
    return (int)cudaGetLastError();
  }
  return S <= 10 ? launch_rows<10>(a, tiles, nblk, st)
                 : launch_rows<32>(a, tiles, nblk, st);
}

// sums (nsum,) of the row kernel's partials, then total (0-dim) and the
// terms (4,): lab, sl, sl1, recc. nsum is 4 (the terms alone) or ncol.
extern "C" int goi_distill_finish(const void* part, int P, int ncol, int nsum,
                                  float inv_p, float inv_pk, void* sums,
                                  void* total, void* terms, void* stream) {
  if (P <= 0 || nsum < NLOSS || nsum > ncol)
    return (int)cudaErrorInvalidValue;
  const int tiles = (P + TILE - 1) / TILE;
  const int nblk = tiles < ROW_BLOCKS ? tiles : ROW_BLOCKS;
  finish_kernel<<<(nsum + RED - 1) / RED, RED, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(part), nblk, ncol, nsum, inv_p, inv_pk,
      static_cast<float*>(sums), static_cast<float*>(total),
      static_cast<float*>(terms));
  return (int)cudaGetLastError();
}

// The backward's epilogue: gscale (0-dim) is grad_output; R (K, C) =
// dsim^T gtl or null (no LUT gradient), u (K, C), dlut (K, C); dw (K,
// S), db (K,) or null.
extern "C" int goi_distill_lut_grad(const void* R, const void* u,
                                    const void* lut, const void* lnorm,
                                    const void* sums, int K, int C, int S,
                                    const void* gscale, void* dlut, void* dw,
                                    void* db, void* stream) {
  if (K <= 0 || C <= 0 || S < 0) return (int)cudaErrorInvalidValue;
  lut_grad_kernel<<<K, RED, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(R), static_cast<const float*>(u),
      static_cast<const float*>(lut), static_cast<const float*>(lnorm),
      static_cast<const float*>(sums), K, C, S,
      static_cast<const float*>(gscale), static_cast<float*>(dlut),
      static_cast<float*>(dw), static_cast<float*>(db));
  return (int)cudaGetLastError();
}
