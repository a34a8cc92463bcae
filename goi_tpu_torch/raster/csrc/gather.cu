// Expansion gather: out[c, i] = table[c, idx[i]], bit-exact.
//
// Replaces goi_tpu/raster/gather.py `_kernel` (launched by
// `monotone_gather`), which the TPU ran as a block-diagonal one-hot
// matmul on the MXU because its general gather runs per element. A GPU
// gathers natively, so the one-hot product, the 128-aligned window `lo`
// and the SPAN table pad do not carry over: this is a plain copy.
//
// Bound on the H100: bytes. It moves C*M floats out, M indices and (at
// most) C*N table floats in, and does no arithmetic. The design serves
// that: one thread per output element with i fastest, so each warp
// writes 128 contiguous bytes of one feature row; idx is non-decreasing
// (an expansion stream), so the table reads of a warp fall in a few
// neighbouring cache lines. The index stream is re-read once per row
// from L2, not from device memory.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void monotone_gather_kernel(const float* __restrict__ table,
                                       const int* __restrict__ idx,
                                       float* __restrict__ out,
                                       long long n, long long m) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long c = blockIdx.y;
  if (i >= m) return;
  out[c * m + i] = table[c * n + idx[i]];
}

}  // namespace

extern "C" int goi_monotone_gather(const void* table, const void* idx,
                                   void* out, int c, long long n,
                                   long long m, void* stream) {
  if (m > 0 && c > 0) {
    const int threads = 256;
    dim3 grid((unsigned)((m + threads - 1) / threads), (unsigned)c);
    monotone_gather_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(table), static_cast<const int*>(idx),
        static_cast<float*>(out), n, m);
  }
  return (int)cudaGetLastError();
}
