// Block-windowed monotone row gather: for a row-major (n, c) float32
// table and a non-decreasing index idx (m,), block b of `blk` indices
// has the window lo = min(idx[b * blk], n - span), and
//   out[i, :] = table[idx[i], :]  if 0 <= idx[i] - lo < span, else 0,
// bit-exact.
//
// Replaces examples/micro_sortpayload.py `_mono_kernel` (the JAX
// package's micro-benchmark, blk = 1024, span = 2048), which DMA'd the
// block's span-row window into VMEM and gathered from it by a (blk x
// span) one-hot matmul on the MXU, so an index past the window produced
// a zero row. The zero row is kept as the function's semantics; the
// window copy and the one-hot product are not: a GPU gathers natively.
//
// Bound on the H100: bytes. It reads the index once and the table rows
// it names, writes m * c floats, and does no arithmetic. The design
// serves that: one thread per output element with the column fastest,
// so each warp writes 128 contiguous bytes and reads whole table rows
// that neighbouring indices (monotone) keep within a few cache lines.
// The window start is one more read of the block's first index, from L1.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void mono_rows_kernel(const float* __restrict__ table,
                                 const int* __restrict__ idx,
                                 float* __restrict__ out, int c,
                                 long long n, long long m, int blk,
                                 int span) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m * c) return;
  const long long i = e / c;
  const int col = (int)(e - i * c);
  const long long first = idx[(i / blk) * blk];
  const long long lo = first < n - span ? first : n - span;
  const long long row = idx[i];
  const long long local = row - lo;
  out[e] = (local >= 0 && local < span) ? table[row * c + col] : 0.f;
}

}  // namespace

extern "C" int goi_mono_rows(const void* table, const void* idx, void* out,
                             int c, long long n, long long m, int blk,
                             int span, void* stream) {
  if (c <= 0 || blk <= 0 || span <= 0) return (int)cudaErrorInvalidValue;
  if (m > 0) {
    const int threads = 256;
    const long long total = m * c;
    mono_rows_kernel<<<(unsigned)((total + threads - 1) / threads), threads,
                       0, (cudaStream_t)stream>>>(
        static_cast<const float*>(table), static_cast<const int*>(idx),
        static_cast<float*>(out), c, n, m, blk, span);
  }
  return (int)cudaGetLastError();
}
