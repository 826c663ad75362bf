// Kernel-matrix stripe K = kappa(X, Xb), X (p, n), Xb (p, w) -> K (n, w).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gram/gram.py
// (_gram_kernel / gram_stripe_call).
//
// Bound on this card: at the stripe shapes of the paper's regime (p <= 19,
// w = 512) the kernel does 2p + O(1) flops per entry and writes 4 bytes per
// entry, about 10 flops per byte against the H100's 20 fp32 flops per byte
// of HBM bandwidth: it is bound by the bytes of the (n, w) output.
// Design: one 64 x 64 output tile per block of 256 threads, each thread
// 4 x 4 entries in registers; X and Xb are staged through shared memory in
// chunks of 16 rows of p; the nonlinearity is applied in registers, so each
// output entry is written once and coalesced (a warp stores 16 consecutive
// columns of two rows).
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(rt::kThreads)
    gram_kernel(const float* __restrict__ X, long long ldx, int n,
                const float* __restrict__ Xb, long long ldb, int w, int p,
                int kind, float gamma, int degree, float* __restrict__ out) {
  __shared__ rt::TileSmem sm;
  const int i0 = blockIdx.x * rt::TM, j0 = blockIdx.y * rt::TN;
  float acc[rt::RA][rt::RB];
  rt::gram_tile(X, ldx, n, Xb, ldb, w, p, i0, j0, kind, gamma, degree, sm,
                acc);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int a = 0; a < rt::RA; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= n) continue;
#pragma unroll
    for (int b = 0; b < rt::RB; ++b) {
      const int j = j0 + tx + 16 * b;
      if (j < w) out[(long long)i * w + j] = acc[a][b];
    }
  }
}

}  // namespace

extern "C" int rt_gram_stripe(const float* X, long long ldx, int n,
                              const float* Xb, long long ldb, int w, int p,
                              int kind, float gamma, int degree, float* out,
                              void* stream) {
  const dim3 grid((n + rt::TM - 1) / rt::TM, (w + rt::TN - 1) / rt::TN);
  gram_kernel<<<grid, rt::kThreads, 0, (cudaStream_t)stream>>>(
      X, ldx, n, Xb, ldb, w, p, kind, gamma, degree, out);
  return (int)cudaGetLastError();
}
