// Fused serving stripe out = P kappa(X, Xb): X (p, n) training points,
// P (r, n) the projection Sigma^{-1/2} U^T, Xb (p, w) queries -> (r, w).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/extend_embed/extend_embed.py (_extend_embed_kernel /
// extend_embed_call).
//
// Bound on this card: per (n, w) kernel entry it does 2p flops for the tile,
// 2r for the projection and a few for the nonlinearity, and it reads only
// X, P and Xb once: at n = 100,000, w = 512, p = 19, r = 2 that is about
// 2.3e9 flops against 8.4 MB, so it is bound by fp32 operations.
// Design: the (n, w) kernel stripe never reaches device memory. Block
// (s, t) takes the w-tile t and the row range s of n; it builds one 64 x 64
// kernel tile at a time in shared memory and contracts it at once with the
// matching (r, 64) slice of P into an (r, 64) accumulator that stays in
// shared memory for its whole row range. The Pallas grid ran in order and
// added into one resident (r, w) output; blocks here run concurrently, so
// each row range writes its partial to scratch and a second pass sums the
// partials in a fixed order (no float atomics: the result does not change
// from run to run). The row ranges depend on n alone, never on w, so a
// query column gets the same bits whatever the width of its batch.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(rt::kThreads)
    extend_embed_partial(const float* __restrict__ X, long long ldx, int n,
                         const float* __restrict__ P, long long ldp, int r,
                         const float* __restrict__ Xb, long long ldb, int w,
                         int p, int kind, float gamma, int degree,
                         int rows_per_split, float* __restrict__ part) {
  extern __shared__ float dyn[];
  float* ps = dyn;              // (r, TM)  slice of P for the row tile
  float* accs = ps + r * rt::TM;  // (r, TN)  this block's partial
  __shared__ rt::TileSmem sm;
  __shared__ float ks[rt::TM][rt::TN + 1];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int s = blockIdx.x, j0 = blockIdx.y * rt::TN;
  const int row_begin = s * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);
  for (int e = tid; e < r * rt::TN; e += rt::kThreads) accs[e] = 0.f;
  for (int i0 = row_begin; i0 < row_end; i0 += rt::TM) {
    float acc[rt::RA][rt::RB];
    rt::gram_tile(X, ldx, row_end, Xb, ldb, w, p, i0, j0, kind, gamma, degree,
                  sm, acc);
#pragma unroll
    for (int a = 0; a < rt::RA; ++a) {
      const int ii = ty + 16 * a;
#pragma unroll
      for (int b = 0; b < rt::RB; ++b) {
        const int jj = tx + 16 * b;
        ks[ii][jj] = (i0 + ii < row_end && j0 + jj < w) ? acc[a][b] : 0.f;
      }
    }
    for (int e = tid; e < r * rt::TM; e += rt::kThreads) {
      const int c = e / rt::TM, ii = e % rt::TM;
      ps[e] = (i0 + ii < row_end) ? P[c * ldp + i0 + ii] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < r * rt::TN; e += rt::kThreads) {
      const int c = e / rt::TN, jj = e % rt::TN;
      float t = 0.f;
      for (int ii = 0; ii < rt::TM; ++ii)
        t = fmaf(ps[c * rt::TM + ii], ks[ii][jj], t);
      accs[e] += t;
    }
    __syncthreads();
  }
  for (int e = tid; e < r * rt::TN; e += rt::kThreads) {
    const int c = e / rt::TN, jj = e % rt::TN;
    if (j0 + jj < w) part[((long long)s * r + c) * w + j0 + jj] = accs[e];
  }
}

}  // namespace

extern "C" int rt_extend_embed(const float* X, long long ldx, int n,
                               const float* P, long long ldp, int r,
                               const float* Xb, long long ldb, int w, int p,
                               int kind, float gamma, int degree,
                               int rows_per_split, int n_splits, float* part,
                               float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)r * (rt::TM + rt::TN) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      extend_embed_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_splits, (w + rt::TN - 1) / rt::TN);
  extend_embed_partial<<<grid, rt::kThreads, smem, st>>>(
      X, ldx, n, P, ldp, r, Xb, ldb, w, p, kind, gamma, degree,
      rows_per_split, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)rt::launch_sum_splits(part, n_splits, (long long)r * w, out, st);
}
