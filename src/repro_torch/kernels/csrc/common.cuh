// Shared device routines of the kernel-clustering kernels (fp32, CUDA cores).
//
// The kernel tile kappa(X[:, i0:i0+TM], C[:, j0:j0+TN]) is the building block
// of gram, extend_embed and fit_sketch, as the MXU tile was for the Pallas
// kernels they replace. X is (p, m) and C is (p, w), samples as columns, each
// with its own leading dimension (a column slice of a wider matrix needs no
// copy). The contraction dim p is walked in chunks of PC rows through shared
// memory, so nothing bounds p.
//
// fp32 throughout, no TF32: the rbf tile computes ||x||^2 + ||y||^2 - 2 x.y,
// and that cancellation does not stay inside the 2e-3 parity tolerance at
// TF32's 10-bit mantissa.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace rt {

constexpr int kThreads = 256;  // 16 x 16 threads per block
constexpr int TM = 64;         // rows of X (samples) per tile
constexpr int TN = 64;         // columns of C per tile
constexpr int PC = 16;         // rows of the contraction dim p per chunk
constexpr int RA = TM / 16;    // tile rows held by one thread
constexpr int RB = TN / 16;    // tile columns held by one thread

enum Kind { kPolynomial = 0, kRbf = 1, kLinear = 2 };

// x**e for an integer e >= 0 by binary exponentiation: the multiplication
// order of JAX's lax.integer_pow, which `(z + gamma) ** degree` lowers to.
static __device__ __forceinline__ float int_pow(float x, int e) {
  float acc = 1.f;
  bool first = true;
  while (e > 0) {
    if (e & 1) {
      acc = first ? x : acc * x;
      first = false;
    }
    e >>= 1;
    if (e) x = x * x;
  }
  return acc;
}

static __device__ __forceinline__ float kappa(float z, float xn, float yn,
                                              int kind, float gamma,
                                              int degree) {
  if (kind == kPolynomial) return int_pow(z + gamma, degree);
  if (kind == kRbf) return expf(-gamma * fmaxf(xn + yn - 2.f * z, 0.f));
  return z;
}

struct TileSmem {
  float xs[PC][TM];
  float cs[PC][TN];
};

// Computes the TM x TN kernel tile with top-left (i0, j0) into acc.
// Thread (ty, tx) = (tid / 16, tid % 16) owns tile rows ty + 16 a and tile
// columns tx + 16 b, so a warp's stores hit consecutive columns. Rows >= m
// and columns >= w are computed from zero vectors: callers mask them.
// Every thread of the block must call this (it synchronises).
static __device__ __forceinline__ void gram_tile(
    const float* __restrict__ X, long long ldx, int m,
    const float* __restrict__ C, long long ldc, int w, int p, int i0, int j0,
    int kind, float gamma, int degree, TileSmem& sm, float acc[RA][RB]) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float xn[RA], yn[RB];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    xn[a] = 0.f;
#pragma unroll
    for (int b = 0; b < RB; ++b) acc[a][b] = 0.f;
  }
#pragma unroll
  for (int b = 0; b < RB; ++b) yn[b] = 0.f;
  for (int k0 = 0; k0 < p; k0 += PC) {
    for (int e = tid; e < PC * TM; e += kThreads) {
      const int k = e / TM, ii = e % TM, gk = k0 + k, gi = i0 + ii;
      sm.xs[k][ii] = (gk < p && gi < m) ? X[gk * ldx + gi] : 0.f;
    }
    for (int e = tid; e < PC * TN; e += kThreads) {
      const int k = e / TN, jj = e % TN, gk = k0 + k, gj = j0 + jj;
      sm.cs[k][jj] = (gk < p && gj < w) ? C[gk * ldc + gj] : 0.f;
    }
    __syncthreads();
    const int kmax = min(PC, p - k0);
    for (int k = 0; k < kmax; ++k) {
      float xv[RA], cv[RB];
#pragma unroll
      for (int a = 0; a < RA; ++a) xv[a] = sm.xs[k][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < RB; ++b) cv[b] = sm.cs[k][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int b = 0; b < RB; ++b) acc[a][b] = fmaf(xv[a], cv[b], acc[a][b]);
      if (kind == kRbf) {
#pragma unroll
        for (int a = 0; a < RA; ++a) xn[a] = fmaf(xv[a], xv[a], xn[a]);
#pragma unroll
        for (int b = 0; b < RB; ++b) yn[b] = fmaf(cv[b], cv[b], yn[b]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < RB; ++b)
      acc[a][b] = kappa(acc[a][b], xn[a], yn[b], kind, gamma, degree);
}

// out[e] = sum over s of part[s * len + e], s ascending: the fixed-order
// second pass of every split reduction (no float atomics, so results are the
// same from run to run).
static __global__ void __launch_bounds__(kThreads)
    sum_splits_kernel(const float* __restrict__ part, int nsplit,
                      long long len, float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= len) return;
  float t = 0.f;
  for (int s = 0; s < nsplit; ++s) t += part[s * len + e];
  out[e] = t;
}

static inline cudaError_t launch_sum_splits(const float* part, int nsplit,
                                            long long len, float* out,
                                            cudaStream_t stream) {
  if (len <= 0) return cudaSuccess;
  const unsigned grid = (unsigned)((len + kThreads - 1) / kThreads);
  sum_splits_kernel<<<grid, kThreads, 0, stream>>>(part, nsplit, len, out);
  return cudaGetLastError();
}

// cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, bytes) once per
// device and process, not per launch; `done` keeps one bit per device.
template <typename Kernel>
static inline cudaError_t allow_smem(Kernel kernel, int bytes,
                                     std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

}  // namespace rt
