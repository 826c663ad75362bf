// Fused K-means assignment: Y (n, r), C (k, r) -> label (n,) int32 and
// min squared distance (n,), d2 = max(|y|^2 + |c|^2 - 2 y.c, 0).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/kmeans_assign/kmeans_assign.py (_assign_kernel /
// assign_call).
//
// Bound on this card: at serving batch sizes (n <= a few thousand, r = 2,
// k = 7) the whole call moves a few tens of kilobytes and does a few hundred
// thousand flops; it is bound by its launch latency, not by bytes or flops.
// Design: one thread per row, one launch; the centroids and their norms sit
// in shared memory (k * r floats), so the (n, k) distance matrix never
// exists. The scan over k keeps the first index on ties (strict <), as
// jnp.argmin does.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kRows = 128;  // rows per block

__global__ void __launch_bounds__(kRows)
    assign_kernel(const float* __restrict__ Y, int n, int r,
                  const float* __restrict__ C, int k, int* __restrict__ labels,
                  float* __restrict__ d2out) {
  extern __shared__ float smem[];
  float* cs = smem;       // (k, r) centroids
  float* cn = cs + k * r; // (k,)   their squared norms
  for (int e = threadIdx.x; e < k * r; e += blockDim.x) cs[e] = C[e];
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float t = 0.f;
    for (int c = 0; c < r; ++c) t = fmaf(cs[j * r + c], cs[j * r + c], t);
    cn[j] = t;
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* y = Y + (long long)i * r;
  float yn = 0.f;
  for (int c = 0; c < r; ++c) yn = fmaf(y[c], y[c], yn);
  float best = INFINITY;
  int arg = 0;
  for (int j = 0; j < k; ++j) {
    float z = 0.f;
    for (int c = 0; c < r; ++c) z = fmaf(y[c], cs[j * r + c], z);
    const float d = fmaxf(yn + cn[j] - 2.f * z, 0.f);
    if (d < best) {
      best = d;
      arg = j;
    }
  }
  labels[i] = arg;
  d2out[i] = best;
}

}  // namespace

extern "C" int rt_kmeans_assign(const float* Y, int n, int r, const float* C,
                                int k, int* labels, float* d2, void* stream) {
  const size_t smem = (size_t)(k * r + k) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (n + kRows - 1) / kRows;
  assign_kernel<<<grid, kRows, smem, (cudaStream_t)stream>>>(Y, n, r, C, k,
                                                             labels, d2);
  return (int)cudaGetLastError();
}
