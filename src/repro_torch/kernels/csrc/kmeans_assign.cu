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
// So the serving path on the card does not launch it: when a request's
// embedding comes from the extend_embed kernel, the same routine
// (assign.cuh) runs in that kernel's summing launch (extend_embed.cu,
// sum_assign_kernel). This standalone launch serves the rest: Y from any
// other source (the two-pass embedding with the kernel assignment).
// Design: one thread per row; the centroids and their norms sit in shared
// memory (k * r + k floats), so the (n, k) distance matrix never exists;
// each thread reads its row into registers once (r <= 16; a wider row is
// read again for every centroid, assign.cuh).
#include "assign.cuh"

namespace {

__global__ void __launch_bounds__(rt::kAssignThreads)
    assign_kernel(const float* __restrict__ Y, int n, int r,
                  const float* __restrict__ C, int k, int* __restrict__ labels,
                  float* __restrict__ d2out) {
  extern __shared__ float smem[];
  float* cs = smem;        // (k, r) centroids
  float* cn = cs + k * r;  // (k,)   their squared norms
  rt::stage_centroids(C, k, r, cs, cn);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  rt::nearest(Y + (long long)i * r, 1, r, cs, cn, k, labels + i, d2out + i);
}

}  // namespace

extern "C" int rt_kmeans_assign(const float* Y, int n, int r, const float* C,
                                int k, int* labels, float* d2, void* stream) {
  static std::atomic<unsigned long long> prepared;
  size_t smem = 0;
  const cudaError_t err = rt::assign_smem(assign_kernel, k, r, &smem,
                                          prepared);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + rt::kAssignThreads - 1) / rt::kAssignThreads;
  assign_kernel<<<grid, rt::kAssignThreads, smem, (cudaStream_t)stream>>>(
      Y, n, r, C, k, labels, d2);
  return (int)cudaGetLastError();
}
