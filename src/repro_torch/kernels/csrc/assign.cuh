// The nearest-centroid routine of the K-means assignment, shared by its two
// launch sites: assign_kernel (kmeans_assign.cu) and the assigning form of
// extend_embed's summing launch (extend_embed.cu). One copy with explicit
// fmaf, so both sites give the same bits for the same r values: yn and z by
// fmaf over c ascending, d2 = max(yn + |c|^2 - 2z, 0), the first index on
// ties (strict <, as jnp.argmin).
#pragma once

#include <math.h>

#include "common.cuh"

namespace rt {

constexpr int kAssignThreads = 128;  // points (one per thread) per block

// Dynamic shared memory of an assigning block: C (k, r) and its k norms.
// Past 48 KB the kernel is opted in, once per device, to the 227 KB a block
// may take; the wrappers refuse k (r + 1) floats beyond that.
template <typename Kernel>
static inline cudaError_t assign_smem(Kernel kernel, int k, int r,
                                      size_t* bytes,
                                      std::atomic<unsigned long long>& done) {
  *bytes = (size_t)k * (r + 1) * sizeof(float);
  return *bytes > 48 * 1024 ? allow_smem(kernel, 227 * 1024, done)
                            : cudaSuccess;
}

// Block-wide: C (k, r) into cs and the squared norms |c_j|^2 (fmaf over c
// ascending) into cn, both in shared memory. Every thread of the block
// must call it.
static __device__ __forceinline__ void stage_centroids(
    const float* __restrict__ C, int k, int r, float* cs, float* cn) {
  for (int e = threadIdx.x; e < k * r; e += blockDim.x) cs[e] = C[e];
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float t = 0.f;
    for (int c = 0; c < r; ++c) t = fmaf(cs[j * r + c], cs[j * r + c], t);
    cn[j] = t;
  }
  __syncthreads();
}

// The scan over the staged centroids of one point y (its r values at
// y[0], y[stride], ...). N > 0: the loops over c unrolled to N with c < r
// guards, so a y held in a register array stays there; N = 0: r at run
// time. Either way the same fmaf in the same order.
template <int N>
static __device__ __forceinline__ void scan(const float* y, long long stride,
                                            int r, const float* cs,
                                            const float* cn, int k,
                                            int* label, float* d2) {
  const int rr = N ? N : r;
  float yn = 0.f;
#pragma unroll
  for (int c = 0; c < rr; ++c)
    if (c < r) yn = fmaf(y[c * stride], y[c * stride], yn);
  float best = INFINITY;
  int arg = 0;
  for (int j = 0; j < k; ++j) {
    float z = 0.f;
#pragma unroll
    for (int c = 0; c < rr; ++c)
      if (c < r) z = fmaf(y[c * stride], cs[j * r + c], z);
    const float d = fmaxf(yn + cn[j] - 2.f * z, 0.f);
    if (d < best) {
      best = d;
      arg = j;
    }
  }
  *label = arg;
  *d2 = best;
}

// Points of up to this many values are read once into registers; wider
// ones are read again for every centroid (through L1).
constexpr int kRowRegs = 16;

// One point y, its r values at y[0], y[stride], ...: the label and d2 of
// its nearest staged centroid.
static __device__ __forceinline__ void nearest(const float* y,
                                               long long stride, int r,
                                               const float* cs,
                                               const float* cn, int k,
                                               int* label, float* d2) {
  if (r > kRowRegs) {
    scan<0>(y, stride, r, cs, cn, k, label, d2);
    return;
  }
  float v[kRowRegs];
#pragma unroll
  for (int c = 0; c < kRowRegs; ++c) v[c] = c < r ? y[c * stride] : 0.f;
  scan<kRowRegs>(v, 1, r, cs, cn, k, label, d2);
}

}  // namespace rt
