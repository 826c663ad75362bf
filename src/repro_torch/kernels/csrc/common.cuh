// Shared device routines of the kernel-clustering kernels: the kernel
// functions kappa (in the multiplication order of the JAX package), the
// fixed-order second pass of the split reductions, and the one-time opt-in
// to more than 48 KB of dynamic shared memory.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace rt {

constexpr int kThreads = 256;  // threads per block of sum_splits_kernel

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
