// Walsh-Hadamard transform along dim 0 of x (n, c), n = 2^m, f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fwht/fwht.py
// (_fwht_kernel / fwht_1level) and the two-sweep wrapper fwht_pallas of
// src/repro/kernels/fwht/ops.py.
//
// Bound on this card: each of the n c log2(n) butterfly adds touches data
// that has to come from and go back to HBM once, so one read and one
// write of x (8 n c bytes) bound it; at (131072, 512) that is 0.160 ms,
// against 0.017 ms for the adds at the fp32 rate.
// Design: the Pallas kernel kept a (2^13, 128) slab (4 MiB) in VMEM; a
// Hopper block has at most 227 KB. So the log2(n) stages run in passes of
// at most 10 stages (the wrapper splits them evenly, low bits first: at
// n = 2^17 two passes of 9 and 8 stages). In a pass that starts at stage
// bit `lo_bits`, a block owns the 2^k rows hi * 2^(lo_bits+k) + j * s + lo
// (s = 2^lo_bits, j < 2^k) for one tile of up to 32 columns: every row is
// one coalesced segment of the tile's columns, and the strided pass
// addresses its rows directly, so no transpose is ever materialized. The
// rows sit in dynamic shared memory (2^k x tile x 4 B <= 128 KB), the k
// stages run there in the plain version's order (h = 1, 2, 4, ...) and the
// block writes them back; columns past c are masked. The last pass divides
// by sqrt(n) as the plain version does (the same f32 divisor, IEEE
// division), and nothing is summed in a data-dependent order, so the
// result equals the plain version's bit for bit and is the same on every
// run (chunked == one-shot ingest rests on it).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 32;      // columns per block
constexpr int kMaxBits = 10;      // stages per pass

__global__ void __launch_bounds__(kThreads)
    fwht_pass_kernel(const float* x, float* out, int c, int lo_bits, int k, int tile_log2,
                     float divisor) {
  extern __shared__ float sm[];
  const int tile = 1 << tile_log2;
  const int rows = 1 << k;
  const long long s = 1LL << lo_bits;
  const long long g = blockIdx.x;
  const long long lo = g & (s - 1), hi = g >> lo_bits;
  const long long row0 = (hi << (lo_bits + k)) + lo;
  const int col0 = blockIdx.y * tile;
  const int total = rows << tile_log2;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int j = e >> tile_log2, col = col0 + (e & (tile - 1));
    sm[e] = col < c ? x[(row0 + j * s) * c + col] : 0.f;
  }
  __syncthreads();
  const int pairs = total >> 1;
  for (int h = 1; h < rows; h <<= 1) {
    for (int p = threadIdx.x; p < pairs; p += kThreads) {
      const int q = p >> tile_log2, col = p & (tile - 1);
      const int i = ((q & ~(h - 1)) << 1) | (q & (h - 1));
      const int ia = (i << tile_log2) | col, ib = ia + (h << tile_log2);
      const float a = sm[ia], b = sm[ib];
      sm[ia] = a + b;
      sm[ib] = a - b;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int j = e >> tile_log2, col = col0 + (e & (tile - 1));
    if (col < c) out[(row0 + j * s) * c + col] = __fdiv_rn(sm[e], divisor);
  }
}

}  // namespace

// One pass: stages lo_bits .. lo_bits + k - 1 of the transform of x (n, c)
// into out (which may alias x: every block reads all of its elements
// before it writes them). divisor is sqrt(n) on the last pass of a
// normalized transform, else 1.
extern "C" int rt_fwht_pass(const float* x, float* out, long long n, int c,
                            int lo_bits, int k, float divisor,
                            void* stream) {
  if (k < 0 || k > kMaxBits || c <= 0) return (int)cudaErrorInvalidValue;
  int tile_log2 = 0;
  while ((1 << tile_log2) < c && (1 << tile_log2) < kMaxTile) ++tile_log2;
  const size_t smem = (sizeof(float) << k) << tile_log2;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fwht_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)(n >> k),
                  (unsigned)((c + (1 << tile_log2) - 1) >> tile_log2));
  fwht_pass_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, out, c, lo_bits, k, tile_log2, divisor);
  return (int)cudaGetLastError();
}
