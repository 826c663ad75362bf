// Fused fit-block update. From Kc = kappa(X, C), X (p, m), C (p, b):
//   new_rows (b, r') = Kc^T Omega          Omega (m, r')
//   delta    (m, r') = Kc Ocross           Ocross (b, r')
//   rn_rows  (m,)    = sum over j < b of Kc[i, j]^2
//   rn_cols  (b,)    = sum over i of V[i] Kc[i, j]^2   (V = 1 when absent)
//
// Replaces the Pallas TPU kernel src/repro/kernels/fit_sketch/fit_sketch.py
// (_fit_sketch_kernel / fit_sketch_call).
//
// Bound on this card: per (m, b) kernel entry it does 2p flops for the tile,
// 2r' each for new_rows and delta and a few for the norms, about 71 flops at
// p = 19, r' = 7, while it reads X, Omega, C, Ocross once and writes
// (m + b)(r' + 1) floats: bound by fp32 operations.
// Design: the (m, b) block Kc never reaches device memory. Block (s, t)
// takes the b-tile t and the row range s of m and walks the range in 64-row
// tiles: it builds the 64 x 64 kernel tile in shared memory, folds it into
// its (64, r') new_rows and (64,) rn_cols accumulators, which stay in shared
// memory for the whole range, and contracts it with Ocross into the tile's
// delta and rn_rows partials for this b-tile. The Pallas grid ran in order
// and added into resident outputs; blocks here run concurrently, so both
// reductions go through scratch: new_rows/rn_cols partials per row range,
// delta/rn_rows partials per b-tile, each summed by a second pass in a fixed
// order (no float atomics: bit-identical from run to run, which the
// chunked-ingest == one-shot contract needs). The row ranges depend on m
// alone. Edges are masked in the kernel itself: rows >= m and columns >= b
// contribute exact zeros to every output, and a zero V drops a row out of
// rn_cols.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(rt::kThreads)
    fit_sketch_partial(const float* __restrict__ X, long long ldx, int m,
                       const float* __restrict__ Om, int rp,
                       const float* __restrict__ C, long long ldc, int b,
                       const float* __restrict__ Ocr,
                       const float* __restrict__ V, int p, int kind,
                       float gamma, int degree, int rows_per_split,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_delta) {
  extern __shared__ float dyn[];
  float* os = dyn;                  // (TM, rp) Omega rows of the row tile
  float* accs = os + rt::TM * rp;   // (TN, rp) new_rows partial
  float* rncs = accs + rt::TN * rp; // (TN,)    rn_cols partial
  float* vs = rncs + rt::TN;        // (TM,)    row weights of the row tile
  __shared__ rt::TileSmem sm;
  __shared__ float ks[rt::TM][rt::TN + 1];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int s = blockIdx.x, t = blockIdx.y, j0 = t * rt::TN;
  const int ncol = min(rt::TN, b - j0);
  const int row_begin = s * rows_per_split;
  const int row_end = min(m, row_begin + rows_per_split);
  const long long dlen = (long long)m * rp + m;  // one b-tile's delta slab
  float* dpart = part_delta + t * dlen;
  for (int e = tid; e < rt::TN * rp + rt::TN; e += rt::kThreads) accs[e] = 0.f;
  for (int i0 = row_begin; i0 < row_end; i0 += rt::TM) {
    const int nrows = min(rt::TM, row_end - i0);
    float acc[rt::RA][rt::RB];
    rt::gram_tile(X, ldx, row_end, C, ldc, b, p, i0, j0, kind, gamma, degree,
                  sm, acc);
#pragma unroll
    for (int a = 0; a < rt::RA; ++a) {
      const int ii = ty + 16 * a;
#pragma unroll
      for (int bb = 0; bb < rt::RB; ++bb) {
        const int jj = tx + 16 * bb;
        ks[ii][jj] = (ii < nrows && jj < ncol) ? acc[a][bb] : 0.f;
      }
    }
    for (int e = tid; e < rt::TM * rp; e += rt::kThreads)
      os[e] = (e / rp < nrows) ? Om[(long long)i0 * rp + e] : 0.f;
    for (int ii = tid; ii < rt::TM; ii += rt::kThreads)
      vs[ii] = ii < nrows ? (V ? V[i0 + ii] : 1.f) : 0.f;
    __syncthreads();
    // new_rows partial: accs[j, c] += sum_i Kc[i, j] Omega[i, c]
    for (int e = tid; e < rt::TN * rp; e += rt::kThreads) {
      const int jj = e / rp, c = e % rp;
      float u = 0.f;
      for (int ii = 0; ii < rt::TM; ++ii)
        u = fmaf(ks[ii][jj], os[ii * rp + c], u);
      accs[e] += u;
    }
    // rn_cols partial: rncs[j] += sum_i V[i] Kc[i, j]^2
    for (int jj = tid; jj < rt::TN; jj += rt::kThreads) {
      float u = 0.f;
      for (int ii = 0; ii < rt::TM; ++ii) {
        const float kv = ks[ii][jj];
        u = fmaf(vs[ii], kv * kv, u);
      }
      rncs[jj] += u;
    }
    // delta partial of this b-tile: sum_j Kc[i, j] Ocross[j, c]
    for (int e = tid; e < nrows * rp; e += rt::kThreads) {
      const int ii = e / rp, c = e % rp;
      float u = 0.f;
      for (int jj = 0; jj < ncol; ++jj)
        u = fmaf(ks[ii][jj], Ocr[(long long)(j0 + jj) * rp + c], u);
      dpart[(long long)(i0 + ii) * rp + c] = u;
    }
    // rn_rows partial of this b-tile: sum_j Kc[i, j]^2
    for (int ii = tid; ii < nrows; ii += rt::kThreads) {
      float u = 0.f;
      for (int jj = 0; jj < ncol; ++jj) u = fmaf(ks[ii][jj], ks[ii][jj], u);
      dpart[(long long)m * rp + i0 + ii] = u;
    }
    __syncthreads();
  }
  const long long alen = (long long)b * rp + b;  // one row range's slab
  float* apart = part_acc + s * alen;
  for (int e = tid; e < ncol * rp; e += rt::kThreads)
    apart[(long long)j0 * rp + e] = accs[e];
  for (int jj = tid; jj < ncol; jj += rt::kThreads)
    apart[(long long)b * rp + j0 + jj] = rncs[jj];
}

}  // namespace

extern "C" int rt_fit_sketch(const float* X, long long ldx, int m,
                             const float* Om, int rp, const float* C,
                             long long ldc, int b, const float* Ocr,
                             const float* V, int p, int kind, float gamma,
                             int degree, int rows_per_split, int m_splits,
                             float* part_acc, float* part_delta,
                             float* out_acc, float* out_delta, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem =
      (size_t)((rt::TM + rt::TN) * rp + rt::TN + rt::TM) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fit_sketch_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int b_tiles = (b + rt::TN - 1) / rt::TN;
  const dim3 grid(m_splits, b_tiles);
  fit_sketch_partial<<<grid, rt::kThreads, smem, st>>>(
      X, ldx, m, Om, rp, C, ldc, b, Ocr, V, p, kind, gamma, degree,
      rows_per_split, part_acc, part_delta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = rt::launch_sum_splits(part_acc, m_splits, (long long)b * rp + b,
                              out_acc, st);
  if (err != cudaSuccess) return (int)err;
  return (int)rt::launch_sum_splits(part_delta, b_tiles,
                                    (long long)m * rp + m, out_delta, st);
}
