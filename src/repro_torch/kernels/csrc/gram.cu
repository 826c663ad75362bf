// Kernel-matrix stripe K = kappa(X, Xb): X (p, n), Xb (p, w) -> K (n, w),
// fp32, row-major.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gram/gram.py
// (_gram_kernel / gram_stripe_call).
//
// Bound on this card: per entry the kernel does 2p + O(1) flops and writes
// 4 bytes. At the stripe shapes of the paper's regime (p <= 19, w = 512)
// the products take under half the time of the output's bytes: the kernel
// is bound by writing the (n, w) output to HBM, four times the L2 at
// n = 100,000. The design keeps that write stream going while the next
// tiles compute.
//
// Design (the launch follows kernels/_common.py gram_plan).
// - Persistent blocks of 16 warps, one per SM; a block owns one column
//   chunk of 64 c columns (c = 1, 2, 4 or 8 warps across it) and walks row
//   steps of 16 x (16 / c) rows in a grid-stride loop. Each warp makes 16
//   rows x 64 columns per step and walks on without waiting for the
//   others: where Xb is resident there is no block barrier after the
//   set-up. (A first version, whose warps met at two barriers per 16-row
//   tile, was bound by that latency.)
// - Xb's chunk is staged once, as split B fragments, and stays in shared
//   memory for the whole walk, as the TPU kernel kept (p, w) in VMEM, with
//   the squared column norms for the rbf kind. The plan takes the widest
//   chunk at which all of p fits (p <= 312 fits at 64 columns). Past that
//   the block walks p in chunks of krows rows, staging Xb's chunk for every
//   step between two barriers.
// - The product: 3xTF32 mma.sync m16n8k8 (mma_tf32.cuh), p in k-groups of
//   4 k8 steps. Each warp loads the A fragments of its next k-group (of
//   this tile, else of its next tile) from X into registers while it
//   multiplies the current one, and splits them at use.
// - kappa is compiled per kind, and for the polynomial degree 2, so that
//   it inlines without branches (int_pow keeps lax.integer_pow's order).
// - Write-back: each warp stages its kappa fragments in its own buffer,
//   whose rows are padded by 16 bytes so the fragment writes meet no bank
//   conflict, and its lanes store them with st.global.cs, four floats at a
//   time, so that each warp store covers two 256-byte row segments. The
//   stores drain while the warp computes its next tile. (A 1-D
//   cp.async.bulk per staged row, and an fp32 FMA product, were slower on
//   the H100; PERF.md, §6 gram, has their times.)
// - Edges: rows past n and columns past w load as zeros, so their kappa
//   values are finite, and are not written. p = 0 gives kappa(0).
#include <cstdint>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int WARPS = 16;           // warps of a block, one block per SM
constexpr int WC = 64;              // columns of one warp
constexpr int NT = WC / 8;          // its n8 tiles
constexpr int WR = 16;              // rows of one warp tile
constexpr int SS = WC + 4;          // staging row stride (floats)
constexpr int KSR = 4;              // k8 steps of a k-group, in registers
constexpr int KG = 8 * KSR;         // rows of p in a k-group
constexpr int kMaxSmem = 232448;    // dynamic shared memory of one block

// The launch as kernels/_common.py gram_plan chose it. Xb's chunk is
// resident when krows >= p; else p is walked in chunks of krows rows, a
// multiple of KG.
struct Plan {
  int col_warps;  // warps across the column chunk: 1, 2, 4 or 8
  int krows;      // rows of p in shared memory, a multiple of 8
};

// Shared memory of one block, in bytes from the start: Xb's chunk as B
// fragments (16 bytes per lane and k8 step), its squared column norms, each
// warp's staging buffer. kernels/_common.py gram_smem_bytes mirrors it.
struct Layout {
  int cols, groups, yn_off, stage_off, bytes;

  __host__ __device__ Layout(const Plan& pl) {
    cols = WC * pl.col_warps;
    groups = WARPS / pl.col_warps;           // warp rows of a block step
    yn_off = 8 * cols * pl.krows;
    stage_off = yn_off + 4 * cols;
    bytes = stage_off + 4 * WARPS * WR * SS;
  }
};

// Xb rows k0 .. k0 + krows of the chunk's columns c0 .. c0 + cols (past p
// or w: zeros), by the whole block, as split B fragments: slot (jt ks_all +
// ks) 32 + lane holds b0 = Xb[k0 + 8ks + t][c0 + 8jt + g] and b1 four rows
// down (mma_tf32.cuh).
__device__ void load_xb(float4* f, const Layout& L, int krows,
                        const float* __restrict__ Xb, long long ldb, int w,
                        int p, int k0, int c0) {
  const int ks_all = krows / 8;
#pragma unroll 4
  for (int s = threadIdx.x; s < L.cols * krows / 2; s += 32 * WARPS) {
    const int lane = s & 31, ks = (s >> 5) % ks_all, jt = (s >> 5) / ks_all;
    const int k = k0 + 8 * ks + (lane & 3), j = c0 + 8 * jt + (lane >> 2);
    const float b0 = k < p && j < w ? Xb[k * ldb + j] : 0.f;
    const float b1 = k + 4 < p && j < w ? Xb[(k + 4) * ldb + j] : 0.f;
    f[s] = tc::b_frag(b0, b1);
  }
}

// The A fragments of the warp tile from row i0 for the k-group from k0:
// a0 = X[k0 + 8ks + t][i0 + g], a1 eight rows on, a2 and a3 four k down
// (past p or n: zeros).
__device__ __forceinline__ void load_a(float a[KSR][4],
                                       const float* __restrict__ X,
                                       long long ldx, int n, int p, int k0,
                                       int i0, int lane) {
#pragma unroll
  for (int ks = 0; ks < KSR; ++ks)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int k = k0 + 8 * ks + (lane & 3) + 4 * (h >> 1);
      const int i = i0 + (lane >> 2) + 8 * (h & 1);
      a[ks][h] = k < p && i < n ? X[k * ldx + i] : 0.f;
    }
}

// acc += X^T Xb over `ksteps` k8 steps, as 3xTF32, for the warp's n8 tiles
// from jt0, reading Xb's fragments from k8 step ks0 of the chunk; na and nb
// gather this lane's share of the squared norms of rows g and g + 8 (rbf).
template <bool RBF>
__device__ __forceinline__ void tc_product(float acc[NT][4], float& na,
                                           float& nb, const float a[KSR][4],
                                           const float4* xbf, int ks_all,
                                           int ks0, int ksteps, int jt0,
                                           int lane) {
#pragma unroll
  for (int ks = 0; ks < KSR; ++ks) {
    if (ks >= ksteps) break;
    if (RBF) {
      na = fmaf(a[ks][2], a[ks][2], fmaf(a[ks][0], a[ks][0], na));
      nb = fmaf(a[ks][3], a[ks][3], fmaf(a[ks][1], a[ks][1], nb));
    }
    float ab[4], as[4];
    tc::split_a(a[ks], ab, as);
    float4 bf[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      bf[nt] = xbf[((jt0 + nt) * ks_all + ks0 + ks) * 32 + lane];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) tc::mma(acc[nt], as, bf[nt].x, bf[nt].y);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) tc::mma(acc[nt], ab, bf[nt].z, bf[nt].w);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) tc::mma(acc[nt], ab, bf[nt].x, bf[nt].y);
  }
}

// kappa of one entry from its product z and the squared norms xn, yn of
// its row and column (rbf). The polynomial kind is rt::kappa's (int_pow in
// lax.integer_pow's order); for rbf, c = -gamma log2(e) folds the scale
// into one exp2f: exp(-gamma d) = exp2(c d), without expf's range
// reduction (relative difference about 1e-6 where the tolerance is 2e-3).
template <int K, int D>
__device__ __forceinline__ float kappa(float z, float xn, float yn,
                                       float gamma, float c, int deg) {
  if (K == rt::kRbf) return exp2f(c * fmaxf(xn + yn - 2.f * z, 0.f));
  return rt::kappa(z, xn, yn, K, gamma, D < 0 ? deg : D);
}

// Four floats of an output row from column c by st.global.cs: one vector
// store where the row is 16-byte aligned and all four lie in the warp's
// wcols columns, else one store per column inside them.
__device__ __forceinline__ void store4(float* row, int c, float4 v,
                                       int wcols, bool vec) {
  if (vec && c + 4 <= wcols) {
    __stcs(reinterpret_cast<float4*>(row + c), v);
  } else {
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < wcols) __stcs(row + c + j, f[j]);
  }
}

// The warp's staged tile (nrows x wcols) out by st.global.cs: lanes 0-15
// and 16-31 take a row each, four floats a lane.
__device__ __forceinline__ void store_tile(const float* st, float* orow,
                                           int w, int nrows, int wcols,
                                           int lane) {
  const int c = 4 * (lane & 15);
  for (int r = lane >> 4; r < nrows; r += 2)
    store4(orow + (long long)r * w, c,
           *reinterpret_cast<const float4*>(st + r * SS + c), wcols,
           (w & 3) == 0);
}

template <int K, int D>
__global__ void __launch_bounds__(32 * WARPS, 1)
    gram_kernel(const float* __restrict__ X, long long ldx, int n,
                const float* __restrict__ Xb, long long ldb, int w, int p,
                float gamma, int degree, Plan pl, float* __restrict__ out) {
  extern __shared__ float4 dyn[];
  constexpr bool rbf = K == rt::kRbf;
  const Layout L(pl);
  char* base = reinterpret_cast<char*>(dyn);
  float* yn = reinterpret_cast<float*>(base + L.yn_off);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* st = reinterpret_cast<float*>(base + L.stage_off) + warp * WR * SS;
  const int wr = warp / pl.col_warps, wc = warp % pl.col_warps;
  const int c0 = blockIdx.y * L.cols;            // the block's chunk
  const int wcols = min(WC, w - c0 - WC * wc);   // the warp's columns
  const int tiles = (n + WR - 1) / WR;           // warp tiles of 16 rows
  const int stride = gridDim.x * L.groups;
  const int kr = pl.krows, ks_all = kr / 8;
  const bool resident = kr >= p;
  const int pchunks = resident ? 1 : (p + kr - 1) / kr;
  const int kgroups = (p + KG - 1) / KG;          // k-groups of all of p
  const float c = -gamma * 1.4426950408889634f;   // -gamma log2(e), rbf

  if (rbf)
    for (int j = tid; j < L.cols; j += 32 * WARPS) {
      float s = 0.f;
      if (c0 + j < w)
        for (int k = 0; k < p; ++k) {
          const float v = Xb[k * ldb + c0 + j];
          s = fmaf(v, v, s);
        }
      yn[j] = s;
    }
  if (resident) load_xb(dyn, L, kr, Xb, ldb, w, p, 0, c0);
  __syncthreads();

  // anext: the A fragments of the warp's next k-group in its walk (its
  // tiles in order, each tile's k-groups in order), loaded one ahead.
  int tile = blockIdx.x * L.groups + wr;
  float anext[KSR][4];
  if (wcols > 0 && tile < tiles && kgroups > 0)
    load_a(anext, X, ldx, n, p, 0, WR * tile, lane);
  for (; tile - wr < tiles; tile += stride) {
    const bool active = wcols > 0 && tile < tiles;
    const int i0 = WR * tile;
    float acc[NT][4] = {};
    float na = 0.f, nb = 0.f;
    for (int pc = 0; pc < pchunks; ++pc) {
      if (!resident) {
        __syncthreads();
        load_xb(dyn, L, kr, Xb, ldb, w, p, pc * kr, c0);
        __syncthreads();
      }
      if (!active) continue;
      const int g0 = pc * kr / KG;   // the chunk's k-groups
      const int g1 = resident ? kgroups : min(kgroups, (pc + 1) * kr / KG);
      for (int g = g0; g < g1; ++g) {
        float a[KSR][4];
#pragma unroll
        for (int ks = 0; ks < KSR; ++ks)
#pragma unroll
          for (int h = 0; h < 4; ++h) a[ks][h] = anext[ks][h];
        if (g + 1 < kgroups)
          load_a(anext, X, ldx, n, p, KG * (g + 1), i0, lane);
        else if (tile + stride < tiles)
          load_a(anext, X, ldx, n, p, 0, i0 + WR * stride, lane);
        tc_product<rbf>(acc, na, nb, a, dyn, ks_all, KSR * (g - g0),
                        min(KSR, (p - KG * g + 7) / 8), NT * wc, lane);
      }
    }
    if (!active) continue;
    // kappa on the C fragments: c0, c1 at (g, 2t), (g, 2t + 1) of each n8
    // tile, c2, c3 eight rows down; staged once the warp's lanes have
    // stored the buffer's previous tile.
    const int g = lane >> 2, t = lane & 3;
    if (rbf) {
      na += __shfl_xor_sync(0xffffffffu, na, 1);
      na += __shfl_xor_sync(0xffffffffu, na, 2);
      nb += __shfl_xor_sync(0xffffffffu, nb, 1);
      nb += __shfl_xor_sync(0xffffffffu, nb, 2);
    }
    __syncwarp();
    float* sa = st + g * SS;
    float* sb = sa + 8 * SS;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int jc = 8 * nt + 2 * t;
      const float ya = rbf ? yn[WC * wc + jc] : 0.f;
      const float yb = rbf ? yn[WC * wc + jc + 1] : 0.f;
      const float* k = acc[nt];
      *reinterpret_cast<float2*>(sa + jc) =
          make_float2(kappa<K, D>(k[0], na, ya, gamma, c, degree),
                      kappa<K, D>(k[1], na, yb, gamma, c, degree));
      *reinterpret_cast<float2*>(sb + jc) =
          make_float2(kappa<K, D>(k[2], nb, ya, gamma, c, degree),
                      kappa<K, D>(k[3], nb, yb, gamma, c, degree));
    }
    __syncwarp();
    store_tile(st, out + (long long)i0 * w + c0 + WC * wc, w,
               min(WR, n - i0), wcols, lane);
  }
}

using Kernel = void (*)(const float*, long long, int, const float*,
                        long long, int, int, float, int, Plan, float*);

}  // namespace

// The plan's fields as kernels/_common.py gram_plan returns them; smem must
// equal the kernel's layout, so a plan that drifts from it fails here.
extern "C" int rt_gram_stripe(const float* X, long long ldx, int n,
                              const float* Xb, long long ldb, int w, int p,
                              int kind, float gamma, int degree,
                              int col_warps, int krows, int grid_x, int smem,
                              float* out, void* stream) {
  static const Kernel kernels[4] = {
      gram_kernel<rt::kPolynomial, 2>, gram_kernel<rt::kPolynomial, -1>,
      gram_kernel<rt::kRbf, 0>, gram_kernel<rt::kLinear, 0>};
  static std::atomic<unsigned long long> prepared[4];
  const Plan pl{col_warps, krows};
  const bool cw_ok = col_warps == 1 || col_warps == 2 || col_warps == 4 ||
                     col_warps == 8;
  if (!cw_ok || krows < 8 || krows % 8 || (krows < p && krows % KG) ||
      grid_x < 1 || n < 1 || w < 1 || p < 0)
    return (int)cudaErrorInvalidValue;
  const Layout L(pl);
  if (smem != L.bytes || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int which = kind == rt::kPolynomial ? (degree == 2 ? 0 : 1)
                    : kind == rt::kRbf      ? 2
                                            : 3;
  const Kernel kernel = kernels[which];
  cudaError_t err = rt::allow_smem(kernel, kMaxSmem, prepared[which]);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(grid_x, (w + L.cols - 1) / L.cols);
  kernel<<<grid, 32 * WARPS, smem, (cudaStream_t)stream>>>(
      X, ldx, n, Xb, ldb, w, p, gamma, degree, pl, out);
  return (int)cudaGetLastError();
}
