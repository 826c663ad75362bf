// Fused fit-block update on the tensor cores. From Kc = kappa(X, C), X (p, m),
// C (p, b):
//   new_rows (b, r') = Kc^T Omega          Omega (m, r')
//   delta    (m, r') = Kc Ocross           Ocross (b, r')
//   rn_rows  (m,)    = sum over j < b of Kc[i, j]^2
//   rn_cols  (b,)    = sum over i of V[i] Kc[i, j]^2   (V = 1 when absent)
//
// Replaces the Pallas TPU kernel src/repro/kernels/fit_sketch/fit_sketch.py
// (_fit_sketch_kernel / fit_sketch_call).
//
// Bound on this card: per (m, b) entry the three products take 2p + 4r'
// flops (66 at p = 19, r' = 7), all on the tensor cores as mma.sync
// m16n8k8, each as three TF32 products (3xTF32, mma_tf32.cuh); kappa and
// the norms take a few more on the CUDA cores. The bytes (X, Omega in, delta, rn_rows out, C and Ocross
// once) take a tenth of that time: bound by operations.
//
// Design.
// - One block owns a row range of m and every block column; each of its 8
//   warps owns 64 of the columns. C and Ocross stay in shared memory for
//   the whole range, split into TF32 big and small parts and laid out as
//   mma fragments, as the Pallas kernel kept them resident in VMEM. The
//   block walks its range in 64-row tiles; X, Omega and V of the next tile
//   load into registers while the current one computes.
// - A warp builds each 16 x 64 gram sub-tile in registers (p zero-padded
//   to 24: three k-steps) and applies kappa to the accumulator fragments in
//   place. The tile is never stored as a whole:
//     delta:    its fragments are the A operand of Kc Ocross, the
//               contraction index permuted (mma_tf32.cuh) and Ocross's rows
//               loaded in the matching order;
//     rn_rows:  squared and summed over the quad with shuffles;
//     rn_cols:  squared, weighted by V and kept per column in registers
//               over the whole range, then summed over the 8 row groups
//               with shuffles (a warp owns its columns: nothing to sum
//               across warps);
//     new_rows: the warp transposes its sub-tile through a 16 x 64 slice
//               of shared memory of its own, then Kc^T Omega, kept in
//               registers over the whole range. (Building the tile a second
//               time as C^T X instead was slower.)
// - A tile's delta and rn_rows are summed over the warps in shared memory,
//   in warp order, and leave the kernel final. new_rows and rn_cols leave
//   one partial per row range, which rt::sum_splits_kernel adds in range
//   order. No float atomics: the same inputs give the same bits on every
//   launch (chunked ingest == one-shot ingest rests on it). The row ranges
//   depend on m alone (kernels/_common.py fit_split).
// - Edges: X columns past m and C columns past b load as zeros, so their
//   kappa values are finite; zero rows of Omega, V and Ocross past m and b
//   make their terms of new_rows, rn_cols and delta exact zeros, rn_rows
//   masks columns past b, and outputs past m or b are not written. A zero
//   V drops a row out of rn_cols.
// - Shapes past one block's share are walked inside the block: b in chunks
//   of 512 columns, r' in passes of 8 (each pass builds the gram again), p
//   in chunks of 24 (each chunk of C loaded again per 16 rows).
// - kappa is compiled per kind, and per degree for the polynomial degree 2,
//   so that it inlines without branches.
#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int WC = 64;           // block columns of one warp
constexpr int NT = WC / 8;       // its n8 tiles
constexpr int MW = WC / 16;      // its m16 tiles of Kc^T
constexpr int BC = kWarps * WC;  // block columns per chunk
constexpr int MT = 4;            // m16 sub-tiles of a row tile
constexpr int TM = 16 * MT;      // rows per row tile
constexpr int KS = 3;            // k8 steps of p per chunk
constexpr int PK = 8 * KS;       // rows of p per chunk
constexpr int RC = 8;            // columns of r' per pass
constexpr int TS = WC + 8;       // row stride of a warp's transposed slice
constexpr int DS = TM + 4;       // row stride of the warps' delta partials

struct Smem {
  float4 c[BC / 8][KS][32];     // C as B fragments (b0, b1 big; b0, b1 small)
  float4 o[BC / 8][32];         // Ocross as B fragments, k permuted
  float4 x[MT][KS][2][32];      // X^T as A fragments: [0] big, [1] small
  float4 w[MT][2][32];          // Omega as B fragments
  float kt[kWarps][16][TS];     // each warp's Kc sub-tile, to transpose
  float d[kWarps][RC + 1][DS];  // each warp's delta and rn_rows partials
  float yn[BC], xn[TM], v[TM];  // squared norms of C and X columns; V
};

// Every fragment array in shared memory is filled slot by slot: thread
// after thread takes the next 16-byte slot (lane-major), loads the values
// that slot holds and writes it whole, so the writes meet no bank conflict.
constexpr int kXSlots = MT * KS * 32;      // x, per row tile
constexpr int kXPer = (kXSlots + kThreads - 1) / kThreads;
constexpr int kWSlots = MT * 2 * 32;       // w, per row tile
constexpr int kCSlots = BC / 8 * KS * 32;  // c, per column chunk
constexpr int kOSlots = BC / 8 * 32;       // o, per column chunk
constexpr int kBatch = 8;                  // c slots loaded before stored
static_assert(kWSlots == kThreads, "one Omega slot per thread");
static_assert(kCSlots % (kThreads * kBatch) == 0, "whole batches of C");
static_assert(kOSlots % kThreads == 0, "whole rounds of Ocross");

// Register staging of the next row tile's X, Omega and V.
struct Stage {
  float x[kXPer][4], w[2], v;
};

// The four values of X^T A-fragment slot `lane` (k-step ks) of the 16 rows
// from i: X rows k0 + t (+ 4), columns i + g (+ 8).
__device__ __forceinline__ void load_x(float a[4],
                                       const float* __restrict__ X,
                                       long long ldx, int p, int k0, int i,
                                       int row_end, int lane) {
  const int k = k0 + (lane & 3), r = i + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int kk = k + 4 * (h >> 1), rr = r + 8 * (h & 1);
    a[h] = kk < p && rr < row_end ? X[kk * ldx + rr] : 0.f;
  }
}

__device__ __forceinline__ void put_x(Smem& sm, int slot, int ks, int lane,
                                      const float a[4]) {
  float4 big, small;
  tc::split(a[0], big.x, small.x);
  tc::split(a[1], big.y, small.y);
  tc::split(a[2], big.z, small.z);
  tc::split(a[3], big.w, small.w);
  sm.x[slot][ks][0][lane] = big;
  sm.x[slot][ks][1][lane] = small;
}

// C rows p0 .. p0 + PK and Ocross of the column chunk j0 as B fragments,
// and the squared column norms of C for the rbf kind.
__device__ void load_cols(Smem& sm, const float* __restrict__ C,
                          long long ldc, int b, int p, int p0,
                          const float* __restrict__ Ocr, int rp, int j0,
                          int c0, bool with_ocr, bool rbf) {
  const int tid = threadIdx.x;
#pragma unroll 1
  for (int s0 = tid; s0 < kCSlots; s0 += kThreads * kBatch) {
    float v[kBatch][2];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      // slot = (jt * KS + ks) * 32 + lane: b0 = C[8ks + t][8jt + g], b1 four
      // rows down.
      const int s = s0 + kThreads * q, lane = s & 31, ks = (s >> 5) % KS;
      const int k = p0 + 8 * ks + (lane & 3);
      const int j = j0 + 8 * ((s >> 5) / KS) + (lane >> 2);
      v[q][0] = k < p && j < b ? C[k * ldc + j] : 0.f;
      v[q][1] = k + 4 < p && j < b ? C[(k + 4) * ldc + j] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int s = s0 + kThreads * q;
      sm.c[(s >> 5) / KS][(s >> 5) % KS][s & 31] =
          tc::b_frag(v[q][0], v[q][1]);
    }
  }
  if (!with_ocr) return;
#pragma unroll
  for (int s = tid; s < kOSlots; s += kThreads) {
    // slot = jt * 32 + lane: b0 = Ocross[8jt + 2t][g], b1 the next row (the
    // contraction index permuted, mma_tf32.cuh).
    const int lane = s & 31, j = j0 + 8 * (s >> 5) + 2 * (lane & 3);
    const int c = c0 + (lane >> 2);
    const float b0 = j < b && c < rp ? Ocr[(long long)j * rp + c] : 0.f;
    const float b1 = j + 1 < b && c < rp ? Ocr[(long long)(j + 1) * rp + c]
                                         : 0.f;
    sm.o[s >> 5][lane] = tc::b_frag(b0, b1);
  }
  for (int jj = tid; jj < BC; jj += kThreads) {
    float s = 0.f;
    if (rbf && j0 + jj < b)
      for (int k = 0; k < p; ++k) {
        const float x = C[k * ldc + j0 + jj];
        s = fmaf(x, x, s);
      }
    sm.yn[jj] = s;
  }
}

__device__ __forceinline__ void fetch(Stage& s, const float* __restrict__ X,
                                      long long ldx, int p, bool with_x,
                                      const float* __restrict__ Om, int rp,
                                      const float* __restrict__ V, int i0,
                                      int row_end, int c0) {
  const int tid = threadIdx.x;
  if (with_x) {
#pragma unroll
    for (int q = 0; q < kXPer; ++q) {
      // slot = (st * KS + ks) * 32 + lane
      const int sl = tid + kThreads * q, st = (sl >> 5) / KS;
      if (sl < kXSlots)
        load_x(s.x[q], X, ldx, p, 8 * ((sl >> 5) % KS), i0 + 16 * st,
               row_end, sl & 31);
    }
  }
  // Omega slot = (st * 2 + ks) * 32 + lane: b0 = Omega[16st + 8ks + t][g],
  // b1 four rows down.
  const int lane = tid & 31, i = i0 + 8 * (tid >> 5) + (lane & 3);
  const int c = c0 + (lane >> 2);
  s.w[0] = i < row_end && c < rp ? Om[(long long)i * rp + c] : 0.f;
  s.w[1] = i + 4 < row_end && c < rp ? Om[(long long)(i + 4) * rp + c] : 0.f;
  s.v = 0.f;
  if (tid < TM && i0 + tid < row_end) s.v = V ? V[i0 + tid] : 1.f;
}

__device__ __forceinline__ void store(Smem& sm, const Stage& s,
                                      const float* __restrict__ X,
                                      long long ldx, int p, bool with_x,
                                      int i0, int row_end, bool rbf) {
  const int tid = threadIdx.x;
  if (with_x) {
#pragma unroll
    for (int q = 0; q < kXPer; ++q) {
      const int sl = tid + kThreads * q;
      if (sl < kXSlots)
        put_x(sm, (sl >> 5) / KS, (sl >> 5) % KS, sl & 31, s.x[q]);
    }
  }
  sm.w[tid >> 6][(tid >> 5) & 1][tid & 31] = tc::b_frag(s.w[0], s.w[1]);
  if (tid < TM) {
    sm.v[tid] = s.v;
    float n = 0.f;
    if (rbf && i0 + tid < row_end)
      for (int k = 0; k < p; ++k) {
        const float x = X[k * ldx + i0 + tid];
        n = fmaf(x, x, n);
      }
    sm.xn[tid] = n;
  }
}

// acc[nt] += X^T C over the k-steps of one chunk of p, for sub-tile slot
// `slot` and this warp's n8 tiles. Every tile is computed (columns past b
// hold zeros), so the eight accumulation chains interleave without
// predicates.
__device__ __forceinline__ void gram(const Smem& sm, int slot, int ksteps,
                                     int jt0, float acc[NT][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ks >= ksteps) break;
    const float4 xb = sm.x[slot][ks][0][lane], xs = sm.x[slot][ks][1][lane];
    const float ab[4] = {xb.x, xb.y, xb.z, xb.w};
    const float as[4] = {xs.x, xs.y, xs.z, xs.w};
    float4 cf[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) cf[nt] = sm.c[jt0 + nt][ks][lane];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) tc::mma(acc[nt], as, cf[nt].x, cf[nt].y);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) tc::mma(acc[nt], ab, cf[nt].z, cf[nt].w);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) tc::mma(acc[nt], ab, cf[nt].x, cf[nt].y);
  }
}

// One 16 x 64 sub-tile of a warp, its gram in acc: kappa in place, then
// every contraction of it. K and D are the kernel kind and the polynomial
// degree (D < 0: the runtime `degree`). Columns past b count in rn_rows
// only through the mask; the other sums drop them by zero rows (see the
// note at the top).
template <int K, int D>
__device__ __forceinline__ void update(Smem& sm, float acc[NT][4], int st,
                                      int wj, int wcols, float gamma,
                                      int degree, float nacc[MW][4],
                                      float ncs[NT][2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = 16 * st + g, rb = ra + 8;     // tile-relative rows
  const int deg = D < 0 ? degree : D;
  const float xa = sm.xn[ra], xb = sm.xn[rb];
  const float va = sm.v[ra], vb = sm.v[rb];
  float* kt = &sm.kt[warp][0][0];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int jc = 8 * nt + 2 * t;             // warp-relative column
    const float ya = sm.yn[wj + jc], yb = sm.yn[wj + jc + 1];
    float* k = acc[nt];
    k[0] = rt::kappa(k[0], xa, ya, K, gamma, deg);
    k[1] = rt::kappa(k[1], xa, yb, K, gamma, deg);
    k[2] = rt::kappa(k[2], xb, ya, K, gamma, deg);
    k[3] = rt::kappa(k[3], xb, yb, K, gamma, deg);
  }
  // delta = Kc Ocross in two accumulation chains (n8 tile nt into chain
  // nt % 2), added at the end.
  float dacc[2][4] = {};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float ab[4], as[4];
    tc::c_as_a(acc[nt], ab, as);
    tc::mma3(dacc[nt & 1], ab, as, sm.o[wj / 8 + nt][lane]);
  }
  float rra = 0.f, rrb = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float* k = acc[nt];
    const float q0 = k[0] * k[0], q1 = k[1] * k[1];
    const float q2 = k[2] * k[2], q3 = k[3] * k[3];
    const int jc = 8 * nt + 2 * t;
    const bool ca = jc < wcols, cb = jc + 1 < wcols;
    rra += (ca ? q0 : 0.f) + (cb ? q1 : 0.f);
    rrb += (ca ? q2 : 0.f) + (cb ? q3 : 0.f);
    ncs[nt][0] = fmaf(vb, q2, fmaf(va, q0, ncs[nt][0]));
    ncs[nt][1] = fmaf(vb, q3, fmaf(va, q1, ncs[nt][1]));
    *reinterpret_cast<float2*>(kt + g * TS + jc) = make_float2(k[0], k[1]);
    *reinterpret_cast<float2*>(kt + (g + 8) * TS + jc) =
        make_float2(k[2], k[3]);
  }
  __syncwarp();
  // new_rows += Kc^T Omega, the A operand (16 columns x 8 rows) read
  // transposed from the warp's slice.
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
    for (int mt = 0; mt < MW; ++mt) {
      const float* r0 = kt + (8 * ks + t) * TS + 16 * mt + g;
      const float* r1 = r0 + 4 * TS;
      const float a[4] = {r0[0], r0[8], r1[0], r1[8]};
      float ab[4], as[4];
      tc::split_a(a, ab, as);
      tc::mma3(nacc[mt], ab, as, sm.w[st][ks][lane]);
    }
  }
  __syncwarp();
  rra += __shfl_xor_sync(0xffffffffu, rra, 1);
  rra += __shfl_xor_sync(0xffffffffu, rra, 2);
  rrb += __shfl_xor_sync(0xffffffffu, rrb, 1);
  rrb += __shfl_xor_sync(0xffffffffu, rrb, 2);
  float* d = &sm.d[warp][0][0];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    d[(2 * t + h) * DS + ra] = dacc[0][h] + dacc[1][h];
    d[(2 * t + h) * DS + rb] = dacc[0][2 + h] + dacc[1][2 + h];
  }
  if (t == 0) {
    d[RC * DS + ra] = rra;
    d[RC * DS + rb] = rrb;
  }
}

template <int K, int D>
__global__ void __launch_bounds__(kThreads, 1)
    fit_sketch_kernel(const float* __restrict__ X, long long ldx, int m,
                      const float* __restrict__ Om, int rp,
                      const float* __restrict__ C, long long ldc, int b,
                      const float* __restrict__ Ocr,
                      const float* __restrict__ V, int p, float gamma,
                      int degree, int rows_per_range,
                      float* __restrict__ part, float* __restrict__ delta,
                      float* __restrict__ rn_rows) {
  extern __shared__ float4 dyn[];
  Smem& sm = *reinterpret_cast<Smem*>(dyn);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_begin = blockIdx.x * rows_per_range;
  const int row_end = min(m, row_begin + rows_per_range);
  const int pchunks = (p + PK - 1) / PK;
  const bool one_chunk = pchunks == 1, rbf = K == rt::kRbf;
  float* part_s = part + (long long)blockIdx.x * ((long long)b * rp + b);

  for (int c0 = 0; c0 < rp; c0 += RC) {
    for (int j0 = 0; j0 < b; j0 += BC) {
      const int wj = WC * warp;                  // chunk-relative columns
      const int wcols = max(0, min(WC, b - j0 - wj));
      const int warps = min(kWarps, (b - j0 + WC - 1) / WC);
      Stage stage;
      fetch(stage, X, ldx, p, one_chunk, Om, rp, V, row_begin, row_end, c0);
      load_cols(sm, C, ldc, b, p, 0, Ocr, rp, j0, c0, true, rbf);
      float nacc[MW][4] = {};    // new_rows: rows wj + 16 mt + (g, g + 8)
      float ncs[NT][2] = {};     // rn_cols: columns wj + 8 nt + 2t (+ 1)
      for (int i0 = row_begin; i0 < row_end; i0 += TM) {
        const int nrows = min(TM, row_end - i0);
        store(sm, stage, X, ldx, p, one_chunk, i0, row_end, rbf);
        __syncthreads();
        if (i0 + TM < row_end)
          fetch(stage, X, ldx, p, one_chunk, Om, rp, V, i0 + TM, row_end,
                c0);
        for (int st = 0; 16 * st < nrows; ++st) {
          float acc[NT][4] = {};
          int slot = st;
          for (int pc = 0; pc < pchunks; ++pc) {
            if (!one_chunk) {    // the next 24 rows of p for these 16 rows
              __syncthreads();
              load_cols(sm, C, ldc, b, p, pc * PK, Ocr, rp, j0, c0, false,
                        false);
              if (tid < KS * 32) {
                float a[4];
                load_x(a, X, ldx, p, pc * PK + 8 * (tid >> 5), i0 + 16 * st,
                       row_end, lane);
                put_x(sm, 0, tid >> 5, lane, a);
              }
              __syncthreads();
              slot = 0;
            }
            if (wcols > 0)
              gram(sm, slot, min(KS, (p - pc * PK + 7) / 8), wj / 8, acc);
          }
          if (wcols > 0)
            update<K, D>(sm, acc, st, wj, wcols, gamma, degree, nacc, ncs);
        }
        __syncthreads();
        // The tile's delta and rn_rows (on the first pass over r'): the
        // warps' partials, summed in warp order.
        const int ncols = min(RC, rp - c0);
        for (int e = tid; e < (ncols + (c0 == 0)) * TM; e += kThreads) {
          const int c = e / TM < ncols ? e / TM : RC, ii = e % TM;
          if (ii >= nrows) continue;
          float s = 0.f;
          for (int w = 0; w < warps; ++w) s += sm.d[w][c][ii];
          const long long row = i0 + ii;
          float* out = c < RC ? delta + row * rp + c0 + c : rn_rows + row;
          if (j0 == 0)
            *out = s;
          else
            *out += s;
        }
      }
      if (wcols == 0) continue;
      // This range's partials of new_rows and rn_cols.
#pragma unroll
      for (int mt = 0; mt < MW; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int jc = 16 * mt + g + 8 * h, c = c0 + 2 * t + cc;
            if (jc < wcols && c < rp)
              part_s[(long long)(j0 + wj + jc) * rp + c] =
                  nacc[mt][2 * h + cc];
          }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          float s = ncs[nt][cc];
          s += __shfl_xor_sync(0xffffffffu, s, 4);
          s += __shfl_xor_sync(0xffffffffu, s, 8);
          s += __shfl_xor_sync(0xffffffffu, s, 16);
          const int jc = 8 * nt + 2 * t + cc;
          if (g == 0 && c0 == 0 && jc < wcols)
            part_s[(long long)b * rp + j0 + wj + jc] = s;
        }
    }
  }
}

using Kernel = void (*)(const float*, long long, int, const float*, int,
                        const float*, long long, int, const float*,
                        const float*, int, float, int, int, float*, float*,
                        float*);

}  // namespace

extern "C" int rt_fit_sketch(const float* X, long long ldx, int m,
                             const float* Om, int rp, const float* C,
                             long long ldc, int b, const float* Ocr,
                             const float* V, int p, int kind, float gamma,
                             int degree, int rows_per_range, int ranges,
                             float* part, float* out_acc, float* out_delta,
                             void* stream) {
  static const Kernel kernels[] = {
      fit_sketch_kernel<rt::kPolynomial, 2>,
      fit_sketch_kernel<rt::kPolynomial, -1>,
      fit_sketch_kernel<rt::kRbf, 0>, fit_sketch_kernel<rt::kLinear, 0>};
  static std::atomic<unsigned long long> prepared[4];
  const int which = kind == rt::kPolynomial ? (degree == 2 ? 0 : 1)
                    : kind == rt::kRbf      ? 2
                                            : 3;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      rt::allow_smem(kernels[which], (int)sizeof(Smem), prepared[which]);
  if (err != cudaSuccess) return (int)err;
  kernels[which]<<<ranges, kThreads, sizeof(Smem), st>>>(
      X, ldx, m, Om, rp, C, ldc, b, Ocr, V, p, gamma, degree, rows_per_range,
      part, out_delta, out_delta + (long long)m * rp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)rt::launch_sum_splits(part, ranges, (long long)b * rp + b,
                                    out_acc, st);
}

// Dynamic shared memory of one block, for the build report.
extern "C" int rt_fit_sketch_smem_bytes() { return (int)sizeof(Smem); }
