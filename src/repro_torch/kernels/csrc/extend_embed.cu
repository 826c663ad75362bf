// Fused serving stripe out = P kappa(X, Xb) on the tensor cores: X (p, n)
// training points, P (r, n) the projection Sigma^{-1/2} U^T, Xb (p, w)
// queries -> (r, w).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/extend_embed/extend_embed.py (_extend_embed_kernel /
// extend_embed_call).
//
// Bound on this card: per (n, w) entry the two products take 2p + 2r flops
// (42 at p = 19, r = 2), both on the tensor cores as mma.sync m16n8k8,
// each as three TF32 products (3xTF32, mma_tf32.cuh); kappa takes 2 to 6
// more on the CUDA cores. It reads X, P and Xb once and writes (r, w): at
// n = 100,000, w = 512 the bytes take a fifth of the tensor-core time, so
// it is bound by operations.
//
// Design. The kernel computes the transposed product
//   out^T (w, r) = kappa(Xb^T, X) (w, n) . P^T (n, r):
// queries are the mma rows, training points the columns, so the kappa tile
// is contracted over its columns and its accumulator fragments feed the
// projection directly as A operands (the contraction index permuted,
// mma_tf32.cuh), with r padded to 8 per pass.
// - Block (s, y) walks the training range s of n with 8 warps; each warp
//   owns 16 MT queries of the query group y (MT = 1, 2 or 4 by w, chosen
//   by the wrapper) and keeps their A fragments, split into TF32 big and
//   small parts, in registers for the whole range. The (n, w) tile never
//   leaves the registers.
// - The block stages the range in units of 128 training points: X as B
//   fragments and P^T as B fragments, both split, and the squared norms of
//   X's columns for the rbf kind, in two shared-memory buffers. The next
//   unit loads into registers while the current one computes: one barrier
//   per unit.
// - A warp takes two n8 tiles per step: the gram in 3 k-steps (p
//   zero-padded to 24), kappa on the accumulator fragments in place, then
//   the projection into one accumulation chain per tile parity. At the end
//   of the range the two chains are added and the range's partial written;
//   a second launch adds the partials in range order (rt::sum_splits_kernel,
//   or sum_assign_kernel below when the call assigns). No float atomics.
// - Assignment (the K-means kmeans_assign kernel folded in; it replaces the
//   Pallas TPU kernel src/repro/kernels/kmeans_assign/kmeans_assign.py for
//   the serving path). When the caller passes centroids, the second launch
//   sums the partials in range order as sum_splits_kernel does (the
//   embedding has the same bits), then gives each query, one thread each,
//   the nearest centroid by assign.cuh's routine, so labels and d2 have
//   the bits of the standalone kernel on the same embedding. A served
//   request then pays no launch, transpose or copy for its argmin: the
//   launch replaces the summing launch it already had.
// - Summation order. The ranges depend on n alone
//   (kernels/_common.py extend_split), every warp walks its whole range in
//   the same order whatever w is, and an mma row's sums do not depend on
//   the other rows: a query column gets the same bits in any batch width,
//   at any offset (MicroBatcher's bucketed == unbatched rests on it).
// - Edges: training points past the range load as zeros in X and P, so
//   their kappa values are finite and their terms exact zeros; queries
//   past w load as zeros and are not written, nor are rows of r past r.
// - Shapes past one unit: r in passes of 8 (each pass walks the range
//   again); p past 24 in chunks of 24 rows, with units of 16 training
//   points and the query fragments loaded again for each chunk.
// - kappa is compiled per kind, and for the polynomial degree 2, so that
//   it inlines without branches.
#include "assign.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int KS = 3;                // k8 steps of p per chunk
constexpr int PK = 8 * KS;           // rows of p per chunk
constexpr int CH = 128;              // training points per unit (p <= PK)
constexpr int CH_P = 16;             // training points per unit (p > PK)
constexpr int CT = CH / 8;           // n8 tiles of a unit
constexpr int NS = 2;                // n8 tiles per step
constexpr int RC = 8;                // rows of r per pass

struct Buf {
  float4 x[CT][KS][32];  // X as B fragments (b0, b1 big; b0, b1 small)
  float4 p[CT][32];      // P^T as B fragments, rows permuted
  float xn[CH];          // squared norms of the unit's training points
};

// Every fragment array is filled slot by slot: thread after thread takes
// the next 16-byte slot (lane-major), so the writes meet no bank conflict.
constexpr int kXPer = CT * KS * 32 / kThreads;
constexpr int kPPer = CT * 32 / kThreads;
static_assert(CT * KS * 32 % kThreads == 0, "whole rounds of X");
static_assert(CT * 32 % kThreads == 0, "whole rounds of P");

// One unit of the walk: r rows c0 .. c0 + 8, training points i0 .. i0 + cw,
// p rows 24 pc .. 24 pc + 24; P and the norms come with the last chunk of p.
struct Unit {
  int c0, i0, pc;
  bool last;
};

// Register staging of the next unit.
struct Stage {
  float x[kXPer][2], p[kPPer][2];
};

// A block's walk, in order: passes over r, each over the range's chunks
// of training points, each over the chunks of p; the same order for every
// warp and every w.
struct Walk {
  int row_begin, row_end, cw, pchunks, per_pass, units;

  __device__ Unit at(int u) const {
    const int v = u % per_pass, pc = v % pchunks;
    return {u / per_pass * RC, row_begin + v / pchunks * cw, pc,
            pc == pchunks - 1};
  }
};

__device__ __forceinline__ void fetch(Stage& s, const Unit& u, int cw,
                                      int row_end,
                                      const float* __restrict__ X,
                                      long long ldx, int p,
                                      const float* __restrict__ P,
                                      long long ldp, int r) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < kXPer; ++q) {
    // slot = (tile * KS + ks) * 32 + lane: b0 = X[24pc + 8ks + t][8tile + g],
    // b1 four rows down.
    const int sl = tid + kThreads * q, lane = sl & 31;
    if (sl < cw * KS * 4) {
      const int k = PK * u.pc + 8 * ((sl >> 5) % KS) + (lane & 3);
      const int j = u.i0 + 8 * ((sl >> 5) / KS) + (lane >> 2);
      const bool in = j < row_end;
      s.x[q][0] = in && k < p ? X[k * ldx + j] : 0.f;
      s.x[q][1] = in && k + 4 < p ? X[(k + 4) * ldx + j] : 0.f;
    }
  }
  if (!u.last) return;
#pragma unroll
  for (int q = 0; q < kPPer; ++q) {
    // slot = tile * 32 + lane: b0 = P[c0 + g][8tile + 2t], b1 the next
    // column (the contraction index permuted, mma_tf32.cuh).
    const int sl = tid + kThreads * q, lane = sl & 31;
    if (sl < cw * 4) {
      const int j = u.i0 + 8 * (sl >> 5) + 2 * (lane & 3);
      const int c = u.c0 + (lane >> 2);
      const float* row = P + c * ldp;
      s.p[q][0] = c < r && j < row_end ? row[j] : 0.f;
      s.p[q][1] = c < r && j + 1 < row_end ? row[j + 1] : 0.f;
    }
  }
}

__device__ __forceinline__ void store(Buf& b, const Stage& s, const Unit& u,
                                      int cw, int row_end, bool rbf,
                                      const float* __restrict__ X,
                                      long long ldx, int p) {
  const int tid = threadIdx.x;
  float4* x = &b.x[0][0][0];
  float4* pf = &b.p[0][0];
#pragma unroll
  for (int q = 0; q < kXPer; ++q) {
    const int sl = tid + kThreads * q;
    if (sl < cw * KS * 4) x[sl] = tc::b_frag(s.x[q][0], s.x[q][1]);
  }
  if (!u.last) return;
#pragma unroll
  for (int q = 0; q < kPPer; ++q) {
    const int sl = tid + kThreads * q;
    if (sl < cw * 4) pf[sl] = tc::b_frag(s.p[q][0], s.p[q][1]);
  }
  if (rbf && tid < cw) {
    const int j = u.i0 + tid;
    float n = 0.f;
    if (j < row_end)
      for (int k = 0; k < p; ++k) {
        const float v = X[k * ldx + j];
        n = fmaf(v, v, n);
      }
    b.xn[tid] = n;
  }
}

// The A fragments of the warp's MT query tiles for p rows 24 pc .. 24 pc +
// 24: a0 = Xb[24pc + 8ks + t][q0 + 16mt + g], a1 eight queries on, a2 and
// a3 four rows down; split.
template <int MT>
__device__ __forceinline__ void load_queries(float ab[MT][KS][4],
                                             float as[MT][KS][4],
                                             const float* __restrict__ Xb,
                                             long long ldb, int w, int p,
                                             int pc, int q0, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      float a[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int k = PK * pc + 8 * ks + (lane & 3) + 4 * (h >> 1);
        const int q = q0 + 16 * mt + (lane >> 2) + 8 * (h & 1);
        a[h] = k < p && q < w ? Xb[k * ldb + q] : 0.f;
      }
      tc::split_a(a, ab[mt][ks], as[mt][ks]);
    }
}

// acc[mt][n] += Xb^T X over the k-steps of one chunk of p, for the n8
// tiles NS st + n of the unit. Every tile is computed (points past the
// range hold zeros), so the 2 MT accumulation chains interleave.
template <int MT>
__device__ __forceinline__ void gram(const Buf& b, int st, int ksteps,
                                     float ab[MT][KS][4],
                                     float as[MT][KS][4],
                                     float acc[MT][NS][4], int lane) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ks >= ksteps) break;
    float4 bf[NS];
#pragma unroll
    for (int n = 0; n < NS; ++n) bf[n] = b.x[NS * st + n][ks][lane];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NS; ++n)
        tc::mma(acc[mt][n], as[mt][ks], bf[n].x, bf[n].y);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NS; ++n)
        tc::mma(acc[mt][n], ab[mt][ks], bf[n].z, bf[n].w);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NS; ++n)
        tc::mma(acc[mt][n], ab[mt][ks], bf[n].x, bf[n].y);
  }
}

// kappa on the gram fragments in place (rows: queries g, g + 8 with norms
// qa, qb; columns: training points 2t, 2t + 1), then out[mt][n] += K P^T
// with the fragments as A operands. K and D are the kernel kind and the
// polynomial degree (D < 0: the runtime `degree`).
template <int K, int D, int MT>
__device__ __forceinline__ void project(const Buf& b, int st,
                                        float acc[MT][NS][4],
                                        float out[MT][NS][4],
                                        const float qa[MT],
                                        const float qb[MT], float gamma,
                                        int degree, int lane) {
  const int deg = D < 0 ? degree : D;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const int tile = NS * st + n, jc = 8 * tile + 2 * (lane & 3);
    const float ya = K == rt::kRbf ? b.xn[jc] : 0.f;
    const float yb = K == rt::kRbf ? b.xn[jc + 1] : 0.f;
    const float4 pf = b.p[tile][lane];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float* k = acc[mt][n];
      k[0] = rt::kappa(k[0], ya, qa[mt], K, gamma, deg);
      k[1] = rt::kappa(k[1], yb, qa[mt], K, gamma, deg);
      k[2] = rt::kappa(k[2], ya, qb[mt], K, gamma, deg);
      k[3] = rt::kappa(k[3], yb, qb[mt], K, gamma, deg);
      float cab[4], cas[4];
      tc::c_as_a(k, cab, cas);
      tc::mma3(out[mt][n], cab, cas, pf);
    }
  }
}

template <int K, int D, int MT>
__global__ void __launch_bounds__(kThreads, 1)
    extend_embed_kernel(const float* __restrict__ X, long long ldx, int n,
                        const float* __restrict__ P, long long ldp, int r,
                        const float* __restrict__ Xb, long long ldb, int w,
                        int p, float gamma, int degree, int rows_per_range,
                        float* __restrict__ part) {
  extern __shared__ float4 dyn[];
  Buf* buf = reinterpret_cast<Buf*>(dyn);
  constexpr bool rbf = K == rt::kRbf;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int s = blockIdx.x;
  const int q0 = (blockIdx.y * kWarps + (tid >> 5)) * 16 * MT;
  const bool active = q0 < w;

  Walk walk;
  walk.row_begin = s * rows_per_range;
  walk.row_end = min(n, walk.row_begin + rows_per_range);
  walk.pchunks = max(1, (p + PK - 1) / PK);
  walk.cw = walk.pchunks == 1 ? CH : CH_P;
  walk.per_pass = (walk.row_end - walk.row_begin + walk.cw - 1) / walk.cw *
                  walk.pchunks;
  walk.units = (r + RC - 1) / RC * walk.per_pass;
  const int cw = walk.cw, row_end = walk.row_end;

  float ab[MT][KS][4], as[MT][KS][4];
  float qa[MT], qb[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    qa[mt] = qb[mt] = 0.f;
    const int q = q0 + 16 * mt + g;
    if (rbf)
      for (int k = 0; k < p; ++k) {
        const float va = q < w ? Xb[k * ldb + q] : 0.f;
        const float vb = q + 8 < w ? Xb[k * ldb + q + 8] : 0.f;
        qa[mt] = fmaf(va, va, qa[mt]);
        qb[mt] = fmaf(vb, vb, qb[mt]);
      }
  }
  if (walk.pchunks == 1 && active)
    load_queries<MT>(ab, as, Xb, ldb, w, p, 0, q0, lane);

  float acc[MT][NS][4];
  float out[MT][NS][4] = {};
  Stage stage;
  fetch(stage, walk.at(0), cw, row_end, X, ldx, p, P, ldp, r);
  for (int ui = 0; ui < walk.units; ++ui) {
    const Unit u = walk.at(ui);
    Buf& b = buf[ui & 1];
    store(b, stage, u, cw, row_end, rbf, X, ldx, p);
    __syncthreads();
    if (ui + 1 < walk.units)
      fetch(stage, walk.at(ui + 1), cw, row_end, X, ldx, p, P, ldp, r);
    if (active) {
      if (walk.pchunks > 1)
        load_queries<MT>(ab, as, Xb, ldb, w, p, u.pc, q0, lane);
      const int ksteps = min(KS, (p - PK * u.pc + 7) / 8);
      const int steps = min(cw, row_end - u.i0 + 8 * NS - 1) / (8 * NS);
      for (int st = 0; st < steps; ++st) {
        if (u.pc == 0) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nn = 0; nn < NS; ++nn)
#pragma unroll
              for (int h = 0; h < 4; ++h) acc[mt][nn][h] = 0.f;
        }
        gram<MT>(b, st, ksteps, ab, as, acc, lane);
        if (u.last)
          project<K, D, MT>(b, st, acc, out, qa, qb, gamma, degree, lane);
      }
    }
    if ((ui + 1) % walk.per_pass) continue;
    // The end of a pass over r: this range's partial of rows c0 .. c0 + 8,
    // the two chains added.
    if (active) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int q = q0 + 16 * mt + g + 8 * h, c = u.c0 + 2 * t + cc;
            if (q < w && c < r)
              part[((long long)s * r + c) * w + q] =
                  out[mt][0][2 * h + cc] + out[mt][1][2 * h + cc];
          }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nn = 0; nn < NS; ++nn)
#pragma unroll
        for (int h = 0; h < 4; ++h) out[mt][nn][h] = 0.f;
  }
}

// The assigning form of the summing launch. A block takes kAssignThreads
// queries. Its threads first sum the r x kAssignThreads elements of those
// queries over the ranges in range order, as sum_splits_kernel does, so
// the embedding has the same bits; they write the sums to out. Then they
// stage the centroids, whose barriers make out visible to the block, and
// thread q takes query q's nearest centroid from its r values in out. The
// entry always writes the embedding: it is where the block keeps the r
// values for the k distance passes, r having no compile-time bound. A
// query's results read nothing of the other queries, so they do not depend
// on its batch.
constexpr int kSumAssignThreads = 2 * rt::kAssignThreads;
// Partials loaded ahead of their adds (the adds keep their order). A plain
// loop, or `#pragma unroll`, here, where the block goes on to read out,
// compiled to one load in flight per add.
constexpr int kSumAhead = 8;

__global__ void __launch_bounds__(kSumAssignThreads)
    sum_assign_kernel(const float* __restrict__ part, int nsplit, int r,
                      int w, float* out, const float* __restrict__ C, int k,
                      int* __restrict__ labels, float* __restrict__ d2) {
  extern __shared__ float smem[];
  float* cs = smem;        // (k, r) centroids
  float* cn = cs + k * r;  // (k,)   their squared norms
  const int q0 = blockIdx.x * rt::kAssignThreads;
  const int nq = min(rt::kAssignThreads, w - q0);
  const long long len = (long long)r * w;
  for (int i = threadIdx.x; i < r * nq; i += blockDim.x) {
    const long long e = (long long)(i / nq) * w + q0 + i % nq;
    const float* p = part + e;
    float t = 0.f;
    int s = 0;
    for (; s + kSumAhead <= nsplit; s += kSumAhead) {
      float v[kSumAhead];
#pragma unroll
      for (int u = 0; u < kSumAhead; ++u) v[u] = __ldg(p + (s + u) * len);
#pragma unroll
      for (int u = 0; u < kSumAhead; ++u) t += v[u];
    }
    for (; s < nsplit; ++s) t += __ldg(p + s * len);
    out[e] = t;
  }
  rt::stage_centroids(C, k, r, cs, cn);
  if (threadIdx.x >= nq) return;
  const int q = q0 + threadIdx.x;
  rt::nearest(out + q, w, r, cs, cn, k, labels + q, d2 + q);
}

using Kernel = void (*)(const float*, long long, int, const float*,
                        long long, int, const float*, long long, int, int,
                        float, int, int, float*);

constexpr int kSmem = 2 * (int)sizeof(Buf);

}  // namespace

// query_tiles: the m16 query tiles of one warp (1, 2 or 4), so a block
// takes 128 query_tiles queries. With labels null the second launch sums
// the partials into out (r, w); with C (k, r), labels (w,) and d2 (w,) it
// also assigns each query (sum_assign_kernel). ranges = 0 (n = 0) skips the
// first launch: the embedding is then zero.
extern "C" int rt_extend_embed(const float* X, long long ldx, int n,
                               const float* P, long long ldp, int r,
                               const float* Xb, long long ldb, int w, int p,
                               int kind, float gamma, int degree,
                               int query_tiles, int rows_per_range,
                               int ranges, float* part, float* out,
                               const float* C, int k, int* labels, float* d2,
                               void* stream) {
#define RT_EXTEND_KERNELS(MT)                                        \
  {extend_embed_kernel<rt::kPolynomial, 2, MT>,                      \
   extend_embed_kernel<rt::kPolynomial, -1, MT>,                     \
   extend_embed_kernel<rt::kRbf, 0, MT>,                             \
   extend_embed_kernel<rt::kLinear, 0, MT>}
  static const Kernel kernels[3][4] = {
      RT_EXTEND_KERNELS(1), RT_EXTEND_KERNELS(2), RT_EXTEND_KERNELS(4)};
#undef RT_EXTEND_KERNELS
  static std::atomic<unsigned long long> prepared[3][4];
  const int which = kind == rt::kPolynomial ? (degree == 2 ? 0 : 1)
                    : kind == rt::kRbf      ? 2
                                            : 3;
  const int m = query_tiles == 1 ? 0 : query_tiles == 2 ? 1 : 2;
  if (query_tiles != 1 << m) return (int)cudaErrorInvalidValue;
  const Kernel kernel = kernels[m][which];
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = rt::allow_smem(kernel, kSmem, prepared[m][which]);
  if (err != cudaSuccess) return (int)err;
  const int per_block = kWarps * 16 * query_tiles;
  if (ranges > 0) {
    const dim3 grid(ranges, (w + per_block - 1) / per_block);
    kernel<<<grid, kThreads, kSmem, st>>>(X, ldx, n, P, ldp, r, Xb, ldb, w,
                                          p, gamma, degree, rows_per_range,
                                          part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (!labels)
    return (int)rt::launch_sum_splits(part, ranges, (long long)r * w, out,
                                      st);
  static std::atomic<unsigned long long> assign_prepared;
  size_t smem = 0;
  err = rt::assign_smem(sum_assign_kernel, k, r, &smem, assign_prepared);
  if (err != cudaSuccess) return (int)err;
  const int grid = (w + rt::kAssignThreads - 1) / rt::kAssignThreads;
  sum_assign_kernel<<<grid, kSumAssignThreads, smem, st>>>(
      part, ranges, r, w, out, C, k, labels, d2);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block, for the build report.
extern "C" int rt_extend_embed_smem_bytes() { return kSmem; }
