// Walsh-Hadamard transform along dim 0 of x (n, c), n = 2^m, f32, and its
// SRHT form Omega^T M = R^T H D M, both on one pass kernel.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fwht/fwht.py
// (_fwht_kernel, :28 / fwht_1level, :42) and its two-sweep wrapper
// src/repro/kernels/fwht/ops.py:54 (fwht_pallas), whose factorization
// the one-column plan below keeps; the SRHT form replaces
// the pad / sign / transform / gather composition around it,
// src/repro/core/sketch.py:104 (srht_apply_t).
//
// Bound on this card. fwht: one read and one write of x (8 n c bytes); at
// (131072, 512) 0.160 ms at 3.35 TB/s, against 0.017 ms for the
// n c log2(n) adds at the fp32 rate. srht_t: one read of the m rows of M,
// of the signs and one write of the (r', c) result, (m c + n + r' c) 4
// bytes; at m = 100,000, c = 512: 0.061 ms.
//
// Design. The log2(n) stages run in passes of at most 10 (the wrapper
// plans them: 9 + 8 at n = 2^17). In a pass that starts at stage bit
// `done`, a block owns 2^k rows base + j * stride (j < 2^k; stride 2^done
// for fwht) of one tile of 8 lanes x VEC columns, VEC = 4 (16-byte loads
// and stores) when c allows it; column tiles vary fastest across blocks,
// so the blocks in flight read whole rows. Each thread holds one lane's
// 2^G rows in registers (G = 3, 64 registers), issues all
// their loads before the first stage, runs G stages there, and the block
// exchanges the tile through shared memory once per further G stages
// (twice at k = 9). Loads of data read once are evict-first and the last
// pass's stores streaming. HBM sees two reads and two writes of the slab,
// and a pass runs at about the rate of a device-to-device copy: running
// the passes of 16 MB column chunks back to back, so that the
// intermediate could stay in L2, did not pay on the H100 (the column
// segments it reads are short, and a pass is bound by loads in flight,
// not by HBM traffic).
// One column (c = 1; the sketched gradient's (2^31, 1), 17.18 GB read and
// written, 5.13 ms at 3.35 TB/s) would leave 7 of a tile row's 8 lanes
// idle and, past the first pass, read one 4-byte word per 32-byte sector.
// Its plan reads the column row-major as an (n / 2^L, 2^L) matrix,
// H_n = (H_{n/2^L} (x) I)(I (x) H_{2^L}), as the JAX wrapper's two sweeps
// do: fwht_rows_kernel transforms each contiguous segment of 2^L floats
// (stage bits 0 .. L - 1; a segment is a tile of 2^(L-5) rows of 32
// floats, each 8-lane row loading one 128-byte line; bits 0 .. 4 inside a
// row by registers and warp shuffles, the rest as a pass runs them), then
// fwht_pass_kernel runs bits L .. m - 1 in place on the view, 2^L columns
// at 16-byte loads. At n = 2^31, L = 13: three passes over x, each
// coalesced, against four (8 + 8 + 8 + 7) of one live lane in eight.
// srht_t reads only the rows of M below m, scales them by the signs in
// its first pass (rows past m are zero; a block past m reads nothing and
// writes zeros), and every pass writes only the rows whose transformed
// low bits equal a sampled row's: the host plans those rows once per
// sketch (bases, write lists; the short pass first, 8 + 9 stages at
// n = 2^17, so the pass that reads M has more, smaller blocks in flight),
// and the second pass runs the <= r' blocks that hold a sampled row, on
// a compact scratch of <= r' rows per 256 that stays in L2.
//
// Same bits as the plain version: the stages run in its order (h = 1, 2,
// 4, ..., each a + b, a - b), the last pass divides by the same f32
// sqrt(n) with __fdiv_rn, and nothing is summed in a data-dependent order,
// so every launch gives the same result (chunked == one-shot ingest rests
// on it). srht_t equals its plain version by value: a row past m is +0
// here where the plain version's 0 * -1 is -0.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 8;        // threads across one row of a tile
constexpr int kMaxBits = 10;     // stages per pass
constexpr int kMaxRegBits = 3;   // rows a thread may hold: 2^G, G <= 3
constexpr int kMaxThreads = 1024;

template <int VEC>
struct Vec {
  float e[VEC];
};

// Loads: evict-first for data read once, L2-only for the intermediate.
template <int VEC>
__device__ __forceinline__ Vec<VEC> load(const float* p, bool once) {
  Vec<VEC> r;
  if constexpr (VEC == 4) {
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 t = once ? __ldcs(q) : __ldcg(q);
    r.e[0] = t.x; r.e[1] = t.y; r.e[2] = t.z; r.e[3] = t.w;
  } else {
    r.e[0] = once ? __ldcs(p) : __ldcg(p);
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void store(float* p, Vec<VEC> v, bool last) {
  if constexpr (VEC == 4) {
    const float4 t = make_float4(v.e[0], v.e[1], v.e[2], v.e[3]);
    if (last) __stcs(reinterpret_cast<float4*>(p), t);
    else *reinterpret_cast<float4*>(p) = t;
  } else {
    if (last) __stcs(p, v.e[0]);
    else *p = v.e[0];
  }
}

template <int VEC>
__device__ __forceinline__ Vec<VEC> divide(Vec<VEC> v, float divisor) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) v.e[e] = __fdiv_rn(v.e[e], divisor);
  return v;
}

// Tile row of a thread's register i when its G register bits are the
// pass-local bits [w, w + G): the thread's group index fills the others.
template <int G>
__device__ __forceinline__ int tile_row(int i, int group, int w) {
  return (group & ((1 << w) - 1)) | (i << w) | ((group >> w) << (w + G));
}

// The register rounds of a pass of k stages: round r runs the stages
// [r G, min(r G + G, k)) in the register window that starts at
// min(r G, k - G); between rounds the block exchanges the tile through
// shared memory. On return each thread holds the rows of the window
// final_window(k).
template <int G>
__device__ __forceinline__ int rounds(int k) {
  return G == 0 ? 1 : (k + G - 1) / G;
}

template <int G>
__device__ __forceinline__ int window(int r, int k) {
  return min(r * G, k - G);
}

template <int G, int VEC>
__device__ __forceinline__ void butterflies(Vec<VEC> (&v)[1 << G], int lo,
                                            int hi, int w) {
#pragma unroll
  for (int lb = 0; lb < G; ++lb) {
    const int bit = w + lb;
    if (bit < lo || bit >= hi) continue;
#pragma unroll
    for (int i = 0; i < (1 << G); ++i) {
      if (i & (1 << lb)) continue;
      const int i2 = i | (1 << lb);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float a = v[i].e[e], b = v[i2].e[e];
        v[i].e[e] = a + b;
        v[i2].e[e] = a - b;
      }
    }
  }
}

template <int G, int VEC>
__device__ __forceinline__ void to_smem(float* sm, const Vec<VEC> (&v)[1 << G],
                                        int group, int lane, int w) {
  constexpr int tc = kLanes * VEC;
#pragma unroll
  for (int i = 0; i < (1 << G); ++i) {
    float* p = sm + tile_row<G>(i, group, w) * tc + lane * VEC;
    if constexpr (VEC == 4)
      *reinterpret_cast<float4*>(p) =
          make_float4(v[i].e[0], v[i].e[1], v[i].e[2], v[i].e[3]);
    else
      *p = v[i].e[0];
  }
}

template <int G, int VEC>
__device__ __forceinline__ void from_smem(const float* sm, Vec<VEC> (&v)[1 << G],
                                          int group, int lane, int w) {
  constexpr int tc = kLanes * VEC;
#pragma unroll
  for (int i = 0; i < (1 << G); ++i) {
    const float* p = sm + tile_row<G>(i, group, w) * tc + lane * VEC;
    if constexpr (VEC == 4) {
      const float4 t = *reinterpret_cast<const float4*>(p);
      v[i].e[0] = t.x; v[i].e[1] = t.y; v[i].e[2] = t.z; v[i].e[3] = t.w;
    } else {
      v[i].e[0] = *p;
    }
  }
}

// All k stages of a pass on the tile whose window-0 rows v holds; on
// return v holds the rows of the last window.
template <int G, int VEC>
__device__ __forceinline__ void run_pass(float* sm, Vec<VEC> (&v)[1 << G],
                                         int k, int group, int lane) {
  const int nr = rounds<G>(k);
  for (int r = 0; r < nr; ++r) {
    if (r > 0) {
      if (r > 1) __syncthreads();
      to_smem<G, VEC>(sm, v, group, lane, window<G>(r - 1, k));
      __syncthreads();
      from_smem<G, VEC>(sm, v, group, lane, window<G>(r, k));
    }
    butterflies<G, VEC>(v, r * G, min(r * G + G, k), window<G>(r, k));
  }
}

constexpr int launch_bound(int g) {
  return (kLanes << (kMaxBits - g)) < kMaxThreads ? (kLanes << (kMaxBits - g))
                                                  : kMaxThreads;
}

// One fwht pass over x (n rows of c columns): stages done .. done + k - 1.
// out may alias x.
template <int G, int VEC>
__global__ void __launch_bounds__(launch_bound(G))
    fwht_pass_kernel(const float* x, float* out, int c, int tiles, int done,
                     int k, float divisor, int first, int last) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x % kLanes, group = threadIdx.x / kLanes;
  const long long s = 1LL << done;
  const long long g = blockIdx.x / tiles;
  const long long row0 = ((g >> done) << (done + k)) + (g & (s - 1));
  const int col = (blockIdx.x % tiles) * kLanes * VEC + lane * VEC;
  const bool active = col < c;
  Vec<VEC> v[1 << G];
#pragma unroll
  for (int i = 0; i < (1 << G); ++i) {
    const long long row = row0 + tile_row<G>(i, group, 0) * s;
    if (active) {
      v[i] = load<VEC>(x + row * c + col, first);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[i].e[e] = 0.f;
    }
  }
  run_pass<G, VEC>(sm, v, k, group, lane);
  if (!active) return;
  const int w = window<G>(rounds<G>(k) - 1, k);
#pragma unroll
  for (int i = 0; i < (1 << G); ++i) {
    const long long row = row0 + tile_row<G>(i, group, w) * s;
    store<VEC>(out + row * c + col, last ? divide<VEC>(v[i], divisor) : v[i],
               last);
  }
}

// Stage bits 0 .. 4 of a tile row's 32 floats: bits 0 and 1 inside each
// thread's 4 columns, bits 2 .. 4 across the row's 8 lanes by warp
// shuffles (a lane whose bit is 0 keeps a + b, its partner a - b, as the
// plain version pairs them). `mask` names the warp's threads.
template <int G>
__device__ __forceinline__ void row_stages(Vec<4> (&v)[1 << G], int lane,
                                           unsigned mask) {
#pragma unroll
  for (int i = 0; i < (1 << G); ++i) {
    float* e = v[i].e;
#pragma unroll
    for (int h = 1; h <= 2; h *= 2) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q & h) continue;
        const float a = e[q], b = e[q | h];
        e[q] = a + b;
        e[q | h] = a - b;
      }
    }
  }
#pragma unroll
  for (int h = 1; h < kLanes; h *= 2) {
    const bool upper = lane & h;
#pragma unroll
    for (int i = 0; i < (1 << G); ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float mine = v[i].e[q];
        const float other = __shfl_xor_sync(mask, mine, h);
        v[i].e[q] = upper ? other - mine : mine + other;
      }
    }
  }
}

// The row pass of one column (c = 1): block b transforms the contiguous
// segment x[b 2^s .. (b + 1) 2^s), s = k + 5, in place of stage bits
// 0 .. s - 1. The segment is a tile of 2^k rows of 32 floats (8 lanes x
// 4): stage bits 0 .. 4 run inside a row (row_stages), bits 5 .. s - 1
// down the tile's rows as a pass kernel runs them. out may alias x.
template <int G>
__global__ void __launch_bounds__(launch_bound(G))
    fwht_rows_kernel(const float* x, float* out, int k, float divisor,
                     int last) {
  extern __shared__ float sm[];
  constexpr int tc = kLanes * 4;
  const int lane = threadIdx.x % kLanes, group = threadIdx.x / kLanes;
  const long long seg = (long long)blockIdx.x << (k + 5);
  const unsigned mask =
      blockDim.x >= 32 ? 0xffffffffu : (1u << blockDim.x) - 1u;
  Vec<4> v[1 << G];
#pragma unroll
  for (int i = 0; i < (1 << G); ++i)
    v[i] = load<4>(x + seg + tile_row<G>(i, group, 0) * tc + lane * 4, true);
  row_stages<G>(v, lane, mask);
  run_pass<G, 4>(sm, v, k, group, lane);
  const int w = window<G>(rounds<G>(k) - 1, k);
#pragma unroll
  for (int i = 0; i < (1 << G); ++i)
    store<4>(out + seg + tile_row<G>(i, group, w) * tc + lane * 4,
             last ? divide<4>(v[i], divisor) : v[i], last);
}

// One srht_t pass. Block b owns the rows bases[b] + j * stride of src
// (j < 2^k); in the first pass (signs != null) rows >= m_src are zero and
// the rest are scaled by signs[row]. After the k stages the block writes
// its tile rows wj[wptr[b] .. wptr[b + 1]) to the dst rows wdst[...].
template <int G, int VEC>
__global__ void __launch_bounds__(launch_bound(G))
    srht_pass_kernel(const float* src, long long m_src, const float* signs,
                     const long long* bases, long long stride,
                     const int* wptr, const int* wj, const long long* wdst,
                     float* dst, int c, int tiles, int k, float divisor,
                     int last) {
  extern __shared__ float sm[];
  constexpr int tc = kLanes * VEC;
  const int lane = threadIdx.x % kLanes, group = threadIdx.x / kLanes;
  const int b = blockIdx.x / tiles, col0 = (blockIdx.x % tiles) * tc;
  const long long base = bases[b];
  const int col = col0 + lane * VEC;
  const bool active = col < c;
  const int w0 = wptr[b], nw = wptr[b + 1] - w0;
  if (signs != nullptr && base >= m_src) {
    // Every row of the tile lies past m: its transform is +0 throughout.
    for (int e = threadIdx.x; e < nw * kLanes; e += blockDim.x) {
      const int cl = col0 + (e % kLanes) * VEC;
      if (cl < c) store<VEC>(dst + wdst[w0 + e / kLanes] * c + cl, Vec<VEC>{},
                             last);
    }
    return;
  }
  Vec<VEC> v[1 << G];
#pragma unroll
  for (int i = 0; i < (1 << G); ++i) {
    const long long row = base + tile_row<G>(i, group, 0) * stride;
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[i].e[e] = 0.f;
    if (active && row < m_src) {
      v[i] = load<VEC>(src + row * c + col, signs != nullptr);
      if (signs != nullptr) {
        const float sg = __ldg(signs + row);
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[i].e[e] = v[i].e[e] * sg;
      }
    }
  }
  run_pass<G, VEC>(sm, v, k, group, lane);
  if (rounds<G>(k) > 1) __syncthreads();
  to_smem<G, VEC>(sm, v, group, lane, window<G>(rounds<G>(k) - 1, k));
  __syncthreads();
  for (int e = threadIdx.x; e < nw * kLanes; e += blockDim.x) {
    const int l = e % kLanes, cl = col0 + l * VEC;
    if (cl >= c) continue;
    Vec<VEC> t;
    const float* p = sm + wj[w0 + e / kLanes] * tc + l * VEC;
#pragma unroll
    for (int q = 0; q < VEC; ++q) t.e[q] = p[q];
    store<VEC>(dst + wdst[w0 + e / kLanes] * c + cl,
               last ? divide<VEC>(t, divisor) : t, last);
  }
}

template <typename Kernel>
cudaError_t raise_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

size_t tile_smem(int k, int vec) { return (sizeof(float) * kLanes * vec) << k; }

bool valid_pass(int k, int g, int vec) {
  return k >= 0 && k <= kMaxBits && g >= 0 && g <= kMaxRegBits && g <= k &&
         (g > 0 || k == 0) && (kLanes << (k - g)) <= kMaxThreads &&
         (vec == 1 || vec == 4);
}

template <int G, int VEC>
cudaError_t fwht_launch(const float* x, float* out, long long n, int c,
                        int done, int k, float divisor, int first, int last,
                        cudaStream_t stream) {
  const size_t smem = tile_smem(k, VEC);
  cudaError_t err = raise_smem(fwht_pass_kernel<G, VEC>, smem);
  if (err != cudaSuccess) return err;
  // Column tiles vary fastest across blocks, so the blocks in flight read
  // whole rows of x, not one tile's segment of many rows.
  const int tc = kLanes * VEC, tiles = (c + tc - 1) / tc;
  const long long blocks = (n >> k) * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fwht_pass_kernel<G, VEC><<<(unsigned)blocks, kLanes << (k - G), smem,
                             stream>>>(x, out, c, tiles, done, k, divisor,
                                       first, last);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t fwht_dispatch(int g, const float* x, float* out, long long n,
                          int c, int done, int k, float divisor, int first,
                          int last, cudaStream_t st) {
  switch (g) {
    case 0: return fwht_launch<0, VEC>(x, out, n, c, done, k, divisor, first, last, st);
    case 1: return fwht_launch<1, VEC>(x, out, n, c, done, k, divisor, first, last, st);
    case 2: return fwht_launch<2, VEC>(x, out, n, c, done, k, divisor, first, last, st);
    case 3: return fwht_launch<3, VEC>(x, out, n, c, done, k, divisor, first, last, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int G>
cudaError_t rows_launch(const float* x, float* out, long long n, int k,
                        float divisor, int last, cudaStream_t stream) {
  const size_t smem = tile_smem(k, 4);
  cudaError_t err = raise_smem(fwht_rows_kernel<G>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = n >> (k + 5);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fwht_rows_kernel<G><<<(unsigned)blocks, kLanes << (k - G), smem,
                        stream>>>(x, out, k, divisor, last);
  return cudaGetLastError();
}

template <int G, int VEC>
cudaError_t srht_launch(const float* src, long long m_src, const float* signs,
                        const long long* bases, int nblocks, long long stride,
                        const int* wptr, const int* wj, const long long* wdst,
                        float* dst, int c, int k, float divisor, int last,
                        cudaStream_t stream) {
  const size_t smem = tile_smem(k, VEC);
  cudaError_t err = raise_smem(srht_pass_kernel<G, VEC>, smem);
  if (err != cudaSuccess) return err;
  const int tc = kLanes * VEC, tiles = (c + tc - 1) / tc;
  const long long blocks = (long long)nblocks * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  srht_pass_kernel<G, VEC><<<(unsigned)blocks, kLanes << (k - G), smem,
                             stream>>>(src, m_src, signs, bases, stride, wptr,
                                       wj, wdst, dst, c, tiles, k, divisor,
                                       last);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t srht_dispatch(int g, const float* src, long long m_src,
                          const float* signs, const long long* bases,
                          int nblocks, long long stride, const int* wptr,
                          const int* wj, const long long* wdst, float* dst,
                          int c, int k, float divisor, int last,
                          cudaStream_t st) {
  switch (g) {
    case 0: return srht_launch<0, VEC>(src, m_src, signs, bases, nblocks, stride, wptr, wj, wdst, dst, c, k, divisor, last, st);
    case 1: return srht_launch<1, VEC>(src, m_src, signs, bases, nblocks, stride, wptr, wj, wdst, dst, c, k, divisor, last, st);
    case 2: return srht_launch<2, VEC>(src, m_src, signs, bases, nblocks, stride, wptr, wj, wdst, dst, c, k, divisor, last, st);
    case 3: return srht_launch<3, VEC>(src, m_src, signs, bases, nblocks, stride, wptr, wj, wdst, dst, c, k, divisor, last, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The whole transform of x (n, c) into out, as the wrapper plans it (out
// may alias x: a pass's blocks read their whole tile before writing):
// bits[0 .. npass) stages per pass (host array), reg_bits[p] register
// stages per round of pass p, vec columns per thread (4 needs c % 4 == 0
// and 16-byte aligned x and out). divisor (sqrt(n), or 1) divides on the
// last pass.
extern "C" int rt_fwht(const float* x, float* out, long long n, int c,
                       const int* bits, const int* reg_bits, int npass,
                       int vec, float divisor, void* stream) {
  if (c <= 0 || npass <= 0 || (vec == 4 && c % 4))
    return (int)cudaErrorInvalidValue;
  long long total = 0;
  for (int p = 0; p < npass; ++p) {
    if (!valid_pass(bits[p], reg_bits[p], vec))
      return (int)cudaErrorInvalidValue;
    total += bits[p];
  }
  if ((1LL << total) != n) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int done = 0;
  for (int p = 0; p < npass; ++p) {
    const int first = p == 0, last = p == npass - 1;
    const float d = last ? divisor : 1.f;
    const cudaError_t err =
        vec == 4 ? fwht_dispatch<4>(reg_bits[p], first ? x : out, out, n, c,
                                    done, bits[p], d, first, last, st)
                 : fwht_dispatch<1>(reg_bits[p], first ? x : out, out, n, c,
                                    done, bits[p], d, first, last, st);
    if (err != cudaSuccess) return (int)err;
    done += bits[p];
  }
  return (int)cudaSuccess;
}

// The row pass of one column x (n, 1) into out (which may alias x): stage
// bits 0 .. row_bits - 1 of each contiguous segment of 2^row_bits floats
// (row_bits >= 5; reg_bits register stages per round down the segment's
// 2^(row_bits - 5) tile rows). x and out 16-byte aligned. Where n ==
// 2^row_bits it is the whole transform and divides by divisor; else
// rt_fwht on the (n / 2^row_bits, 2^row_bits) view of out, handed out as
// x, runs the remaining bits.
extern "C" int rt_fwht_rows(const float* x, float* out, long long n,
                            int row_bits, int reg_bits, float divisor,
                            void* stream) {
  const int k = row_bits - 5;
  if (k < 0 || !valid_pass(k, reg_bits, 4) || n < (1LL << row_bits) ||
      n % (1LL << row_bits) || reinterpret_cast<size_t>(x) % 16 ||
      reinterpret_cast<size_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const int last = n == (1LL << row_bits);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (reg_bits) {
    case 0: return (int)rows_launch<0>(x, out, n, k, divisor, last, st);
    case 1: return (int)rows_launch<1>(x, out, n, k, divisor, last, st);
    case 2: return (int)rows_launch<2>(x, out, n, k, divisor, last, st);
    case 3: return (int)rows_launch<3>(x, out, n, k, divisor, last, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One pass of the SRHT form (see srht_pass_kernel): src rows of c columns
// (row stride c), nblocks blocks, the plan's device arrays, dst of c
// columns. signs is null after the first pass.
extern "C" int rt_srht_t_pass(const float* src, long long m_src,
                              const float* signs, const long long* bases,
                              int nblocks, long long stride, const int* wptr,
                              const int* wj, const long long* wdst,
                              float* dst, int c, int k, int reg_bits, int vec,
                              float divisor, int last, void* stream) {
  if (c <= 0 || nblocks <= 0 || !valid_pass(k, reg_bits, vec) ||
      (vec == 4 && c % 4))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(vec == 4
                   ? srht_dispatch<4>(reg_bits, src, m_src, signs, bases,
                                      nblocks, stride, wptr, wj, wdst, dst, c,
                                      k, divisor, last, st)
                   : srht_dispatch<1>(reg_bits, src, m_src, signs, bases,
                                      nblocks, stride, wptr, wj, wdst, dst, c,
                                      k, divisor, last, st));
}
