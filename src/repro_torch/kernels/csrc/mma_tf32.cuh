// Error-compensated TF32 products on the tensor cores (3xTF32).
//
// mma.sync m16n8k8 with TF32 operands and fp32 accumulation. Each fp32
// operand x is split as big = tf32(x) (round to nearest, ties away from
// zero, as cvt.rna) and small = x - big, exact in fp32; the tensor cores read
// the top 19 bits of small, so big + small carries 22 of x's 24 mantissa
// bits. A product is accumulated as small_a big_b + big_a small_b +
// big_a big_b: the dropped small_a small_b term is below 2^-22 of a b, so
// the result keeps fp32 accuracy, where one TF32 product (10-bit mantissa)
// would not (common.cuh says why that matters for the rbf tile).
//
// Fragment layouts of mma.sync.aligned.m16n8k8.row.col (PTX ISA), for lane
// = 4 g + t (g = lane / 4 the group, t = lane % 4 the thread in the group):
//   A (16 x 8, rows x k)   a0 (g, t)    a1 (g + 8, t)   a2 (g, t + 4)
//                          a3 (g + 8, t + 4)
//   B (8 x 8, k x cols)    b0 (t, g)    b1 (t + 4, g)
//   C (16 x 8)             c0 (g, 2t)   c1 (g, 2t + 1)  c2 (g + 8, 2t)
//                          c3 (g + 8, 2t + 1)
// A C fragment feeds a later product as its A operand, without leaving the
// registers, when that product contracts over the C fragment's columns:
// number the contraction index so that k = t is column 2t and k = t + 4 is
// column 2t + 1, i.e. a = (c0, c2, c1, c3) (c_as_a below), and load the B
// operand's rows in the same order: b0 from row 2t, b1 from row 2t + 1.
#pragma once

#include <cstdint>

namespace tc {

// x rounded to TF32 as a float (the low 13 mantissa bits zero): round to
// nearest, ties away from zero, as cvt.rna.tf32.f32 does; sm_90 lowers
// that instruction to this add and mask plus a NaN / Inf guard that finite
// inputs do not need.
static __device__ __forceinline__ float tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

static __device__ __forceinline__ void split(float x, float& big,
                                             float& small) {
  big = tf32(x);
  small = x - big;
}

// d += a b, one TF32 product; a and b hold TF32 values as floats.
static __device__ __forceinline__ void mma(float d[4], const float a[4],
                                           float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// d += a b in 3xTF32: a as (big, small) A fragments, b as a float4 of
// (b0 big, b1 big, b0 small, b1 small).
static __device__ __forceinline__ void mma3(float d[4], const float ab[4],
                                            const float as[4], float4 b) {
  mma(d, as, b.x, b.y);
  mma(d, ab, b.z, b.w);
  mma(d, ab, b.x, b.y);
}

// Splits the four values of an A fragment.
static __device__ __forceinline__ void split_a(const float a[4], float ab[4],
                                               float as[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], ab[i], as[i]);
}

// A C fragment as the A operand of a product over its columns (k permuted
// as the header says), split.
static __device__ __forceinline__ void c_as_a(const float c[4], float ab[4],
                                              float as[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
  split_a(a, ab, as);
}

// A B fragment (b0, b1) as one float4 (b0 big, b1 big, b0 small, b1 small),
// the form mma3 takes.
static __device__ __forceinline__ float4 b_frag(float b0, float b1) {
  float4 f;
  split(b0, f.x, f.z);
  split(b1, f.y, f.w);
  return f;
}

}  // namespace tc
