"""Emulations of the tensor cores' TF32 arithmetic and of the mma.sync
m16n8k8 fragment layouts (csrc/mma_tf32.cuh), shared by the tests of the
kernels that use them (fit_sketch, extend_embed).

- tf32 / trunc / mm3: a product as 3xTF32 (big = x rounded to TF32 to
  nearest, small = x - big read to its top 19 bits as the tensor cores
  read it, small*big + big*small + big*big with exact products and fp32
  sums); mm1 as one TF32 product.
- a_at / b_at / c_at / mma / frag_c / gather_c: which (row, col) each
  lane's registers hold, and an mma.sync run lane by lane in numpy.
"""
import numpy as np
import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32, to nearest with ties away from zero (cvt.rna)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    return ((bits + 0x1000) & 0xFFFFE000).to(torch.int32).view(torch.float32)


def trunc(x: torch.Tensor) -> torch.Tensor:
    """x read as the tensor cores read a TF32 operand: its top 19 bits."""
    bits = x.contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as 3xTF32: TF32 products are exact in fp32, sums are fp32."""
    ab, bb = tf32(a), tf32(b)
    a_s, b_s = trunc(a - ab), trunc(b - bb)
    return a_s @ bb + ab @ b_s + ab @ bb


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one TF32 product (what the kernel does not do)."""
    return tf32(a) @ tf32(b)


# -- fragment maps --------------------------------------------------------

def a_at(lane):
    """(row, k) of a0..a3 of an m16n8k8 A fragment."""
    g, t = divmod(lane, 4)
    return ((g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4))


def b_at(lane):
    """(k, col) of b0, b1 of a B fragment."""
    g, t = divmod(lane, 4)
    return ((t, g), (t + 4, g))


def c_at(lane):
    """(row, col) of c0..c3 of a C fragment."""
    g, t = divmod(lane, 4)
    return ((g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1))


def mma(a, b, c):
    """mma.sync m16n8k8 on per-lane registers: a (32, 4), b (32, 2),
    c (32, 4) -> d (32, 4) with D = A B + C."""
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        for r, (i, k) in enumerate(a_at(lane)):
            A[i, k] = a[lane, r]
        for r, (k, j) in enumerate(b_at(lane)):
            B[k, j] = b[lane, r]
    D = A @ B
    return np.array([[D[i, j] for i, j in c_at(lane)]
                     for lane in range(32)]) + c


def frag_c(M):
    """The C-fragment registers of a 16 x 8 matrix."""
    return np.array([[M[i, j] for i, j in c_at(lane)] for lane in range(32)])


def gather_c(regs):
    M = np.zeros((16, 8))
    for lane in range(32):
        for r, (i, j) in enumerate(c_at(lane)):
            M[i, j] = regs[lane, r]
    return M
