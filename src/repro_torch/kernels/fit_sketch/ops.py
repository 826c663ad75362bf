"""Wrapper of the fused fit-sketch CUDA kernel (csrc/fit_sketch.cu)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, _common as cm
from repro_torch.kernels.fit_sketch.ref import fit_sketch_ref


def fit_sketch_op(X: torch.Tensor, Omega: torch.Tensor, C: torch.Tensor,
                  Ocross: torch.Tensor, V: Optional[torch.Tensor] = None,
                  kind: str = "polynomial", gamma: float = 0.0,
                  degree: int = 2):  # hot-path
    """Fused fit-block contractions of K = kappa(X, C), float32.

    X (p, m) samples as columns, Omega (m, r') sketch rows (callers zero
    the rows of invalid X columns), C (p, b) block columns, Ocross (b, r')
    the block's own sketch rows, V (m,) optional row weights for rn_cols
    (None = all rows valid). Returns
      (new_rows (b, r'), delta (m, r'), rn_rows (m,), rn_cols (b,))
    matching fit_sketch_ref. CPU tensors run the plain version; CUDA
    tensors launch the kernel, which never writes K to memory and computes
    its products on the tensor cores in 3xTF32 (fp32 accuracy).
    """
    what = "fit_sketch"
    if cm.plain_path(what, X, Omega, C, Ocross, V):
        return fit_sketch_ref(X, Omega, C, Ocross, V, kind, gamma, degree)
    code = cm.kind_code(kind, degree)
    ldx = cm.leading_dim(what, "X", X)
    ldc = cm.leading_dim(what, "C", C)
    cm.contiguous(what, "Omega", Omega, 2)
    cm.contiguous(what, "Ocross", Ocross, 2)
    p, m = X.shape
    b = C.shape[1]
    rp = Omega.shape[1]
    if (C.shape[0] != p or Omega.shape[0] != m
            or tuple(Ocross.shape) != (b, rp)):
        raise ValueError(f"{what}: shapes X {tuple(X.shape)}, Omega "
                         f"{tuple(Omega.shape)}, C {tuple(C.shape)}, Ocross "
                         f"{tuple(Ocross.shape)} disagree")
    if V is not None:
        cm.contiguous(what, "V", V, 1)
        if V.shape[0] != m:
            raise ValueError(f"{what}: V has {V.shape[0]} rows, X has {m}")
    # One buffer: new_rows | rn_cols, delta | rn_rows, then the kernel's
    # partials of new_rows | rn_cols, one per row range (delta and rn_rows
    # leave the kernel final; a second launch sums the partials).
    acc_len, delta_len = b * rp + b, m * rp + m
    per, ranges = cm.fit_split(m) if m else (0, 0)
    buf = torch.empty((acc_len * (1 + ranges) + delta_len,), device=X.device,
                      dtype=torch.float32)
    out_acc, out_delta = buf[:acc_len], buf[acc_len:acc_len + delta_len]
    if m == 0 or b == 0 or rp == 0:
        buf.zero_()
    else:
        rc = _build.library().rt_fit_sketch(
            X.data_ptr(), ldx, m, Omega.data_ptr(), rp, C.data_ptr(), ldc, b,
            Ocross.data_ptr(), None if V is None else V.data_ptr(), p, code,
            float(gamma), int(degree), per, ranges,
            buf[acc_len + delta_len:].data_ptr(), out_acc.data_ptr(),
            out_delta.data_ptr(), cm.stream(X))
        _build.check(rc, what)
        fit_sketch_op.launches += 1
    return (out_acc[:b * rp].view(b, rp), out_delta[:m * rp].view(m, rp),
            out_delta[m * rp:], out_acc[b * rp:])


fit_sketch_op.launches = 0


# Dynamic shared memory of one kernel block, the Smem struct of
# csrc/fit_sketch.cu: C (64 x 3 slots of 32 float4) and Ocross (64 x 32
# float4) as fragments, X^T (4 x 3 x 2 x 32 float4) and Omega (4 x 2 x 32
# float4) of a row tile, each warp's 16 x 72 slice to transpose and its
# 9 x 68 delta partials, the norms of C's 512 and X's 64 columns, V.
FIT_SMEM = (16 * (64 * 3 * 32 + 64 * 32 + 4 * 3 * 2 * 32 + 4 * 2 * 32)
            + 4 * (8 * 16 * 72 + 8 * 9 * 68 + 512 + 64 + 64))


def fit_plan(m: int, b: int, rp: int, p: int, rbf: bool = False,
             has_v: bool = False) -> cm.LaunchPlan:
    """The launches of one fit block, from the split fit_sketch_op uses
    (detail: rows per range and ranges): the kernel over the row ranges, then the
    summing launch of new_rows and rn_cols; none when m, b or r' is 0."""
    per, ranges = cm.fit_split(m) if m else (0, 0)
    shapes = {"p": p, "m": m, "b": b, "rp": rp, "rbf": rbf, "v": has_v}
    launches = ()
    if m and b and rp:
        launches = (cm.Launch("fit_sketch_kernel", (ranges,), 256, FIT_SMEM,
                              (per,)),) + cm.sum_splits_launch(ranges,
                                                               b * rp + b)
    return cm.LaunchPlan(shapes, launches, (per, ranges))


def fit_launch_plan(X, Omega, C, Ocross, V=None, kind: str = "polynomial",
                    gamma: float = 0.0, degree: int = 2) -> cm.LaunchPlan:
    """The launches fit_sketch_op makes for these arguments."""
    return fit_plan(X.shape[1], C.shape[1], Omega.shape[1], X.shape[0],
                    kind == "rbf", V is not None)


def fit_contract(plan: cm.LaunchPlan) -> dict:
    """The declared memory contract of one fit block, in its plan's
    parameters. Each range's block walks passes of 8 columns of r' and
    chunks of 512 block columns: per pass and chunk it reads C's chunk
    (its first 24 rows of p; past 24, all of p again per 16 rows), Ocross
    and the rbf norms of C; X, Omega, V and the rbf norms of X over its
    rows; it writes delta and rn_rows (read back and rewritten past the
    first chunk) and its partials of new_rows and rn_cols, which the
    summing launch reads and sums once."""
    s = plan.shapes
    p, m, b, rp = s["p"], s["m"], s["b"], s["rp"]
    per, ranges = plan.detail
    if not plan.launches:
        return {"dram_bytes": 0, "smem_bytes": 0}
    passes, chunks = -(-rp // 8), -(-b // 512)
    rbf = 2 if s["rbf"] else 1
    c = passes * b * ranges * min(24, p)
    if p > 24:
        c += passes * b * p * sum(-(-(min(m, per * (i + 1)) - per * i) // 16)
                                  for i in range(ranges))
    c += ranges * b * rp + (ranges * passes * p * b if s["rbf"] else 0)
    x = passes * chunks * m * (p * rbf + (1 if s["v"] else 0)) + chunks * m * rp
    out = (2 * chunks - 1) * m * (rp + 1) + (2 * ranges + 1) * (b * rp + b)
    return {"dram_bytes": 4 * (c + x + out), "smem_bytes": FIT_SMEM}


def fit_sketch_bytes(p: int, m: int, b: int, rp: int) -> int:
    """Bytes a launch must move: X, Omega, C and Ocross read once; new_rows,
    delta and the two norm vectors written once (no V)."""
    return 4 * (p * m + m * rp + p * b + b * rp + b * rp + m * rp + m + b)
