"""Wrapper of the fused fit-sketch CUDA kernel (csrc/fit_sketch.cu)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, _common as cm
from repro_torch.kernels.fit_sketch.ref import fit_sketch_ref


def fit_sketch_op(X: torch.Tensor, Omega: torch.Tensor, C: torch.Tensor,
                  Ocross: torch.Tensor, V: Optional[torch.Tensor] = None,
                  kind: str = "polynomial", gamma: float = 0.0,
                  degree: int = 2):
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


def fit_sketch_bytes(p: int, m: int, b: int, rp: int) -> int:
    """Bytes a launch must move: X, Omega, C and Ocross read once; new_rows,
    delta and the two norm vectors written once (no V)."""
    return 4 * (p * m + m * rp + p * b + b * rp + b * rp + m * rp + m + b)
