"""Wrapper of the gram-stripe CUDA kernel (csrc/gram.cu)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _common as cm
from repro_torch.kernels.gram.ref import gram_stripe_ref


def gram_stripe_op(X: torch.Tensor, Xb: torch.Tensor,
                   kind: str = "polynomial", gamma: float = 0.0,
                   degree: int = 2) -> torch.Tensor:
    """kappa(X, Xb) -> (n, w) for X (p, n), Xb (p, w), float32.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    what = "gram_stripe"
    if cm.plain_path(what, X, Xb):
        return gram_stripe_ref(X, Xb, kind, gamma, degree)
    code = cm.kind_code(kind, degree)
    ldx = cm.leading_dim(what, "X", X)
    ldb = cm.leading_dim(what, "Xb", Xb)
    p, n = X.shape
    if Xb.shape[0] != p:
        raise ValueError(f"{what}: X has p={p}, Xb has {Xb.shape[0]} rows")
    w = Xb.shape[1]
    out = torch.empty((n, w), device=X.device, dtype=torch.float32)
    if n == 0 or w == 0:
        return out
    rc = _build.library().rt_gram_stripe(
        X.data_ptr(), ldx, n, Xb.data_ptr(), ldb, w, p, code, float(gamma),
        int(degree), out.data_ptr(), cm.stream(X))
    _build.check(rc, what)
    gram_stripe_op.launches += 1
    return out


gram_stripe_op.launches = 0
