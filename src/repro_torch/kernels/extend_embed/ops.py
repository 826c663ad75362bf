"""Wrapper of the fused gram->projection CUDA kernel
(csrc/extend_embed.cu)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _common as cm
from repro_torch.kernels.extend_embed.ref import extend_embed_ref

# The (r, 64) accumulator and P slice of a block live in shared memory.
MAX_R = 200


def extend_embed_op(X: torch.Tensor, P: torch.Tensor, Xb: torch.Tensor,
                    kind: str = "polynomial", gamma: float = 0.0,
                    degree: int = 2) -> torch.Tensor:
    """Fused serving stripe P @ kappa(X, Xb) -> (r, w).

    X (p, n) training data, P (r, n) projection Sigma^{-1/2} U^T, Xb (p, w)
    query block, float32. CPU tensors run the plain version; CUDA tensors
    launch the kernel, which never writes the (n, w) stripe to memory.
    """
    what = "extend_embed"
    if cm.plain_path(what, X, P, Xb):
        return extend_embed_ref(X, P, Xb, kind, gamma, degree)
    code = cm.kind_code(kind, degree)
    ldx = cm.leading_dim(what, "X", X)
    ldp = cm.leading_dim(what, "P", P)
    ldb = cm.leading_dim(what, "Xb", Xb)
    p, n = X.shape
    r, w = P.shape[0], Xb.shape[1]
    if P.shape[1] != n or Xb.shape[0] != p:
        raise ValueError(f"{what}: shapes X {tuple(X.shape)}, P "
                         f"{tuple(P.shape)}, Xb {tuple(Xb.shape)} disagree")
    if r > MAX_R:
        raise ValueError(f"{what}: r={r} exceeds the kernel's {MAX_R}")
    out = torch.empty((r, w), device=X.device, dtype=torch.float32)
    if r == 0 or w == 0:
        return out
    if n == 0:
        return out.zero_()
    per, splits = cm.split_rows(n)
    part = torch.empty((splits, r, w), device=X.device, dtype=torch.float32)
    rc = _build.library().rt_extend_embed(
        X.data_ptr(), ldx, n, P.data_ptr(), ldp, r, Xb.data_ptr(), ldb, w, p,
        code, float(gamma), int(degree), per, splits, part.data_ptr(),
        out.data_ptr(), cm.stream(X))
    _build.check(rc, what)
    extend_embed_op.launches += 1
    return out


extend_embed_op.launches = 0
