"""Wrapper of the fused gram->projection CUDA kernel
(csrc/extend_embed.cu)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _common as cm
from repro_torch.kernels.extend_embed.ref import extend_embed_ref


def extend_embed_op(X: torch.Tensor, P: torch.Tensor, Xb: torch.Tensor,
                    kind: str = "polynomial", gamma: float = 0.0,
                    degree: int = 2) -> torch.Tensor:
    """Fused serving stripe P @ kappa(X, Xb) -> (r, w).

    X (p, n) training data, P (r, n) projection Sigma^{-1/2} U^T, Xb (p, w)
    query block, float32. CPU tensors run the plain version; CUDA tensors
    launch the kernel, which never writes the (n, w) stripe to memory and
    computes both products on the tensor cores in 3xTF32 (fp32 accuracy).
    """
    what = "extend_embed"
    if cm.plain_path(what, X, P, Xb):
        return extend_embed_ref(X, P, Xb, kind, gamma, degree)
    r, w = P.shape[0], Xb.shape[1]
    if r == 0 or w == 0 or X.shape[1] == 0:
        check(what, X, P, Xb, kind, degree)
        return torch.zeros((r, w), device=X.device, dtype=torch.float32)
    out = launch(what, X, P, Xb, kind, gamma, degree)
    extend_embed_op.launches += 1
    return out


extend_embed_op.launches = 0


def check(what: str, X: torch.Tensor, P: torch.Tensor, Xb: torch.Tensor,
          kind: str, degree: int):
    """The kernel's argument checks; returns (kind code, ldx, ldp, ldb)."""
    code = cm.kind_code(kind, degree)
    lds = (cm.leading_dim(what, "X", X), cm.leading_dim(what, "P", P),
           cm.leading_dim(what, "Xb", Xb))
    if P.shape[1] != X.shape[1] or Xb.shape[0] != X.shape[0]:
        raise ValueError(f"{what}: shapes X {tuple(X.shape)}, P "
                         f"{tuple(P.shape)}, Xb {tuple(Xb.shape)} disagree")
    return (code,) + lds


def launch(what: str, X: torch.Tensor, P: torch.Tensor, Xb: torch.Tensor,
           kind: str, gamma: float, degree: int,
           assign=(0, 0, 0, 0)) -> torch.Tensor:
    """Launch the kernel and its summing launch on CUDA tensors; returns
    the (r, w) embedding. `assign` = (C, k, labels, d2) pointers and k
    turns the summing launch into its assigning form (embed_assign_op)."""
    code, ldx, ldp, ldb = check(what, X, P, Xb, kind, degree)
    p, n = X.shape
    r, w = P.shape[0], Xb.shape[1]
    # One buffer: the result, then the kernel's partials, one per training
    # range (the second launch sums them in range order).
    per, ranges = cm.extend_split(n) if n else (0, 0)
    buf = torch.empty(((1 + ranges) * r * w,), device=X.device,
                      dtype=torch.float32)
    out = buf[:r * w].view(r, w)
    rc = _build.library().rt_extend_embed(
        X.data_ptr(), ldx, n, P.data_ptr(), ldp, r, Xb.data_ptr(), ldb, w, p,
        code, float(gamma), int(degree), cm.extend_query_tiles(w), per,
        ranges, buf[r * w:].data_ptr(), out.data_ptr(), *assign,
        cm.stream(X))
    _build.check(rc, what)
    return out


def extend_embed_bytes(p: int, n: int, r: int, w: int) -> int:
    """Bytes one serving stripe must move: X (p, n) and P (r, n) read once,
    the query block Xb (p, w) read once, the (r, w) embedding written once
    (the JAX package's memory_contract without the TPU padding)."""
    return 4 * (p * n + r * n + p * w + r * w)
