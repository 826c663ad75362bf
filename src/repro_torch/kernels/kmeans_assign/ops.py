"""Wrappers of the fused K-means assignment CUDA kernel: alone
(csrc/kmeans_assign.cu) and folded into the extend_embed kernel's summing
launch (csrc/extend_embed.cu), both through csrc/assign.cuh."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, _common as cm
from repro_torch.kernels.extend_embed import ops as extend_ops
from repro_torch.kernels.kmeans_assign.ref import assign_ref, embed_assign_ref

# Centroids and their norms live in one block's shared memory.
MAX_SHARED_FLOATS = 227 * 1024 // 4


def _centroids(what: str, C: torch.Tensor, r: int) -> int:
    """Check C (k, r) for a launch; returns k."""
    cm.contiguous(what, "C", C, 2)
    k = C.shape[0]
    if C.shape[1] != r:
        raise ValueError(f"{what}: the points have r={r}, C has "
                         f"{C.shape[1]} columns")
    if k < 1:
        raise ValueError(f"{what}: needs at least one centroid")
    if k * (r + 1) > MAX_SHARED_FLOATS:
        raise ValueError(f"{what}: k * (r + 1) = {k * (r + 1)} floats do "
                         f"not fit one block's shared memory")
    return k


def assign_op(Y: torch.Tensor, C: torch.Tensor):
    """Y (n, r), C (k, r) -> (labels (n,) int32, min_d2 (n,) float32).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    what = "kmeans_assign"
    if cm.plain_path(what, Y, C):
        return assign_ref(Y, C)
    cm.contiguous(what, "Y", Y, 2)
    n, r = Y.shape
    k = _centroids(what, C, r)
    labels = torch.empty((n,), device=Y.device, dtype=torch.int32)
    d2 = torch.empty((n,), device=Y.device, dtype=torch.float32)
    if n == 0:
        return labels, d2
    rc = _build.library().rt_kmeans_assign(
        Y.data_ptr(), n, r, C.data_ptr(), k, labels.data_ptr(),
        d2.data_ptr(), cm.stream(Y))
    _build.check(rc, what)
    assign_op.launches += 1
    return labels, d2


assign_op.launches = 0


def _output(what: str, name: str, t: Optional[torch.Tensor], w: int,
            dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if t is None:
        return torch.empty((w,), device=device, dtype=dtype)
    if t.dtype != dtype or tuple(t.shape) != (w,) or not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be a contiguous ({w},) "
                         f"{dtype} tensor, got {tuple(t.shape)} {t.dtype}")
    return t


def embed_assign_op(X: torch.Tensor, P: torch.Tensor, Xb: torch.Tensor,
                    C: torch.Tensor, kind: str = "polynomial",
                    gamma: float = 0.0, degree: int = 2,
                    labels: Optional[torch.Tensor] = None,
                    d2: Optional[torch.Tensor] = None):
    """Assign the queries Xb (p, w) of one serving stripe: their
    embedding P kappa(X, Xb) (extend_embed_op's arguments) against the
    centroids C (k, r) -> (labels (w,) int32, min_d2 (w,) float32),
    written into `labels` and `d2` when given (a request's preallocated
    outputs at the stripe's offset).

    CPU tensors run the plain version; CUDA tensors launch the
    extend_embed kernel and, in place of its summing launch, the summing
    launch that also assigns: the labels and distances carry the bits of
    assign_op on extend_embed_op's embedding.
    """
    what = "embed_assign"
    w = Xb.shape[1]
    plain = cm.plain_path(what, X, P, Xb, C, labels, d2)
    labels = _output(what, "labels", labels, w, torch.int32, Xb.device)
    d2 = _output(what, "d2", d2, w, torch.float32, Xb.device)
    if plain:
        got = embed_assign_ref(X, P, Xb, C, kind, gamma, degree)
        labels.copy_(got[0])
        d2.copy_(got[1])
        return labels, d2
    k = _centroids(what, C, P.shape[0])
    if w == 0:
        extend_ops.check(what, X, P, Xb, kind, degree)
        return labels, d2
    extend_ops.launch(what, X, P, Xb, kind, gamma, degree,
                      (C.data_ptr(), k, labels.data_ptr(), d2.data_ptr()))
    embed_assign_op.launches += 1
    return labels, d2


embed_assign_op.launches = 0


def assign_bytes(n: int, r: int, k: int) -> int:
    """Bytes one assignment sweep must move: Y (n, r) and C (k, r) read
    once, the (n,) int32 labels and (n,) float32 distances written once
    (the JAX package's memory_contract without the TPU padding)."""
    return 4 * (n * r + k * r + n + n)
