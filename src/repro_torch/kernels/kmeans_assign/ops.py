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
# Points of up to this many values are read once into registers; wider
# ones once more for every centroid (csrc/assign.cuh, kRowRegs).
ROW_REGS = 16


def _point_reads(r: int, k: int) -> int:
    """Reads of each of a point's r values by the nearest-centroid scan."""
    return 1 if r <= ROW_REGS else k + 1


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


def assign_op(Y: torch.Tensor, C: torch.Tensor):  # hot-path
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
                    d2: Optional[torch.Tensor] = None):  # hot-path
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


def assign_launch_plan(Y, C) -> cm.LaunchPlan:
    """The launch assign_op makes for these arguments: a block of 128 rows,
    one a thread, with the centroids and their norms in shared memory."""
    n, r = Y.shape
    k = C.shape[0]
    shapes = {"n": n, "r": r, "k": k}
    if n == 0:
        return cm.LaunchPlan(shapes, ())
    return cm.LaunchPlan(shapes, (cm.Launch(
        "assign_kernel", (-(-n // cm.ASSIGN_THREADS),), cm.ASSIGN_THREADS,
        cm.assign_smem(k, r)),))


def embed_assign_launch_plan(X, P, Xb, C, kind: str = "polynomial",
                             gamma: float = 0.0, degree: int = 2,
                             labels=None, d2=None) -> cm.LaunchPlan:
    """The launches embed_assign_op makes for these arguments: the
    extend_embed kernel, then the summing launch that assigns."""
    return extend_ops.extend_plan(X.shape[1], Xb.shape[1], X.shape[0],
                                  P.shape[0], C.shape[0], kind == "rbf")


def assign_contract(plan: cm.LaunchPlan) -> dict:
    """The declared memory contract of one assignment launch: every block
    reads C (k, r), each row is read once (r <= 16, else once more per
    centroid), labels and distances written once; shared memory holds C
    and its norms."""
    s = plan.shapes
    n, r, k = s["n"], s["r"], s["k"]
    blocks = -(-n // cm.ASSIGN_THREADS)
    return {"dram_bytes": 4 * (blocks * k * r + n * r * _point_reads(r, k)
                               + 2 * n),
            "smem_bytes": cm.assign_smem(k, r) if n else 0}


def embed_assign_contract(plan: cm.LaunchPlan) -> dict:
    """extend_embed's contract with its summing launch in the assigning
    form: the partials read and the embedding written as there, then C
    read by every block, the embedding read back (once, r <= 16), labels
    and distances written."""
    s = plan.shapes
    r, w, k = s["r"], s["w"], s["k"]
    ranges = plan.detail[1]
    out = extend_ops.extend_contract(plan)
    summing = ((ranges + 1) * r * w + -(-w // cm.ASSIGN_THREADS) * k * r
               + r * w * _point_reads(r, k) + 2 * w)
    return {"dram_bytes": out["dram_bytes"] + 4 * summing,
            "smem_bytes": max(out["smem_bytes"], cm.assign_smem(k, r))}


def embed_assign_bytes(p: int, n: int, r: int, w: int, k: int) -> int:
    """Bytes one assigned stripe must move: X, P, the queries Xb and C read
    once, the (w,) int32 labels and float32 distances written once (the
    embedding it writes as scratch is not counted)."""
    return 4 * (p * n + r * n + p * w + k * r) + 8 * w


def assign_bytes(n: int, r: int, k: int) -> int:
    """Bytes one assignment sweep must move: Y (n, r) and C (k, r) read
    once, the (n,) int32 labels and (n,) float32 distances written once
    (the JAX package's memory_contract without the TPU padding)."""
    return 4 * (n * r + k * r + n + n)
