"""Wrapper of the fused gram->projection CUDA kernel
(csrc/extend_embed.cu)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _common as cm
from repro_torch.kernels.extend_embed.ref import extend_embed_ref


def extend_embed_op(X: torch.Tensor, P: torch.Tensor, Xb: torch.Tensor,
                    kind: str = "polynomial", gamma: float = 0.0,
                    degree: int = 2) -> torch.Tensor:  # hot-path
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


# Dynamic shared memory of one kernel block: two Buf (csrc/extend_embed.cu),
# each a unit's X and P^T as B fragments (16 x 3 and 16 slots of 32
# float4) and the squared norms of its 128 training points.
EXTEND_SMEM = 2 * (16 * 3 * 32 * 16 + 16 * 32 * 16 + 128 * 4)


def extend_plan(n: int, w: int, p: int, r: int, k: int = 0,
                rbf: bool = False) -> cm.LaunchPlan:
    """The launches of one stripe, from the helpers launch() uses (detail:
    training points per range, ranges, query tiles per warp): the kernel over
    (ranges, query groups) unless n = 0, then the summing launch, or with
    k centroids the summing launch that assigns."""
    per, ranges = cm.extend_split(n) if n else (0, 0)
    tiles = cm.extend_query_tiles(w)
    shapes = {"p": p, "n": n, "r": r, "w": w, "k": k, "rbf": rbf}
    launches = ()
    if ranges:
        group = 16 * cm.EXTEND_WARPS * tiles
        launches = (cm.Launch("extend_embed_kernel", (ranges, -(-w // group)),
                              32 * cm.EXTEND_WARPS, EXTEND_SMEM,
                              (tiles, per)),)
    if k:
        launches += (cm.Launch(
            "sum_assign_kernel", (-(-w // cm.ASSIGN_THREADS),),
            2 * cm.ASSIGN_THREADS, cm.assign_smem(k, r), (ranges, k)),)
    else:
        launches += cm.sum_splits_launch(ranges, r * w)
    return cm.LaunchPlan(shapes, launches, (per, ranges, tiles))


def extend_launch_plan(X, P, Xb, kind: str = "polynomial",
                       gamma: float = 0.0, degree: int = 2) -> cm.LaunchPlan:
    """The launches extend_embed_op makes for these arguments."""
    return extend_plan(X.shape[1], Xb.shape[1], X.shape[0], P.shape[0], 0,
                       kind == "rbf")


def extend_contract(plan: cm.LaunchPlan) -> dict:
    """The declared memory contract of one stripe, in its plan's
    parameters (the summing launch's when the plan sums; the assigning
    form adds its own, embed_assign_contract). The kernel reads X once per
    pass of 8 rows of r, twice with the rbf norms, and P once, in every
    query group; each block reads its queries once (p <= 24: held in
    registers; else once per 16 training points of every pass) and once
    more for the rbf norms, and writes its range's partial of r rows; the
    summing launch reads the partials and writes the embedding."""
    s = plan.shapes
    p, n, r, w = s["p"], s["n"], s["r"], s["w"]
    per, ranges, tiles = plan.detail
    groups = -(-w // (16 * cm.EXTEND_WARPS * tiles))
    passes = -(-r // 8)
    lengths = [min(n, per * (i + 1)) - per * i for i in range(ranges)]
    x = passes * p * n * groups * (2 if s["rbf"] else 1) + r * n * groups
    if p <= 24:
        q = ranges * p * w
    else:
        q = passes * p * w * sum(-(-length // 16) for length in lengths)
    q += ranges * p * w if s["rbf"] else 0
    summing = 0 if s["k"] else (ranges + 1) * r * w
    return {"dram_bytes": 4 * (x + q + ranges * r * w + summing),
            "smem_bytes": EXTEND_SMEM if ranges else 0}


def extend_embed_bytes(p: int, n: int, r: int, w: int) -> int:
    """Bytes one serving stripe must move: X (p, n) and P (r, n) read once,
    the query block Xb (p, w) read once, the (r, w) embedding written once
    (the JAX package's memory_contract without the TPU padding)."""
    return 4 * (p * n + r * n + p * w + r * w)
