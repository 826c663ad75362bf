"""Wrapper of the gram-stripe CUDA kernel (csrc/gram.cu)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _common as cm
from repro_torch.kernels.gram.ref import gram_stripe_ref


def gram_stripe_op(X: torch.Tensor, Xb: torch.Tensor,
                   kind: str = "polynomial", gamma: float = 0.0,
                   degree: int = 2) -> torch.Tensor:  # hot-path
    """kappa(X, Xb) -> (n, w) for X (p, n), Xb (p, w), float32.

    CPU tensors run the plain version; CUDA tensors launch the kernel as
    kernels/_common.py gram_plan plans it.
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
    plan = cm.gram_plan(n, w, p)
    rc = _build.library().rt_gram_stripe(
        X.data_ptr(), ldx, n, Xb.data_ptr(), ldb, w, p, code, float(gamma),
        int(degree), plan.col_warps, plan.krows, plan.grid[0], plan.smem,
        out.data_ptr(), cm.stream(X))
    _build.check(rc, what)
    gram_stripe_op.launches += 1
    return out


gram_stripe_op.launches = 0


def gram_launch_plan(X, Xb, kind: str = "polynomial", gamma: float = 0.0,
                     degree: int = 2) -> cm.LaunchPlan:
    """The launch gram_stripe_op makes for these arguments, from their
    shapes: gram_plan's grid, 16 warps a block, its shared memory."""
    p, n = X.shape
    w = Xb.shape[1]
    shapes = {"p": p, "n": n, "w": w, "rbf": kind == "rbf"}
    if n == 0 or w == 0:
        return cm.LaunchPlan(shapes, ())
    plan = cm.gram_plan(n, w, p)
    return cm.LaunchPlan(shapes, (cm.Launch(
        "gram_kernel", plan.grid, 32 * cm.GRAM_WARPS, plan.smem,
        (plan.col_warps, plan.krows)),), plan)


def gram_contract(plan: cm.LaunchPlan) -> dict:
    """The declared memory contract of one gram launch, in its plan's
    parameters. DRAM bytes: X once per column chunk (each chunk's blocks
    walk every row step), Xb's chunk once per block where it stays
    resident (else once per row step), once more per block for the rbf
    column norms, K written once. Shared memory: gram_smem_bytes."""
    s, g = plan.shapes, plan.detail
    if g is None:
        return {"dram_bytes": 0, "smem_bytes": 0}
    p, n, w = s["p"], s["n"], s["w"]
    xb_walks = g.grid[0] if g.resident else g.tiles
    norms = g.grid[0] if s["rbf"] else 0
    return {"dram_bytes": 4 * (p * n * g.chunks + p * w * (xb_walks + norms)
                               + n * w),
            "smem_bytes": cm.gram_smem_bytes(g.col_warps, g.krows)}


def gram_stripe_bytes(p: int, n: int, w: int) -> int:
    """Bytes the stripe must move: X and Xb read once, K written once."""
    return 4 * (p * n + p * w + n * w)
