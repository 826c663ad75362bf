"""Out-of-sample extension: embed and assign new points against a fit.

A one-pass fit reduces to eigenpairs (U, Sigma) over the training
points, and a new point x embeds as

    y(x) = Sigma^{-1/2} U^T kappa(X_train, x)          in R^r

Query columns stream in stripes of the training `block`, so serving never
holds more than an (n, block) kernel stripe. Two stripe engines:

  fused (the default on the card)  the extend_embed kernel builds each
      kernel tile and contracts it with P = Sigma^{-1/2} U^T on chip: the
      (n, block) stripe never reaches device memory.
  two-pass  a plain gram stripe (kernels_fn.stripe_iterator, pad_tail)
      then the projection, the stripe materialized between them.

Assignment takes the nearest centroid through the kmeans_assign kernel
(fused) or a plain distance + argmin. Path selection follows the
ComputePolicy against the model's device (serve/policy.py).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.kernels_fn import stripe_iterator
from repro_torch.core.kmeans import _sq_dists
from repro_torch.kernels.extend_embed.ops import extend_embed_op
from repro_torch.kernels.kmeans_assign.ops import assign_op
from repro_torch.serve.artifact import FittedModel
from repro_torch.serve.policy import ComputePolicy

# Eigenvalues at or below this are rank-deficient directions: they map to 0
# in the projection rather than exploding.
_EIG_EPS = 1e-7

# kernel_fn() falls back to these when the spec omits a param; the fused
# kernels' static arguments must agree.
_STATIC_DEFAULTS = {"polynomial": {"gamma": 0.0, "degree": 2},
                    "rbf": {"gamma": 1.0}, "linear": {}}


def _kernel_statics(spec) -> Tuple[str, float, int]:
    kp = dict(_STATIC_DEFAULTS.get(spec.kernel, {}))
    kp.update(spec.kernel_params)
    return spec.kernel, float(kp.get("gamma", 0.0)), int(kp.get("degree", 2))


def _projection(model: FittedModel) -> torch.Tensor:
    """P = Sigma^{-1/2} U^T (r, n)."""
    ev = model.eigvals
    inv_sqrt = torch.where(ev > _EIG_EPS,
                           1.0 / torch.sqrt(torch.clamp(ev, min=_EIG_EPS)),
                           torch.zeros_like(ev))
    return (inv_sqrt[:, None] * model.U.T).contiguous()


def _assign_plain(Yq: torch.Tensor, C: torch.Tensor):
    d2min, labels = torch.min(_sq_dists(Yq, C), dim=1)
    return labels.to(torch.int32), d2min


class Extender:
    """Extension engine for one model on its device: the fused kernel
    stripe or the two-pass stripe, and the kernel or plain assignment.

    Holds the projection P and the resolved path choices, so serving
    front-ends construct one Extender and reuse it.
    """

    def __init__(self, model: FittedModel, block: Optional[int] = None, *,
                 policy: Optional[ComputePolicy] = None):
        policy = policy if policy is not None else ComputePolicy()
        self.model = model
        self.policy = policy
        self.device = model.device
        self.block = int(block or model.spec.block)
        self.fused = policy.resolve_embed(self.device)
        self.assign_fused = policy.resolve_assign(self.device)
        self._ref = model.X_train.contiguous()
        self._proj = _projection(model)
        self._statics = _kernel_statics(model.spec)

    def embed(self, Xq, block: Optional[int] = None) -> torch.Tensor:
        """Embed query points Xq (p, b) -> Y_q (r, b), streaming over
        columns in stripes of `block` (callers may narrow per bucket)."""
        model = self.model
        Xq = torch.as_tensor(Xq, dtype=torch.float32, device=self.device)
        if Xq.dim() != 2 or Xq.shape[0] != model.spec.p:
            raise ValueError(f"queries must be (p={model.spec.p}, b), got "
                             f"{tuple(Xq.shape)}")
        block = int(block or self.block)
        b = Xq.shape[1]
        out = torch.empty((model.spec.r, b), dtype=torch.float32,
                          device=self.device)
        if self.fused:
            kind, gamma, degree = self._statics
            b_pad = -(-b // block) * block
            Xqp = torch.nn.functional.pad(Xq, (0, b_pad - b))
            for start in range(0, b, block):
                yb = extend_embed_op(self._ref, self._proj,
                                     Xqp[:, start:start + block], kind=kind,
                                     gamma=gamma, degree=degree)
                width = min(block, b - start)
                out[:, start:start + width] = yb[:, :width]
            return out
        kern = model.kernel_fn()
        for start, stripe in stripe_iterator(kern, Xq, block, lhs=self._ref,
                                             pad_tail=True):
            width = min(block, b - start)
            out[:, start:start + width] = (self._proj @ stripe)[:, :width]
        return out

    def assign(self, Xq, block: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Assign queries to the fitted clusters: (labels (b,) int32,
        squared distance (b,))."""
        Yq = self.embed(Xq, block).T.contiguous()          # (b, r)
        C = self.model.centroids.contiguous()
        if self.assign_fused:
            return assign_op(Yq, C)
        return _assign_plain(Yq, C)


def embed(model: FittedModel, Xq, block: Optional[int] = None, *,
          policy: Optional[ComputePolicy] = None) -> torch.Tensor:
    """One-shot embed Xq (p, b) -> (r, b) through a throwaway Extender."""
    return Extender(model, block, policy=policy).embed(Xq)


def assign(model: FittedModel, Xq, block: Optional[int] = None, *,
           policy: Optional[ComputePolicy] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot assignment: (labels (b,), squared distance (b,))."""
    return Extender(model, block, policy=policy).assign(Xq)
