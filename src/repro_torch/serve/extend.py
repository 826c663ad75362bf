"""Out-of-sample extension: embed and assign new points against a fit.

A fit reduces to eigenpairs (U, Sigma) over its reference points, and a
new point x embeds as

    y(x) = Sigma^{-1/2} U^T kappa(ref, x)              in R^r

where ref (`FittedModel.extension_ref`, (p, n_ref)) is the training set
for the one-pass and exact backends and the m landmarks for Nystrom.
Query columns stream in stripes of the training `block`, so serving never
holds more than an (n_ref, block) kernel stripe. Two stripe engines:

  fused (the default on the card)  the extend_embed kernel builds each
      kernel tile and contracts it with P = Sigma^{-1/2} U^T on chip: the
      (n_ref, block) stripe never reaches device memory.
  two-pass  a plain gram stripe (kernels_fn.stripe_iterator, pad_tail)
      then the projection, the stripe materialized between them.

Assignment takes the nearest centroid through the kmeans_assign kernel
(fused) or a plain distance + argmin. With the fused stripe it runs in the
stripe's own launches (embed_assign_op: each stripe writes its labels and
distances at its offset of the request's outputs, no embedding to
transpose); after a two-pass stripe, through assign_op. Path selection
follows the ComputePolicy against the model's device (serve/policy.py).

Sharded (`ShardedExtender`, policy.mesh): the extension P kappa(ref, x)
shards like the fit. Each rank holds a column slab of the reference set
and of P (zero-padded to a multiple of the ranks; padded P columns are
zero, so whatever kernel values the padded reference columns give are
annihilated, exactly, even where kappa(0, x) != 0), embeds every stripe
against its slab (extend_embed on the card) and one all_reduce of the
(r, block) partials sums them: r * block floats per stripe, whatever n.
The assignment runs after the sum, through the standalone kmeans_assign
kernel: the fold into extend_embed's launch cannot reach across ranks.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.kernels_fn import stripe_iterator
from repro_torch.core.kmeans import _sq_dists
from repro_torch.kernels.extend_embed.ops import extend_embed_op
from repro_torch.kernels.kmeans_assign.ops import assign_op, embed_assign_op
from repro_torch.launch.mesh import mesh_axis
from repro_torch.serve.artifact import FittedModel
from repro_torch.serve.policy import ComputePolicy, resolve_kernel_path

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
    """P = Sigma^{-1/2} U^T (r, n_ref)."""
    ev = model.eigvals
    inv_sqrt = torch.where(ev > _EIG_EPS,
                           1.0 / torch.sqrt(torch.clamp(ev, min=_EIG_EPS)),
                           torch.zeros_like(ev))
    return (inv_sqrt[:, None] * model.U.T).contiguous()


def _queries(model: FittedModel, Xq) -> torch.Tensor:
    """Xq as a (p, b) float32 tensor on the model's device whose column
    stripes the kernels take without a copy."""
    p = model.spec.p
    Xq = torch.as_tensor(Xq, dtype=torch.float32, device=model.device)
    if Xq.dim() != 2 or Xq.shape[0] != p:
        raise ValueError(f"queries must be (p={p}, b), got "
                         f"{tuple(Xq.shape)}")
    if Xq.shape[1] > 1 and Xq.stride(1) != 1:
        Xq = Xq.contiguous()
    return Xq


def _assign_plain(Yq: torch.Tensor, C: torch.Tensor):  # hot-path
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
        # The reference set the stripes run against: the training points,
        # or the Nystrom landmarks.
        self._ref = model.extension_ref.contiguous()
        self._proj = _projection(model)
        self._statics = _kernel_statics(model.spec)

    def _queries(self, Xq) -> torch.Tensor:
        return _queries(self.model, Xq)

    def embed(self, Xq,
              block: Optional[int] = None) -> torch.Tensor:  # hot-path
        """Embed query points Xq (p, b) -> Y_q (r, b), streaming over
        columns in stripes of `block` (callers may narrow per bucket)."""
        model = self.model
        Xq = self._queries(Xq)
        block = int(block or self.block)
        b = Xq.shape[1]
        out = torch.empty((model.spec.r, b), dtype=torch.float32,
                          device=self.device)
        if self.fused:
            # The kernel takes each stripe at its real width: a ragged last
            # stripe needs no padding, and a query's bits do not depend on
            # the width (kernels/_common.py extend_split).
            kind, gamma, degree = self._statics
            for start in range(0, b, block):
                out[:, start:start + block] = extend_embed_op(
                    self._ref, self._proj, Xq[:, start:start + block],
                    kind=kind, gamma=gamma, degree=degree)
            return out
        kern = model.kernel_fn()
        for start, stripe in stripe_iterator(kern, Xq, block, lhs=self._ref,
                                             pad_tail=True):
            width = min(block, b - start)
            out[:, start:start + width] = (self._proj @ stripe)[:, :width]
        return out

    def assign(self, Xq, block: Optional[int] = None,
               fused: Optional[bool] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Assign queries to the fitted clusters: (labels (b,) int32,
        squared distance (b,)).

        `fused` overrides the constructor's assignment path for this call,
        re-resolved on the extender's device by the policy's rules; the
        policy's `interpret` is replayed only when the kernel path is
        asked for, so fused=False always takes the plain argmin."""
        if fused is None:
            use_kernel = self.assign_fused
        else:
            use_kernel = resolve_kernel_path(
                fused, self.policy.interpret if fused else None,
                "kmeans_assign kernel", self.device)
        C = self.model.centroids.contiguous()
        if use_kernel and self.fused:
            return self._assign_stripes(Xq, C, block)
        Yq = self.embed(Xq, block).T.contiguous()          # (b, r)
        if use_kernel:
            return assign_op(Yq, C)
        return _assign_plain(Yq, C)

    def _assign_stripes(self, Xq, C: torch.Tensor, block: Optional[int]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:  # hot-path
        """Fused stripe and kernel assignment: one embed_assign_op per
        stripe, writing into the request's (b,) outputs."""
        Xq = self._queries(Xq)
        block = int(block or self.block)
        b = Xq.shape[1]
        labels = torch.empty((b,), dtype=torch.int32, device=self.device)
        d2 = torch.empty((b,), dtype=torch.float32, device=self.device)
        kind, gamma, degree = self._statics
        for start in range(0, b, block):
            embed_assign_op(self._ref, self._proj, Xq[:, start:start + block],
                            C, kind=kind, gamma=gamma, degree=degree,
                            labels=labels[start:start + block],
                            d2=d2[start:start + block])
        return labels, d2


def embed(model: FittedModel, Xq, block: Optional[int] = None, *,
          policy: Optional[ComputePolicy] = None) -> torch.Tensor:
    """One-shot embed Xq (p, b) -> (r, b) through a throwaway Extender."""
    return Extender(model, block, policy=policy).embed(Xq)


def assign(model: FittedModel, Xq, block: Optional[int] = None, *,
           policy: Optional[ComputePolicy] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot assignment: (labels (b,), squared distance (b,))."""
    return Extender(model, block, policy=policy).assign(Xq)


class ShardedExtender:
    """The extension sharded over a mesh axis, one all_reduce per stripe.

    Takes the mesh from `mesh` / `axis` or from policy.mesh /
    policy.mesh_axis. embed() and assign() have Extender's arguments and
    are collective: every rank calls them with the same queries. At world
    size 1 the slab is the whole reference set and embed() has the bits of
    Extender.embed() on the same policy.
    """

    def __init__(self, model: FittedModel, mesh=None, axis: str = "data",
                 block: Optional[int] = None, *,
                 policy: Optional[ComputePolicy] = None):
        policy = policy if policy is not None else ComputePolicy()
        if mesh is None:
            mesh, axis = policy.mesh, policy.mesh_axis
        if mesh is None:
            raise ValueError("ShardedExtender needs a mesh — pass mesh= "
                             "or a policy with policy.mesh set")
        self.ax = ax = mesh_axis(mesh, axis)
        self.model = model
        self.policy = policy
        self.device = model.device
        self.block = int(block or model.spec.block)
        self.fused = policy.resolve_embed(self.device,
                                          "fused extend_embed stripe "
                                          "(sharded)")
        self.assign_fused = policy.resolve_assign(self.device)
        self._statics = _kernel_statics(model.spec)
        # This rank's column slab of the reference set and of P.
        n = model.n_ref
        width = -(-n // ax.size)
        lo, hi = min(ax.index * width, n), min((ax.index + 1) * width, n)
        pad = (0, width - (hi - lo))
        self._ref = torch.nn.functional.pad(
            model.extension_ref[:, lo:hi], pad).contiguous()
        self._proj = torch.nn.functional.pad(
            _projection(model)[:, lo:hi], pad).contiguous()
        ax.check("ShardedExtender", self._ref)

    def embed(self, Xq,
              block: Optional[int] = None) -> torch.Tensor:  # hot-path
        """Embed Xq (p, b) -> (r, b) in stripes of `block`: each stripe
        against this rank's slab, then one all_reduce of the partials."""
        Xq = _queries(self.model, Xq)
        block = int(block or self.block)
        b = Xq.shape[1]
        out = torch.empty((self.model.spec.r, b), dtype=torch.float32,
                          device=self.device)
        if self.fused:
            kind, gamma, degree = self._statics
            for start in range(0, b, block):
                part = extend_embed_op(
                    self._ref, self._proj, Xq[:, start:start + block],
                    kind=kind, gamma=gamma, degree=degree)
                out[:, start:start + block] = self.ax.all_reduce(part)
            return out
        kern = self.model.kernel_fn()
        for start, stripe in stripe_iterator(kern, Xq, block, lhs=self._ref,
                                             pad_tail=True):
            width = min(block, b - start)
            part = (self._proj @ stripe)[:, :width].contiguous()
            out[:, start:start + width] = self.ax.all_reduce(part)
        return out

    def assign(self, Xq, block: Optional[int] = None,
               fused: Optional[bool] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sharded embed, then the nearest centroid: (labels (b,) int32,
        squared distance (b,)). `fused` as in Extender.assign."""
        if fused is None:
            use_kernel = self.assign_fused
        else:
            use_kernel = resolve_kernel_path(
                fused, self.policy.interpret if fused else None,
                "kmeans_assign kernel", self.device)
        C = self.model.centroids.contiguous()
        Yq = self.embed(Xq, block).T.contiguous()          # (b, r)
        if use_kernel:
            return assign_op(Yq, C)
        return _assign_plain(Yq, C)


def embed_sharded(model: FittedModel, Xq, mesh, axis: str = "data",
                  block: Optional[int] = None) -> torch.Tensor:
    """One-shot sharded embed through a throwaway ShardedExtender on the
    default policy (serving paths hold one and reuse its slabs).
    Collective."""
    return ShardedExtender(model, mesh, axis, block).embed(Xq)
