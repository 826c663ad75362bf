"""Standard K-means (Lloyd) with k-means++ seeding.

Alg. 1 ends with "perform standard K-means on Y in R^r"; the MATLAB
reference used `kmeans(..., 'Replicates', 10)`. Same semantics here:
k-means++ init, Lloyd iterations with a relative-tolerance stop, restarts,
best objective kept. The JAX package vmaps the restarts; here they are a
leading batch dimension, and a restart that has converged stops moving
while the others go on, as under vmap of a while loop.

Randomness comes from an explicit torch.Generator, or from outside: the
initial centroids can be passed in (`kmeans(..., init=...)`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class KMeansResult(NamedTuple):
    labels: torch.Tensor      # (n,) int32
    centroids: torch.Tensor   # (K, r)
    objective: torch.Tensor   # () float32, sum of squared distances
    n_iter: torch.Tensor      # () int32


def _sq_dists(Y: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """(..., n, K) squared Euclidean distances. Y: (n, r), C: (..., K, r)."""
    yn = torch.sum(Y * Y, dim=-1)[:, None]
    cn = torch.sum(C * C, dim=-1)[..., None, :]
    return torch.clamp(yn + cn - 2.0 * (Y @ C.transpose(-1, -2)), min=0.0)


def kmeans_plus_plus(Y: torch.Tensor, k: int, generator: torch.Generator,
                     n_restarts: int = 1) -> torch.Tensor:
    """k-means++ seeding [Arthur & Vassilvitskii 2007] for n_restarts
    independent restarts at once. Y: (n, r) -> (n_restarts, k, r)."""
    n = Y.shape[0]
    first = torch.randint(0, n, (n_restarts,), generator=generator,
                          device=Y.device)
    cents = torch.zeros((n_restarts, k, Y.shape[1]), dtype=Y.dtype,
                        device=Y.device)
    cents[:, 0] = Y[first]
    d2 = torch.sum((Y[None] - Y[first][:, None]) ** 2, dim=2)   # (R, n)
    for i in range(1, k):
        # Sample proportional to the current D^2 (guard the all-zero case).
        tot = torch.sum(d2, dim=1, keepdim=True)
        probs = torch.where(tot > 0, d2 / torch.where(tot > 0, tot, 1.0),
                            torch.full_like(d2, 1.0 / n))
        idx = torch.multinomial(probs, 1, generator=generator)[:, 0]
        c = Y[idx]                                               # (R, r)
        cents[:, i] = c
        d2 = torch.minimum(d2, torch.sum((Y[None] - c[:, None]) ** 2, dim=2))
    return cents


def _assign(Y: torch.Tensor, C: torch.Tensor):
    """Labels (first index on ties, as argmin) and objective per restart."""
    d2min, labels = torch.min(_sq_dists(Y, C), dim=-1)
    return labels, torch.sum(d2min, dim=-1)


def _update(Y: torch.Tensor, C: torch.Tensor, labels: torch.Tensor
            ) -> torch.Tensor:
    onehot = torch.nn.functional.one_hot(labels, C.shape[-2]).to(Y.dtype)
    counts = torch.sum(onehot, dim=-2)                   # (..., K)
    sums = onehot.transpose(-1, -2) @ Y                  # (..., K, r)
    # Empty clusters keep their previous centroid (never increases the
    # objective), as in the JAX package.
    return torch.where(counts[..., None] > 0,
                       sums / torch.clamp(counts, min=1.0)[..., None], C)


def _lloyd(Y: torch.Tensor, init: torch.Tensor, max_iter: int,
           tol: float) -> KMeansResult:  # hot-path
    """Lloyd from `init` ((k, r), or (R, k, r) for R restarts at once)."""
    single = init.dim() == 2
    C = init[None] if single else init
    R = C.shape[0]
    labels, obj = _assign(Y, C)
    prev = torch.full_like(obj, float("inf"))
    it = torch.zeros((R,), dtype=torch.int32, device=Y.device)

    def running():
        rel = torch.abs(prev - obj) > tol * torch.clamp(obj, min=1e-30)
        return (it < max_iter) & rel

    active = running()
    while bool(active.any()):
        C_new = _update(Y, C, labels)
        lab_new, obj_new = _assign(Y, C_new)
        C = torch.where(active[:, None, None], C_new, C)
        labels = torch.where(active[:, None], lab_new, labels)
        prev = torch.where(active, obj, prev)
        obj = torch.where(active, obj_new, obj)
        it = it + active.to(torch.int32)
        active = running()
    labels, obj = _assign(Y, C)
    res = KMeansResult(labels=labels.to(torch.int32), centroids=C,
                       objective=obj, n_iter=it)
    if single:
        return KMeansResult(*(t[0] for t in res))
    return res


def kmeans(Y: torch.Tensor, k: int, n_restarts: int = 10, max_iter: int = 20,
           tol: float = 1e-6, generator: Optional[torch.Generator] = None,
           init: Optional[torch.Tensor] = None) -> KMeansResult:  # hot-path
    """K-means with `n_restarts` k-means++ seeded Lloyd runs; best kept.

    Y: (n, r) data (rows = samples, the paper's Y^T). init: optional
    (n_restarts, k, r) initial centroids in place of the k-means++ draw
    from `generator`. Defaults mirror the paper's setup (10 inits, 20
    iterations).
    """
    if init is None:
        if generator is None:
            raise ValueError("kmeans needs a generator or init centroids")
        init = kmeans_plus_plus(Y, k, generator, n_restarts)
    res = _lloyd(Y, init.to(Y.dtype), max_iter, tol)
    # The best restart gathered on the device: no host read of its index.
    best = torch.argmin(res.objective).reshape(1)
    return KMeansResult(*(torch.index_select(t, 0, best)[0] for t in res))
