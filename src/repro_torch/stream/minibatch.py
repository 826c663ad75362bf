"""Minibatch K-means (Sculley 2010) in the rank-r embedding space.

The `kmeans_mode="minibatch"` path of `KernelKMeans.partial_fit`: per
step, take a batch of rows of Y, assign it to the nearest centroid, and
move each centroid toward its batch mean with the count-based learning
rate cnt / (counts + cnt). O(steps * batch * k * r) per re-eig instead of
Lloyd's O(restarts * iters * n * k * r). Each re-eig seeds afresh with
k-means++ on the new embedding (the basis rotates between re-eigs).

The draws (the k-means++ centroids and the (n_steps, batch) row indices,
uniform with replacement) come from a torch.Generator, or from outside as
`MiniBatchDraws`, which is how tests feed the JAX package's draws in.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.kmeans import _sq_dists, kmeans_plus_plus


class MiniBatchResult(NamedTuple):
    labels: torch.Tensor      # (n,) int32, final full-data assignment
    centroids: torch.Tensor   # (K, r)
    objective: torch.Tensor   # () float32, full-data sum of squared dists
    n_steps: int


class MiniBatchDraws(NamedTuple):
    init: torch.Tensor        # (K, r) starting centroids
    idx: torch.Tensor         # (n_steps, batch) int64 rows of Y per step


def draw_minibatch(Y: torch.Tensor, k: int, batch_size: int, n_steps: int,
                   generator: torch.Generator) -> MiniBatchDraws:
    """k-means++ seeds, then the batch indices, from one generator."""
    init = kmeans_plus_plus(Y, k, generator, 1)[0]
    idx = torch.randint(0, Y.shape[0], (n_steps, batch_size),
                        generator=generator, device=Y.device)
    return MiniBatchDraws(init=init, idx=idx)


def minibatch_kmeans(Y: torch.Tensor, k: int, batch_size: int = 256,
                     n_steps: int = 50, *,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[MiniBatchDraws] = None
                     ) -> MiniBatchResult:  # hot-path
    """Sculley minibatch K-means on the rows of Y (n, r)."""
    if draws is None:
        if generator is None:
            raise ValueError("minibatch_kmeans needs a generator or draws")
        draws = draw_minibatch(Y, k, batch_size, n_steps, generator)
    C = torch.as_tensor(draws.init, dtype=Y.dtype, device=Y.device)
    idx = torch.as_tensor(draws.idx, device=Y.device).to(torch.int64)
    counts = torch.zeros((k,), dtype=Y.dtype, device=Y.device)
    for step in range(idx.shape[0]):
        B = Y[idx[step]]
        labels = torch.argmin(_sq_dists(B, C), dim=1)
        onehot = torch.nn.functional.one_hot(labels, k).to(Y.dtype)
        cnt = torch.sum(onehot, dim=0)                          # (K,)
        mean = (onehot.T @ B) / torch.clamp(cnt, min=1.0)[:, None]
        counts = counts + cnt
        lr = (cnt / torch.clamp(counts, min=1.0))[:, None]
        C = torch.where(cnt[:, None] > 0, C + lr * (mean - C), C)
    d2 = _sq_dists(Y, C)
    d2min, labels = torch.min(d2, dim=1)
    return MiniBatchResult(labels=labels.to(torch.int32), centroids=C,
                           objective=torch.sum(d2min),
                           n_steps=int(idx.shape[0]))
