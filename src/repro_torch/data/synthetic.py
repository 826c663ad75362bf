"""Synthetic data sets for the paper's experiments.

- two_rings: the Fig. 1 data (n=4000, R^2, two concentric rings; not
  linearly separable, separable under the homogeneous polynomial kernel
  d=2).
- blob_ring: the Fig. 1 / Table 1 geometry, a central Gaussian blob
  enclosed by a ring.
- segmentation_proxy: a structure-matched stand-in for the UCI image
  segmentation set (n=2310, p=19, K=7, unit-l2 rows) of Fig. 3.
- gaussian_blobs: well-separated clusters for unit tests.
- blobs_1d: two-row blobs along the x axis, the drift demos' data.

Draws come from a numpy Generator (or an int seed for one), or from a
torch.Generator, whose device the data is then made on.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

Source = Union[int, np.random.Generator, torch.Generator]


class _Draws:
    """normal / uniform / integers from a numpy or a torch generator."""

    def __init__(self, source: Source):
        if isinstance(source, torch.Generator):
            self.gen, self.torch = source, True
        else:
            self.gen, self.torch = np.random.default_rng(source), False

    def normal(self, *shape) -> torch.Tensor:
        if self.torch:
            return torch.randn(shape, generator=self.gen,
                               device=self.gen.device)
        return torch.from_numpy(
            self.gen.standard_normal(shape).astype(np.float32))

    def uniform(self, *shape) -> torch.Tensor:
        if self.torch:
            return torch.rand(shape, generator=self.gen,
                              device=self.gen.device)
        return torch.from_numpy(self.gen.random(shape).astype(np.float32))

    def integers(self, high: int, n: int) -> torch.Tensor:
        if self.torch:
            return torch.randint(0, high, (n,), generator=self.gen,
                                 device=self.gen.device)
        return torch.from_numpy(self.gen.integers(0, high, n))

    def permutation(self, n: int) -> torch.Tensor:
        if self.torch:
            return torch.randperm(n, generator=self.gen,
                                  device=self.gen.device)
        return torch.from_numpy(self.gen.permutation(n))


def _labelled_halves(d: _Draws, X: torch.Tensor, n_first: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Label the first n_first columns of X (2, n) 0 and the rest 1, then
    permute columns and labels together."""
    n = X.shape[1]
    labels = (torch.arange(n, device=X.device) >= n_first).to(torch.int32)
    perm = d.permutation(n).to(X.device)
    return X[:, perm], labels[perm]


def two_rings(source: Source, n: int = 4000, r_inner: float = 1.0,
              r_outer: float = 2.0, noise: float = 0.1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns X (2, n) and labels (n,) int32. Half the points on each
    ring."""
    d = _Draws(source)
    n_in = n // 2
    theta = 2 * torch.pi * d.uniform(n)
    radii = torch.cat([torch.full((n_in,), r_inner),
                       torch.full((n - n_in,), r_outer)]).to(theta.device)
    radii = radii + noise * d.normal(n)
    X = torch.stack([radii * torch.cos(theta), radii * torch.sin(theta)])
    return _labelled_halves(d, X, n_in)


def blob_ring(source: Source, n: int = 4000, sigma: float = 0.3,
              radius: float = 2.0, rnoise: float = 0.1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fig. 1 geometry (primary): central Gaussian blob enclosed by a ring.

    Not linearly separable; under the homogeneous polynomial kernel (d=2)
    the rank-2 linearization separates the classes (Table 1: exact/ours
    acc 0.99). Returns X (2, n), labels (n,) int32: 0 blob, 1 ring.
    """
    d = _Draws(source)
    n_blob = n // 2
    n_ring = n - n_blob
    Xb = sigma * d.normal(2, n_blob)
    theta = 2 * torch.pi * d.uniform(n_ring)
    rr = radius + rnoise * d.normal(n_ring)
    Xr = torch.stack([rr * torch.cos(theta), rr * torch.sin(theta)])
    return _labelled_halves(d, torch.cat([Xb, Xr], dim=1), n_blob)


def gaussian_blobs(source: Source, n: int, p: int, k: int,
                   spread: float = 0.1, center_scale: float = 1.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k isotropic Gaussian clusters. Returns X (p, n), labels (n,) int32."""
    d = _Draws(source)
    centers = center_scale * d.normal(k, p)
    labels = d.integers(k, n)
    X = centers[labels].T + spread * d.normal(p, n)
    return X, labels.to(torch.int32)


def segmentation_proxy(source: Source, n: int = 2310, p: int = 19,
                       k: int = 7, spread: float = 0.25
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """UCI-image-segmentation-like data: K=7 anisotropic clusters, rows
    normalized to unit l2 norm (as the paper preprocesses), equal class
    sizes (the UCI set has 330 per class). Returns X (p, n), labels (n,)."""
    d = _Draws(source)
    per = n // k
    centers = d.normal(k, p)
    # Anisotropic per-cluster scales: the heterogeneous region statistics
    # of the segmentation attributes.
    scales = 0.3 + d.uniform(k, p)
    labels = torch.cat([
        torch.arange(k, device=centers.device).repeat_interleave(per),
        d.integers(k, n - per * k).to(centers.device)])
    noise = d.normal(n, p)
    X = centers[labels] + spread * scales[labels] * noise   # (n, p)
    X = X / torch.linalg.norm(X, dim=1, keepdim=True)      # unit l2 rows
    return X.T.contiguous(), labels.to(torch.int32)


def blobs_1d(rng: np.random.RandomState, xs, n_per: int = 100
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Two-row blobs of n_per points centered at each x position of `xs`
    (spread 0.25): the drift demos' initial and drifted distributions.
    Returns X (2, len(xs) n_per) float32, labels (len(xs) n_per,)."""
    cols, labs = [], []
    for i, x0 in enumerate(xs):
        c = np.zeros((2, n_per), np.float32)
        c[0] = x0 + 0.25 * rng.randn(n_per)
        c[1] = 0.25 * rng.randn(n_per)
        cols.append(c)
        labs.append(np.full(n_per, i))
    return np.concatenate(cols, axis=1), np.concatenate(labs)
