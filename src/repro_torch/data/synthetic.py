"""Synthetic data sets for the paper's experiments.

- segmentation_proxy: a structure-matched stand-in for the UCI image
  segmentation set (n=2310, p=19, K=7, unit-l2 rows) of Fig. 3.
- gaussian_blobs: well-separated clusters for unit tests.

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
