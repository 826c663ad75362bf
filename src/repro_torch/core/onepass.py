"""Algorithm 1: One-Pass Kernel K-means as two free functions (deprecated).

    lines 1-6   K ~= U Sigma U^T through the one-pass sketch, giving the
                linearization Y = Sigma^{1/2} U^T in R^{r x n}
    line 7      standard K-means on the columns of Y (core/kmeans.py)

`one_pass_kernel_kmeans` is a shim over the estimator API's one-pass
backend (`repro_torch.api`), kept for call sites that pass a raw kernel
callable; `linearized_kmeans_from_Y` is line 7 alone, for any (r, n)
linearization (exact, Nystrom).
"""
from __future__ import annotations

import warnings
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.kernels_fn import KernelFn
from repro_torch.core.kmeans import KMeansResult, kmeans, kmeans_plus_plus


class OnePassResult(NamedTuple):
    labels: torch.Tensor
    Y: torch.Tensor            # (r, n) linearized samples
    eigvals: torch.Tensor      # (r,)
    kmeans: KMeansResult


def one_pass_kernel_kmeans(
    kernel: KernelFn,
    X: torch.Tensor,                # (p, n) data matrix
    k: int,                         # number of clusters
    r: int,                         # target rank
    oversampling: int = 10,         # l; r' = r + l
    block: int = 512,               # streaming stripe width
    n_restarts: int = 10,
    max_iter: int = 20,
    sketch_type: str = "srht",
    fwht_fn: Optional[Callable] = None,
    *,
    seed: int = 0,
    sketch=None,
    init: Optional[torch.Tensor] = None,
) -> OnePassResult:
    """DEPRECATED shim for Alg. 1: use `repro_torch.api.KernelKMeans`.

    Delegates to the one-pass backend and K-means with the generators
    `KernelKMeans.fit(X, seed)` derives from `seed`, on X's device;
    `sketch` and `init` hand in ready draws, as there.
    """
    warnings.warn(
        "one_pass_kernel_kmeans is deprecated; use repro_torch.api."
        "KernelKMeans(k=..., r=..., backend='onepass-srht').fit(X, seed) "
        "(or repro_torch.api.get_backend(...) for a raw-callable kernel)",
        DeprecationWarning, stacklevel=2)
    # Lazy: api builds on core.
    from repro_torch.api.backends import get_backend
    from repro_torch.api.estimator import generator, seeds
    sketch_seed, km_seed = seeds(seed)
    emb = get_backend(f"onepass-{sketch_type}").fit(
        generator(sketch_seed, X.device), kernel, X, r, block=block,
        oversampling=oversampling, fwht_fn=fwht_fn, sketch=sketch)
    km = linearized_kmeans_from_Y(emb.Y, k, n_restarts, max_iter,
                                  generator=generator(km_seed, X.device),
                                  init=init)
    return OnePassResult(labels=km.labels, Y=emb.Y, eigvals=emb.eigvals,
                         kmeans=km)


def linearized_kmeans_from_Y(Y: torch.Tensor, k: int, n_restarts: int = 10,
                             max_iter: int = 20, *,
                             generator: Optional[torch.Generator] = None,
                             init: Optional[torch.Tensor] = None
                             ) -> KMeansResult:
    """Line 7 alone: K-means on any (r, n) linearization (exact / Nystrom).
    `init` ((n_restarts, k, r)) replaces the k-means++ draw from
    `generator`."""
    Yt = Y.T.contiguous()
    if init is None:
        if generator is None:
            raise ValueError("linearized_kmeans_from_Y needs a generator "
                             "or init centroids")
        init = kmeans_plus_plus(Yt, k, generator, n_restarts)
    return kmeans(Yt, k, n_restarts=n_restarts, max_iter=max_iter,
                  init=torch.as_tensor(init, dtype=Yt.dtype,
                                       device=Yt.device))
