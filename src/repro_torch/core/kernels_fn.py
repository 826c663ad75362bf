"""Kernel functions and streaming block-gram construction.

Alg. 1 never materializes the full kernel matrix K: it consumes K in
column stripes built on the fly from the data matrix X (p x n, samples as
columns). This module holds the kernel registry and the stripe builders
the sketch (core/sketch.py), the accumulator and the serving extension
use.
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import torch

KernelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def polynomial_kernel(gamma: float = 0.0, degree: int = 2) -> KernelFn:
    """kappa(x, y) = (<x, y> + gamma)^degree. gamma=0 -> homogeneous."""
    degree = int(degree)

    def fn(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        # X: (p, n1), Y: (p, n2) -> (n1, n2)
        return (X.T @ Y + gamma) ** degree

    return fn


def rbf_kernel(gamma: float = 1.0) -> KernelFn:
    """kappa(x, y) = exp(-gamma * ||x - y||^2)."""

    def fn(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        xn = torch.sum(X * X, dim=0)[:, None]  # (n1, 1)
        yn = torch.sum(Y * Y, dim=0)[None, :]  # (1, n2)
        d2 = torch.clamp(xn + yn - 2.0 * (X.T @ Y), min=0.0)
        return torch.exp(-gamma * d2)

    return fn


def linear_kernel() -> KernelFn:
    def fn(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        return X.T @ Y

    return fn


# name -> (factory, valid parameter names). make_kernel enforces the valid
# set: a typo like gamm= must raise, not be dropped.
_REGISTRY = {
    "polynomial": (polynomial_kernel, frozenset({"gamma", "degree"})),
    "rbf": (rbf_kernel, frozenset({"gamma"})),
    "linear": (linear_kernel, frozenset()),
}


def kernel_names() -> list:
    """Registered kernel names, sorted."""
    return sorted(_REGISTRY)


def kernel_params_for(name: str) -> frozenset:
    """Valid parameter names of a registered kernel."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown kernel {name!r}; have {kernel_names()}")
    return _REGISTRY[name][1]


def make_kernel(name: str, **params) -> KernelFn:
    if name not in _REGISTRY:
        raise ValueError(f"unknown kernel {name!r}; have {kernel_names()}")
    factory, valid = _REGISTRY[name]
    unknown = set(params) - valid
    if unknown:
        accepted = (f"valid params: {sorted(valid)}" if valid
                    else "it takes no params")
        raise ValueError(f"unknown param(s) {sorted(unknown)} for kernel "
                         f"{name!r}; {accepted}")
    return factory(**params)


def gram_stripe(kernel: KernelFn, lhs: torch.Tensor, X: torch.Tensor,
                start: int, block: int) -> torch.Tensor:
    """Stripe kappa(lhs, X[:, start:start+block]) of the rectangular gram."""
    return kernel(lhs, X[:, start:start + block])


def stripe_iterator(kernel: KernelFn, X: torch.Tensor, block: int,
                    lhs: Optional[torch.Tensor] = None,
                    pad_tail: bool = False
                    ) -> Iterator[Tuple[int, torch.Tensor]]:
    """Yield (start, kappa(lhs, X[:, start:start+width])) covering all n cols.

    lhs defaults to X (the paper's square gram stripes); passing the
    training matrix as `lhs` with query columns in `X` yields the
    rectangular stripes of the out-of-sample extension (serve/extend.py).

    X is zero-padded to a column multiple of `block`, so every stripe has
    the same width; the ragged tail is sliced back to its true width
    unless pad_tail=True, which yields it at full `block` width for
    callers that slice with the yielded start and their own n. (Column j
    of kappa(lhs, X) depends only on column j of X, so the padding lands
    only in the sliced-off region.)
    """
    n = X.shape[1]
    lhs = X if lhs is None else lhs
    n_pad = -(-n // block) * block
    Xp = X if n_pad == n else torch.nn.functional.pad(X, (0, n_pad - n))
    for start in range(0, n, block):
        width = min(block, n - start)
        stripe = gram_stripe(kernel, lhs, Xp, start, block)
        yield start, (stripe if width == block or pad_tail
                      else stripe[:, :width])
