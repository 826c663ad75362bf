"""Exact rank-r eigendecomposition baseline (eq. 5): the accuracy ceiling.

O(n^2) memory, O(n^3) time: only feasible for validation-scale n; the whole
point of the paper is avoiding this.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.kernels_fn import KernelFn, gram_matrix


class ExactEig(NamedTuple):
    Y: torch.Tensor        # (r, n)
    eigvals: torch.Tensor  # (r,) top-r eigenvalues, descending
    U: torch.Tensor        # (n, r) orthonormal eigenvector basis: K_r = U S U^T


def exact_eig_from_gram(K: torch.Tensor, r: int) -> ExactEig:
    K = 0.5 * (K + K.T)
    evals, U = torch.linalg.eigh(K)
    evals = torch.flip(evals, (0,))
    U = torch.flip(U, (1,))
    top = torch.clamp(evals[:r], min=0.0)
    Y = torch.sqrt(top)[:, None] * U[:, :r].T
    return ExactEig(Y=Y, eigvals=top, U=U[:, :r].contiguous())


def exact_eig(kernel: KernelFn, X: torch.Tensor, r: int, *,
              clock=None) -> ExactEig:
    """The rank-r eigendecomposition of the full gram; `clock` (an
    api.estimator.StepClock) marks the end of the gram and of the eigh."""
    K = gram_matrix(kernel, X)
    if clock is not None:
        clock.mark("gram")
    eig = exact_eig_from_gram(K, r)
    if clock is not None:
        clock.mark("eig")
    return eig
