"""Standard one-pass Nystrom approximation [Williams & Seeger 2001].

The paper's main baseline: sample m columns of K uniformly WITHOUT
replacement, K_hat = C W^+ C^T with C = K[:, idx] (n x m), W = K[idx, idx].
For the embedding comparison at fixed rank r we truncate K_hat to its best
rank-r part (both methods then feed r-dimensional samples to K-means).
Memory: O(nm) for C; the paper's point is that matching the one-pass
accuracy needs m >> r', hence ~10x the memory (Table 1, Fig. 3).

The landmarks are drawn from an explicit torch.Generator, or handed in
(`idx`): the JAX package's draw cannot be reproduced in torch, so tests
feed it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.kernels_fn import KernelFn


class NystromResult(NamedTuple):
    Y: torch.Tensor        # (r, n): K_hat_r = Y^T Y
    idx: torch.Tensor      # (m,) sampled column indices, int64
    eigvals: torch.Tensor  # (r,) top eigenvalues (of W_m, classical form)
    # (m, r) top-r eigenvectors of W_m = K[idx, idx] (classical form only;
    # None under optimal_truncation). With eigvals this is the W^+ factor
    # the out-of-sample extension needs: a new point embeds as
    # y(x) = Lambda_r^{-1/2} U_r^T kappa(X[:, idx], x), against the m
    # landmarks (serve/extend.py).
    U: Optional[torch.Tensor] = None


# Truncation floor of the classical path: equal to the serving
# projection's epsilon (serve/extend._EIG_EPS), so fit and serve make the
# same call on which eigen-directions are rank-deficient, in both
# directions (zeroed directions get an exactly-zero eigenvalue below).
_ABS_EIG_FLOOR = 1e-7


def nystrom(kernel: KernelFn, X: torch.Tensor, m: int, r: int,
            eps: float = 1e-8, optimal_truncation: bool = False, *,
            generator: Optional[torch.Generator] = None,
            idx: Optional[torch.Tensor] = None, clock=None) -> NystromResult:
    """Classical rank-r Nystrom: Y = Lambda_r^{-1/2} U_r^T C^T with
    (Lambda_r, U_r) the top-r eigenpairs of W_m = K[idx, idx].

    optimal_truncation=True instead SVD-truncates the full rank-m Nystrom
    extension K_hat = C W_m^+ C^T to its best rank-r part (a strictly
    stronger variant; the paper's Table 1 numbers are the classical form).
    `idx` ((m,) distinct column indices) replaces the draw from
    `generator`; `clock` (an api.estimator.StepClock) marks the end of the
    landmark gram and of the eigensolve.
    """
    n = X.shape[1]
    if idx is None:
        if generator is None:
            raise ValueError("nystrom needs a generator or landmark idx")
        idx = torch.randperm(n, generator=generator, device=X.device)[:m]
    idx = torch.as_tensor(idx, device=X.device).to(torch.int64)
    if idx.shape != (m,):
        raise ValueError(f"landmark idx must be ({m},), got "
                         f"{tuple(idx.shape)}")
    Xs = X[:, idx]
    C = kernel(X, Xs)                 # (n, m): one pass over m columns
    Wm = C[idx, :]                    # (m, m)
    Wm = 0.5 * (Wm + Wm.T)
    if clock is not None:
        clock.mark("landmark_gram")
    evals, U = torch.linalg.eigh(Wm)
    evals = torch.flip(evals, (0,))
    U = torch.flip(U, (1,))
    thresh = torch.clamp(eps * torch.max(torch.abs(evals)),
                         min=_ABS_EIG_FLOOR)
    if optimal_truncation:
        inv_sqrt = torch.where(
            evals > thresh, 1.0 / torch.sqrt(torch.maximum(evals, thresh)),
            torch.zeros_like(evals))
        F = C @ (U * inv_sqrt[None, :])   # (n, m): K_hat = F F^T
        Uf, Sf, _ = torch.linalg.svd(F, full_matrices=False)
        Y = Sf[:r, None] * Uf[:, :r].T    # (r, n)
        if clock is not None:
            clock.mark("eig")
        return NystromResult(Y=Y, idx=idx, eigvals=Sf[:r] ** 2)
    ev = evals[:r]
    inv_sqrt_r = torch.where(
        ev > thresh, 1.0 / torch.sqrt(torch.maximum(ev, thresh)),
        torch.zeros_like(ev))
    Y = (inv_sqrt_r[:, None] * U[:, :r].T) @ C.T   # (r, n)
    # Zero the eigenvalues of directions the truncation refused to invert
    # (Y's row is 0 there), so the serving projection, which zeroes
    # eigenvalues below its own absolute epsilon, makes the same rank
    # decision as this fit: a direction between that epsilon and this
    # relative threshold would otherwise be inverted at serve time.
    evals_r = torch.where(ev > thresh, ev, torch.zeros_like(ev))
    if clock is not None:
        clock.mark("eig")
    return NystromResult(Y=Y, idx=idx, eigvals=evals_r,
                         U=U[:, :r].contiguous())
