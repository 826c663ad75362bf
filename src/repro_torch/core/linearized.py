"""Linearized kernel K-means theory (Sec. 3): objective, Theorem 1 machinery.

L(C) = tr((I - C^T C) K (I - C^T C)) with C the normalized cluster-indicator
matrix (C C^T = I_K). Since P = C^T C is an orthogonal projection,
L(C) = tr(K) - tr(C K C^T), which is what we compute.

Includes a brute-force optimal-partition search (tiny n only) used by the
property tests of Theorem 1:
    L(C_hat) - L(C_star) <= 2 ||E||_*          (any PSD K_hat = K - E)
    L(C_hat) - L(C_star) <= tr(E)              (K_hat = best rank-r approx)

Every function takes tensors on any device (numpy arrays are accepted
where the JAX package takes them).
"""
from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np
import torch


def objective_from_labels(K: torch.Tensor, labels: torch.Tensor,
                          k: int) -> torch.Tensor:
    """L(C) = tr(K) - sum_k (1/|S_k|) sum_{i,j in S_k} K_ij."""
    labels = torch.as_tensor(labels, device=K.device)
    onehot = (labels[:, None] == torch.arange(k, device=K.device)[None, :]
              ).to(K.dtype)
    counts = torch.sum(onehot, dim=0)
    # C = diag(1/sqrt(counts)) @ onehot^T ; tr(C K C^T) = sum_k s_k / |S_k|
    per_cluster = torch.einsum("ik,ij,jk->k", onehot, K, onehot)
    safe = torch.where(counts > 0,
                       per_cluster / torch.clamp(counts, min=1.0),
                       torch.zeros_like(per_cluster))
    return torch.trace(K) - torch.sum(safe)


def brute_force_optimal(K, k: int) -> Tuple[np.ndarray, float]:
    """Exact argmin over all surjective k-labelings. n <= ~10 only."""
    K = torch.as_tensor(K)
    n = K.shape[0]
    best_labels, best_obj = None, np.inf
    for labels in itertools.product(range(k), repeat=n):
        if len(set(labels)) < k:   # every cluster non-empty (paper's C in C)
            continue
        obj = float(objective_from_labels(
            K, torch.tensor(labels, dtype=torch.int32), k))
        if obj < best_obj:
            best_obj, best_labels = obj, np.asarray(labels)
    return best_labels, best_obj


def trace_norm(E: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.linalg.svdvals(E))


def best_rank_r(K: torch.Tensor, r: int) -> torch.Tensor:
    """Best rank-r PSD approximation of PSD K (truncated eigendecomposition)."""
    evals, U = torch.linalg.eigh(K)
    evals = torch.clamp(torch.flip(evals, (0,)), min=0.0)
    U = torch.flip(U, (1,))
    return (U[:, :r] * evals[:r][None, :]) @ U[:, :r].T


def theorem1_bounds(K: torch.Tensor, K_hat: torch.Tensor,
                    k: int) -> Tuple[float, float, float]:
    """Return (L(C_hat) - L(C_star), 2||E||_*, tr(E)) via brute force.

    Small-n validation of Theorem 1. C_hat optimizes under K_hat; its excess
    objective is evaluated under the TRUE K.
    """
    K, K_hat = torch.as_tensor(K), torch.as_tensor(K_hat)
    _, l_star = brute_force_optimal(K, k)
    labels_hat, _ = brute_force_optimal(K_hat, k)
    l_hat = float(objective_from_labels(
        K, torch.as_tensor(labels_hat, dtype=torch.int32), k))
    E = K - K_hat
    return l_hat - l_star, float(2.0 * trace_norm(E)), float(torch.trace(E))
