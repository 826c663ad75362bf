"""Clustering and approximation metrics of the paper's experiments."""
from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.core.kernels_fn import stripe_iterator


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).ravel()


def clustering_accuracy(labels_true, labels_pred, k: int) -> float:
    """Best-permutation matching accuracy (the paper's 'clustering
    accuracy'): exhaustive over permutations for k <= 8, greedy beyond
    (exact for near-diagonal confusion matrices)."""
    lt, lp = _np(labels_true), _np(labels_pred)
    n = lt.shape[0]
    conf = np.zeros((k, k), dtype=np.int64)
    np.add.at(conf, (lp, lt), 1)
    if k <= 8:
        best = 0
        for perm in itertools.permutations(range(k)):
            best = max(best, sum(conf[i, perm[i]] for i in range(k)))
        return best / n
    total = 0
    for _ in range(k):
        i, j = np.unravel_index(np.argmax(conf), conf.shape)
        total += conf[i, j]
        conf[i, :] = -1
        conf[:, j] = -1
    return total / n


def nmi(labels_true, labels_pred) -> float:
    """Normalized mutual information (arithmetic normalization)."""
    lt, lp = _np(labels_true), _np(labels_pred)
    n = lt.size
    ct = np.unique(lt, return_inverse=True)[1]
    cp = np.unique(lp, return_inverse=True)[1]
    joint = np.zeros((ct.max() + 1, cp.max() + 1))
    np.add.at(joint, (ct, cp), 1.0)
    joint /= n
    pt = joint.sum(axis=1, keepdims=True)
    pp = joint.sum(axis=0, keepdims=True)
    nz = joint > 0
    mi = np.sum(joint[nz] * np.log(joint[nz] / (pt @ pp)[nz]))
    ht = -np.sum(pt[pt > 0] * np.log(pt[pt > 0]))
    hp = -np.sum(pp[pp > 0] * np.log(pp[pp > 0]))
    denom = 0.5 * (ht + hp)
    return float(mi / denom) if denom > 0 else 1.0


def kernel_approx_error(K: torch.Tensor, Y: torch.Tensor) -> float:
    """||K - Y^T Y||_F / ||K||_F (paper Fig. 3a). Materializes K:
    validation scale only."""
    return float(torch.linalg.norm(K - Y.T @ Y) / torch.linalg.norm(K))


def kernel_approx_error_streaming(kernel, X, Y, block: int = 1024) -> float:
    """Same metric without materializing K: stream stripes of K."""
    num = 0.0
    den = 0.0
    for start, stripe in stripe_iterator(kernel, X, block):
        width = stripe.shape[1]
        approx = Y.T @ Y[:, start:start + width]
        num += float(torch.sum((stripe - approx) ** 2))
        den += float(torch.sum(stripe ** 2))
    return float(np.sqrt(num / den))
