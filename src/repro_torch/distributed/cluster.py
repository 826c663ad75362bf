"""One-pass kernel K-means on a mesh: the paper's Alg. 1 across ranks.

The data X (p, n) is column-sharded over the mesh's data axis (rank i owns
columns [i n/d, (i+1) n/d)); the kernel matrix never exists, not even a
whole column stripe on one rank:

  sketch   each rank makes its rows of a stripe, kappa(X_local, Xb); D is
           applied locally, H by the butterfly of distributed_fwht, R^T by
           a masked gather and one all_reduce of the (r', b) sampled rows;
  basis    Q from the row-sharded W (n, r') by Cholesky-QR: G = W^T W
           (one all_reduce of r' x r'), Q = W G^{-1/2}, W never gathered;
  core     B (Q^T Omega) = Q^T W on replicated r' x r' matrices;
  embed    Y = Sigma^{1/2} V^T Q^T stays column-sharded (r, n/d);
  cluster  Lloyd with local assignment and centroids from all_reduced
           (sums, counts).

Communication per stripe: log2(d) n/d b (butterfly) + r' b (all_reduce),
against n b to gather the stripe.

Every function is collective, and its arguments are the same on every
rank: the whole X (each rank reads its columns and the stripe's), and the
random draws, which ranks cannot share a generator for: the SRHT's
`signs` (n,) and `rows` (r',), and each restart's k initial column
indices `inits` (n_restarts, k). Results that are sharded come back as
this rank's slab.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.sketch import _lstsq
from repro_torch.distributed.dfwht import (RowGather, distributed_fwht,
                                          f32_sqrt)
from repro_torch.launch.mesh import MeshAxis, mesh_axis


class DistClusterResult(NamedTuple):
    labels: torch.Tensor     # (n/d,) int64, this rank's columns
    Y: torch.Tensor          # (r, n/d), this rank's columns
    centroids: torch.Tensor  # (k, r), replicated
    eigvals: torch.Tensor    # (r,), replicated


def _slab(ax: MeshAxis, n: int):
    """This rank's [lo, hi) of n sharded items; n % size must be 0."""
    if n % ax.size:
        raise ValueError(f"{n} columns do not shard over {ax.size} ranks")
    width = n // ax.size
    return ax.index * width, (ax.index + 1) * width


def distributed_sketch(kernel, X: torch.Tensor, mesh, signs: torch.Tensor,
                       rows: torch.Tensor, axis: str = "data",
                       block: int = 1024) -> torch.Tensor:
    """W = K Omega with K's stripes row-sharded. X (p, n), n a power of two
    (pad with zero columns upstream: D and R act trivially on them);
    signs (n,), rows (r',) int64. Returns this rank's (n/d, r') rows of W.
    """
    ax = mesh_axis(mesh, axis)
    ax.check("distributed_sketch", X, signs, rows)
    n = X.shape[1]
    if signs.shape[0] != n:
        raise ValueError(f"the distributed sketch expects pre-padded n == "
                         f"n_pad, got n={n} for {signs.shape[0]} signs")
    lo, hi = _slab(ax, n)
    Xl, sl = X[:, lo:hi], signs[lo:hi, None]
    scale = f32_sqrt(n, X)
    gather = RowGather(rows, lo, hi)
    W = torch.empty((hi - lo, rows.shape[0]), dtype=torch.float32,
                    device=X.device)
    for start in range(0, n, block):
        b = min(block, n - start)
        stripe = kernel(Xl, X[:, start:start + b]) * sl   # (n/d, b)
        Fl = distributed_fwht(stripe, mesh, axis, normalize=False)
        wt = gather(ax, Fl) / scale                       # (r', b)
        a, z = max(start, lo), min(start + b, hi)
        if z > a:
            W[a - lo:z - lo] = wt.T[a - start:z - start]
    return W


def cholesky_qr(Wl: torch.Tensor, mesh, axis: str = "data",
                eps: float = 1e-7) -> torch.Tensor:
    """Orthonormal columns spanning range(W), W (n, r') row-sharded (Wl is
    this rank's rows): G = W^T W by one all_reduce, Q_i = W v_i /
    sqrt(lambda_i). A rank-deficient W keeps only the columns of positive
    eigenvalues; the truncation is decided on the host, so Q is (n, rank)
    with the rank the same on every rank. Returns this rank's rows."""
    ax = mesh_axis(mesh, axis)
    G = ax.all_reduce(Wl.T @ Wl)
    evals, V = torch.linalg.eigh(0.5 * (G + G.T))
    ev = evals.cpu().numpy()
    keep = ev > eps * max(float(ev.max()), 1e-30)
    idx = torch.from_numpy(np.nonzero(keep)[0][::-1].copy()).to(Wl.device)
    cols = V[:, idx] / torch.sqrt(evals[idx])[None, :]
    return Wl @ cols


def distributed_omega_t(Ml: torch.Tensor, mesh, signs: torch.Tensor,
                        rows: torch.Tensor, axis: str = "data"
                        ) -> torch.Tensor:
    """Omega^T M for row-sharded M (n, c), Ml this rank's rows: D, the
    distributed H, R^T. Returns the replicated (r', c)."""
    ax = mesh_axis(mesh, axis)
    n = signs.shape[0]
    lo, hi = _slab(ax, n)
    Fl = distributed_fwht(Ml * signs[lo:hi, None], mesh, axis,
                          normalize=False)
    return RowGather(rows, lo, hi)(ax, Fl) / f32_sqrt(n, Ml)


def _lloyd_step(ax: MeshAxis, C: torch.Tensor, Yl: torch.Tensor, k: int):
    """One Lloyd step on this rank's columns: local assignment, centroids
    from all_reduced sums and counts, the all_reduced objective."""
    d2 = (torch.sum(Yl * Yl, dim=0)[None, :]
          + torch.sum(C * C, dim=1)[:, None] - 2.0 * (C @ Yl))   # (k, nl)
    d2min, labels = torch.min(d2, dim=0)
    onehot = torch.nn.functional.one_hot(labels, k).to(Yl.dtype)  # (nl, k)
    stats = torch.cat([Yl @ onehot, onehot.sum(dim=0)[None]], dim=0)
    stats = ax.all_reduce(torch.cat([stats.reshape(-1),
                                     d2min.sum().reshape(1)]))
    r = Yl.shape[0]
    sums, counts = stats[:r * k].reshape(r, k), stats[r * k:(r + 1) * k]
    newC = torch.where(counts[:, None] > 0,
                       sums.T / torch.clamp(counts[:, None], min=1.0), C)
    return newC, labels, stats[-1]


def distributed_kmeans(Yl: torch.Tensor, k: int, inits: torch.Tensor, mesh,
                       axis: str = "data", n_iter: int = 20):
    """Lloyd on column-sharded Y (r, n), Yl this rank's columns. Each row
    of `inits` ((n_restarts, k) global column indices) starts a restart
    from those columns (gathered by one all_reduce, O(kr)); the restart
    of least objective wins. Returns (labels (n/d,), centroids (k, r),
    objective)."""
    ax = mesh_axis(mesh, axis)
    r, nl = Yl.shape
    lo = ax.index * nl
    best = None
    for idx in torch.as_tensor(inits, dtype=torch.int64):
        idx = idx.to(Yl.device)
        mine = (idx >= lo) & (idx < lo + nl)
        C = torch.zeros((k, r), dtype=Yl.dtype, device=Yl.device)
        C[mine] = Yl[:, idx[mine] - lo].T
        C = ax.all_reduce(C)
        for _ in range(n_iter):
            C, _, _ = _lloyd_step(ax, C, Yl, k)
        C, labels, obj = _lloyd_step(ax, C, Yl, k)
        score = float(obj)
        if best is None or score < best[0]:
            best = (score, labels, C)
    return best[1], best[2], best[0]


def distributed_one_pass_kernel_kmeans(
        kernel, X: torch.Tensor, k: int, r: int, mesh,
        signs: torch.Tensor, rows: torch.Tensor, inits: torch.Tensor,
        axis: str = "data", block: int = 1024,
        n_iter: int = 20) -> DistClusterResult:
    """Alg. 1 end to end on a mesh. X (p, n), n a power of two (pad with
    zero columns upstream); the draws as in distributed_sketch and
    distributed_kmeans; r' = rows.shape[0]."""
    W = distributed_sketch(kernel, X, mesh, signs, rows, axis, block)
    Q = cholesky_qr(W, mesh, axis)                          # (n/d, rank)
    QtO = distributed_omega_t(Q, mesh, signs, rows, axis).T   # (rank, r')
    QtW = mesh_axis(mesh, axis).all_reduce(Q.T @ W)         # (rank, r')
    Bt = _lstsq(QtO.T, QtW.T)
    B = 0.5 * (Bt + Bt.T)
    evals, V = torch.linalg.eigh(B)
    evals = torch.clamp(torch.flip(evals, dims=(0,)), min=0.0)
    V = torch.flip(V, dims=(1,))
    proj = torch.sqrt(evals[:r])[:, None] * V[:, :r].T      # (r, rank)
    Y = proj @ Q.T                                          # (r, n/d)
    labels, C, _ = distributed_kmeans(Y, k, inits, mesh, axis, n_iter)
    return DistClusterResult(labels=labels, Y=Y, centroids=C,
                             eigvals=evals[:r])
