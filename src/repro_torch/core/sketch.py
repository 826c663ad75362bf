"""Randomized sketching: SRHT test matrices and the one-pass eigendecomposition.

Alg. 1 lines 1-6:

    Omega = D H R            (n x r'), never materialized
    W     = K Omega          one streaming pass over column stripes of K
    Q     = orthonormal basis of range(W), all r' columns
    solve B (Q^T Omega) = Q^T W          the one-pass trick (Halko et al.
                                         2011, sec. 5.5): no second pass
                                         over K
    B     = V Sigma V^T  (eigh, PSD-projected)
    Y     = Sigma^{1/2} V^T Q^T  in R^{r x n}

`H` is the normalized Walsh-Hadamard transform; `fwht` here is the plain
PyTorch version. Random draws (SRHT signs/rows, the Gaussian Omega) come
from an explicit torch.Generator, or from outside: SRHT and GaussianSketch
are plain tuples of tensors, so a caller can hand in the draws of another
implementation.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def fwht(x: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Fast Walsh-Hadamard transform along dim 0. x: (n, ...), n = 2^m.

    Iterative radix-2 butterflies, log2(n) stages; normalize=True applies
    1/sqrt(n) so H is orthonormal.
    """
    n = x.shape[0]
    if n & (n - 1):
        raise ValueError(f"FWHT needs power-of-two length, got {n}")
    orig_shape = x.shape
    x = x.reshape(n, -1)
    h = 1
    while h < n:
        x = x.reshape(n // (2 * h), 2, h, -1)
        a, b = x[:, 0], x[:, 1]
        x = torch.stack([a + b, a - b], dim=1)
        h *= 2
    x = x.reshape(orig_shape)
    if normalize:
        x = x / torch.sqrt(torch.tensor(float(n), dtype=x.dtype,
                                        device=x.device))
    return x


class SRHT(NamedTuple):
    """Implicit Omega = D H R in R^{n_pad x r'} restricted to the top n rows.

    signs: (n_pad,) float32 +-1 diagonal of D
    rows:  (r',) int64 row indices sampled without replacement (R)
    n:     true (unpadded) dimension
    n_pad: power-of-two padded dimension
    """
    signs: torch.Tensor
    rows: torch.Tensor
    n: int
    n_pad: int

    @property
    def r_prime(self) -> int:
        return int(self.rows.shape[0])


def make_srht(n: int, r_prime: int, generator: torch.Generator,
              device=None) -> SRHT:
    """Draw an SRHT for n rows from `generator` (on `device`)."""
    n_pad = next_pow2(n)
    device = generator.device if device is None else torch.device(device)
    signs = (torch.randint(0, 2, (n_pad,), generator=generator,
                           device=device) * 2 - 1).to(torch.float32)
    rows = torch.randperm(n_pad, generator=generator,
                          device=device)[:r_prime]
    return SRHT(signs=signs, rows=rows, n=int(n), n_pad=n_pad)


def srht_apply_t(srht: SRHT, M: torch.Tensor) -> torch.Tensor:
    """Omega^T M = R^T H (D M) for M of shape (n, b) -> (r', b).

    Scale rows by D, FWHT over the zero-padded row axis, gather the
    sampled rows.
    """
    n = M.shape[0]
    if n != srht.n:
        raise ValueError(f"expected {srht.n} rows, got {n}")
    Mp = torch.nn.functional.pad(M, (0, 0, 0, srht.n_pad - n))
    Mp = fwht(Mp * srht.signs[:, None])
    return Mp[srht.rows]


def srht_apply(srht: SRHT, V: torch.Tensor) -> torch.Tensor:
    """Omega V for V of shape (r', b) -> (n, b). (D H R V; H, D symmetric.)"""
    scatter = torch.zeros((srht.n_pad, V.shape[1]), dtype=V.dtype,
                          device=V.device)
    scatter[srht.rows] = V
    out = fwht(scatter) * srht.signs[:, None]
    return out[:srht.n]


def _parity(x: torch.Tensor) -> torch.Tensor:
    """Parity of the set bits of each non-negative int64 (popcount & 1)."""
    for shift in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> shift)
    return x & 1


def srht_rows(srht: SRHT, start: int, stop: int) -> torch.Tensor:
    """Materialize rows [start, stop) of the implicit Omega = D H R.

    Omega[i, c] = signs[i] * (-1)^popcount(i & rows[c]) / sqrt(n_pad), the
    Sylvester-Hadamard entry formula: exactly what srht_apply_t gives for
    the one-hot column e_i, at O(b r') cost for a b-row slice.
    """
    if not (0 <= start <= stop <= srht.n):
        raise ValueError(f"row slice [{start}, {stop}) outside [0, {srht.n})")
    dev = srht.signs.device
    idx = torch.arange(start, stop, dtype=torch.int64, device=dev)
    bits = idx[:, None] & srht.rows.to(torch.int64)[None, :]
    scale = 1.0 / torch.sqrt(torch.tensor(float(srht.n_pad),
                                          dtype=torch.float32, device=dev))
    vals = torch.where(_parity(bits) == 1, -scale, scale)
    return srht.signs[start:stop, None] * vals


class GaussianSketch(NamedTuple):
    """Dense Gaussian Omega: the memory-hungry baseline Alg. 1 replaces."""
    omega: torch.Tensor  # (n, r')


def make_gaussian(n: int, r_prime: int, generator: torch.Generator,
                  device=None) -> GaussianSketch:
    device = generator.device if device is None else torch.device(device)
    omega = torch.randn((n, r_prime), generator=generator, device=device)
    return GaussianSketch(omega / torch.sqrt(torch.tensor(
        float(r_prime), dtype=torch.float32, device=device)))


class LowRankEig(NamedTuple):
    Y: torch.Tensor        # (r, n) linearized samples: K_hat = Y^T Y
    Q: torch.Tensor        # (n, r)
    eigvals: torch.Tensor  # (r,) eigenvalues of B (>= 0)
    U: torch.Tensor        # (n, r) orthonormal eigenvector basis Q V of K_hat


def _lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Least squares through the SVD with rcond = eps * max(a.shape), the
    rule of jnp.linalg.lstsq; the same on the CPU and on the card."""
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    rcond = torch.finfo(a.dtype).eps * max(a.shape)
    mask = s >= rcond * s[0]
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))[:, None]
    return vt.T @ (s_inv * (u.T @ b))


def one_pass_core(W: torch.Tensor, omega_t_q_fn, r: int) -> LowRankEig:
    """Lines 3-6 of Alg. 1 given the sketch W = K Omega.

    omega_t_q_fn: Q -> Omega^T Q (n x r' -> r' x r'), so the core solve
    never revisits K and never materializes Omega. Like the JAX package it
    keeps all r' columns of Q for the solve (Halko et al. sec. 5.5) and
    truncates to r at the eigendecomposition.
    """
    Q, _ = torch.linalg.qr(W)                     # (n, r')
    QtO = omega_t_q_fn(Q).T                       # (r', r')
    QtW = Q.T @ W                                 # (r', r')
    # B QtO = QtW  =>  QtO^T B^T = QtW^T ; B symmetric in exact arithmetic.
    Bt = _lstsq(QtO.T, QtW.T)
    B = 0.5 * (Bt + Bt.T)
    evals, V = torch.linalg.eigh(B)
    evals = torch.clamp(torch.flip(evals, dims=(0,)), min=0.0)
    V = torch.flip(V, dims=(1,))
    U = Q @ V[:, :r]
    Y = torch.sqrt(evals[:r])[:, None] * U.T
    return LowRankEig(Y=Y, Q=Q[:, :r], eigvals=evals[:r], U=U)
