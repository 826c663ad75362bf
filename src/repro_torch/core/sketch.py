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
PyTorch version (kernels/fwht/ref.py). By default an SRHT apply runs the
kernels (kernels/fwht/ops.py: srht_t_op for Omega^T M, fwht_op for
Omega V), which take the plain versions for CPU tensors; a `fwht_fn=`
hook, as the JAX package's takes its Pallas kernel, runs the unfused
pad / sign / transform / gather composition through that transform
instead (fwht_fn=fwht for the plain path on the card). Random draws (SRHT
signs/rows, the Gaussian Omega) come from an explicit torch.Generator, or
from outside: SRHT and GaussianSketch are plain tuples of tensors, so a
caller can hand in the draws of another implementation.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.kernels_fn import KernelFn, stripe_iterator
from repro_torch.kernels.fwht.ops import fwht_op, srht_t_op
from repro_torch.kernels.fwht.ref import fwht_ref as fwht


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


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


def srht_apply_t(srht: SRHT, M: torch.Tensor,
                 fwht_fn: Optional[Callable] = None) -> torch.Tensor:
    """Omega^T M = R^T H (D M) for M of shape (n, b) -> (r', b).

    Scale rows by D, FWHT over the zero-padded row axis, gather the
    sampled rows: in one kernel (srht_t_op) by default, or composed around
    `fwht_fn` when one is given.
    """
    n = M.shape[0]
    if n != srht.n:
        raise ValueError(f"expected {srht.n} rows, got {n}")
    return srht_apply_t_prefix(srht, M, fwht_fn)


def srht_apply_t_prefix(srht: SRHT, M: torch.Tensor,
                        fwht_fn: Optional[Callable] = None) -> torch.Tensor:
    """Omega[:m]^T M for M of shape (m, b), m <= n: srht_apply_t of M with
    zero rows below it, which neither route reads or stores."""
    m = M.shape[0]
    if m > srht.n:
        raise ValueError(f"expected at most {srht.n} rows, got {m}")
    if fwht_fn is None:
        # Row-major for the kernel: a QR factor on the card is column-major.
        return srht_t_op(M.contiguous(), srht.signs, srht.rows, srht.n_pad)
    Mp = torch.nn.functional.pad(M, (0, 0, 0, srht.n_pad - m))
    # Row-major for the kernel: a QR factor on the card is column-major.
    Mp = fwht_fn((Mp * srht.signs[:, None]).contiguous())
    return Mp[srht.rows]


def srht_apply(srht: SRHT, V: torch.Tensor,
               fwht_fn: Optional[Callable] = None) -> torch.Tensor:
    """Omega V for V of shape (r', b) -> (n, b). (D H R V; H, D symmetric.)
    The transform is fwht_fn, the kernel fwht_op by default."""
    fwht_fn = fwht_fn or fwht_op
    scatter = torch.zeros((srht.n_pad, V.shape[1]), dtype=V.dtype,
                          device=V.device)
    scatter[srht.rows] = V
    out = fwht_fn(scatter) * srht.signs[:, None]
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


class SketchedEig(NamedTuple):
    """randomized_eig's result with the sketch state it consumed (SRHT
    or GaussianSketch), which with X fully determines the fit."""
    eig: LowRankEig
    sketch: Tuple


def sketch_stream(kernel: KernelFn, X: torch.Tensor, srht: SRHT,
                  block: int = 512,
                  fwht_fn: Optional[Callable] = None) -> torch.Tensor:
    """W = K Omega in one streaming pass over column stripes of K: stripe
    j of K gives rows j of W. K is never materialized."""
    W = torch.zeros((srht.n, srht.r_prime), dtype=torch.float32,
                    device=X.device)
    for start, stripe in stripe_iterator(kernel, X, block):
        W[start:start + stripe.shape[1]] = srht_apply_t(srht, stripe,
                                                        fwht_fn).T
    return W


def truncate_sketch(W: torch.Tensor, r: int) -> torch.Tensor:
    """Alg. 1 line 3 read literally: W projected onto its r leading left
    singular vectors before the core solve (the truncate_basis ablation;
    it loses the oversampling benefit, see one_pass_core)."""
    U, S, Vt = torch.linalg.svd(W, full_matrices=False)
    return (U[:, :r] * S[None, :r]) @ Vt[:r]


def randomized_eig_with_state(kernel: KernelFn, X: torch.Tensor, r: int,
                              oversampling: int = 10, block: int = 512,
                              sketch_type: str = "srht",
                              fwht_fn: Optional[Callable] = None,
                              truncate_basis: bool = False, *,
                              generator: Optional[torch.Generator] = None,
                              sketch=None) -> SketchedEig:
    """One-pass randomized eigendecomposition of K = kappa(X, X), with the
    sketch it drew from `generator` or was handed (`sketch`)."""
    n = X.shape[1]
    r_prime = r + oversampling
    if sketch is None:
        if generator is None:
            raise ValueError("randomized_eig needs a generator or a sketch")
        if sketch_type == "srht":
            sketch = make_srht(n, r_prime, generator, device=X.device)
        elif sketch_type == "gaussian":
            sketch = make_gaussian(n, r_prime, generator, device=X.device)
        else:
            raise ValueError(f"unknown sketch_type {sketch_type!r}")
    if isinstance(sketch, SRHT):
        W = sketch_stream(kernel, X, sketch, block, fwht_fn)

        def omega_t_q(Q):
            return srht_apply_t(sketch, Q, fwht_fn)
    else:
        W = torch.zeros((n, r_prime), dtype=torch.float32, device=X.device)
        for start, stripe in stripe_iterator(kernel, X, block):
            W[start:start + stripe.shape[1]] = stripe.T @ sketch.omega

        def omega_t_q(Q):
            return sketch.omega.T @ Q
    if truncate_basis:
        W = truncate_sketch(W, r)
    return SketchedEig(eig=one_pass_core(W, omega_t_q, r), sketch=sketch)


def randomized_eig(kernel: KernelFn, X: torch.Tensor, r: int,
                   oversampling: int = 10, block: int = 512,
                   sketch_type: str = "srht",
                   fwht_fn: Optional[Callable] = None,
                   truncate_basis: bool = False, *,
                   generator: Optional[torch.Generator] = None,
                   sketch=None) -> LowRankEig:
    """randomized_eig_with_state without the sketch state."""
    return randomized_eig_with_state(
        kernel, X, r, oversampling, block, sketch_type, fwht_fn,
        truncate_basis, generator=generator, sketch=sketch).eig
