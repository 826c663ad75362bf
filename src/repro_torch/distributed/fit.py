"""The one-pass fit sharded over the ranks of a mesh.

Each rank owns a row slab [lo, lo + L) of the padded sample space (L =
N / ranks; N is the SRHT's n_pad, or the capacity rounded up to a multiple
of the ranks for a Gaussian sketch) and its slab of W and of the row
norms. A block update of the streaming accumulator (stream/accumulate.py),
columns [q, q + b), touches only the slab's rows below q + b, the valid
rows:

  default   Kc = kappa(X[:, lo:valid], C)       (m, b) local stripe
            new rows: signs, local fwht_op, butterfly_stages
            (distributed/dfwht.py), / sqrt(N), the sampled rows this rank
            holds (Gaussian: Kc^T Omega[lo:valid])
            norm ledger: the column sums of Kc * Kc
            cross term: Kc[:applied] @ Omega[q:q+b], local
  fused     fit_sketch_op on the slab's valid rows with its own Omega
            rows: new_rows and rn_cols as partial sums, the rest local

Each route sums its (r', b) new rows and its (b,) column norms over the
ranks in ONE all_reduce: r' b + b floats per block, independent of n,
the paper's point restated for the fit (the butterfly adds log2(ranks)
slab exchanges on the default route). The JAX engine runs a fixed L-row slab under
masks, as shard_map needs static shapes; eagerly the slab's valid rows
are a slice, so rows past q + b are never computed. At world size 1 the
slice is the canonical update's (q + b, b) border, and every step is the
canonical arithmetic in its order (the FWHT's stages run in the plain
version's order, a gathered row sums one nonzero with zeros, the norm
ledger reduces the canonical slice): the sharded fit has the bits of the
unsharded one on both routes. Across ranks the reductions re-associate,
so there the contract is close agreement; on a fixed mesh chunked ==
one-shot and resume == live hold bit for bit.

The eigensolve stays replicated: `gather` all-gathers the small (cap, r')
sketch, the only thing worth gathering, and every rank runs the canonical
core on it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.kernels_fn import KernelFn
from repro_torch.core.sketch import SRHT, srht_rows
from repro_torch.distributed.dfwht import (RowGather, butterfly_stages,
                                          f32_sqrt)
from repro_torch.kernels.fit_sketch.ops import fit_sketch_op
from repro_torch.kernels.fwht.ops import fwht_op
from repro_torch.launch.mesh import mesh_axis


class ShardedFitEngine:
    """Sharded executor of SketchAccumulator block updates.

    mesh, axis:   the DeviceMesh and the dim the rows shard over
    sketch:       the accumulator's SRHT or GaussianSketch (every rank
                  holds the same draws)
    kernel:       KernelFn kappa(X, Z)
    fit_fused:    run each block through the fit_sketch kernel
    kernel_statics: (kind, gamma, degree), required when fit_fused

    W and the row norms live as this rank's (L, r') and (L,) slabs
    (`pad_rows`, `pad_vec`); `apply` updates them in place from the
    accumulator's data buffer, of which it reads the slab's columns and
    the block's; `gather` returns the logical (capacity, ...) view.
    """

    def __init__(self, mesh, axis: str, sketch, kernel: KernelFn, *,
                 fit_fused: bool = False,
                 kernel_statics: Optional[Tuple[str, float, int]] = None):
        self.ax = ax = mesh_axis(mesh, axis)
        d = ax.size
        self.sketch = sketch
        self.kernel = kernel
        self.fit_fused = bool(fit_fused)
        self.kernel_statics = kernel_statics
        if fit_fused and kernel_statics is None:
            raise ValueError(
                "fit_fused needs the kernel statics (kind, gamma, degree) "
                "for the fit_sketch kernel — fit through KernelKMeans "
                "(which passes them from the spec) or give "
                "SketchAccumulator kernel_statics=")
        self._is_srht = isinstance(sketch, SRHT)
        if self._is_srht:
            self.capacity = int(sketch.n)
            N = int(sketch.n_pad)
            if d & (d - 1):
                raise ValueError(f"sharded SRHT fit needs a power-of-two "
                                 f"rank count, got {d}")
            if d > N:
                raise ValueError(f"{d} ranks cannot shard the {N}-row "
                                 f"padded sample space")
            ax.check("ShardedFitEngine", sketch.signs)
        else:
            self.capacity = int(sketch.omega.shape[0])
            N = -(-self.capacity // d) * d
            ax.check("ShardedFitEngine", sketch.omega)
        self.N = N
        self.L = N // d
        self.lo = ax.index * self.L
        self.hi = self.lo + self.L
        self._omega_all: Optional[torch.Tensor] = None
        if self._is_srht:
            self._root_n = f32_sqrt(N, sketch.signs)
            self._gather = RowGather(sketch.rows, self.lo, self.hi)

    # -- placement ---------------------------------------------------------

    def _rows(self) -> Tuple[int, int]:
        """This rank's rows of the logical (capacity) space."""
        return min(self.lo, self.capacity), min(self.hi, self.capacity)

    def pad_rows(self, W: torch.Tensor) -> torch.Tensor:
        """(capacity, r') -> this rank's (L, r') slab."""
        a, z = self._rows()
        out = torch.zeros((self.L, W.shape[1]), dtype=torch.float32,
                          device=W.device)
        out[:z - a] = W[a:z]
        return out

    def pad_vec(self, v: torch.Tensor) -> torch.Tensor:
        """(capacity,) -> this rank's (L,) slab."""
        a, z = self._rows()
        out = torch.zeros((self.L,), dtype=torch.float32, device=v.device)
        out[:z - a] = v[a:z]
        return out

    def gather(self, slab: torch.Tensor) -> torch.Tensor:
        """Every rank's slab, as the logical [:capacity] rows, on every
        rank: the eig / persist boundary, the only time the sketch moves.
        Collective."""
        return self.ax.all_gather_cat(slab)[:self.capacity]

    def omega(self) -> torch.Tensor:
        """The (capacity, r') Omega, materialized once (O(n r'), the size of
        the gathered sketch): every rank needs a block's own rows, and the
        fused kernel this rank's. srht_rows is elementwise, so a slice has
        the bits of srht_rows over the slice, as in the unsharded fit."""
        if self._omega_all is None:
            self._omega_all = (srht_rows(self.sketch, 0, self.capacity)
                               if self._is_srht
                               else self.sketch.omega.contiguous())
        return self._omega_all

    # -- the block update --------------------------------------------------

    def apply(self, X: torch.Tensor, W: torch.Tensor, rn: torch.Tensor,
              q: int, b: int) -> None:  # hot-path
        """Fold columns [q, q + b) of X (the accumulator's (p, capacity)
        buffer) into this rank's slabs W (L, r') and rn (L,), in place.
        Collective: every rank calls it with the same q and b."""
        lo = self.lo
        m = max(0, min(self.hi, q + b) - lo)        # valid rows: < q + b
        a = max(0, min(self.hi, q) - lo)            # applied rows: < q
        C = X[:, q:q + b]
        if self.fit_fused:
            new_rows, colsum, delta, rn_rows = self._fused(X, C, m, q, b)
        else:
            new_rows, colsum, Kl = self._default(X, C, m, q, b)
        n0, n1 = max(q, lo), min(q + b, self.hi)    # this rank's new rows
        if n1 > n0:
            W[n0 - lo:n1 - lo] = new_rows[n0 - q:n1 - q]
            rn[n0 - lo:n1 - lo] = colsum[n0 - q:n1 - q]
        if a:
            if self.fit_fused:
                W[:a] += delta[:a]
                rn[:a] += rn_rows[:a]
            else:
                W[:a] += Kl[:a] @ self._cross(q, b)
                rn[:a] += torch.sum(Kl[:a] * Kl[:a], dim=1)

    def _cross(self, q: int, b: int) -> torch.Tensor:
        """Omega[q:q+b], the block's own sketch rows."""
        return self.omega()[q:q + b]

    def _default(self, X, C, m: int, q: int, b: int):  # hot-path
        lo = self.lo
        Kl = self.kernel(X[:, lo:lo + m], C)                  # (m, b)
        if self._is_srht:
            # Zero-pad (the mask), then the signs: the canonical order.
            M = torch.zeros((self.L, b), dtype=torch.float32,
                            device=C.device)
            M[:m] = Kl
            M.mul_(self.sketch.signs[lo:self.hi, None])
            F = butterfly_stages(fwht_op(M, normalize=False), self.ax)
            # / sqrt(N) after the gather: elementwise, the same bits.
            part = (self._gather.local(F) / self._root_n).T  # (b, r')
        else:
            part = Kl.T @ self.sketch.omega[lo:lo + m]       # (b, r')
        new_rows, colsum = self.ax.all_reduce_many(
            part, torch.sum(Kl * Kl, dim=0))
        return new_rows, colsum, Kl

    def _fused(self, X, C, m: int, q: int, b: int):  # hot-path
        kind, gamma, degree = self.kernel_statics
        rp = int(self.sketch.rows.shape[0] if self._is_srht
                 else self.sketch.omega.shape[1])
        if m:
            new_rows, delta, rn_rows, rn_cols = fit_sketch_op(
                X[:, self.lo:self.lo + m], self.omega()[self.lo:self.lo + m],
                C, self._cross(q, b), kind=kind, gamma=float(gamma),
                degree=int(degree))
        else:
            zeros = torch.zeros((b, rp + 1), dtype=torch.float32,
                                device=C.device)
            new_rows, rn_cols = zeros[:, :rp], zeros[:, rp]
            delta = rn_rows = None
        new_rows, rn_cols = self.ax.all_reduce_many(new_rows, rn_cols)
        return new_rows, rn_cols, delta, rn_rows
