"""Distributed FWHT: the hypercube butterfly across the ranks of a mesh.

The transform's rows are sharded over the mesh's data axis, and
H_n = H_dev (x) H_local factors it:

  1. a local FWHT of each rank's rows (the fwht kernel on the card),
  2. log2(ndev) butterfly stages across ranks: each exchanges its whole
     slab with its XOR partner (one paired send / receive) and combines
     +/-.

Stage k moves n/ndev * c elements per rank, log2(ndev) * n * c / ndev in
all: the classic hypercube schedule. Every stage is the single-host
radix-2 stage (a + b on the low side, a - b on the high), in the same
order h = 1, 2, 4, ..., so the result has the bits of one FWHT over all n
rows. The one-pass sketch uses it to precondition a row-sharded kernel
stripe without gathering it.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.kernels.fwht.ops import fwht_op
from repro_torch.launch.mesh import MeshAxis, mesh_axis


def butterfly_stages(xl: torch.Tensor, ax: MeshAxis) -> torch.Tensor:
    """H_dev across the ranks of `ax`: xl is this rank's (n/ndev, ...) row
    slab after its local (unnormalized) FWHT. Shared by distributed_fwht
    and the sharded fit engine (distributed/fit.py)."""
    h = 1
    while h < ax.size:
        partner = ax.peer(ax.index ^ h)
        xl = xl.contiguous()
        other = torch.empty_like(xl)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, xl, partner, ax.group),
                dist.P2POp(dist.irecv, other, partner, ax.group)]):
            req.wait()
        xl = xl + other if ax.index & h == 0 else other - xl
        h *= 2
    return xl


def f32_sqrt(n: int, like: torch.Tensor) -> torch.Tensor:
    """The f32 sqrt(n) the plain FWHT divides by, as a tensor on like's
    device: a CUDA tensor divided by a Python float is multiplied by its
    reciprocal, which changes the bits. Making it copies to the device and
    waits for it, so a loop makes it once."""
    return torch.sqrt(torch.tensor(float(n), dtype=like.dtype,
                                   device=like.device))


class RowGather:
    """R^T of a row-sharded (n, c) matrix: the sampled global `rows`, each
    from the rank that holds it (this rank holds [lo, hi)), then summed
    over the ranks into (r', c). Which rows are this rank's is found once,
    so a gather waits for nothing on the host."""

    def __init__(self, rows: torch.Tensor, lo: int, hi: int):
        self.dst = torch.nonzero((rows >= lo) & (rows < hi)).flatten()
        self.src = rows[self.dst] - lo
        self.count = int(rows.shape[0])

    def local(self, Fl: torch.Tensor) -> torch.Tensor:
        """This rank's part: its sampled rows, zeros elsewhere."""
        sel = torch.zeros((self.count, Fl.shape[1]), dtype=Fl.dtype,
                          device=Fl.device)
        return sel.index_copy_(0, self.dst, Fl.index_select(0, self.src))

    def __call__(self, ax: MeshAxis, Fl: torch.Tensor) -> torch.Tensor:
        return ax.all_reduce(self.local(Fl))


def distributed_fwht(xl: torch.Tensor, mesh, axis: str = "data",
                     normalize: bool = True,
                     local_fwht: Optional[Callable] = None) -> torch.Tensor:
    """FWHT along dim 0 of an (n, c) matrix whose rows are sharded over
    `axis`: xl is this rank's (n/ndev, c) slab, rank i holding rows
    [i n/ndev, (i+1) n/ndev). Returns this rank's slab of the transform.

    n and the axis size must be powers of two. `local_fwht` (an
    unnormalized transform) defaults to the fwht kernel, fwht_op, which
    runs its plain version for CPU tensors. Collective: every rank of the
    axis calls it.
    """
    ax = mesh_axis(mesh, axis)
    ax.check("distributed_fwht", xl)
    ndev = ax.size
    n = xl.shape[0] * ndev
    if n & (n - 1) or ndev & (ndev - 1) or n == 0:
        raise ValueError(f"n={n} and axis size={ndev} must be powers of two")
    lf = local_fwht or (lambda v: fwht_op(v.contiguous(), normalize=False))
    xl = butterfly_stages(lf(xl), ax)
    if normalize:
        xl = xl / f32_sqrt(n, xl)
    return xl
