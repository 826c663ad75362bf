"""Incremental one-pass sketch accumulation: fit as a stream of chunks.

The sketch W = K Omega is a sum over entries of K, so it accumulates
exactly: when a block of points C arrives after q applied points, the only
new kernel values are the symmetric border

    Kc = kappa([X_applied | C], C)          (q + b, b)

and the sketch update splits along it:

    W[q:q+b]  = Kc^T Omega[:q+b]            new rows
    W[:q]    += Kc[:q] @ Omega[q:q+b]       symmetric cross-term into the
                                            old rows

Row norms of K accumulate the same way (a streaming ||K||_F^2).

Chunk-size invariance comes from block-granular staging: `add()` buffers
incoming columns and applies updates only in exact `block`-wide slices;
the ragged tail is applied on a copy at `eig()` time, so the update
sequence never depends on how callers chunked their data. One-shot fit
goes through this same accumulator (api/backends.py).

The sketch is built at a fixed `capacity` (the SRHT pads to the next power
of two of the capacity), so the test matrix, and with it the fit, is a
function of (draws, capacity) alone. Unlike the JAX package, which is
functional, the port updates W, the row norms and a preallocated
(p, capacity) data buffer in place, which saves a copy of each per block.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from repro_torch.core.kernels_fn import KernelFn
from repro_torch.core.sketch import (GaussianSketch, LowRankEig, SRHT,
                                     make_gaussian, make_srht, one_pass_core,
                                     srht_apply_t, srht_apply_t_prefix,
                                     srht_rows, truncate_sketch)
from repro_torch.distributed.fit import ShardedFitEngine
from repro_torch.kernels.fit_sketch.ops import fit_sketch_op

Sketch = Union[SRHT, GaussianSketch]


def _sketch_device(sketch: Sketch) -> torch.device:
    return (sketch.signs if isinstance(sketch, SRHT)
            else sketch.omega).device


class SketchAccumulator:
    """Streaming accumulation of the one-pass sketch state.

    kernel:      KernelFn kappa(X, Z)
    capacity:    maximum total columns this accumulator will ever hold;
                 the SRHT/Gaussian test matrix is sized to it up front
    r:           target rank of `eig()`
    generator:   torch.Generator the test matrix is drawn from, on the
                 accumulator's device; or
    sketch:      a ready SRHT / GaussianSketch (the draws of another
                 implementation), whose device the state then lives on
    oversampling/block/sketch_type/fwht_fn/truncate_basis: the one-pass
                 backend knobs (api/backends.py). When fwht_fn is None,
                 every Omega^T M of the canonical update and of the
                 eigensolve runs the srht_t kernel (the plain version for
                 CPU tensors); a given fwht_fn (the kernel fwht_op, or the
                 plain fwht_ref) runs the unfused pad / sign / transform /
                 gather composition through it
    policy:      optional ComputePolicy. policy.mesh routes every block
                 update through the sharded engine (distributed/fit.py,
                 the bits of the unsharded fit at world size 1); fit_fused
                 routes it through the fused fit_sketch kernel.
    kernel_statics: (kind, gamma, degree) for the fused kernel; required
                 whenever fit_fused resolves on.
    """

    def __init__(self, kernel: KernelFn, capacity: int, r: int, *,
                 generator: Optional[torch.Generator] = None,
                 sketch: Optional[Sketch] = None, oversampling: int = 10,
                 block: int = 512, sketch_type: str = "srht",
                 fwht_fn: Optional[Callable] = None,
                 truncate_basis: bool = False,
                 policy=None, kernel_statics=None):
        capacity = int(capacity)
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        r_prime = int(r) + int(oversampling)
        if sketch is None:
            if generator is None:
                raise ValueError("SketchAccumulator needs a generator or a "
                                 "sketch")
            if sketch_type == "srht":
                sketch = make_srht(capacity, r_prime, generator)
            elif sketch_type == "gaussian":
                sketch = make_gaussian(capacity, r_prime, generator)
            else:
                raise ValueError(f"unknown sketch_type {sketch_type!r}")
        _check_sketch(sketch, capacity, r_prime)
        dev = _sketch_device(sketch)
        self._bind(kernel, int(r), sketch,
                   torch.zeros((capacity, r_prime), dtype=torch.float32,
                               device=dev),
                   torch.zeros((capacity,), dtype=torch.float32, device=dev),
                   0, None, block=block, fwht_fn=fwht_fn,
                   truncate_basis=truncate_basis, policy=policy,
                   kernel_statics=kernel_statics)

    def _bind(self, kernel, r, sketch, W, row_norms2, n_applied, X, *,
              block, fwht_fn=None, truncate_basis=False, policy=None,
              kernel_statics=None) -> None:
        self.kernel = kernel
        self.r = int(r)
        self.sketch = sketch
        self.device = _sketch_device(sketch)
        self.W = W
        self.row_norms2 = row_norms2
        self.n_applied = int(n_applied)
        self._Xbuf: Optional[torch.Tensor] = None
        self._n_added = 0
        self._omega: Optional[torch.Tensor] = None
        self.block = int(block)
        self.fwht_fn = fwht_fn
        self.truncate_basis = bool(truncate_basis)
        self.reeigs = 0
        self.last_fro2 = 0.0
        self.last_approx_err = 0.0
        self.policy = policy
        self.kernel_statics = kernel_statics
        self._fit_fused = (policy is not None
                           and policy.resolve_fit(self.device))
        if self._fit_fused and kernel_statics is None:
            raise ValueError(
                "fit_fused needs the kernel statics (kind, gamma, degree) "
                "for the fit_sketch kernel — fit through KernelKMeans "
                "(which passes them from the spec) or give "
                "SketchAccumulator kernel_statics=")
        # Under a mesh, self.W / self.row_norms2 hold this rank's padded
        # slabs; eig() and state_arrays() gather the logical rows.
        self._engine = None
        if policy is not None and policy.mesh is not None:
            self._engine = ShardedFitEngine(
                policy.mesh, policy.mesh_axis, sketch, kernel,
                fit_fused=self._fit_fused, kernel_statics=kernel_statics)
            self.W = self._engine.pad_rows(W)
            self.row_norms2 = self._engine.pad_vec(row_norms2)
        if X is not None:
            self._store(torch.as_tensor(X, dtype=torch.float32,
                                        device=self.device))

    @classmethod
    def from_arrays(cls, kernel: KernelFn, r: int, sketch: Sketch,
                    W: torch.Tensor, row_norms2: torch.Tensor,
                    n_applied: int, X: Optional[torch.Tensor], *,
                    block: int = 512, fwht_fn: Optional[Callable] = None,
                    truncate_basis: bool = False, policy=None,
                    kernel_statics=None) -> "SketchAccumulator":
        """Rebuild an accumulator around existing state (W, row norms and
        the data added so far), on the sketch's device."""
        dev = _sketch_device(sketch)
        W = torch.as_tensor(W, dtype=torch.float32, device=dev).clone()
        _check_sketch(sketch, int(W.shape[0]), int(W.shape[1]))
        acc = cls.__new__(cls)
        acc._bind(kernel, r, sketch, W,
                  torch.as_tensor(row_norms2, dtype=torch.float32,
                                  device=dev).clone(),
                  n_applied, X, block=block, fwht_fn=fwht_fn,
                  truncate_basis=truncate_basis, policy=policy,
                  kernel_statics=kernel_statics)
        if acc.n_added < acc.n_applied or acc.n_added > acc.capacity:
            raise ValueError(
                f"inconsistent stream state: {acc.n_added} columns of data "
                f"for n_applied={acc.n_applied}, capacity={acc.capacity}")
        return acc

    @classmethod
    def from_model(cls, model, *, device=None,
                   fwht_fn: Optional[Callable] = None, policy=None,
                   kernel_statics=None) -> "SketchAccumulator":
        """Resume accumulation from a FittedModel with streaming state.

        The stream_* leaves carry the applied sketch state; the columns
        of X_train past stream_counts[0] are the staged tail and re-enter
        the buffer, so resume-then-eig reproduces the saved model's eig.
        The state lands on `device` (the model's when None).
        """
        spec = model.spec
        if getattr(model, "stream_counts", None) is None:
            raise ValueError(
                "model carries no streaming state (stream_counts is "
                "missing): only one-pass fits made through "
                "SketchAccumulator can resume partial_fit")
        dev = torch.device(device) if device is not None else model.device
        n_applied, capacity = (int(v) for v in model.stream_counts)

        def on(t, dtype=torch.float32):
            return torch.as_tensor(t, device=dev).to(dtype)

        if spec.sketch_type == "srht":
            sketch: Sketch = SRHT(signs=on(model.sketch_signs),
                                  rows=on(model.sketch_rows, torch.int64),
                                  n=capacity,
                                  n_pad=int(model.sketch_signs.shape[0]))
        elif spec.sketch_type == "gaussian":
            sketch = GaussianSketch(omega=on(model.sketch_omega))
        else:
            raise ValueError(
                f"backend {spec.backend!r} has no streaming sketch state")
        return cls.from_arrays(
            model.kernel_fn(), spec.r, sketch, model.stream_w,
            model.stream_row_norms2, n_applied, on(model.X_train),
            block=spec.block, fwht_fn=fwht_fn,
            truncate_basis=bool(
                spec.backend_params.get("truncate_basis", False)),
            policy=policy, kernel_statics=kernel_statics)

    # -- views -----------------------------------------------------------

    @property
    def capacity(self) -> int:
        return (self.sketch.n if isinstance(self.sketch, SRHT)
                else int(self.sketch.omega.shape[0]))

    @property
    def r_prime(self) -> int:
        return int(self.W.shape[1])

    @property
    def n_added(self) -> int:
        """Total columns added (applied + staged)."""
        return self._n_added

    @property
    def n_pending(self) -> int:
        """Staged columns not yet folded into the canonical W."""
        return self.n_added - self.n_applied

    @property
    def X_all(self) -> torch.Tensor:
        """All columns added so far, (p, n_added): the model's X_train."""
        if self._Xbuf is None:
            raise RuntimeError("no data accumulated; call add() first")
        return self._Xbuf[:, :self._n_added]

    # -- accumulation ----------------------------------------------------

    def _store(self, X_chunk: torch.Tensor) -> None:  # hot-path
        b = int(X_chunk.shape[1])
        if self._Xbuf is None:
            self._Xbuf = torch.zeros((X_chunk.shape[0], self.capacity),
                                     dtype=torch.float32, device=self.device)
        self._Xbuf[:, self._n_added:self._n_added + b] = X_chunk
        self._n_added += b

    def add(self, X_chunk) -> "SketchAccumulator":
        """Fold one data chunk (p, b) in; applies any full blocks now."""
        X_chunk = torch.as_tensor(X_chunk, dtype=torch.float32,
                                  device=self.device)
        if X_chunk.dim() != 2 or X_chunk.shape[1] < 1:
            raise ValueError(f"chunk must be (p, b>=1), got "
                             f"{tuple(X_chunk.shape)}")
        if self._Xbuf is not None and X_chunk.shape[0] != self._Xbuf.shape[0]:
            raise ValueError(f"chunk has p={X_chunk.shape[0]}, accumulator "
                             f"holds p={self._Xbuf.shape[0]}")
        if self.n_added + int(X_chunk.shape[1]) > self.capacity:
            raise ValueError(
                f"capacity {self.capacity} exceeded: have {self.n_added} "
                f"columns, chunk adds {int(X_chunk.shape[1])}")
        self._store(X_chunk)
        while self.n_added - self.n_applied >= self.block:
            self._apply(self.W, self.row_norms2, self.n_applied, self.block)
            self.n_applied += self.block
        return self

    def _apply(self, W: torch.Tensor, row_norms2: torch.Tensor, q: int,
               b: int) -> None:
        """One block update, in place: fold columns [q, q+b) of the data
        into (W, row_norms2). A mesh policy routes it through the sharded
        engine, fit_fused through the fused fit_sketch kernel; otherwise
        the canonical update."""
        if self._engine is not None:
            self._engine.apply(self._Xbuf, W, row_norms2, q, b)
            return
        if self._fit_fused:
            self._apply_fused(W, row_norms2, q, b)
            return
        X = self._Xbuf
        Kc = self.kernel(X[:, :q + b], X[:, q:q + b])      # (q+b, b)
        if isinstance(self.sketch, SRHT):
            # Rows past q + b of the capacity stripe are zero.
            new_rows = srht_apply_t_prefix(self.sketch, Kc, self.fwht_fn).T
            cross = srht_rows(self.sketch, q, q + b)
        else:
            new_rows = Kc.T @ self.sketch.omega[:q + b]
            cross = self.sketch.omega[q:q + b]
        W[q:q + b] = new_rows
        row_norms2[q:q + b] = torch.sum(Kc * Kc, dim=0)
        if q:
            W[:q] += Kc[:q] @ cross
            row_norms2[:q] += torch.sum(Kc[:q] * Kc[:q], dim=1)

    def _omega_rows(self) -> torch.Tensor:
        """The materialized (capacity, r') Omega, made once: the fused
        kernel contracts row prefixes of it (srht_rows is elementwise, so
        a slice of it has the bits of srht_rows over the slice)."""
        if self._omega is None:
            self._omega = (srht_rows(self.sketch, 0, self.capacity)
                           if isinstance(self.sketch, SRHT)
                           else self.sketch.omega.contiguous())
        return self._omega

    def _apply_fused(self, W, row_norms2, q, b) -> None:
        """Block update through the fused fit_sketch kernel: gram block and
        every contraction of it in one pass, the (q+b, b) block never in
        memory."""
        kind, gamma, degree = self.kernel_statics
        X = self._Xbuf
        Omega = self._omega_rows()
        new_rows, delta, rn_rows, rn_cols = fit_sketch_op(
            X[:, :q + b], Omega[:q + b], X[:, q:q + b], Omega[q:q + b],
            kind=kind, gamma=float(gamma), degree=int(degree))
        W[q:q + b] = new_rows
        row_norms2[q:q + b] = rn_cols
        if q:
            W[:q] += delta[:q]
            row_norms2[:q] += rn_rows[:q]

    def _effective_state(self):
        """(W, row_norms2, n_eff) with the staged tail applied on a copy:
        the canonical block alignment is never disturbed, so later adds
        keep the chunk-invariant update sequence."""
        tail = self.n_added - self.n_applied
        if tail == 0:
            W, rn, n_eff = self.W, self.row_norms2, self.n_applied
        else:
            W, rn = self.W.clone(), self.row_norms2.clone()
            self._apply(W, rn, self.n_applied, tail)
            n_eff = self.n_added
        return self._logical(W), self._logical(rn), n_eff

    def _logical(self, t: torch.Tensor) -> torch.Tensor:
        """The (capacity, ...) view of W or the row norms: under a mesh,
        every rank's slab gathered (collective)."""
        return t if self._engine is None else self._engine.gather(t)

    # -- eigendecomposition ----------------------------------------------

    def eig(self, r: Optional[int] = None) -> LowRankEig:
        """Alg. 1 lines 3-6 on the effective sketch (tail included).

        Also refreshes `last_fro2` (streaming ||K||_F^2) and
        `last_approx_err` (sqrt(1 - sum(eigvals^2) / ||K||_F^2)).
        """
        r = self.r if r is None else int(r)
        W, rn, n_eff = self._effective_state()
        if n_eff < 1:
            raise RuntimeError("no data accumulated; call add() first")
        Wn = W[:n_eff]
        if self.truncate_basis:
            Wn = truncate_sketch(Wn, r)
        if isinstance(self.sketch, SRHT):
            def omega_t_q(Q):
                if n_eff < self.capacity:
                    Q = torch.nn.functional.pad(
                        Q, (0, 0, 0, self.capacity - n_eff))
                return srht_apply_t(self.sketch, Q, self.fwht_fn)
        else:
            def omega_t_q(Q):
                return self.sketch.omega[:n_eff].T @ Q
        out = one_pass_core(Wn, omega_t_q, r)
        fro2 = float(torch.sum(rn))
        tail2 = max(fro2 - float(torch.sum(out.eigvals ** 2)), 0.0)
        self.last_fro2 = fro2
        self.last_approx_err = (tail2 / fro2) ** 0.5 if fro2 > 0 else 0.0
        self.reeigs += 1
        return out

    # -- state -----------------------------------------------------------

    def state_arrays(self) -> Dict[str, torch.Tensor]:
        """The sketch state, keyed as FittedModel leaves. Staged columns
        are not separate state: they are the trailing columns of X_train,
        past stream_counts[0]."""
        if isinstance(self.sketch, SRHT):
            st = {"sketch_signs": self.sketch.signs,
                  "sketch_rows": self.sketch.rows}
        else:
            st = {"sketch_omega": self.sketch.omega}
        st["stream_w"] = self._logical(self.W).clone()
        st["stream_row_norms2"] = self._logical(self.row_norms2).clone()
        st["stream_counts"] = torch.tensor([self.n_applied, self.capacity],
                                           dtype=torch.int32)
        return st

    def __repr__(self) -> str:
        kind = "srht" if isinstance(self.sketch, SRHT) else "gaussian"
        return (f"SketchAccumulator({kind}, r={self.r}, "
                f"r'={self.r_prime}, {self.n_added}/{self.capacity} cols, "
                f"{self.n_pending} pending, {self.device})")


def _check_sketch(sketch: Sketch, capacity: int, r_prime: int) -> None:
    if isinstance(sketch, SRHT):
        ok = (sketch.n == capacity and sketch.r_prime == r_prime
              and sketch.signs.shape[0] == sketch.n_pad >= capacity)
    else:
        ok = tuple(sketch.omega.shape) == (capacity, r_prime)
    if not ok:
        raise ValueError(f"sketch does not fit capacity={capacity}, "
                         f"r'={r_prime}: {sketch!r}"[:300])
