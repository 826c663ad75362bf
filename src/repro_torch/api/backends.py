"""The one-pass approximation backends behind one registry.

Every backend linearizes the kernel matrix K = kappa(X, X) at rank r and
returns the same `Embedding`, so the estimator (KernelKMeans) and the
serving stack do not depend on which one ran:

    Y        (r, n)      linearized training samples: K_hat ~= Y^T Y
    U        (n, r)      orthonormal eigenvector basis of the extension
                         operator (rows index the training points)
    eigvals  (r,)        matching eigenvalues (descending, >= 0)
    state    dict        the sketch state, kept in the FittedModel

This slice holds `onepass-srht` and `onepass-gaussian`; `fit_memory_bytes`
gives each one's dominant fit-time working set (the paper's comparison
axis): the (n, r') sketch, plus the equally-sized dense Omega for the
Gaussian one.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.stream.accumulate import SketchAccumulator


class Embedding(NamedTuple):
    """What every backend's fit returns; see module docstring."""
    Y: torch.Tensor
    U: torch.Tensor
    eigvals: torch.Tensor
    state: Optional[Dict[str, torch.Tensor]] = None

    @property
    def arrays(self) -> Dict[str, torch.Tensor]:
        """The state dict, never-None view."""
        return self.state or {}


class _Backend:
    """Registry entry: a named (fit, fit_memory_bytes) pair."""

    def __init__(self, name: str, fit: Callable, memory: Callable):
        self.name = name
        self._fit = fit
        self._memory = memory

    def fit(self, generator, kernel, X, r, *, block=512,
            **params) -> Embedding:
        return self._fit(generator, kernel, X, r, block=block, **params)

    def fit_memory_bytes(self, n: int, r: int, **params) -> int:
        return int(self._memory(n, r, **params))

    def __repr__(self) -> str:
        return f"<Approximator {self.name!r}>"


_BACKENDS: Dict[str, _Backend] = {}


def get_backend(name: str) -> _Backend:
    if name not in _BACKENDS:
        raise ValueError(f"unknown backend {name!r}; "
                         f"have {available_backends()}")
    return _BACKENDS[name]


def available_backends() -> list:
    return sorted(_BACKENDS)


def fit_memory_bytes(name: str, n: int, r: int, **params) -> int:
    """Dominant fit-time working set of `name` at (n, r), float32."""
    return get_backend(name).fit_memory_bytes(n, r, **params)


def _onepass(sketch_type: str):
    def fit(generator, kernel, X, r, *, block=512, oversampling=10,
            capacity=None, sketch=None, policy=None,
            kernel_statics=None, clock=None) -> Embedding:
        # One-shot fit is a single-chunk pass through the streaming
        # accumulator: the same block-granular update sequence a chunked
        # ingest replays. `sketch` hands in ready draws (another
        # implementation's SRHT or Omega) in place of the generator's;
        # `clock` (a StepClock) marks the end of each step.
        acc = SketchAccumulator(kernel, capacity or X.shape[1], r,
                                generator=generator, sketch=sketch,
                                oversampling=oversampling, block=block,
                                sketch_type=sketch_type, policy=policy,
                                kernel_statics=kernel_statics)
        acc.add(X)
        if clock is not None:
            clock.mark("block_updates")
        eig = acc.eig()
        if clock is not None:
            clock.mark("eig")
        return Embedding(Y=eig.Y, U=eig.U, eigvals=eig.eigvals,
                         state=acc.state_arrays())
    return fit


_BACKENDS["onepass-srht"] = _Backend(
    "onepass-srht", _onepass("srht"),
    lambda n, r, oversampling=10, **_: 4 * n * (r + oversampling))
_BACKENDS["onepass-gaussian"] = _Backend(
    "onepass-gaussian", _onepass("gaussian"),
    # Sketch W plus the equally-sized dense Omega it is multiplied by.
    lambda n, r, oversampling=10, **_: 8 * n * (r + oversampling))
