"""Kernel-approximation backends behind one registry.

Every backend linearizes the kernel matrix K = kappa(X, X) at rank r and
returns the same `Embedding`, so the estimator (KernelKMeans) and the
serving stack do not depend on which one ran:

    Y        (r, n)      linearized training samples: K_hat ~= Y^T Y
    U        (n_ref, r)  orthonormal eigenvector basis of the extension
                         operator; rows index the training points
                         (one-pass / exact) or the Nystrom landmarks
    eigvals  (r,)        matching eigenvalues (descending, >= 0)
    ref      (p, m)|None extension reference points when they are not the
                         training set (the Nystrom landmarks); None means
                         "extend against X_train"
    state    dict        backend state kept in the FittedModel (sketch
                         draws and stream state, landmark indices)

The out-of-sample extension is the same formula for every backend,
y(x) = eigvals^{-1/2} U^T kappa(ref, x) (serve/extend.py): for the
Nystrom backend U and eigvals are the eigenpairs of the landmark gram W_m,
so the formula against the m landmarks reproduces the fitted Y on the
training points and serves at O(m x block) kernel memory per stripe.

Four backends are registered: `onepass-srht` and `onepass-gaussian`
(Alg. 1), `nystrom` (m uniform landmarks) and `exact` (the rank-r
eigendecomposition of the full gram, the accuracy ceiling).
`fit_memory_bytes` gives each one's dominant fit-time working set (the
paper's comparison axis): the (n, r') sketch (plus the equally-sized dense
Omega for the Gaussian one), the (n, m) landmark block C, the (n, n) gram.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Protocol

import torch

from repro_torch.core.exact import exact_eig
from repro_torch.core.kernels_fn import KernelFn
from repro_torch.core.nystrom import nystrom
from repro_torch.stream.accumulate import SketchAccumulator


class Embedding(NamedTuple):
    """What every backend's fit returns; see module docstring."""
    Y: torch.Tensor
    U: torch.Tensor
    eigvals: torch.Tensor
    ref: Optional[torch.Tensor] = None
    state: Optional[Dict[str, torch.Tensor]] = None

    @property
    def arrays(self) -> Dict[str, torch.Tensor]:
        """The state dict, never-None view."""
        return self.state or {}


class Approximator(Protocol):
    """Protocol every registered backend satisfies."""
    name: str

    def fit(self, generator: Optional[torch.Generator], kernel: KernelFn,
            X: torch.Tensor, r: int, *, block: int = 512,
            **params) -> Embedding:
        """Linearize kappa(X, X) at rank r; X is (p, n)."""
        ...

    def fit_memory_bytes(self, n: int, r: int, **params) -> int:
        """Dominant fit-time working-set bytes (float32)."""
        ...


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


def register_backend(name: str, memory: Callable):
    """Decorator: register `fit` under `name` with its memory model."""

    def wrap(fit: Callable) -> Callable:
        _BACKENDS[name] = _Backend(name, fit, memory)
        return fit

    return wrap


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


def default_nystrom_m(n: int, r: int) -> int:
    """Default landmark count: matching the one-pass accuracy needs
    m >> r'; 16r (floored at 64) tracks the m/r ratios of Table 1 / Fig. 3
    without scaling past n."""
    return min(n, max(16 * r, 64))


def _onepass(sketch_type: str):
    def fit(generator, kernel, X, r, *, block=512, oversampling=10,
            fwht_fn=None, truncate_basis=False, capacity=None, sketch=None,
            policy=None, kernel_statics=None, clock=None) -> Embedding:
        # One-shot fit is a single-chunk pass through the streaming
        # accumulator: the same block-granular update sequence a chunked
        # ingest replays. `sketch` hands in ready draws (another
        # implementation's SRHT or Omega) in place of the generator's;
        # `fwht_fn` (e.g. the CUDA kernel fwht_op) runs the FWHTs of the
        # canonical update and of the eigensolve, unfused (the srht_t
        # kernel when None); `clock` (a StepClock)
        # marks the end of each step.
        acc = SketchAccumulator(kernel, capacity or X.shape[1], r,
                                generator=generator, sketch=sketch,
                                oversampling=oversampling, block=block,
                                sketch_type=sketch_type, fwht_fn=fwht_fn,
                                truncate_basis=truncate_basis,
                                policy=policy,
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


register_backend(
    "onepass-srht",
    memory=lambda n, r, oversampling=10, **_: 4 * n * (r + oversampling),
)(_onepass("srht"))

register_backend(
    "onepass-gaussian",
    # Sketch W plus the equally-sized dense Omega it is multiplied by.
    memory=lambda n, r, oversampling=10, **_: 8 * n * (r + oversampling),
)(_onepass("gaussian"))


@register_backend(
    "nystrom",
    memory=lambda n, r, m=None, **_: 4 * n * (m or default_nystrom_m(n, r)),
)
def _fit_nystrom(generator, kernel, X, r, *, block=512, m=None, eps=1e-8,
                 sketch=None, clock=None) -> Embedding:
    # `sketch` hands in the landmark indices (another implementation's
    # draw) in place of the generator's. No fused fit exists here: C is
    # the plain kernel function, as in the JAX package.
    del block
    n = X.shape[1]
    m = m if m is not None else default_nystrom_m(n, r)
    res = nystrom(kernel, X, m=m, r=r, eps=eps, generator=generator,
                  idx=sketch, clock=clock)
    return Embedding(Y=res.Y, U=res.U, eigvals=res.eigvals,
                     ref=X[:, res.idx].contiguous(),
                     state={"landmark_idx": res.idx})


@register_backend(
    "exact",
    memory=lambda n, r, **_: 4 * n * n,
)
def _fit_exact(generator, kernel, X, r, *, block=512, sketch=None,
               clock=None) -> Embedding:
    # Deterministic (the generator is unused); materializes the full
    # gram: the accuracy ceiling, validation-scale n only.
    del generator, block
    if sketch is not None:
        raise ValueError("the exact backend draws nothing: sketch= does "
                         "not apply")
    eig = exact_eig(kernel, X, r, clock=clock)
    return Embedding(Y=eig.Y, U=eig.U, eigvals=eig.eigvals, state={})
