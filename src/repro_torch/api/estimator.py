"""KernelKMeans: the sklearn-shaped estimator over the one-pass backends.

    est = KernelKMeans(k=7, r=2, kernel="polynomial",
                       kernel_params={"gamma": 0.0, "degree": 2},
                       backend="onepass-srht").fit(X, seed=0)
    est.labels_                   # training clustering
    est.predict(X_new)            # out-of-sample assignment
    est.embed(X_new)              # (r, b) linearized new points

The estimator runs on the card: `device` defaults to "cuda", and with no
CUDA device it raises unless the caller asks for device="cpu".

Randomness: `fit(X, seed)` draws the sketch from one generator and the
k-means++ seeds from a second, both derived from `seed`; either draw can
be handed in instead (`sketch=`, `init=`), which is how tests feed the
JAX package's draws into the port.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.api import backends as be
from repro_torch.core.kernels_fn import kernel_params_for, make_kernel
from repro_torch.core.kmeans import kmeans, kmeans_plus_plus
from repro_torch.serve import extend
from repro_torch.serve.artifact import ClusteringSpec, FittedModel

# The default parameters of the paper's primary kernel.
_KERNEL_DEFAULTS = {"polynomial": {"gamma": 0.0, "degree": 2}}


def resolve_device(device) -> torch.device:
    """`device`, or the card when None; no silent fallback to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the card by default and no CUDA device "
                "is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def generators(seed: int, device: torch.device):
    """(sketch generator, k-means generator) on `device`, from one seed."""
    a, b = np.random.SeedSequence(int(seed)).generate_state(2, np.uint64)
    gens = []
    for s in (a, b):
        g = torch.Generator(device=device)
        g.manual_seed(int(s) & ((1 << 63) - 1))
        gens.append(g)
    return gens


class StepClock:
    """Marks the end of each step of a fit on the device's own clock: a
    CUDA event on the card (recorded in stream order, no synchronize until
    `seconds` is read), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._marks = []
        self.mark("start")

    def mark(self, name: str) -> None:
        if self._cuda:
            stamp = torch.cuda.Event(enable_timing=True)
            stamp.record()
        else:
            stamp = time.perf_counter()
        self._marks.append((name, stamp))

    def seconds(self) -> Dict[str, float]:
        """{step: seconds from the previous mark to this one}."""
        if self._cuda:
            self._marks[-1][1].synchronize()
        return {name: (a.elapsed_time(b) / 1e3 if self._cuda else b - a)
                for (_, a), (name, b) in zip(self._marks, self._marks[1:])}


class KernelKMeans:
    """Kernel K-means at rank r through a one-pass approximation backend.

    Parameters mirror `ClusteringSpec`; `policy` is an optional
    ComputePolicy choosing the compute paths of fit (fit_fused) and serve
    (embed_fused / assign_fused). Without a policy the fit takes the
    canonical plain path and serving the default policy (the kernels on
    the card), as in the JAX package.

    Fitted attributes: labels_ (n,), embedding_ (r, n), eigvals_ (r,),
    centroids_ (k, r), inertia_ (float), kmeans_init_ (n_restarts, k, r)
    the Lloyd starting centroids, spec_, model_ (the FittedModel),
    fit_times_ (seconds of each step of the last fit, by StepClock:
    block_updates, eig, kmeans_pp (0 when `init` was given), lloyd).
    """

    def __init__(self, k: int = 2, r: int = 2, *,
                 kernel: str = "polynomial",
                 kernel_params: Optional[Dict] = None,
                 backend: str = "onepass-srht",
                 backend_params: Optional[Dict] = None,
                 block: int = 512, n_restarts: int = 10,
                 max_iter: int = 20, policy=None, device=None):
        be.get_backend(backend)                      # fail fast
        valid = kernel_params_for(kernel)            # fail fast
        if kernel_params is None:
            kernel_params = dict(_KERNEL_DEFAULTS.get(kernel, {}))
        unknown = set(kernel_params) - valid
        if unknown:
            raise ValueError(
                f"unknown param(s) {sorted(unknown)} for kernel "
                f"{kernel!r}; valid params: {sorted(valid) or 'none'}")
        self.device = resolve_device(device)
        self.k = int(k)
        self.r = int(r)
        self.kernel = kernel
        self.kernel_params = dict(kernel_params)
        self.backend = backend
        self.backend_params = dict(backend_params or {})
        self.block = int(block)
        self.n_restarts = int(n_restarts)
        self.max_iter = int(max_iter)
        self.policy = policy
        self.model_: Optional[FittedModel] = None
        self.labels_ = None
        self.embedding_ = None
        self.eigvals_ = None
        self.centroids_ = None
        self.inertia_: Optional[float] = None
        self.kmeans_init_ = None
        self.fit_times_: Optional[Dict[str, float]] = None
        self.spec_: Optional[ClusteringSpec] = None
        self._extender: Optional[extend.Extender] = None

    # -- fitting ---------------------------------------------------------

    def _make_spec(self, n: int, p: int) -> ClusteringSpec:
        return ClusteringSpec(
            kernel=self.kernel, kernel_params=dict(self.kernel_params),
            k=self.k, r=self.r, backend=self.backend,
            backend_params={k: v for k, v in self.backend_params.items()
                            if not callable(v)},
            block=self.block, n_restarts=self.n_restarts,
            max_iter=self.max_iter, n=int(n), p=int(p))

    def _policy_kwargs(self, spec: ClusteringSpec) -> Dict:
        if self.policy is None:
            return {}
        return {"policy": self.policy,
                "kernel_statics": extend._kernel_statics(spec)}

    def fit(self, X, seed: int = 0, *, sketch=None,
            init: Optional[torch.Tensor] = None) -> "KernelKMeans":
        """Fit on X (p, n). `sketch` (an SRHT or GaussianSketch) replaces
        the sketch draw, `init` ((n_restarts, k, r)) the k-means++ draw.
        Returns self."""
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        if X.dim() != 2:
            raise ValueError(f"X must be (p, n), got {tuple(X.shape)}")
        spec = self._make_spec(n=X.shape[1], p=X.shape[0])
        g_sketch, g_km = generators(seed, self.device)
        clock = StepClock(self.device)
        emb = be.get_backend(self.backend).fit(
            g_sketch, make_kernel(self.kernel, **self.kernel_params), X,
            self.r, block=self.block, sketch=sketch, clock=clock,
            **self.backend_params, **self._policy_kwargs(spec))
        Yt = emb.Y.T.contiguous()
        if init is None:
            init = kmeans_plus_plus(Yt, self.k, g_km, self.n_restarts)
        init = torch.as_tensor(init, dtype=torch.float32, device=self.device)
        clock.mark("kmeans_pp")
        km = kmeans(Yt, self.k, n_restarts=self.n_restarts,
                    max_iter=self.max_iter, init=init)
        clock.mark("lloyd")
        st = emb.arrays
        self.model_ = FittedModel(
            spec=spec, X_train=X, U=emb.U, eigvals=emb.eigvals,
            centroids=km.centroids, sketch_signs=st.get("sketch_signs"),
            sketch_rows=st.get("sketch_rows"),
            sketch_omega=st.get("sketch_omega"),
            stream_w=st.get("stream_w"),
            stream_row_norms2=st.get("stream_row_norms2"),
            stream_counts=st.get("stream_counts"))
        self.labels_ = km.labels
        self.embedding_ = emb.Y
        self.eigvals_ = emb.eigvals
        self.centroids_ = km.centroids
        self.inertia_ = float(km.objective)
        self.kmeans_init_ = init
        self.fit_times_ = clock.seconds()
        self.spec_ = spec
        self._extender = None
        return self

    def fit_predict(self, X, seed: int = 0) -> torch.Tensor:
        return self.fit(X, seed=seed).labels_

    # -- inference -------------------------------------------------------

    def _require_fit(self) -> FittedModel:
        if self.model_ is None:
            raise RuntimeError("KernelKMeans is not fitted; call fit()")
        return self.model_

    def extender(self) -> extend.Extender:
        """The serving extension engine over the fitted model (cached)."""
        model = self._require_fit()
        if self._extender is None:
            self._extender = extend.Extender(model, policy=self.policy)
        return self._extender

    def embed(self, X) -> torch.Tensor:
        """Out-of-sample extension of X (p, b) -> (r, b)."""
        return self.extender().embed(X)

    def predict(self, X) -> torch.Tensor:
        """Assign X (p, b) to the fitted clusters -> labels (b,)."""
        return self.extender().assign(X)[0]

    def transform(self, X) -> torch.Tensor:
        """sklearn-style alias of `embed` (column-major: (r, b))."""
        return self.embed(X)

    def score(self, X=None) -> float:
        """Negative sum of squared distances to the assigned centroids
        (higher is better); X=None scores the training fit."""
        if X is None:
            self._require_fit()
            if self.inertia_ is None:
                raise RuntimeError("the training objective is not part of "
                                   "a model; pass X to score against data")
            return -self.inertia_
        return -float(torch.sum(self.extender().assign(X)[1]))

    @classmethod
    def from_model(cls, model: FittedModel, policy=None) -> "KernelKMeans":
        """An estimator around an existing FittedModel, on its device
        (training labels and embedding are not part of a model)."""
        spec = model.spec
        est = cls(k=spec.k, r=spec.r, kernel=spec.kernel,
                  kernel_params=dict(spec.kernel_params),
                  backend=spec.backend,
                  backend_params=dict(spec.backend_params),
                  block=spec.block, n_restarts=spec.n_restarts,
                  max_iter=spec.max_iter, policy=policy,
                  device=model.device)
        est.model_ = model
        est.eigvals_ = model.eigvals
        est.centroids_ = model.centroids
        est.spec_ = spec
        return est

    def __repr__(self) -> str:
        fitted = "fitted" if self.model_ is not None else "unfitted"
        return (f"KernelKMeans(k={self.k}, r={self.r}, "
                f"kernel={self.kernel!r}, backend={self.backend!r}, "
                f"device={str(self.device)!r}) <{fitted}>")
