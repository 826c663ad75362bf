"""KernelKMeans: the sklearn-shaped estimator over the approximation backends.

    est = KernelKMeans(k=7, r=2, kernel="polynomial",
                       kernel_params={"gamma": 0.0, "degree": 2},
                       backend="onepass-srht").fit(X, seed=0)
    est.labels_                   # training clustering
    est.predict(X_new)            # out-of-sample assignment
    est.embed(X_new)              # (r, b) linearized new points
    est.save("artifacts/demo")    # servable artifact, the JAX layout

    est = KernelKMeans(k=7, r=2, backend="nystrom",
                       backend_params={"m": 64}).fit(X, seed=0)
    est = KernelKMeans(k=7, r=2, backend="exact").fit(X[:, :10000])

    est = KernelKMeans(...)       # a streaming fit, chunk by chunk
    est.partial_fit(X[:, :5000], seed=0, capacity=n, reeig=False)
    est.partial_fit(X[:, 5000:])  # re-eigs and re-clusters

The estimator runs on the card: `device` defaults to "cuda", and with no
CUDA device it raises unless the caller asks for device="cpu".

Randomness: `fit(X, seed)` draws the sketch (the Nystrom landmarks) from
one generator and the k-means++ seeds from a second, both derived from
`seed`; either draw can be handed in instead (`sketch=`, `init=`), which
is how tests feed the JAX package's draws into the port. The K-means generator is made afresh
from its seed at every re-eig, so, as with a JAX key, the clustering of
an embedding does not depend on how many re-eigs came before: a chunked
`partial_fit` over X equals `fit(X, seed)`, and a stream resumed from a
saved artifact equals the live one.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.api import backends as be
from repro_torch.core.kernels_fn import kernel_params_for, make_kernel
from repro_torch.core.kmeans import kmeans, kmeans_plus_plus
from repro_torch.device import resolve_device
from repro_torch.serve import extend
from repro_torch.serve.artifact import (ClusteringSpec, FittedModel,
                                        load_model, save_model)
from repro_torch.stream.accumulate import SketchAccumulator
from repro_torch.stream.minibatch import draw_minibatch, minibatch_kmeans

# The default parameters of the paper's primary kernel.
_KERNEL_DEFAULTS = {"polynomial": {"gamma": 0.0, "degree": 2}}


def seeds(seed: int) -> Tuple[int, int]:
    """(sketch seed, k-means seed), derived from one seed."""
    a, b = np.random.SeedSequence(int(seed)).generate_state(2, np.uint64)
    return int(a) & ((1 << 63) - 1), int(b) & ((1 << 63) - 1)


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _spec_safe(params: Dict) -> Dict:
    """The JSON-ready part of backend_params: runtime-only knobs (a
    fwht_fn callable) act on the fit but stay out of the spec; numpy
    scalars are config and become Python numbers."""
    out = {}
    for name, val in params.items():
        if isinstance(val, np.generic):
            val = val.item()
        try:
            json.dumps(val)
        except TypeError:
            continue
        out[name] = val
    return out


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
    """Kernel K-means at rank r through an approximation backend
    (api/backends.py: onepass-srht, onepass-gaussian, nystrom, exact).

    Parameters mirror `ClusteringSpec`; `policy` is an optional
    ComputePolicy choosing the compute paths of fit (fit_fused) and serve
    (embed_fused / assign_fused). Without a policy the fit takes the
    canonical path (its SRHT applies through the srht_t kernel on the
    card) and serving the default policy (the kernels on the card), as in
    the JAX package.

    `backend_params` carries the backend's knobs. One-pass: oversampling,
    truncate_basis (the Alg. 1 line 3 ablation), capacity, and fwht_fn
    (a transform for the unfused SRHT composition of the canonical path,
    e.g. kernels.fwht_op, or the plain fwht_ref; runtime-only, it never
    lands in the spec). Nystrom: m (landmarks; default_nystrom_m) and eps.
    A policy's fit field is inert for nystrom and exact, which have no
    fused fit; its serving fields apply to every backend.

    Fitted attributes: labels_ (n,), embedding_ (r, n), eigvals_ (r,),
    centroids_ (k, r), inertia_ (float), kmeans_init_ the K-means starting
    centroids ((n_restarts, k, r); (k, r) after a minibatch re-eig),
    spec_, model_ (the FittedModel), fit_times_ (seconds of each step of
    the last fit, by StepClock: the backend's steps (block_updates, eig;
    nystrom landmark_gram, eig; exact gram, eig), then kmeans_pp (0 when
    `init` was given) and lloyd).
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
        # Live streaming state (partial_fit); a loaded model with stream
        # state rebuilds it on the next partial_fit.
        self._acc: Optional[SketchAccumulator] = None
        self._km_seed: Optional[int] = None

    # -- fitting ---------------------------------------------------------

    def _make_spec(self, n: int, p: int) -> ClusteringSpec:
        return ClusteringSpec(
            kernel=self.kernel, kernel_params=dict(self.kernel_params),
            k=self.k, r=self.r, backend=self.backend,
            backend_params=_spec_safe(self.backend_params),
            block=self.block, n_restarts=self.n_restarts,
            max_iter=self.max_iter, n=int(n), p=int(p))

    def _policy_kwargs(self, spec: ClusteringSpec) -> Dict:
        """Backend kwargs the policy adds. Only the one-pass backends take
        policy= / kernel_statics=: nystrom and exact have no fused fit,
        so a policy is inert there (its serving fields still apply
        through extender())."""
        if self.policy is None or not self.backend.startswith("onepass-"):
            return {}
        return {"policy": self.policy,
                "kernel_statics": extend._kernel_statics(spec)}

    def fit(self, X, seed: int = 0, *, sketch=None,
            init: Optional[torch.Tensor] = None) -> "KernelKMeans":
        """Fit on X (p, n). `sketch` (an SRHT or GaussianSketch; for
        nystrom the (m,) landmark indices) replaces the backend's draw,
        `init` ((n_restarts, k, r)) the k-means++ draw. Returns self."""
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        if X.dim() != 2:
            raise ValueError(f"X must be (p, n), got {tuple(X.shape)}")
        spec = self._make_spec(n=X.shape[1], p=X.shape[0])
        sketch_seed, self._km_seed = seeds(seed)
        g_sketch = generator(sketch_seed, self.device)
        g_km = generator(self._km_seed, self.device)
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
        self._acc = None          # a fresh fit retires live stream state
        self._set_fit(spec, X, emb.U, emb.eigvals, emb.Y, km.labels,
                      km.centroids, km.objective, init, emb.arrays,
                      ref=emb.ref)
        self.fit_times_ = clock.seconds()
        return self

    def _set_fit(self, spec, X, U, eigvals, Y, labels, centroids,
                 objective, init, state, ref=None) -> None:
        self.model_ = FittedModel(
            spec=spec, X_train=X, U=U, eigvals=eigvals, centroids=centroids,
            sketch_signs=state.get("sketch_signs"),
            sketch_rows=state.get("sketch_rows"),
            sketch_omega=state.get("sketch_omega"),
            landmarks=ref, landmark_idx=state.get("landmark_idx"),
            stream_w=state.get("stream_w"),
            stream_row_norms2=state.get("stream_row_norms2"),
            stream_counts=state.get("stream_counts"))
        self.labels_ = labels
        self.embedding_ = Y
        self.eigvals_ = eigvals
        self.centroids_ = centroids
        self.inertia_ = float(objective)
        self.kmeans_init_ = init
        self.spec_ = spec
        self._extender = None

    # -- streaming fit ---------------------------------------------------

    def partial_fit(self, X_chunk, seed: Optional[int] = None, *,
                    capacity: Optional[int] = None, reeig: bool = True,
                    kmeans_mode: str = "full", minibatch_size: int = 256,
                    minibatch_steps: int = 50, sketch=None,
                    init=None) -> "KernelKMeans":
        """Fold one data chunk (p, b) into a streaming fit. Returns self.

        The first call derives the generators from `seed` (None: 0)
        exactly as `fit` does and sizes the sketch to `capacity`
        (required then; capacity=n reproduces fit), so a chunked pass over
        X equals `fit(X, seed)` bit for bit at the re-eig. `sketch` hands
        in ready draws on that call. When the estimator holds a model with
        streaming state (a loaded artifact, an earlier fit), `seed` seeds
        only K-means and accumulation resumes from the saved state.

        reeig=False accumulates without refreshing the model; a later
        call with reeig=True (or `reeig_now()`) folds the staged tail in
        and re-eigs. kmeans_mode: "full" (restarted Lloyd, the fit path)
        or "minibatch" (Sculley updates, stream/minibatch.py). `init`
        replaces the K-means draw of this call's re-eig: (n_restarts, k,
        r) seeds for "full", a MiniBatchDraws for "minibatch".
        """
        X_chunk = torch.as_tensor(X_chunk, dtype=torch.float32,
                                  device=self.device)
        if X_chunk.dim() != 2:
            raise ValueError(f"partial_fit chunk must be 2-D (p, b); got "
                             f"shape {tuple(X_chunk.shape)}")
        p_fit = None
        if self._acc is not None and self._acc._Xbuf is not None:
            p_fit = int(self._acc._Xbuf.shape[0])
        elif self.model_ is not None:
            p_fit = int(self.model_.spec.p)
        if p_fit is not None and int(X_chunk.shape[0]) != p_fit:
            raise ValueError(
                f"partial_fit chunk has {int(X_chunk.shape[0])} feature "
                f"rows but this fit holds p={p_fit}: chunks are (p, b) "
                f"column blocks over a fixed feature dimension")
        if self._acc is not None:
            if self._acc.policy != self.policy:
                raise ValueError(
                    f"ComputePolicy changed mid-stream: the streaming "
                    f"state was built under {self._acc.policy!r} but the "
                    f"estimator now holds {self.policy!r}. The fit compute "
                    f"path is fixed at the first partial_fit; keep the "
                    f"original policy, or start a fresh fit()")
            if sketch is not None:
                raise ValueError("sketch= is taken on the first "
                                 "partial_fit only")
        else:
            self._acc = self._start_stream(X_chunk, seed, capacity, sketch)
        self._acc.add(X_chunk)
        if reeig:
            self.reeig_now(kmeans_mode=kmeans_mode,
                           minibatch_size=minibatch_size,
                           minibatch_steps=minibatch_steps, init=init)
        return self

    def _start_stream(self, X_chunk, seed, capacity,
                      sketch) -> SketchAccumulator:
        if not self.backend.startswith("onepass-"):
            raise ValueError(
                f"partial_fit needs a one-pass backend (streaming sketch "
                f"state); backend is {self.backend!r}")
        sketch_seed, self._km_seed = seeds(0 if seed is None else seed)
        fwht_fn = self.backend_params.get("fwht_fn")
        pk = self._policy_kwargs(self._make_spec(n=0, p=X_chunk.shape[0]))
        if self.model_ is not None and self.model_.stream_counts is not None:
            if sketch is not None:
                raise ValueError("a resumed stream keeps its saved sketch; "
                                 "sketch= applies to a new stream only")
            return SketchAccumulator.from_model(
                self.model_, device=self.device, fwht_fn=fwht_fn, **pk)
        if capacity is None:
            raise ValueError(
                "partial_fit needs capacity=<total columns> on the first "
                "call: the sketch test matrix is sized up front (capacity=n "
                "reproduces fit; larger keeps room to stream). Or load a "
                "model with streaming state to resume.")
        return SketchAccumulator(
            make_kernel(self.kernel, **self.kernel_params), capacity, self.r,
            generator=(generator(sketch_seed, self.device)
                       if sketch is None else None),
            sketch=sketch,
            oversampling=int(self.backend_params.get("oversampling", 10)),
            block=self.block, sketch_type=self.backend.split("-", 1)[1],
            fwht_fn=fwht_fn,
            truncate_basis=bool(self.backend_params.get("truncate_basis",
                                                        False)),
            **pk)

    def reeig_now(self, kmeans_mode: str = "full",
                  minibatch_size: int = 256, minibatch_steps: int = 50, *,
                  init=None) -> "KernelKMeans":
        """Re-eig the accumulated sketch (staged tail applied on a copy)
        and re-cluster the fresh embedding; refreshes model_."""
        if self._acc is None:
            raise RuntimeError("no streaming state; call partial_fit()")
        if kmeans_mode not in ("full", "minibatch"):
            raise ValueError(f"unknown kmeans_mode {kmeans_mode!r}; "
                             f"have 'full' | 'minibatch'")
        eig = self._acc.eig()
        Yt = eig.Y.T.contiguous()
        g_km = generator(self._km_seed, self._acc.device)
        if kmeans_mode == "full":
            if init is None:
                init = kmeans_plus_plus(Yt, self.k, g_km, self.n_restarts)
            init = torch.as_tensor(init, dtype=torch.float32,
                                   device=Yt.device)
            km = kmeans(Yt, self.k, n_restarts=self.n_restarts,
                        max_iter=self.max_iter, init=init)
            labels, centroids, objective = (km.labels, km.centroids,
                                            km.objective)
        else:
            draws = init if init is not None else draw_minibatch(
                Yt, self.k, minibatch_size, minibatch_steps, g_km)
            mb = minibatch_kmeans(Yt, self.k, draws=draws)
            labels, centroids, objective = (mb.labels, mb.centroids,
                                            mb.objective)
            init = draws.init
        X_all = self._acc.X_all.clone()
        spec = self._make_spec(n=X_all.shape[1], p=X_all.shape[0])
        self._set_fit(spec, X_all, eig.U, eig.eigvals, eig.Y, labels,
                      centroids, objective, init, self._acc.state_arrays())
        return self

    @property
    def stream_progress(self) -> Dict:
        """Streaming fit counters: columns added/applied/pending,
        capacity, re-eigs run, and the last approx-error estimate."""
        if self._acc is None:
            return {}
        return {"n_added": self._acc.n_added,
                "n_applied": self._acc.n_applied,
                "n_pending": self._acc.n_pending,
                "capacity": self._acc.capacity,
                "reeigs": self._acc.reeigs,
                "approx_err_estimate": self._acc.last_approx_err}

    def fit_predict(self, X, seed: int = 0) -> torch.Tensor:
        return self.fit(X, seed=seed).labels_

    # -- inference -------------------------------------------------------

    def _require_fit(self) -> FittedModel:
        if self.model_ is None:
            raise RuntimeError("KernelKMeans is not fitted; call fit()")
        return self.model_

    def extender(self, **kwargs) -> extend.Extender:
        """The serving extension engine over the fitted model. With kwargs
        (Extender's `block`, `policy`), a fresh one with the estimator's
        policy as the default; without, one cached so that repeated
        predict()s reuse it."""
        model = self._require_fit()
        if kwargs:
            kwargs.setdefault("policy", self.policy)
            return extend.Extender(model, **kwargs)
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

    # -- persistence -----------------------------------------------------

    def save(self, artifact_dir: str, dtype: str = "f32") -> str:
        """Persist the fitted model as an artifact directory (the JAX
        package's layout; dtype "f32", "bf16" or "int8")."""
        return save_model(self._require_fit(), artifact_dir, dtype=dtype)

    @classmethod
    def load(cls, artifact_dir: str, device=None, policy=None,
             backend_params: Optional[Dict] = None) -> "KernelKMeans":
        """An estimator around a saved artifact, on `device` (the card
        when None); see from_model."""
        model = load_model(artifact_dir, device=resolve_device(device))
        return cls.from_model(model, policy=policy,
                              backend_params=backend_params)

    @classmethod
    def from_model(cls, model: FittedModel, policy=None,
                   backend_params: Optional[Dict] = None
                   ) -> "KernelKMeans":
        """An estimator around an existing FittedModel, on its device
        (training labels and embedding are not part of a model). A model
        with streaming state resumes on the next partial_fit.
        `backend_params` are merged over the spec's: the runtime-only
        knobs a spec cannot carry, such as fwht_fn."""
        spec = model.spec
        est = cls(k=spec.k, r=spec.r, kernel=spec.kernel,
                  kernel_params=dict(spec.kernel_params),
                  backend=spec.backend,
                  backend_params={**spec.backend_params,
                                  **(backend_params or {})},
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


def spec_to_estimator(spec: ClusteringSpec, **kwargs) -> KernelKMeans:
    """An unfitted estimator configured as `spec` records (the refit
    path: spec_to_estimator(old.spec, device=...).fit(X_new, seed));
    kwargs add what a spec does not carry (device, policy)."""
    d = dataclasses.asdict(spec)
    d.pop("n", None)
    d.pop("p", None)
    return KernelKMeans(**d, **kwargs)
