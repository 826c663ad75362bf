"""FittedModel: the servable result of a kernel-clustering fit.

A fit collapses to a few tensors that fully determine serving:

    X_train    (p, n)     training data
    U          (n_ref, r) orthonormal eigenvector basis of the extension
                          operator: rows index the training points
                          (one-pass / exact) or the Nystrom landmarks
    eigvals    (r,)       matching eigenvalues (descending, >= 0)
    centroids  (k, r)     K-means centroids in the linearized space
    sketch_*              one-pass state: SRHT signs/rows or the dense
                          Gaussian Omega (not needed to serve; they make
                          the fit reproducible)
    landmarks  (p, m)     Nystrom backend: the sampled reference points
    landmark_idx (m,)     and their columns in X_train; the extension
                          evaluates kappa(landmarks, x) against them
                          (`extension_ref` picks the reference set)
    stream_*              the accumulated sketch W, the row norms of K and
                          [n_applied, capacity]

plus a frozen `ClusteringSpec`. The fields and the spec are the JAX
package's (repro.serve.artifact), so `from_reference` carries a model
fitted there across in memory, and the artifact on disk has its layout:

    <dir>/spec.json        ClusteringSpec (legacy ModelSpec read too)
    <dir>/leaves.json      leaf names in checkpoint leaf order (sorted
                           keys) and the quantization map of a bf16 or
                           int8 artifact
    <dir>/step_0/          atomic checkpoint of the leaves
                           (distributed/checkpoint.py)

so an artifact saved by either package loads in the other, for every
backend. `fit_model` is a deprecated shim over the estimator API.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import warnings
from typing import Dict, List, Mapping, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.kernels_fn import KernelFn, make_kernel
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import compression


@dataclasses.dataclass(frozen=True)
class ClusteringSpec:
    """The single frozen config of a kernel-clustering fit.

    `backend` names a registered approximation backend
    (api/backends.py); `backend_params` carries its knobs (oversampling
    for one-pass). n/p are bound at fit time from the data.
    """
    kernel: str = "polynomial"          # registry name (core/kernels_fn)
    kernel_params: Dict = dataclasses.field(default_factory=dict)
    k: int = 2                          # clusters
    r: int = 2                          # target rank (= serving embed dim)
    backend: str = "onepass-srht"       # approximation backend
    backend_params: Dict = dataclasses.field(default_factory=dict)
    block: int = 512                    # streaming stripe width
    n_restarts: int = 10                # K-means restarts
    max_iter: int = 20                  # K-means Lloyd iterations
    n: Optional[int] = None             # training points (bound at fit)
    p: Optional[int] = None             # input dimension (bound at fit)

    @property
    def sketch_type(self) -> Optional[str]:
        """'srht' | 'gaussian' for one-pass backends, else None."""
        if self.backend.startswith("onepass-"):
            return self.backend.split("-", 1)[1]
        return None

    @property
    def oversampling(self) -> int:
        return int(self.backend_params.get("oversampling", 10))

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ClusteringSpec":
        d = json.loads(text)
        # Legacy ModelSpec schema: oversampling/sketch_type at top level,
        # no backend fields, no K-means params.
        if "backend" not in d:
            d["backend"] = f"onepass-{d.pop('sketch_type', 'srht')}"
            d["backend_params"] = {"oversampling": d.pop("oversampling", 10)}
        d.pop("sketch_type", None)
        return cls(**d)


# Legacy alias, as the JAX package keeps it.
ModelSpec = ClusteringSpec


class FittedModel(NamedTuple):
    """Servable fit; see module docstring for the fields."""
    spec: ClusteringSpec
    X_train: torch.Tensor              # (p, n)
    U: torch.Tensor                    # (n_ref, r)
    eigvals: torch.Tensor              # (r,)
    centroids: torch.Tensor            # (k, r)
    sketch_signs: Optional[torch.Tensor] = None   # (n_pad,)  srht only
    sketch_rows: Optional[torch.Tensor] = None    # (r',)     srht only
    sketch_omega: Optional[torch.Tensor] = None   # (n, r')   gaussian only
    landmarks: Optional[torch.Tensor] = None      # (p, m)    nystrom only
    landmark_idx: Optional[torch.Tensor] = None   # (m,)      nystrom only
    stream_w: Optional[torch.Tensor] = None           # (capacity, r')
    stream_row_norms2: Optional[torch.Tensor] = None  # (capacity,)
    stream_counts: Optional[torch.Tensor] = None      # (2,) int32

    @property
    def device(self) -> torch.device:
        return self.X_train.device

    @property
    def extension_ref(self) -> torch.Tensor:
        """Reference points the out-of-sample extension evaluates the
        kernel against: the Nystrom landmarks when present, else the
        training set. Shape (p, n_ref)."""
        return self.landmarks if self.landmarks is not None else self.X_train

    @property
    def n_ref(self) -> int:
        """Columns of `extension_ref`: the per-stripe kernel height that
        serving pays (m for Nystrom, n otherwise)."""
        return int(self.extension_ref.shape[1])

    @property
    def Y(self) -> torch.Tensor:
        """Fitted linearization Sigma^{1/2} U^T in R^{r x n} (recomputed).

        Only defined when U spans the training points (one-pass / exact).
        A landmark (Nystrom) fit does not keep its training linearization:
        embed the training data through the extension instead (exact on
        training points by construction).
        """
        if self.landmarks is not None:
            raise AttributeError(
                f"backend {self.spec.backend!r} is landmark-based: U spans "
                f"the {self.n_ref} landmarks, not the training set; use "
                f"serve.extend.embed(model, model.X_train) for the "
                f"training linearization")
        return torch.sqrt(self.eigvals)[:, None] * self.U.T

    def kernel_fn(self) -> KernelFn:
        return make_kernel(self.spec.kernel, **self.spec.kernel_params)


def fit_model(X, k: int, r: int, kernel: str = "polynomial",
              kernel_params: Optional[Dict] = None,
              oversampling: int = 10, block: int = 512,
              sketch_type: str = "srht", n_restarts: int = 10,
              max_iter: int = 20, *, seed: int = 0,
              device=None) -> FittedModel:
    """DEPRECATED shim: use `repro_torch.api.KernelKMeans`.

    Delegates to the estimator with the matching one-pass backend, so the
    returned FittedModel is that of `KernelKMeans(...).fit(X, seed)`.
    """
    warnings.warn(
        "fit_model is deprecated; use repro_torch.api.KernelKMeans(k=..., "
        "r=..., backend='onepass-srht', ...).fit(X, seed).model_",
        DeprecationWarning, stacklevel=2)
    from repro_torch.api import KernelKMeans   # lazy: api builds on serve
    est = KernelKMeans(k=k, r=r, kernel=kernel, kernel_params=kernel_params,
                       backend=f"onepass-{sketch_type}",
                       backend_params={"oversampling": oversampling},
                       block=block, n_restarts=n_restarts,
                       max_iter=max_iter, device=device)
    return est.fit(X, seed=seed).model_


# Leaves of a JAX FittedModel; integer leaves keep their integer type (SRHT
# rows and landmark indices index, stream counts count).
_FLOAT_LEAVES = ("X_train", "U", "eigvals", "centroids", "sketch_signs",
                 "sketch_omega", "landmarks", "stream_w",
                 "stream_row_norms2")
_INT_LEAVES = {"sketch_rows": torch.int64, "landmark_idx": torch.int64,
               "stream_counts": torch.int32}
# On disk the integer leaves keep the JAX package's int32.
_DISK_INT = {"sketch_rows": np.int32, "landmark_idx": np.int32,
             "stream_counts": np.int32}
_SPEC_FIELDS = tuple(f.name for f in dataclasses.fields(ClusteringSpec))


def from_reference(leaves: Mapping[str, np.ndarray], spec: Mapping,
                   device="cuda") -> FittedModel:
    """Carry a model fitted by the JAX package across.

    leaves: the JAX FittedModel's array leaves as numpy arrays, by field
    name (X_train, U, eigvals, centroids, sketch_signs/rows |
    sketch_omega, landmarks, landmark_idx, stream_w, stream_row_norms2,
    stream_counts; absent or None leaves stay None). spec: the JAX ClusteringSpec's fields (e.g.
    dataclasses.asdict of it). The tensors land on `device`.
    """
    unknown = set(spec) - set(_SPEC_FIELDS)
    if unknown:
        raise ValueError(f"unknown ClusteringSpec field(s) {sorted(unknown)}")
    missing = {"X_train", "U", "eigvals", "centroids"} - {
        k for k, v in leaves.items() if v is not None}
    if missing:
        raise ValueError(f"reference model lacks leaves {sorted(missing)}")
    present = {k for k, v in leaves.items() if v is not None}
    extra = present - set(_FLOAT_LEAVES) - set(_INT_LEAVES)
    if extra:
        raise ValueError(f"unknown leaves {sorted(extra)}")
    fields = {}
    for name, val in leaves.items():
        if val is None:
            continue
        dtype = _INT_LEAVES.get(name, torch.float32)
        fields[name] = torch.as_tensor(np.array(val), device=device).to(
            dtype)
    d = dict(spec)
    d["kernel_params"] = dict(d.get("kernel_params", {}))
    d["backend_params"] = dict(d.get("backend_params", {}))
    return FittedModel(spec=ClusteringSpec(**d), **fields)


# -- save / load on top of distributed/checkpoint.py --------------------------

def _array_state(model: FittedModel) -> Dict[str, np.ndarray]:
    state = {}
    for name in model._fields[1:]:
        val = getattr(model, name)
        if val is not None:
            arr = ckpt.to_host(val)
            state[name] = arr.astype(_DISK_INT.get(name, arr.dtype),
                                     copy=False)
    return state


def save_model(model: FittedModel, artifact_dir: str,
               dtype: str = "f32") -> str:
    """Persist atomically; returns the artifact directory.

    dtype="bf16" stores every floating leaf as its bfloat16 bit pattern
    (half the bytes), "int8" as absmax-scaled int8 with one scale per
    leaf in leaves.json (a quarter); integer leaves and the spec are kept
    as they are, and load_model restores float32.
    """
    base = pathlib.Path(artifact_dir)
    base.mkdir(parents=True, exist_ok=True)
    state = _array_state(model)
    quantized: Dict = {}
    if dtype not in ("f32", "float32"):
        state, quantized = compression.quantize_state(state, dtype)
    ckpt.save_checkpoint(str(base), step=0, state=state, blocking=True)
    (base / "leaves.json").write_text(
        json.dumps({"names": sorted(state), "quantized": quantized}))
    (base / "spec.json").write_text(model.spec.to_json())
    return str(base)


# Artifacts from before leaves.json carry only keystr paths like
# "['X_train']": match the quoted key.
_KEYSTR_RE = re.compile(r"\['([^\]]+)'\]")


def _leaf_names(base: pathlib.Path, manifest: Dict) -> tuple:
    """(leaf names in leaf order, quantized map) of an artifact."""
    names_file = base / "leaves.json"
    quantized: Dict = {}
    if names_file.exists():
        meta = json.loads(names_file.read_text())
        names: List[str] = meta["names"]
        quantized = meta.get("quantized", {})
    else:
        names = []
        for path in manifest["paths"]:
            m = _KEYSTR_RE.fullmatch(path)
            names.append(m.group(1) if m else path)
    missing = {"X_train", "U", "eigvals", "centroids"} - set(names)
    if missing:
        raise ValueError(f"artifact at {base} lacks required leaves "
                         f"{sorted(missing)}; found {names}")
    return names, quantized


def load_model(artifact_dir: str, device="cuda") -> FittedModel:
    """Load an artifact written by either package onto `device`."""
    base = pathlib.Path(artifact_dir)
    spec = ClusteringSpec.from_json((base / "spec.json").read_text())
    manifest = ckpt.read_manifest(str(base), step=0)
    names, quantized = _leaf_names(base, manifest)
    like = {name: np.zeros(shape, dtype)
            for name, shape, dtype in zip(names, manifest["shapes"],
                                          manifest["dtypes"])}
    state, _ = ckpt.restore_checkpoint(str(base), like, step=0)
    if quantized:
        state = compression.dequantize_state(state, quantized)
    return from_reference(state, dataclasses.asdict(spec), device=device)
