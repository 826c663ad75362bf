"""FittedModel: the servable result of a kernel-clustering fit.

A fit collapses to a few tensors that fully determine serving:

    X_train    (p, n)     training data
    U          (n, r)     orthonormal eigenvector basis of the extension
                          operator (rows index the training points)
    eigvals    (r,)       matching eigenvalues (descending, >= 0)
    centroids  (k, r)     K-means centroids in the linearized space
    sketch_*              one-pass state: SRHT signs/rows or the dense
                          Gaussian Omega (not needed to serve; they make
                          the fit reproducible)
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

so an artifact saved by either package loads in the other. A landmark
(Nystrom) artifact waits for the port of that backend and is refused.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import re
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


class FittedModel(NamedTuple):
    """Servable fit; see module docstring for the fields."""
    spec: ClusteringSpec
    X_train: torch.Tensor              # (p, n)
    U: torch.Tensor                    # (n, r)
    eigvals: torch.Tensor              # (r,)
    centroids: torch.Tensor            # (k, r)
    sketch_signs: Optional[torch.Tensor] = None   # (n_pad,)  srht only
    sketch_rows: Optional[torch.Tensor] = None    # (r',)     srht only
    sketch_omega: Optional[torch.Tensor] = None   # (n, r')   gaussian only
    stream_w: Optional[torch.Tensor] = None           # (capacity, r')
    stream_row_norms2: Optional[torch.Tensor] = None  # (capacity,)
    stream_counts: Optional[torch.Tensor] = None      # (2,) int32

    @property
    def device(self) -> torch.device:
        return self.X_train.device

    def kernel_fn(self) -> KernelFn:
        return make_kernel(self.spec.kernel, **self.spec.kernel_params)


# Leaves of a one-pass JAX FittedModel; integer leaves keep their integer
# type (SRHT rows index, stream counts count). A landmark (Nystrom) model
# waits for that backend's slice and is refused.
_FLOAT_LEAVES = ("X_train", "U", "eigvals", "centroids", "sketch_signs",
                 "sketch_omega", "stream_w", "stream_row_norms2")
_INT_LEAVES = {"sketch_rows": torch.int64, "stream_counts": torch.int32}
_LANDMARK_LEAVES = ("landmarks", "landmark_idx")
# On disk the integer leaves keep the JAX package's int32.
_DISK_INT = {"sketch_rows": np.int32, "stream_counts": np.int32}
_SPEC_FIELDS = tuple(f.name for f in dataclasses.fields(ClusteringSpec))


def from_reference(leaves: Mapping[str, np.ndarray], spec: Mapping,
                   device="cuda") -> FittedModel:
    """Carry a model fitted by the JAX package across.

    leaves: the JAX FittedModel's array leaves as numpy arrays, by field
    name (X_train, U, eigvals, centroids, sketch_signs/rows |
    sketch_omega, stream_w, stream_row_norms2, stream_counts; absent or
    None leaves stay None). spec: the JAX ClusteringSpec's fields (e.g.
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
    if present & set(_LANDMARK_LEAVES):
        raise ValueError(
            "landmark (Nystrom) models are not ported yet (ROADMAP Queue A "
            "item 7, other backends); this model carries "
            f"{sorted(present & set(_LANDMARK_LEAVES))}")
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
    landmark = sorted(set(names) & set(_LANDMARK_LEAVES))
    if landmark:
        raise ValueError(
            f"artifact at {base} is a landmark (Nystrom) model "
            f"({landmark}); that backend is not ported yet (ROADMAP "
            f"Queue A item 7, other backends)")
    like = {name: np.zeros(shape, dtype)
            for name, shape, dtype in zip(names, manifest["shapes"],
                                          manifest["dtypes"])}
    state, _ = ckpt.restore_checkpoint(str(base), like, step=0)
    if quantized:
        state = compression.dequantize_state(state, quantized)
    return from_reference(state, dataclasses.asdict(spec), device=device)
