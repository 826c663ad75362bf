"""FittedModel: the servable result of a kernel-clustering fit, in memory.

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
fitted there across. Saving and loading artifacts on disk is not part of
this slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.kernels_fn import KernelFn, make_kernel


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
# is not part of this slice and is refused as an unknown leaf.
_FLOAT_LEAVES = ("X_train", "U", "eigvals", "centroids", "sketch_signs",
                 "sketch_omega", "stream_w", "stream_row_norms2")
_INT_LEAVES = {"sketch_rows": torch.int64, "stream_counts": torch.int32}
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
    known = set(_FLOAT_LEAVES) | set(_INT_LEAVES)
    extra = {k for k, v in leaves.items() if v is not None} - known
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
