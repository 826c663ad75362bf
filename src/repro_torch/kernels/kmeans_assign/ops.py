"""Wrapper of the fused K-means assignment CUDA kernel
(csrc/kmeans_assign.cu)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _common as cm
from repro_torch.kernels.kmeans_assign.ref import assign_ref

# Centroids and their norms live in one block's shared memory.
MAX_SHARED_FLOATS = 227 * 1024 // 4


def assign_op(Y: torch.Tensor, C: torch.Tensor):
    """Y (n, r), C (k, r) -> (labels (n,) int32, min_d2 (n,) float32).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    what = "kmeans_assign"
    if cm.plain_path(what, Y, C):
        return assign_ref(Y, C)
    cm.contiguous(what, "Y", Y, 2)
    cm.contiguous(what, "C", C, 2)
    n, r = Y.shape
    k = C.shape[0]
    if C.shape[1] != r:
        raise ValueError(f"{what}: Y has r={r}, C has {C.shape[1]} columns")
    if k < 1:
        raise ValueError(f"{what}: needs at least one centroid")
    if k * (r + 1) > MAX_SHARED_FLOATS:
        raise ValueError(f"{what}: k * (r + 1) = {k * (r + 1)} floats do "
                         f"not fit one block's shared memory")
    labels = torch.empty((n,), device=Y.device, dtype=torch.int32)
    d2 = torch.empty((n,), device=Y.device, dtype=torch.float32)
    if n == 0:
        return labels, d2
    rc = _build.library().rt_kmeans_assign(
        Y.data_ptr(), n, r, C.data_ptr(), k, labels.data_ptr(),
        d2.data_ptr(), cm.stream(Y))
    _build.check(rc, what)
    assign_op.launches += 1
    return labels, d2


assign_op.launches = 0
