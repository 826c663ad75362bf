"""Argument checks and launch helpers shared by the kernel wrappers.

A wrapper takes the plain PyTorch version when every tensor it was given
lies on the CPU, launches its CUDA kernel when every tensor lies on one
CUDA device, and raises otherwise: there is no fallback from the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# Kernel-function kinds, as the C entry points number them
# (csrc/common.cuh, enum Kind).
KINDS = {"polynomial": 0, "rbf": 1, "linear": 2}

# Rows of one tile in the CUDA kernels (csrc/common.cuh, TM).
TILE_ROWS = 64
# Row ranges a split-reduction kernel cuts its long dimension into.
SPLITS = 128


def kind_code(kind: str, degree: int) -> int:
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}; have {sorted(KINDS)}")
    if int(degree) < 0:
        raise ValueError(f"degree must be >= 0, got {degree}")
    return KINDS[kind]


def plain_path(what: str, *tensors: Optional[torch.Tensor]) -> bool:
    """True when every tensor lies on the CPU (run the plain version),
    False when all lie on one CUDA device (launch the kernel)."""
    devices = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return False
    raise ValueError(f"{what}: tensors lie on {sorted(map(str, devices))}; "
                     f"all must be on the CPU or on one CUDA device")


def check_f32(what: str, name: str, t: torch.Tensor, ndim: int) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: {name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")


def contiguous(what: str, name: str, t: torch.Tensor, ndim: int) -> None:
    check_f32(what, name, t, ndim)
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")


def leading_dim(what: str, name: str, t: torch.Tensor) -> int:
    """Row stride of a row-major 2-D matrix; column slices of a wider
    matrix qualify, so callers pass them without a copy."""
    check_f32(what, name, t, 2)
    rows, cols = t.shape
    if rows <= 1:
        return max(cols, 1)
    if cols > 1 and t.stride(1) != 1 or t.stride(0) < cols:
        raise ValueError(f"{what}: {name} must be row-major with unit "
                         f"column stride, got strides {t.stride()}")
    return t.stride(0)


def split_rows(n: int) -> Tuple[int, int]:
    """(rows per split, splits) of a split reduction over n rows. Depends
    on n alone, so a result's summation order does not depend on the
    other dimension (a query column gets the same bits in any batch)."""
    per = -(-n // SPLITS)
    per = -(-per // TILE_ROWS) * TILE_ROWS
    return per, -(-n // per)


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
