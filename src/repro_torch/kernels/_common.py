"""Argument checks and launch helpers shared by the kernel wrappers.

A wrapper takes the plain PyTorch version when every tensor it was given
lies on the CPU, launches its CUDA kernel when every tensor lies on one
CUDA device, and raises otherwise: there is no fallback from the card.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

# Kernel-function kinds, as the C entry points number them
# (csrc/common.cuh, enum Kind).
KINDS = {"polynomial": 0, "rbf": 1, "linear": 2}

# The fit_sketch kernel's row ranges: one block each, at most one per SM of
# the H100 (132), in steps of its 16-row mma tile (csrc/fit_sketch.cu).
FIT_RANGES = 132
FIT_ROWS = 16
# The extend_embed kernel's training ranges: at most one per SM in each
# query group, in steps of its 128-point staging unit
# (csrc/extend_embed.cu); a block's 8 warps take 16 queries per m16 tile.
EXTEND_RANGES = 132
EXTEND_ROWS = 128
EXTEND_WARPS = 8
# The gram kernel (csrc/gram.cu): persistent blocks of 16 warps, one per
# SM of the H100 (132 SMs; a block may take 227 KB of shared memory), each
# warp 16 rows x 64 columns per step, p in k-groups of 32 rows.
GRAM_SMS = 132
GRAM_SMEM_MAX = 232_448
GRAM_WARPS = 16
GRAM_KGROUP = 32
# The fixed-order second pass of the split reductions (csrc/common.cuh,
# sum_splits_kernel) and the assigning blocks (csrc/assign.cuh).
SUM_THREADS = 256
ASSIGN_THREADS = 128


class Launch(NamedTuple):
    """One CUDA launch as its plan schedules it: the __global__ function
    of csrc/, its grid, threads per block, dynamic shared memory per block
    (bytes), and the tile parameters the launch passes."""
    kernel: str
    grid: Tuple[int, ...]
    threads: int
    smem: int
    tiles: Tuple[int, ...] = ()


class LaunchPlan(NamedTuple):
    """The launches a wrapper makes for one call, planned from the call's
    shapes alone (srht_t's also from its sampled rows): the shapes, the
    launches in order, and the kernel's own plan (GramPlan, the SRHT
    passes, ...) that the traffic model reads."""
    shapes: Dict[str, int]
    launches: Tuple[Launch, ...]
    detail: object = None


def sum_splits_launch(nsplit: int, length: int) -> Tuple[Launch, ...]:
    """The summing launch of a split reduction: `length` outputs, each
    the sum of `nsplit` partials (none when length is 0)."""
    if length <= 0:
        return ()
    return (Launch("sum_splits_kernel", (-(-length // SUM_THREADS),),
                   SUM_THREADS, 0, (nsplit, length)),)


def assign_smem(k: int, r: int) -> int:
    """Dynamic shared memory of an assigning block: the centroids (k, r)
    and their k norms (csrc/assign.cuh, assign_smem)."""
    return 4 * k * (r + 1)


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


def split_rows(n: int, splits: int, step: int) -> Tuple[int, int]:
    """(rows per split, splits) of a split reduction over n rows: at most
    `splits` ranges, each a multiple of `step` rows. Depends on n alone,
    so a result's summation order does not depend on the other dimension
    (a query column gets the same bits in any batch)."""
    per = -(-n // splits)
    per = -(-per // step) * step
    return per, -(-n // per)


def fit_split(m: int) -> Tuple[int, int]:
    """(rows per range, ranges) of the fit_sketch kernel over m rows."""
    return split_rows(m, FIT_RANGES, FIT_ROWS)


def extend_split(n: int) -> Tuple[int, int]:
    """(training points per range, ranges) of the extend_embed kernel over
    n training points; a function of n alone, never of the batch width."""
    return split_rows(n, EXTEND_RANGES, EXTEND_ROWS)


def extend_query_tiles(w: int) -> int:
    """m16 query tiles per warp of the extend_embed kernel at batch width
    w: the fewest of 1, 2, 4 whose block of 8 warps covers w, so narrow
    batches do not build wide tiles. It changes no bits (each query's sums
    run in the same order whatever tile it lands in)."""
    block = EXTEND_WARPS * 16              # queries of a block at one tile
    return 1 if w <= block else 2 if w <= 2 * block else 4


@dataclass(frozen=True)
class GramPlan:
    """The gram kernel's launch (csrc/gram.cu). A block owns one column
    chunk of `cols` columns (`col_warps` warps across it) and walks steps
    of `rows` rows, step = block, block + grid[0], ... (`tiles` steps);
    each of its warps makes 16 rows x 64 columns of a step. Xb's chunk
    stays in shared memory for the whole walk when `resident`, else p is
    walked in chunks of `krows` rows for every step."""
    rows: int
    col_warps: int
    cols: int
    chunks: int
    krows: int
    resident: bool
    tiles: int
    grid: Tuple[int, int]
    smem: int


def gram_smem_bytes(col_warps: int, krows: int) -> int:
    """Dynamic shared memory of one gram block (csrc/gram.cu Layout): Xb's
    chunk as B fragments (16 bytes per lane and k8 step), its squared
    column norms, and each warp's staging buffer of 16 rows of 68 floats."""
    cols = 64 * col_warps
    return 8 * cols * krows + 4 * cols + GRAM_WARPS * 16 * 68 * 4


@functools.lru_cache(maxsize=256)
def gram_plan(n: int, w: int, p: int) -> GramPlan:
    """The gram kernel's launch for K (n, w) over p: the widest column
    chunk (up to 512 columns, no wider than w needs) at which all of p
    stays resident; where none does (p > 312), chunks of 64 columns with p
    walked in chunks of as many k-groups as fit; one block per SM, at most
    one per step."""
    widest = 8
    while widest > 1 and 64 * (widest // 2) >= w:
        widest //= 2
    resident_rows = max(8, -(-p // 8) * 8)
    for col_warps in (widest >> i for i in range(widest.bit_length())):
        if gram_smem_bytes(col_warps, resident_rows) <= GRAM_SMEM_MAX:
            krows = resident_rows
            break
    else:
        col_warps = 1
        free = GRAM_SMEM_MAX - gram_smem_bytes(1, 0)
        krows = free // (8 * 64) // GRAM_KGROUP * GRAM_KGROUP
    rows, cols = 16 * GRAM_WARPS // col_warps, 64 * col_warps
    chunks, tiles = -(-w // cols), -(-n // rows)
    grid_x = max(1, min(tiles, GRAM_SMS // chunks))
    return GramPlan(rows=rows, col_warps=col_warps, cols=cols, chunks=chunks,
                    krows=krows, resident=krows >= p, tiles=tiles,
                    grid=(grid_x, chunks),
                    smem=gram_smem_bytes(col_warps, krows))


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
