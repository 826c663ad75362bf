"""Parity cases of the port's kernels: op, plain version, shapes, tolerances.

The cases and tolerances are those of the JAX package's kernel registry
(repro.kernels.registry), copied so that the port imports nothing of it;
tests/test_torch_kernels.py asserts that the two agree. `build` makes one
case's inputs with numpy from a seed, so the same arrays can be handed to
both packages.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.extend_embed.ops import extend_embed_op
from repro_torch.kernels.extend_embed.ref import extend_embed_ref
from repro_torch.kernels.fit_sketch.ops import fit_sketch_op
from repro_torch.kernels.fit_sketch.ref import fit_sketch_ref
from repro_torch.kernels.gram.ops import gram_stripe_op
from repro_torch.kernels.gram.ref import gram_stripe_ref
from repro_torch.kernels.kmeans_assign.ops import assign_op
from repro_torch.kernels.kmeans_assign.ref import assign_ref


class KernelEntry(NamedTuple):
    """One kernel's parity contract.

    op/ref:   the wrapper and its plain version, same positional signature.
    cases:    case dicts, one parity point each.
    build:    (rng, case) -> (numpy args, kwargs), args passed positionally.
    rtol/atol: allclose tolerances.
    compare:  optional (got, want, rtol, atol) override, for outputs that
              need more than leaf-wise allclose (argmin label ties).
    """
    name: str
    op: Callable
    ref: Callable
    cases: Tuple[Dict, ...]
    build: Callable
    rtol: float = 2e-3
    atol: float = 2e-3
    compare: Optional[Callable] = None


def _kw(case: Dict) -> Dict:
    return {k: case[k] for k in ("kind", "gamma", "degree") if k in case}


def _normal(rng: np.random.Generator, *shape) -> np.ndarray:
    return rng.standard_normal(shape).astype(np.float32)


def _gram_build(rng, case):
    return (_normal(rng, case["p"], case["n"]),
            _normal(rng, case["p"], case["w"])), _kw(case)


def _assign_build(rng, case):
    return (_normal(rng, case["n"], case["r"]),
            _normal(rng, case["k"], case["r"])), {}


def _extend_embed_build(rng, case):
    return (_normal(rng, case["p"], case["n"]),
            _normal(rng, case["r"], case["n"]),
            _normal(rng, case["p"], case["w"])), _kw(case)


def _fit_sketch_build(rng, case):
    p, m, b, rp = case["p"], case["m"], case["b"], case["rp"]
    X = _normal(rng, p, m)
    Omega = _normal(rng, m, rp)
    C = _normal(rng, p, b)
    Ocr = _normal(rng, b, rp)
    valid = case.get("valid", m)
    # The fit caller's contract: Omega rows of invalid columns are zero,
    # and V drops them out of the column norms.
    Omega[valid:] = 0.0
    V = np.zeros((m,), np.float32)
    V[:valid] = 1.0
    return (X, Omega, C, Ocr, V), _kw(case)


def assign_compare(got, want, rtol, atol):
    """Distances within tolerance; labels may differ only on ties, on
    fewer than 1% of rows (repro.kernels.kmeans_assign.ops rule)."""
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=rtol,
                               atol=atol)
    mism = _np(got[0]) != _np(want[0])
    assert mism.mean() < 0.01, f"labels differ on {mism.mean():.2%} of rows"


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


ENTRIES: Tuple[KernelEntry, ...] = (
    KernelEntry(
        name="extend_embed", op=extend_embed_op, ref=extend_embed_ref,
        cases=(
            {"p": 2, "n": 100, "r": 2, "w": 12},
            {"p": 19, "n": 555, "r": 3, "w": 64, "kind": "rbf",
             "gamma": 0.5},
            {"p": 7, "n": 1024, "r": 16, "w": 128},
            {"p": 3, "n": 97, "r": 5, "w": 1, "kind": "linear"},
            {"p": 2, "n": 250, "r": 2, "w": 23, "kind": "polynomial",
             "gamma": 1.0, "degree": 3},
        ),
        build=_extend_embed_build, rtol=2e-3, atol=2e-3),
    KernelEntry(
        name="fit_sketch", op=fit_sketch_op, ref=fit_sketch_ref,
        cases=(
            {"p": 2, "m": 100, "b": 12, "rp": 12},
            {"p": 19, "m": 555, "b": 64, "rp": 33, "kind": "rbf",
             "gamma": 0.5},
            {"p": 7, "m": 1024, "b": 128, "rp": 140, "valid": 700},
            {"p": 3, "m": 97, "b": 1, "rp": 5, "kind": "linear"},
            {"p": 5, "m": 300, "b": 37, "rp": 20, "kind": "polynomial",
             "gamma": 1.0, "degree": 3, "valid": 123},
        ),
        build=_fit_sketch_build, rtol=2e-3, atol=2e-3),
    KernelEntry(
        name="gram_stripe", op=gram_stripe_op, ref=gram_stripe_ref,
        cases=(
            {"p": 2, "n": 100, "w": 12},
            {"p": 19, "n": 555, "w": 64, "kind": "rbf", "gamma": 0.5},
            {"p": 7, "n": 1024, "w": 128, "kind": "polynomial",
             "gamma": 1.0, "degree": 3},
            {"p": 3, "n": 97, "w": 1, "kind": "linear"},
        ),
        build=_gram_build, rtol=2e-3, atol=2e-3),
    KernelEntry(
        name="kmeans_assign", op=assign_op, ref=assign_ref,
        cases=({"n": 50, "r": 2, "k": 2}, {"n": 1000, "r": 2, "k": 7},
               {"n": 513, "r": 16, "k": 100}, {"n": 31, "r": 5, "k": 3}),
        build=_assign_build, rtol=1e-4, atol=1e-4,
        compare=assign_compare),
)


def kernel_entries() -> Tuple[KernelEntry, ...]:
    """All entries, name-sorted."""
    return ENTRIES


def get_kernel(name: str) -> KernelEntry:
    for entry in ENTRIES:
        if entry.name == name:
            return entry
    raise KeyError(f"unknown kernel {name!r}; have "
                   f"{[e.name for e in ENTRIES]}")


def compare(entry: KernelEntry, got, want) -> None:
    """Assert got == want within the entry's tolerances."""
    if entry.compare is not None:
        entry.compare(got, want, entry.rtol, entry.atol)
        return
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=entry.rtol,
                                   atol=entry.atol)
