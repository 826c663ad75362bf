"""Parity cases of the port's kernels: op, plain version, shapes, tolerances.

The cases and tolerances are those of the JAX package's kernel registry
(repro.kernels.registry), copied so that the port imports nothing of it;
tests/test_torch_kernels.py asserts that the two agree. srht_t, the SRHT
form of fwht, and embed_assign, the assignment folded into extend_embed's
summing launch, have no entry there: their cases are the port's own. `build`
makes one case's inputs with numpy from a seed, so the same arrays can be
handed to both packages.

The registry itself keeps JAX's semantics (repro/kernels/registry.py:65,
:82): `register_kernel` refuses an entry with no parity cases and
replaces an entry of the same name, `registered_kernels` gives the names
sorted, and `kernel_entries` the entries in that order. The port's
entries below are registered when this module is imported.

Each entry also registers its memory contract (KernelContract,
register_contract, get_contract; repro/kernels/registry.py:44, :92, :99):
the launches its wrapper makes for a call, planned from the call's shapes
by the function the wrapper launches from, and closed forms of the DRAM
bytes and shared memory in that plan's parameters, which
repro_torch.analysis holds against the traffic the plan's grid implies
(rules C001-C003).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.extend_embed.ops import (
    extend_contract, extend_embed_bytes, extend_embed_op, extend_launch_plan)
from repro_torch.kernels.extend_embed.ref import extend_embed_ref
from repro_torch.kernels.fit_sketch.ops import (
    fit_contract, fit_launch_plan, fit_sketch_bytes, fit_sketch_op)
from repro_torch.kernels.fit_sketch.ref import fit_sketch_ref
from repro_torch.kernels.fwht.ops import (
    fwht_bytes, fwht_contract, fwht_launch_plan, fwht_op, srht_contract,
    srht_launch_plan, srht_t_bytes, srht_t_op)
from repro_torch.kernels.fwht.ref import fwht_ref, srht_t_ref
from repro_torch.kernels.gram.ops import (
    gram_contract, gram_launch_plan, gram_stripe_bytes, gram_stripe_op)
from repro_torch.kernels.gram.ref import gram_stripe_ref
from repro_torch.kernels.kmeans_assign.ops import (
    assign_bytes, assign_contract, assign_launch_plan, assign_op,
    embed_assign_bytes, embed_assign_contract, embed_assign_launch_plan,
    embed_assign_op)
from repro_torch.kernels.kmeans_assign.ref import assign_ref, embed_assign_ref


class KernelEntry(NamedTuple):
    """One kernel's parity contract.

    op/ref:   the wrapper and its plain version, same positional signature.
    cases:    case dicts, one parity point each.
    build:    (rng, case) -> (numpy args, kwargs), args passed positionally.
    rtol/atol: allclose tolerances.
    compare:  optional (got, want, rtol, atol) override, for outputs that
              need more than leaf-wise allclose (argmin label ties); with
              tie_distances, (got, want, rtol, atol, distances).
    tie_distances: optional (*args, **kw) -> the plain version's (w, k)
              squared distances, which compare's near-tie rule reads.
    """
    name: str
    op: Callable
    ref: Callable
    cases: Tuple[Dict, ...]
    build: Callable
    rtol: float = 2e-3
    atol: float = 2e-3
    compare: Optional[Callable] = None
    tie_distances: Optional[Callable] = None


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


def _embed_assign_build(rng, case):
    args, kw = _extend_embed_build(rng, case)
    return args + (_normal(rng, case["k"], case["r"]),), kw


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


def _fwht_build(rng, case):
    return (_normal(rng, case["n"], case["c"]),), {}


def _srht_t_build(rng, case):
    n_pad = case["n_pad"]
    signs = (rng.integers(0, 2, n_pad) * 2 - 1).astype(np.float32)
    rows = rng.permutation(n_pad)[:case["r"]].astype(np.int64)
    return (_normal(rng, case["m"], case["c"]), signs, rows), {"n_pad": n_pad}


def assign_compare(got, want, rtol, atol):
    """Distances within tolerance; labels may differ only on ties, on
    fewer than 1% of rows (repro.kernels.kmeans_assign.ops rule)."""
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=rtol,
                               atol=atol)
    mism = _np(got[0]) != _np(want[0])
    assert mism.mean() < 0.01, f"labels differ on {mism.mean():.2%} of rows"


def near_tie_compare(got, want, rtol, atol, distances):
    """Distances within tolerance; a label may differ only on a near-tie,
    where the reference's squared distances (`distances`, (w, k)) to the
    two labels agree within the tolerance."""
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=rtol,
                               atol=atol)
    got_l = _np(got[0]).astype(np.int64)
    want_l = _np(want[0]).astype(np.int64)
    k = distances.shape[1]
    assert ((got_l >= 0) & (got_l < k)).all(), "labels out of range"
    rows = np.flatnonzero(got_l != want_l)
    a = distances[rows, got_l[rows]]
    b = distances[rows, want_l[rows]]
    far = rows[np.abs(a - b) > atol + rtol * np.abs(b)]
    assert far.size == 0, f"labels differ off a near-tie at rows {far[:8]}"


def sq_distances(Y, C):
    """Squared distances (w, k) in float64 of the embedding Y (r, w) to
    the centroids C (k, r): the near-tie rule's reference."""
    Y = Y.T.double()
    return _np(((Y[:, None, :] - C.double()[None]) ** 2).sum(-1))


def embed_distances(X, P, Xb, C, kind="polynomial", gamma=0.0, degree=2):
    """The plain embedding's squared distances to C, (w, k), in float64."""
    return sq_distances(extend_embed_ref(X, P, Xb, kind, gamma, degree), C)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


_EXTEND_CASES = (
    {"p": 2, "n": 100, "r": 2, "w": 12},
    {"p": 19, "n": 555, "r": 3, "w": 64, "kind": "rbf", "gamma": 0.5},
    {"p": 7, "n": 1024, "r": 16, "w": 128},
    {"p": 3, "n": 97, "r": 5, "w": 1, "kind": "linear"},
    {"p": 2, "n": 250, "r": 2, "w": 23, "kind": "polynomial", "gamma": 1.0,
     "degree": 3},
)

ENTRIES: Tuple[KernelEntry, ...] = (
    KernelEntry(
        name="extend_embed", op=extend_embed_op, ref=extend_embed_ref,
        cases=_EXTEND_CASES,
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
        name="fwht", op=fwht_op, ref=fwht_ref,
        cases=({"n": 8, "c": 3}, {"n": 512, "c": 128}, {"n": 4096, "c": 1},
               {"n": 1 << 14, "c": 2}),
        build=_fwht_build, rtol=2e-4, atol=2e-4),
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
    # The SRHT form of fwht (Omega^T M, repro.core.sketch.srht_apply_t in
    # the JAX package, which has no registry entry for it): m = n_pad,
    # n_pad - 1 and ragged, one and two passes, at the fwht tolerances.
    KernelEntry(
        name="srht_t", op=srht_t_op, ref=srht_t_ref,
        cases=({"n_pad": 8, "m": 8, "c": 1, "r": 3},
               {"n_pad": 1 << 10, "m": (1 << 10) - 1, "c": 7, "r": 7},
               {"n_pad": 1 << 11, "m": 1500, "c": 512, "r": 7},
               {"n_pad": 1 << 17, "m": 100_000, "c": 7, "r": 7},
               {"n_pad": 1 << 17, "m": (1 << 17) - 1, "c": 1, "r": 12}),
        build=_srht_t_build, rtol=2e-4, atol=2e-4),
    # kmeans_assign folded into extend_embed's summing launch (the JAX
    # package assigns the stripe's embedding with assign_pallas): the
    # extend_embed cases, each with a centroid set, at extend_embed's
    # tolerance. Labels by the near-tie rule: at w = 12 or 1, the 1%-of-rows
    # rule of assign_compare cannot tell a flip from a fault.
    KernelEntry(
        name="embed_assign", op=embed_assign_op, ref=embed_assign_ref,
        cases=tuple(dict(case, k=k)
                    for case, k in zip(_EXTEND_CASES, (2, 7, 100, 3, 7))),
        build=_embed_assign_build, rtol=2e-3, atol=2e-3,
        compare=near_tie_compare, tie_distances=embed_distances),
)


_REGISTRY: Dict[str, KernelEntry] = {}


def register_kernel(entry: KernelEntry) -> KernelEntry:
    """Register one kernel (re-registering a name replaces it)."""
    if not entry.cases:
        raise ValueError(f"kernel {entry.name!r} registered with no "
                         f"parity cases")
    _REGISTRY[entry.name] = entry
    return entry


def registered_kernels() -> list:
    """Registered kernel names, sorted."""
    return sorted(_REGISTRY)


def kernel_entries() -> Tuple[KernelEntry, ...]:
    """All entries, name-sorted."""
    return tuple(_REGISTRY[name] for name in registered_kernels())


def get_kernel(name: str) -> KernelEntry:
    if name not in _REGISTRY:
        raise KeyError(f"unknown kernel {name!r}; registered: "
                       f"{registered_kernels()}")
    return _REGISTRY[name]


for _entry in ENTRIES:
    register_kernel(_entry)


# Hopper's opt-in limit of shared memory per block (227 KB).
SMEM_BUDGET = 232_448


class KernelContract(NamedTuple):
    """One kernel's declared memory contract.

    plan:     (*args, **kw) -> LaunchPlan (kernels/_common.py): the launches
              the wrapper makes for the entry's positional arguments,
              planned from their shapes alone by the function the wrapper
              launches from (srht_t's also from its sampled rows).
    declared: (plan) -> {"dram_bytes", "smem_bytes"}: closed forms in the
              plan's shapes and parameters of the DRAM traffic its launches
              schedule and their largest shared memory per block.
              repro_torch.analysis derives both from the plan's grid at
              every registered case (rule C001).
    bound_bytes: (shapes) -> the bytes the kernel's bound counts (its
              *_bytes: each input read once, each output written once),
              which the declared traffic must not undercut.
    smem_budget: dynamic shared memory per block the kernel must stay
              under at every registered case (rule C002).
    """
    name: str
    plan: Callable
    declared: Callable
    bound_bytes: Callable
    smem_budget: int = SMEM_BUDGET


CONTRACTS: Tuple[KernelContract, ...] = (
    KernelContract(
        name="extend_embed", plan=extend_launch_plan,
        declared=extend_contract,
        bound_bytes=lambda s: extend_embed_bytes(s["p"], s["n"], s["r"],
                                                 s["w"])),
    KernelContract(
        name="fit_sketch", plan=fit_launch_plan, declared=fit_contract,
        bound_bytes=lambda s: fit_sketch_bytes(s["p"], s["m"], s["b"],
                                               s["rp"])),
    KernelContract(
        name="fwht", plan=fwht_launch_plan, declared=fwht_contract,
        bound_bytes=lambda s: fwht_bytes(s["n"], s["c"])),
    KernelContract(
        name="gram_stripe", plan=gram_launch_plan, declared=gram_contract,
        bound_bytes=lambda s: gram_stripe_bytes(s["p"], s["n"], s["w"])),
    KernelContract(
        name="kmeans_assign", plan=assign_launch_plan,
        declared=assign_contract,
        bound_bytes=lambda s: assign_bytes(s["n"], s["r"], s["k"])),
    KernelContract(
        name="srht_t", plan=srht_launch_plan, declared=srht_contract,
        bound_bytes=lambda s: srht_t_bytes(s["m"], s["c"], s["r"],
                                           s["n_pad"])),
    KernelContract(
        name="embed_assign", plan=embed_assign_launch_plan,
        declared=embed_assign_contract,
        bound_bytes=lambda s: embed_assign_bytes(s["p"], s["n"], s["r"],
                                                 s["w"], s["k"])),
)

_CONTRACTS: Dict[str, KernelContract] = {}


def register_contract(contract: KernelContract) -> KernelContract:
    """Register one kernel's memory contract (re-registering a name
    replaces it, as register_kernel does)."""
    _CONTRACTS[contract.name] = contract
    return contract


def get_contract(name: str) -> Optional[KernelContract]:
    """The declared contract for `name`, or None: repro_torch.analysis
    reports a missing contract as C003 rather than raising here."""
    return _CONTRACTS.get(name)


for _contract in CONTRACTS:
    register_contract(_contract)


def compare(entry: KernelEntry, got, want, inputs=None) -> None:
    """Assert got == want within the entry's tolerances. `inputs` = (args,
    kw) of the call, which an entry with tie_distances needs."""
    if entry.tie_distances is not None:
        if inputs is None:
            raise ValueError(f"{entry.name}: the near-tie rule needs the "
                             f"call's inputs")
        args, kw = inputs
        entry.compare(got, want, entry.rtol, entry.atol,
                      entry.tie_distances(*args, **kw))
        return
    if entry.compare is not None:
        entry.compare(got, want, entry.rtol, entry.atol)
        return
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=entry.rtol,
                                   atol=entry.atol)
