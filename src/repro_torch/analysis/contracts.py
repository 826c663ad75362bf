"""Kernel memory-contract verifier (rules C001-C003), the counterpart of
repro.analysis.contracts for the port's CUDA kernels.

Each kernel registers a KernelContract (kernels/registry.py): `plan`, the
launches its wrapper makes for a call, planned from the call's shapes by
the function the wrapper itself launches from, and `declared`, closed
forms of the DRAM bytes and the shared memory in that plan's parameters.
Nothing keeps a closed form honest, so this pass derives the same
quantities from the plan and fails on divergence:

* DRAM traffic: every launch's grid is walked block by block, and each
  block counts the global-memory tiles its kernel (csrc/) loads and
  stores as the plan schedules it. A tile held in shared memory or in
  registers for the block's whole walk counts once per block; tiles that
  several blocks read count once per block (L2 hits are not subtracted).
  This is the JAX verifier's walk of each BlockSpec's index_map over the
  grid, with the CUDA kernel's schedule in place of the BlockSpecs.
* Shared memory: each launch's dynamic shared memory per block, against
  the contract's budget (Hopper's opt-in limit per block by default).

The declared DRAM bytes are the plan's traffic, not the bound's minimum
(the kernels' *_bytes functions, each input read once and each output
written once): `bound_bytes` gives those, which declared must not
undercut. Nothing here needs a card: the plans are functions of shapes.
On the card, chip_smoke's phase 20 reads each launch's kernel, grid, block
and shared memory from a torch.profiler trace and holds them to the same
plans.
"""
from __future__ import annotations

import inspect
import itertools
import math
import os
import re
from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.analysis.findings import Finding

# A derivation walks every block; a huge grid means a plan bug.
_MAX_BLOCKS = 1 << 17


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# -- each CUDA kernel's schedule: the bytes one block moves -----------------
# (plan, launch index, launch, block index) -> bytes; the csrc/ code each
# mirrors is named in its docstring.

def _gram(plan, i, launch, block) -> int:
    """csrc/gram.cu gram_kernel: block (bx, by) owns column chunk by and
    walks row steps bx, bx + grid[0], ...: per step its rows of X (p of
    them) in and of K out, and Xb's chunk unless resident (then once,
    before the walk), and the chunk once more for the rbf column norms."""
    s, g = plan.shapes, plan.detail
    p, n, w = s["p"], s["n"], s["w"]
    bx, by = block
    cols = min(g.cols, w - by * g.cols)
    total = p * cols * ((1 if g.resident else 0) + (1 if s["rbf"] else 0))
    for step in range(bx, g.tiles, launch.grid[0]):
        rows = min(g.rows, n - step * g.rows)
        total += p * rows + rows * cols + (0 if g.resident else p * cols)
    return 4 * total


def _assign(plan, i, launch, block) -> int:
    """csrc/kmeans_assign.cu assign_kernel: C staged once a block, a row a
    thread (assign.cuh nearest), its label and distance out."""
    from repro_torch.kernels.kmeans_assign.ops import ROW_REGS
    s = plan.shapes
    r, k = s["r"], s["k"]
    rows = min(launch.threads, s["n"] - block[0] * launch.threads)
    reads = 1 if r <= ROW_REGS else k + 1
    return 4 * (k * r + rows * r * reads + 2 * rows)


def _extend(plan, i, launch, block) -> int:
    """csrc/extend_embed.cu extend_embed_kernel: block (s, y) walks the
    training range s for the query group y, in passes of 8 rows of r, each
    over units of cw training points and chunks of 24 rows of p (fetch,
    store): X's rows of the unit, P's rows of the pass, the rbf norms; the
    queries once into registers (p <= 24) else per unit, their rbf norms
    once; the range's partial of the pass's rows at its end."""
    s = plan.shapes
    p, n, r, w = s["p"], s["n"], s["r"], s["w"]
    tiles, per = launch.tiles
    rng, y = block
    begin, end = rng * per, min(n, (rng + 1) * per)
    group = 16 * 8 * tiles
    queries = min(w, (y + 1) * group) - y * group
    one = p <= 24
    cw = 128 if one else 16
    total = p * queries * ((1 if one else 0) + (1 if s["rbf"] else 0))
    for c0 in range(0, r, 8):
        rows = min(8, r - c0)
        for i0 in range(begin, end, cw):
            points = min(cw, end - i0)
            total += p * points * (2 if s["rbf"] else 1) + rows * points
            total += 0 if one else p * queries
        total += rows * queries
    return 4 * total


def _sum_splits(plan, i, launch, block) -> int:
    """csrc/common.cuh sum_splits_kernel: an output a thread, the sum of
    its nsplit partials."""
    nsplit, length = launch.tiles
    outs = min(launch.threads, length - block[0] * launch.threads)
    return 4 * outs * (nsplit + 1)


def _sum_assign(plan, i, launch, block) -> int:
    """csrc/extend_embed.cu sum_assign_kernel: 128 queries a block, their r
    partial sums over nsplit ranges into the embedding, C staged, then a
    query a thread from its embedding read back."""
    from repro_torch.kernels.kmeans_assign.ops import ROW_REGS
    s = plan.shapes
    r, w = s["r"], s["w"]
    nsplit, k = launch.tiles
    queries = min(launch.threads // 2, w - block[0] * (launch.threads // 2))
    reads = 1 if r <= ROW_REGS else k + 1
    return 4 * (r * queries * (nsplit + 1 + reads) + k * r + 2 * queries)


def _fit(plan, i, launch, block) -> int:
    """csrc/fit_sketch.cu fit_sketch_kernel: the block of row range s walks
    passes of 8 columns of r' and chunks of 512 block columns (load_cols),
    each over 64-row tiles (fetch, store; past 24 rows of p, C and X again
    per 16 rows), writes each tile's delta and rn_rows (read-modify-write
    past the first chunk) and, per pass and chunk, its partials."""
    s = plan.shapes
    p, m, b, rp = s["p"], s["m"], s["b"], s["rp"]
    (per,) = launch.tiles
    begin, end = block[0] * per, min(m, (block[0] + 1) * per)
    rbf = 2 if s["rbf"] else 1
    total = 0
    for c0 in range(0, rp, 8):
        cols = min(8, rp - c0)
        for j0 in range(0, b, 512):
            bc = min(512, b - j0)
            total += min(24, p) * bc + bc * cols
            total += p * bc if s["rbf"] else 0
            for i0 in range(begin, end, 64):
                rows = min(64, end - i0)
                total += p * rows * rbf + rows * cols
                total += rows if s["v"] else 0
                total += 0 if p <= 24 else _cdiv(rows, 16) * p * bc
                total += (cols * rows + (rows if c0 == 0 else 0)) * \
                    (2 if j0 else 1)
            total += bc * cols + (bc if c0 == 0 else 0)
    return 4 * total


def _fwht_pass(plan, i, launch, block) -> int:
    """csrc/fwht.cu fwht_pass_kernel: a tile of 2^k rows by 8 lanes x vec
    columns of the c-column matrix the pass runs on, read and written
    once."""
    k, _, vec, _, c = launch.tiles
    width = 8 * vec
    cols = min(width, c - (block[0] % _cdiv(c, width)) * width)
    return 8 * (1 << k) * cols


def _fwht_rows(plan, i, launch, block) -> int:
    """csrc/fwht.cu fwht_rows_kernel: a contiguous segment of 2^s floats,
    read and written once."""
    s, _ = launch.tiles
    return 8 * (1 << s)


def _srht_pass(plan, i, launch, block) -> int:
    """csrc/fwht.cu srht_pass_kernel: block b of a column tile reads
    bases[b] and wptr[b], wptr[b + 1]; its rows below m_src (the first
    pass: and their signs; a first-pass block whose base is past m reads
    no row and writes zeros); per row it writes, wj and wdst (wdst only
    for the zeros) and the row."""
    c = plan.shapes["c"]
    k, _, vec, stride, m_src, _ = launch.tiles
    width = 8 * vec
    tiles = _cdiv(c, width)
    b, t = divmod(block[0], tiles)
    cols = min(width, c - t * width)
    ps = plan.detail[i]
    base = int(ps.bases[b])
    writes = int(ps.wptr[b + 1] - ps.wptr[b])
    if i == 0 and base >= m_src:
        return 16 + writes * (8 + 4 * cols)
    rows = min(1 << k, max(0, _cdiv(m_src - base, stride)))
    signs = rows if i == 0 else 0
    return 16 + 4 * (rows * cols + signs) + writes * (12 + 4 * cols)


SCHEDULES: Dict[str, Callable] = {
    "gram_kernel": _gram,
    "assign_kernel": _assign,
    "extend_embed_kernel": _extend,
    "sum_splits_kernel": _sum_splits,
    "sum_assign_kernel": _sum_assign,
    "fit_sketch_kernel": _fit,
    "fwht_pass_kernel": _fwht_pass,
    "fwht_rows_kernel": _fwht_rows,
    "srht_pass_kernel": _srht_pass,
}


def derive(plan) -> Dict[str, int]:
    """The plan's DRAM bytes (every launch's blocks walked) and its
    largest dynamic shared memory per block."""
    total = 0
    for i, launch in enumerate(plan.launches):
        blocks = math.prod(launch.grid)
        if blocks > _MAX_BLOCKS:
            raise ValueError(f"{launch.kernel}: grid {launch.grid} has "
                             f"{blocks} blocks; refusing to walk it")
        schedule = SCHEDULES[launch.kernel]
        for block in itertools.product(*(range(g) for g in launch.grid)):
            total += schedule(plan, i, launch, block)
    return {"dram_bytes": total,
            "smem_bytes": max((ln.smem for ln in plan.launches), default=0)}


# -- the launches a torch.profiler trace shows --------------------------------

def _kernel_of(name: str):
    """The scheduled kernel a trace event's name (demangled, or mangled as
    <length><name>) launches, or None for any other kernel."""
    for kernel in SCHEDULES:
        if re.search(rf"(?<!\w){kernel}(?=[<(])|{len(kernel)}{kernel}", name):
            return kernel
    return None


def traced_launches(events) -> List[Tuple[str, Tuple[int, ...],
                                          Tuple[int, ...], int]]:
    """(kernel, grid, block, shared memory per block) of every launch of a
    scheduled kernel among a torch.profiler chrome trace's events, in
    start order. CUPTI reports static plus dynamic shared memory."""
    out = []
    kernels = [e for e in events if str(e.get("cat", "")).lower() == "kernel"]
    for e in sorted(kernels, key=lambda e: e["ts"]):
        kernel = _kernel_of(e["name"])
        if kernel is not None:
            a = e["args"]
            out.append((kernel, tuple(a["grid"]), tuple(a["block"]),
                        int(a["shared memory"])))
    return out


def planned_launch(launch, static_smem: int = 0) -> Tuple:
    """A plan's launch as traced_launches reads it from a trace, the
    kernel's static shared memory (ptxas) added to the dynamic."""
    grid = tuple(launch.grid) + (1,) * (3 - len(launch.grid))
    return (launch.kernel, grid, (launch.threads, 1, 1),
            launch.smem + static_smem)


# -- the rules ----------------------------------------------------------------

def _anchor(obj) -> Tuple[str, int]:
    """(repo-relative path, line) for a callable, for finding anchors."""
    try:
        path = inspect.getsourcefile(obj) or "<unknown>"
        line = obj.__code__.co_firstlineno
    except (TypeError, AttributeError):
        return "<unknown>", 1
    path = path.replace(os.sep, "/")
    marker = "/src/repro_torch/"
    idx = path.find(marker)
    if idx >= 0:
        path = "src/repro_torch/" + path[idx + len(marker):]
    return path, line


def case_plan(entry, contract, case: dict, seed: int = 0):
    """The launch plan of a registry case: the entry's inputs for the case
    (numpy, from `seed`), planned by the contract."""
    args, kw = entry.build(np.random.default_rng(seed), case)
    return contract.plan(*args, **kw)


def verify_contracts() -> List[Finding]:
    """Cross-check every registered kernel at every parity case."""
    from repro_torch.kernels.registry import get_contract, kernel_entries

    findings: List[Finding] = []
    for entry in kernel_entries():
        contract = get_contract(entry.name)
        path, line = _anchor(entry.op)

        def emit(rule: str, message: str) -> None:
            findings.append(Finding(rule=rule, path=path, line=line,
                                    symbol=entry.name, message=message))

        if contract is None:
            emit("C003", f"registered kernel {entry.name!r} declares no "
                         f"memory contract (register_contract missing)")
            continue
        for case in entry.cases:
            plan = case_plan(entry, contract, case)
            if not plan.launches:
                emit("C001", f"case {case}: the plan makes no launch to "
                             f"derive a contract from")
                continue
            declared = contract.declared(plan)
            derived = derive(plan)
            for key, what in (("dram_bytes", "DRAM bytes"),
                              ("smem_bytes", "bytes of shared memory")):
                if declared[key] != derived[key]:
                    emit("C001", f"case {case}: declared {declared[key]} "
                                 f"{what} but the launch plan implies "
                                 f"{derived[key]}")
            for ln in plan.launches:
                if ln.smem > contract.smem_budget:
                    emit("C002", f"case {case}: {ln.kernel} holds {ln.smem} "
                                 f"B of shared memory a block (budget "
                                 f"{contract.smem_budget} B)")
    return findings
