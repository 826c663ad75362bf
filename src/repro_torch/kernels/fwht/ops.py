"""Wrappers of the FWHT CUDA kernel and its SRHT form (csrc/fwht.cu).

The plan of every launch is made here, where the CPU tests reach it:
`pass_bits` splits the stages into passes, `reg_bits` each pass into
register rounds, `column_bits` one column's transform into a row pass and
the passes over its (n / 2^L, 2^L) view, and `srht_plan` the blocks and
rows each pass of the SRHT form runs and writes.
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import _build, _common as cm
from repro_torch.kernels.fwht.ref import fwht_ref, srht_t_ref

# Butterfly stages one pass runs: 2^10 rows x 32 columns of f32 is the
# largest tile, 128 KB of a block's 227 KB of shared memory.
MAX_PASS_BITS = 10
# Stages a thread runs in registers between two exchanges through shared
# memory: it holds 2^3 rows of its lane (32 floats at 4 columns). On the
# H100, 3 beat 4 and 5 (PERF.md): the 64 registers a thread then needs let
# two 512-thread blocks share an SM, where 5 (213 registers) leaves one
# block of loads in flight per SM. With passes of <= 10 stages a block
# then has at most 8 x 2^7 = 1024 threads.
MAX_REG_BITS = 3
# Threads across one row of a tile (csrc/fwht.cu, kLanes) and the most a
# block may have.
LANES = 8
MAX_THREADS = 1024
# One column (c = 1) runs as a row pass over contiguous segments of 2^L
# floats, then passes over the (n / 2^L, 2^L) view. A segment is a tile of
# 2^(L - 5) rows of 32 floats (8 lanes x 4), so L >= 5; L = 13 holds a
# segment in 32 KB of shared memory and leaves 18 bits at n = 2^31, two
# passes of 9 (PERF.md: 11 and 12 were tried beside it).
ROW_BITS = 13
MIN_ROW_BITS = 5


def pass_bits(n: int, max_bits: Optional[int] = None) -> List[int]:
    """Stages of each pass over n rows: log2(n) split as evenly as
    possible into passes of at most max_bits (MAX_PASS_BITS), low bits
    first."""
    max_bits = max_bits or MAX_PASS_BITS
    m = n.bit_length() - 1
    passes = -(-m // max_bits)
    if passes == 0:
        return []
    return [m // passes + (i < m % passes) for i in range(passes)]


def reg_bits(k: int) -> int:
    """Register stages per round of a k-stage pass (k <= MAX_PASS_BITS):
    the block then has 8 x 2^(k - G) <= 1024 threads."""
    return min(MAX_REG_BITS, k)


def aligned(*tensors: torch.Tensor) -> bool:
    """Every tensor starts 16-byte aligned (fresh allocations do)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def vec_width(c: int, *tensors: torch.Tensor) -> int:
    """Columns per thread: 4 (16-byte loads and stores) when every row
    starts 16-byte aligned, else 1."""
    return 4 if c % 4 == 0 and aligned(*tensors) else 1


def column_bits(n: int, c: int) -> int:
    """Stage bits of the row pass for x (n, c): min(log2(n), ROW_BITS) for
    one column of at least 2^MIN_ROW_BITS rows, else 0 (no row pass: the
    pass kernel runs every stage, as at every c != 1)."""
    m = n.bit_length() - 1
    return min(m, ROW_BITS) if c == 1 and m >= MIN_ROW_BITS else 0


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


@functools.lru_cache(maxsize=64)
def fwht_passes(n: int, max_pass_bits: int = MAX_PASS_BITS) -> tuple:
    """(stages, register stages per round) of each pass over n rows."""
    bits = pass_bits(n, max_pass_bits) or [0]   # n == 1: one pass, no stages
    return tuple((k, reg_bits(k)) for k in bits)


@functools.lru_cache(maxsize=64)
def _fwht_plan(n: int, max_pass_bits: int) -> tuple:
    """rt_fwht's plan arguments (stages and register bits per pass, and
    the number of passes), made once per length and pass size."""
    passes = fwht_passes(n, max_pass_bits)
    return (_ints([k for k, _ in passes]), _ints([g for _, g in passes]),
            len(passes))


def _pass_launch(kernel: str, blocks: int, c: int, k: int, g: int,
                 vec: int, tiles: tuple) -> cm.Launch:
    """One pass kernel's launch (csrc/fwht.cu fwht_launch / srht_launch):
    `blocks` row tiles times the column tiles of 8 lanes x vec columns,
    8 x 2^(k - g) threads, a tile of 2^k rows in shared memory."""
    col_tiles = -(-c // (LANES * vec))
    return cm.Launch(kernel, (blocks * col_tiles,), LANES << (k - g),
                     (4 * LANES * vec) << k, tiles)


def planned_vec(c: int) -> int:
    """vec_width of 16-byte aligned tensors: 4 where c allows it."""
    return 4 if c % 4 == 0 else 1


def _rows_launch(n: int, s: int) -> cm.Launch:
    """The row pass's launch (csrc/fwht.cu rows_launch): a block per
    segment of 2^s floats, 8 x 2^(k - g) threads, a tile of 2^k rows of
    32 floats in shared memory (k = s - 5)."""
    k = s - MIN_ROW_BITS
    g = reg_bits(k)
    return cm.Launch("fwht_rows_kernel", (n >> s,), LANES << (k - g),
                     (4 * LANES * 4) << k, (s, g))


def fwht_launch_plan(x, normalize: bool = True) -> cm.LaunchPlan:
    """The launches fwht_op makes for x (n, c), its tensors 16-byte
    aligned (fresh allocations are): for one column, the row pass and
    then one pass kernel a pass over the (n / 2^s, 2^s) view; else one
    pass kernel a pass over x. A pass launch's tiles are (stages,
    register stages, vec, stages done, columns of the matrix it runs
    on)."""
    n, c = x.shape
    s = column_bits(n, c)
    launches, rows, cols = [], n, c
    if s:
        launches.append(_rows_launch(n, s))
        rows, cols = n >> s, 1 << s
    # Without a row pass, n == 1 still runs one pass of no stages.
    passes = fwht_passes(rows) if c and (rows > 1 or not s) else ()
    vec, done = planned_vec(cols), s
    for k, g in passes:
        launches.append(_pass_launch("fwht_pass_kernel", rows >> k, cols, k,
                                     g, vec, (k, g, vec, done, cols)))
        done += k
    return cm.LaunchPlan({"n": n, "c": c}, tuple(launches))


def fwht_op(x: torch.Tensor,
            normalize: bool = True) -> torch.Tensor:  # hot-path
    """Walsh-Hadamard transform along dim 0 of x (n, c), n = 2^m, float32.

    CPU tensors run the plain version; CUDA tensors launch the pass kernel
    once per pass (pass_bits). One column of at least 32 rows (c == 1, the
    sketched gradient's) runs the row pass over contiguous segments of
    2^s floats (column_bits) and then the pass kernel over the (n / 2^s,
    2^s) view of the output, in place; a column that does not start
    16-byte aligned takes the pass kernel alone, as every c != 1 does.
    Either way the stages run in the plain version's order and the last
    launch divides by the same f32 sqrt(n), so the two agree bit for bit.
    `launches` counts transforms, one per call that ran the kernel.
    """
    what = "fwht"
    # Checked on both paths, so a CPU run catches what the kernel refuses.
    cm.contiguous(what, "x", x, 2)
    n, c = x.shape
    if n < 1 or n & (n - 1):
        raise ValueError(f"{what}: power-of-two length required, got {n}")
    if cm.plain_path(what, x):
        return fwht_ref(x, normalize)
    out = torch.empty_like(x)
    if c == 0:
        return out
    lib, st = _build.library(), cm.stream(x)
    divisor = _sqrt(n) if normalize else 1.0
    s = column_bits(n, c) if aligned(x, out) else 0
    if s:
        rows = n >> s
        _build.check(lib.rt_fwht_rows(
            x.data_ptr(), out.data_ptr(), n, s, reg_bits(s - MIN_ROW_BITS),
            divisor, st), what)
        if rows > 1:
            _build.check(lib.rt_fwht(
                out.data_ptr(), out.data_ptr(), rows, 1 << s,
                *_fwht_plan(rows, MAX_PASS_BITS), 4, divisor, st), what)
    else:
        _build.check(lib.rt_fwht(
            x.data_ptr(), out.data_ptr(), n, c,
            *_fwht_plan(n, MAX_PASS_BITS), vec_width(c, x, out), divisor,
            st), what)
    fwht_op.launches += 1
    return out


fwht_op.launches = 0


@functools.lru_cache(maxsize=None)
def _sqrt(n: int) -> float:
    """The plain version's f32 sqrt(n), as a Python float."""
    return float(torch.sqrt(torch.tensor(float(n), dtype=torch.float32)))


class SrhtPass(NamedTuple):
    """One pass of the SRHT form, as the kernel runs it.

    The pass transforms the row bits [done, done + k) of n_pad rows.
    Block b gathers the source rows bases[b] + j * stride (j < 2^k) and,
    after the k stages, writes its tile rows wj[wptr[b]:wptr[b + 1]] to
    the destination rows wdst[...]. The destination holds out_rows rows:
    for every pass but the last, the rows whose low done + k bits are one
    of `residues`, in the order (row >> (done + k), residue index); for
    the last, one row per sampled row.
    """
    done: int
    k: int
    stride: int
    residues: np.ndarray
    bases: np.ndarray
    wptr: np.ndarray
    wj: np.ndarray
    wdst: np.ndarray
    out_rows: int


def srht_plan(rows, n_pad: int,
              max_bits: Optional[int] = None) -> List[SrhtPass]:
    """The passes of Omega^T M for the sampled rows `rows` of an n_pad-row
    transform. A pass writes a row only if its transformed low bits equal
    a sampled row's, and a pass runs only the blocks that hold such rows:
    the first pass reads every row of M once; at n_pad = 2^17 it writes
    <= r' rows of each 256-row block and the second runs <= r' blocks."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    if n_pad < 1 or n_pad & (n_pad - 1):
        raise ValueError(f"n_pad must be a power of two, got {n_pad}")
    if rows.size and (rows.min() < 0 or rows.max() >= n_pad):
        raise ValueError(f"sampled rows must lie in [0, {n_pad})")
    # The short pass first: the first pass reads M from HBM, and smaller
    # tiles (2^8 rows at n_pad = 2^17) put more blocks in flight on an SM;
    # the later passes run on the small scratch, in L2.
    bits = sorted(pass_bits(n_pad, max_bits)) or [0]
    prev = np.zeros(1, np.int64)                 # residues mod 2^0
    plan, done = [], 0
    for i, k in enumerate(bits):
        e = done + k
        last = i == len(bits) - 1
        n_hi = n_pad >> e
        # The rows this pass writes: for every residue class `item` of the
        # low e bits (the sampled rows themselves on the last pass), the
        # block (hi, t) with prev[t] == item mod 2^done writes its tile
        # row item >> done to destination row hi * len(items) + index.
        items = rows if last else np.unique(rows % (1 << e))
        t_item = np.searchsorted(prev, items % (1 << done))
        order = np.argsort(t_item, kind="stable")
        per_block = np.bincount(t_item, minlength=prev.size)
        n_blocks = n_hi * prev.size
        hi = np.repeat(np.arange(n_hi, dtype=np.int64), prev.size)
        t = np.tile(np.arange(prev.size, dtype=np.int64), n_hi)
        wptr = np.zeros(n_blocks + 1, np.int64)
        np.cumsum(np.tile(per_block, n_hi), out=wptr[1:])
        plan.append(SrhtPass(
            done=done, k=k, stride=prev.size, residues=items,
            bases=hi * (prev.size << k) + t,
            wptr=wptr.astype(np.int32),
            wj=np.tile(items[order] >> done, n_hi).astype(np.int32),
            wdst=(np.arange(n_hi, dtype=np.int64)[:, None] * items.size
                  + order[None, :]).reshape(-1),
            out_rows=n_hi * items.size))
        prev, done = items, e
    return plan


class _DevicePass(NamedTuple):
    host: SrhtPass
    bases: torch.Tensor
    wptr: torch.Tensor
    wj: torch.Tensor
    wdst: torch.Tensor


# Plans on the device, made once per sampled-rows tensor (a sketch's rows
# never change) and dropped with it: id(rows) -> (weak ref, key, plan).
_plans: Dict[int, tuple] = {}


def _device_plan(rows: torch.Tensor, n_pad: int) -> List[_DevicePass]:
    key = (n_pad, MAX_PASS_BITS)
    cached = _plans.get(id(rows))
    if cached is not None and cached[0]() is rows and cached[1] == key:
        return cached[2]
    dev = rows.device
    plan = [_DevicePass(p, *(torch.from_numpy(a).to(dev) for a in
                             (p.bases, p.wptr, p.wj, p.wdst)))
            for p in srht_plan(rows.cpu().numpy(), n_pad)]
    _plans[id(rows)] = (weakref.ref(rows), key, plan)
    weakref.finalize(rows, _plans.pop, id(rows), None)
    return plan


def srht_t_op(M: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor,
              n_pad: int, normalize: bool = True) -> torch.Tensor:  # hot-path
    """Omega^T M = R^T H D M for M (m, c) float32, m <= n_pad -> (r', c).

    Rows m .. n_pad - 1 of M are taken as zero; signs (n_pad,) is D and
    rows (r',) int64 are R. CPU tensors run the plain version; CUDA
    tensors launch the pass kernel once per pass of srht_plan, which
    reads each row of M below m once and writes only what the sampled
    rows need. Equal to the plain version by value (a zero may differ in
    sign). `launches` counts transforms.
    """
    what = "srht_t"
    cm.contiguous(what, "M", M, 2)
    cm.contiguous(what, "signs", signs, 1)
    if rows.dtype != torch.int64 or rows.dim() != 1:
        raise TypeError(f"{what}: rows must be 1-D int64, got {rows.dtype} "
                        f"of shape {tuple(rows.shape)}")
    m, c = M.shape
    if n_pad < 1 or n_pad & (n_pad - 1):
        raise ValueError(f"{what}: n_pad must be a power of two, got {n_pad}")
    if m > n_pad or signs.shape[0] != n_pad:
        raise ValueError(f"{what}: M has {m} rows and signs {signs.shape[0]}"
                         f" for n_pad = {n_pad}")
    if cm.plain_path(what, M, signs, rows):
        return srht_t_ref(M, signs, rows, n_pad, normalize)
    out = torch.empty((rows.shape[0], c), dtype=torch.float32,
                      device=M.device)
    if c == 0 or out.shape[0] == 0:
        return out
    plan = _device_plan(rows, n_pad)
    lib = _build.library()
    src, m_src, sgn = M, m, signs.data_ptr()
    for i, p in enumerate(plan):
        last = i == len(plan) - 1
        dst = out if last else torch.empty((p.host.out_rows, c),
                                           dtype=torch.float32,
                                           device=M.device)
        vec = vec_width(c, src, dst)
        rc = lib.rt_srht_t_pass(
            src.data_ptr(), m_src, sgn, p.bases.data_ptr(),
            int(p.bases.shape[0]), p.host.stride, p.wptr.data_ptr(),
            p.wj.data_ptr(), p.wdst.data_ptr(), dst.data_ptr(), c, p.host.k,
            reg_bits(p.host.k), vec,
            _sqrt(n_pad) if last and normalize else 1.0, int(last),
            cm.stream(M))
        _build.check(rc, what)
        src, m_src, sgn = dst, p.host.out_rows, None
    srht_t_op.launches += 1
    return out


srht_t_op.launches = 0


def srht_launch_plan(M, signs, rows, n_pad: int,
                     normalize: bool = True) -> cm.LaunchPlan:
    """The launches srht_t_op makes for these arguments, its tensors
    16-byte aligned: one pass kernel per pass of srht_plan, each over the
    blocks its plan runs; the detail is the passes."""
    m, c = M.shape
    rows = (rows.cpu().numpy() if isinstance(rows, torch.Tensor)
            else np.asarray(rows))
    shapes = {"m": m, "c": c, "r": int(rows.shape[0]), "n_pad": n_pad}
    if c == 0 or rows.shape[0] == 0:
        return cm.LaunchPlan(shapes, ())
    passes = srht_plan(rows, n_pad)
    vec, m_src, launches = planned_vec(c), m, []
    for i, p in enumerate(passes):
        g = reg_bits(p.k)
        launches.append(_pass_launch(
            "srht_pass_kernel", len(p.bases), c, p.k, g, vec,
            (p.k, g, vec, p.stride, m_src, int(i == len(passes) - 1))))
        m_src = p.out_rows
    return cm.LaunchPlan(shapes, tuple(launches), passes)


def fwht_contract(plan: cm.LaunchPlan) -> dict:
    """The declared memory contract of one transform: every launch (the
    row pass and each pass) reads and writes all of x (n, c); shared
    memory holds a launch's widest tile."""
    s = plan.shapes
    return {"dram_bytes": 8 * s["n"] * s["c"] * len(plan.launches),
            "smem_bytes": max((ln.smem for ln in plan.launches), default=0)}


def srht_contract(plan: cm.LaunchPlan) -> dict:
    """The declared memory contract of Omega^T M, in its passes' figures.
    Every block of a column tile reads its base and write range (16
    bytes), the source rows of its tile below m_src (the first pass also
    their signs) and, per row it writes, its tile row and destination (12
    bytes; a first-pass block past m writes zeros and reads only the
    destinations); each pass reads its source once (M's m rows, then the
    previous pass's rows) and writes out_rows rows."""
    s = plan.shapes
    m, c = s["m"], s["c"]
    if not plan.launches:
        return {"dram_bytes": 0, "smem_bytes": 0}
    tiles = -(-c // (LANES * planned_vec(c)))
    first = plan.detail[0]
    zero = int(np.diff(first.wptr)[first.bases >= m].sum())
    total, src = tiles * 4 * m - tiles * 4 * zero, m
    for p in plan.detail:
        total += (16 * len(p.bases) * tiles + 4 * c * (src + p.out_rows)
                  + 12 * tiles * p.out_rows)
        src = p.out_rows
    return {"dram_bytes": total,
            "smem_bytes": max(ln.smem for ln in plan.launches)}


def fwht_bytes(n: int, c: int) -> int:
    """Bytes a transform of (n, c) must move: x read once, written once."""
    return 8 * n * c


def srht_t_bytes(m: int, c: int, r_prime: int, n_pad: int) -> int:
    """Bytes Omega^T M must move: M's m rows and the signs read once, the
    (r', c) result written once."""
    return 4 * (m * c + n_pad + r_prime * c)
