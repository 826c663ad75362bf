"""The fwht kernel's plan for one column (c = 1, the sketched gradient's
(n_pad, 1) transform): a row pass over contiguous segments of 2^s floats,
then the pass kernel over the (n / 2^s, 2^s) view.

On the CPU: the plan's stages, grids and shared memory at n = 2^1 ..
2^31; the plan at every other width equal to the pass kernel's alone; the
factorization H_n = (H_{n/2^s} (x) I)(I (x) H_{2^s}) through fwht_ref on
the two views, bit for bit with fwht_ref on the column, and against the
JAX package's fwht (its ref.py and fwht_pallas in interpret mode, the
same factorization at 2^13); the row kernel's thread layout (loads, the
in-row stages, the register rounds, the stores) run with torch ops; and
the wrapper's launch path against a library that records its calls. The
kernel itself runs in tests/test_torch_kernels.py (`cuda`).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fwht.ops import fwht_pallas
from repro.kernels.fwht.ref import fwht_ref as jax_fwht_ref
from repro_torch.kernels import _build, _common as cm
from repro_torch.kernels.fwht import ops
from repro_torch.kernels.fwht.ref import fwht_ref
from repro_torch.kernels.registry import SMEM_BUDGET

FWHT_TOL = 2e-4          # the fwht registry tolerance (JAX against the port)


def _column(n: int, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32))


def _shape(n: int, c: int):
    """What fwht_launch_plan reads of x: its shape (no 8 GB at 2^31)."""
    return types.SimpleNamespace(shape=(n, c))


def _stages(launch):
    """The stage bits a launch runs, in order."""
    if launch.kernel == "fwht_rows_kernel":
        return list(range(launch.tiles[0]))
    k, _, _, done, _ = launch.tiles
    return list(range(done, done + k))


@pytest.mark.parametrize("m", range(1, 32))
def test_column_plan_runs_every_stage_once_in_order(m):
    """At c = 1 every stage bit 0 .. m - 1 runs once, low bits first; a
    row pass exactly from 32 rows on, over segments of 2^min(m, L); every
    grid below 2^31 blocks, every block within 1,024 threads and the
    shared memory budget."""
    n = 1 << m
    plan = ops.fwht_launch_plan(_shape(n, 1))
    bits = [b for ln in plan.launches for b in _stages(ln)]
    assert bits == list(range(m))
    s = min(m, ops.ROW_BITS) if m >= ops.MIN_ROW_BITS else 0
    assert ops.column_bits(n, 1) == s
    kernels = [ln.kernel for ln in plan.launches]
    if s:
        assert kernels[0] == "fwht_rows_kernel"
        assert plan.launches[0].grid == (n >> s,)
        assert plan.launches[0].smem == 4 << s
    assert kernels.count("fwht_rows_kernel") == (1 if s else 0)
    for ln in plan.launches:
        assert 0 < ln.grid[0] < 1 << 31
        assert ln.threads <= ops.MAX_THREADS
        assert ln.smem <= SMEM_BUDGET <= cm.GRAM_SMEM_MAX
        if ln.kernel == "fwht_pass_kernel":
            assert ln.tiles[2] == (4 if s else 1)        # 16-byte loads
            assert ln.tiles[4] == (1 << s if s else 1)   # the view's width


def test_sketched_gradient_runs_three_passes():
    """rwkv6-1.6b's (2^31, 1): the row pass over 2^13 floats, then two
    passes of 9 over the (2^18, 2^13) view, against four passes before
    (pass_bits(2^31) = 8 + 8 + 8 + 7). Each launch reads and writes the
    column once: 8 n bytes a launch, three times the bound's."""
    n = 1 << 31
    plan = ops.fwht_launch_plan(_shape(n, 1))
    assert [(ln.kernel, ln.tiles) for ln in plan.launches] == [
        ("fwht_rows_kernel", (13, 3)),
        ("fwht_pass_kernel", (9, 3, 4, 13, 1 << 13)),
        ("fwht_pass_kernel", (9, 3, 4, 22, 1 << 13))]
    assert ops.pass_bits(n) == [8, 8, 8, 7]
    assert ops.fwht_contract(plan)["dram_bytes"] == 3 * ops.fwht_bytes(n, 1)


def _today(n: int, c: int):
    """The plan of the pass kernel alone (every c != 1): one launch a pass
    of pass_bits(n), the column tiles of 8 lanes x vec columns."""
    vec = 4 if c % 4 == 0 else 1
    tiles = -(-c // (8 * vec))
    return [("fwht_pass_kernel", ((n >> k) * tiles,), 8 << (k - g),
             (32 * vec) << k) for k, g in ops.fwht_passes(n)]


@pytest.mark.parametrize("c", [512, 7, 3, 2])
@pytest.mark.parametrize("m", [0, 3, 9, 12, 14, 17, 20, 24])
def test_plan_at_other_widths_is_the_pass_kernels(c, m):
    plan = ops.fwht_launch_plan(_shape(1 << m, c))
    got = [(ln.kernel, ln.grid, ln.threads, ln.smem) for ln in plan.launches]
    assert got == _today(1 << m, c)
    assert all(ln.tiles[4] == c for ln in plan.launches)


@pytest.mark.parametrize("m", range(16, 21))
@pytest.mark.parametrize("s", [11, 12, 13])
def test_factorization_keeps_the_bits(m, s):
    """The in-row transform of the (2^(m - s), 2^s) view (stage bits
    0 .. s - 1), then its column stages (bits s .. m - 1), then the
    division by the f32 sqrt(n): fwht_ref's bits on the flat column."""
    n = 1 << m
    x = _column(n, seed=m)
    view = x.reshape(n >> s, 1 << s)
    rows = fwht_ref(view.T.contiguous(), normalize=False).T.contiguous()
    both = fwht_ref(rows, normalize=False).reshape(n, 1)
    got = both / torch.sqrt(torch.tensor(float(n), dtype=torch.float32))
    assert torch.equal(got, fwht_ref(x))


@pytest.mark.parametrize("m", [13, 14])
def test_column_against_jax(m):
    """The same column through the JAX package's fwht_ref and fwht_pallas
    (interpret mode; two sweeps past 2^13 rows) and the port's fwht_ref."""
    x = _column(1 << m, seed=100 + m)
    want = fwht_ref(x).numpy()
    jx = jnp.asarray(x.numpy())
    np.testing.assert_allclose(np.asarray(jax_fwht_ref(jx)), want,
                               rtol=FWHT_TOL, atol=FWHT_TOL)
    np.testing.assert_allclose(np.asarray(fwht_pallas(jx, interpret=True)),
                               want, rtol=FWHT_TOL, atol=FWHT_TOL)


# -- the row kernel's thread layout, with torch ops ---------------------------

def _tile_row(i, group, w, g):
    """csrc/fwht.cu tile_row<G>."""
    return (group & ((1 << w) - 1)) | (i << w) | ((group >> w) << (w + g))


def _window(r, k, g):
    return min(r * g, k - g)


def _emulate_rows(x: torch.Tensor, s: int) -> torch.Tensor:
    """fwht_rows_kernel on every segment of 2^s floats of the column x, as
    its threads run it: thread (group, lane) loads 4 floats of its lane
    from each of the tile rows tile_row(i, group, 0); stage bits 0, 1
    inside the 4, bits 2 .. 4 against the lanes h apart (the shuffle);
    then the pass's register rounds, the block exchanging its tile between
    windows; the stores from the last window."""
    k = s - ops.MIN_ROW_BITS
    g = ops.reg_bits(k)
    groups = torch.arange((ops.LANES << (k - g)) // ops.LANES)
    tile = x.reshape(-1, 1 << k, ops.LANES, 4)

    def rows_at(w):
        return torch.stack([_tile_row(i, groups, w, g)
                            for i in range(1 << g)], dim=1)

    v = tile[:, rows_at(0)].clone()       # (blocks, groups, 2^g, 8, 4)
    for h in (1, 2):
        lo = [q for q in range(4) if not q & h]
        hi = [q | h for q in lo]
        a, b = v[..., lo].clone(), v[..., hi].clone()
        v[..., lo], v[..., hi] = a + b, a - b
    lanes = torch.arange(ops.LANES)
    for h in (1, 2, 4):
        other = v[..., lanes ^ h, :]
        upper = (lanes & h).bool().view(ops.LANES, 1)
        v = torch.where(upper, other - v, v + other)
    rounds = 1 if g == 0 else -(-k // g)
    for r in range(rounds):
        if r > 0:
            sm = torch.empty_like(tile)
            sm[:, rows_at(_window(r - 1, k, g))] = v
            v = sm[:, rows_at(_window(r, k, g))].clone()
        w = _window(r, k, g)
        for lb in range(g):
            if not r * g <= w + lb < min(r * g + g, k):
                continue
            lo = [i for i in range(1 << g) if not i & (1 << lb)]
            hi = [i | (1 << lb) for i in lo]
            a, b = v[:, :, lo].clone(), v[:, :, hi].clone()
            v[:, :, lo], v[:, :, hi] = a + b, a - b
    out = torch.empty_like(tile)
    out[:, rows_at(_window(rounds - 1, k, g))] = v
    return out.reshape(x.shape)


@pytest.mark.parametrize("s", range(ops.MIN_ROW_BITS, 14))
def test_row_kernel_layout_is_the_in_row_transform(s):
    """Each thread's rows and lanes, the in-row stages and the register
    rounds as csrc/fwht.cu runs them give the in-row transform of each
    segment (stage bits 0 .. s - 1) bit for bit; a block's loads and
    stores each cover its segment once."""
    x = _column(4 << s, seed=s)
    want = fwht_ref(x.reshape(4, 1 << s).T.contiguous(),
                    normalize=False).T.reshape(x.shape)
    assert torch.equal(_emulate_rows(x, s), want)
    k = s - ops.MIN_ROW_BITS
    g = ops.reg_bits(k)
    groups = torch.arange(1 << (k - g))
    for w in {0, _window((1 if g == 0 else -(-k // g)) - 1, k, g)}:
        rows = torch.stack([_tile_row(i, groups, w, g)
                            for i in range(1 << g)]).reshape(-1)
        assert sorted(rows.tolist()) == list(range(1 << k))


# -- the wrapper's launch path ------------------------------------------------

class _Calls:
    """A kernel library that records each call and runs nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def launch_path(monkeypatch):
    lib = _Calls()
    monkeypatch.setattr(cm, "plain_path", lambda what, *t: False)
    monkeypatch.setattr(cm, "stream", lambda t: 0)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(ops.fwht_op, "launches", 0)
    return lib


@pytest.mark.parametrize("m,normalize", [(20, True), (13, True), (12, False),
                                         (14, False)])
def test_wrapper_runs_rows_then_the_view_in_place(launch_path, m,
                                                  normalize):
    """rt_fwht_rows reads x into out; rt_fwht then runs on out as its own
    input, over (n / 2^s, 2^s) at 16-byte loads; both get the whole
    transform's f32 sqrt(n), which the last launch divides by; one call
    counts one launch."""
    n = 1 << m
    x = _column(n)
    out = ops.fwht_op(x, normalize)
    s = min(m, ops.ROW_BITS)
    divisor = ops._sqrt(n) if normalize else 1.0
    (name, a), *rest = launch_path.calls
    assert name == "rt_fwht_rows"
    assert a[:6] == (x.data_ptr(), out.data_ptr(), n, s,
                     ops.reg_bits(s - 5), divisor)
    if m <= ops.ROW_BITS:
        assert rest == []
    else:
        ((name, b),) = rest
        bits = ops.pass_bits(n >> s)
        assert name == "rt_fwht"
        assert b[:4] == (out.data_ptr(), out.data_ptr(), n >> s, 1 << s)
        assert [b[4][j] for j in range(b[6])] == bits
        assert b[7:9] == (4, divisor)
    assert ops.fwht_op.launches == 1


def test_wrapper_takes_the_pass_kernel_for_an_unaligned_column(launch_path):
    """A column that does not start 16-byte aligned runs every stage in
    the pass kernel at one column a thread, as before the row pass."""
    buf = _column((1 << 15) + 1).reshape(-1)
    x = buf[1:].view(-1, 1)
    assert not ops.aligned(x)
    ops.fwht_op(x)
    ((name, a),) = launch_path.calls
    assert name == "rt_fwht"
    assert a[2:4] == (1 << 15, 1)
    assert [a[4][j] for j in range(a[6])] == ops.pass_bits(1 << 15)
    assert a[7] == 1
