"""The gram kernel (csrc/gram.cu): its launch plan, its index maps and its
numerics where they can be tested without the card, and the kernel
against its plain version on the card.

- kernels/_common.py gram_plan over n, w and p: every row of every column
  chunk is walked by one block once, every vector store of the write-back
  is 16-byte aligned when the rows are (w % 4 == 0), and the shared memory
  fits a block (227 KB) and equals gram_smem_bytes.
- One row step of one block as the kernel computes it, lane by lane in
  numpy: each warp's 16 x 64 tile, X through load_a's A fragments k-group
  by k-group, Xb through load_xb's B-fragment slots (resident, or one
  chunk of p at a time), the mma.sync m16n8k8 fragment maps, kappa with
  the quad-summed row norms, the warp's staging rows and store_tile's
  lane map.
- A torch emulation of the 3xTF32 product (tests/torch_tf32.py) against
  the JAX package's gram_stripe_ref at the registry cases and at p 19,
  w 512, n 4,096 for the three kinds, within the registry's 2e-3; one
  TF32 product misses it at rbf.
- `cuda` cases: the kernel against its plain version at the main shape in
  the three kinds, at ragged, strided, column-tiled, deep (p resident in
  narrower column chunks) and p-tiled shapes and at p = 0, the same bits
  on two launches, and a plan that differs from the kernel's layout
  refused. This file imports JAX only inside the tests that need it:

    python -m pytest --noconftest -m cuda tests/test_torch_gram_tc.py

Inputs are made with numpy from a seed; the JAX side runs on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _common as cm
from repro_torch.kernels import registry
from torch_tf32 import mm1, mm3, mma

TOL = 2e-3                # the gram registry tolerance
ENTRY = registry.get_kernel("gram_stripe")
WIDE = {"p": 19, "n": 4096, "w": 512}
KINDS = ({}, {"kind": "rbf", "gamma": 0.5},
         {"kind": "linear"})


@pytest.fixture(scope="module")
def jax_ref():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.gram.ref import gram_stripe_ref

    def ref(X, Xb, **kw):
        return np.asarray(gram_stripe_ref(jnp.asarray(X), jnp.asarray(Xb),
                                          **kw))
    return ref


def _kappa(z, xn, yn, kind="polynomial", gamma=0.0, degree=2):
    if kind == "polynomial":
        return (z + gamma) ** int(degree)
    if kind == "rbf":
        return np.exp(-gamma * np.maximum(xn + yn - 2.0 * z, 0.0))
    return z


# -- the plan -----------------------------------------------------------------

@pytest.mark.parametrize("p", [0, 2, 19, 100, 400])
@pytest.mark.parametrize("w", [1, 12, 37, 512, 600, 4096])
@pytest.mark.parametrize("n", [1, 97, 555, 100_000])
def test_gram_plan_covers_each_row_once_with_aligned_copies(n, w, p):
    plan = cm.gram_plan(n, w, p)
    assert plan.smem <= cm.GRAM_SMEM_MAX == 227 * 1024
    assert plan.smem == cm.gram_smem_bytes(plan.col_warps, plan.krows)
    assert plan.rows * plan.col_warps == 16 * cm.GRAM_WARPS
    assert plan.cols == 64 * plan.col_warps
    assert plan.krows % 8 == 0 and plan.krows >= 8
    assert plan.resident == (plan.krows >= p)
    if not plan.resident:
        # p walked in chunks of whole k-groups, at the narrowest chunk.
        assert plan.krows % cm.GRAM_KGROUP == 0 and plan.col_warps == 1
    # Column chunks: one block column each, together every column once.
    assert plan.grid[1] == plan.chunks == -(-w // plan.cols)
    cols = np.concatenate([np.arange(c * plan.cols,
                                     min(w, (c + 1) * plan.cols))
                           for c in range(plan.chunks)])
    np.testing.assert_array_equal(cols, np.arange(w))
    # Row steps: block b walks steps b, b + grid[0], ...; every row once.
    gx = plan.grid[0]
    assert 1 <= gx <= plan.tiles == -(-n // plan.rows)
    assert gx * plan.chunks <= cm.GRAM_SMS or gx == 1
    count = np.zeros(n, np.int64)
    for b in range(gx):
        for t in range(b, plan.tiles, gx):
            count[t * plan.rows:(t + 1) * plan.rows] += 1
    assert (count == 1).all()
    # The write-back's vector stores: lane l of a warp stores four floats
    # from column 64 wc + 4 (l % 16) of its chunk, 16-byte aligned where
    # the rows are (the output itself starts on 16 bytes); else one float
    # at a time.
    if w % 4 == 0:
        rows = np.arange(n, dtype=np.int64)
        for j0 in range(0, w, 4):
            assert (4 * (rows * w + j0) % 16 == 0).all()


def test_gram_plan_at_the_main_shape_and_the_tiled_ones():
    """The main shape keeps Xb (19, 512) resident as 3 k-steps of B
    fragments beside one 16 x 68 staging buffer per warp; w 4,096 walks 8
    column chunks with Xb's chunk resident; p 100 stays resident in four
    chunks of 128 columns, p 312 in eight of 64; past that (p 313, 400) p
    is walked in chunks of 9 k-groups; p 0 still stages one k8 step."""
    main = cm.gram_plan(100_000, 512, 19)
    assert (main.rows, main.cols, main.chunks, main.krows, main.resident,
            main.tiles, main.grid) == (32, 512, 1, 24, True, 3125, (132, 1))
    assert main.smem == 512 * 24 * 8 + 512 * 4 + 16 * 16 * 68 * 4
    wide = cm.gram_plan(100_000, 4096, 19)
    assert (wide.chunks, wide.resident, wide.grid) == (8, True, (16, 8))
    deep = cm.gram_plan(100_000, 512, 100)
    assert (deep.cols, deep.chunks, deep.krows, deep.resident,
            deep.grid) == (128, 4, 104, True, (33, 4))
    assert cm.gram_plan(100_000, 512, 312).resident
    for p in (313, 400):
        tiled = cm.gram_plan(100_000, 512, p)
        assert (tiled.cols, tiled.krows, tiled.resident) == (64, 288, False)
    empty = cm.gram_plan(5, 1, 0)
    assert (empty.krows, empty.resident) == (8, True)


# -- one row step through the kernel's maps -----------------------------------

def _step_through_maps(X, Xb, plan, step, chunk, kind="polynomial",
                       gamma=0.0, degree=2):
    """Row step `step` of the block of column chunk `chunk` as gram.cu
    computes it, in float64 (the maps, not the rounding): returns what
    the warps' lanes store, as {(row, column): value}, and checks that
    each entry is stored once and each vector store is aligned."""
    p, n = X.shape
    w = Xb.shape[1]
    cols, kr = plan.cols, plan.krows
    c0 = chunk * cols
    lanes = [divmod(lane, 4) for lane in range(32)]
    yn = np.array([(Xb[:, c0 + j] ** 2).sum() if c0 + j < w else 0.0
                   for j in range(cols)])
    pchunks = 1 if plan.resident else -(-p // kr)
    kgroups = -(-p // 32)

    def xv(k, i):
        return X[k, i] if k < p and i < n else 0.0

    def xbv(k, j):
        return Xb[k, j] if k < p and j < w else 0.0

    # load_xb per chunk of p: B-fragment slot s = (jt ks_all + ks) 32 +
    # lane holds Xb[k0 + 8ks + t][c0 + 8jt + g] and four rows down.
    ks_all = kr // 8
    xbs = []
    for pc in range(pchunks):
        f = np.zeros((cols * kr // 2, 2))
        for s in range(len(f)):
            g, t = lanes[s & 31]
            ks, jt = (s >> 5) % ks_all, (s >> 5) // ks_all
            k, j = pc * kr + 8 * ks + t, c0 + 8 * jt + g
            f[s] = xbv(k, j), xbv(k + 4, j)
        xbs.append(f)
    written = {}
    warps = cm.GRAM_WARPS
    for warp in range(warps):
        wr, wc = divmod(warp, plan.col_warps)
        i0 = 16 * (step * (warps // plan.col_warps) + wr)
        wcols = min(64, w - c0 - 64 * wc)
        if wcols <= 0 or i0 >= n:
            continue
        stage = np.full((16, 68), np.nan)       # the warp's staging rows
        acc = np.zeros((8, 32, 4))
        norm = np.zeros((32, 2))
        for pc in range(pchunks):
            g0 = pc * kr // 32
            g1 = kgroups if plan.resident else min(kgroups,
                                                   (pc + 1) * kr // 32)
            for kg in range(g0, g1):
                for ks in range(min(4, (p - 32 * kg + 7) // 8)):
                    # load_a: a_h = X[32 kg + 8ks + t + 4 (h >> 1)][i0 + g
                    # + 8 (h & 1)].
                    a = np.array([[xv(32 * kg + 8 * ks + t + 4 * (h >> 1),
                                      i0 + g + 8 * (h & 1))
                                   for h in range(4)] for g, t in lanes])
                    norm[:, 0] += a[:, 0] ** 2 + a[:, 2] ** 2
                    norm[:, 1] += a[:, 1] ** 2 + a[:, 3] ** 2
                    kc = 4 * (kg - g0) + ks        # k8 step in the chunk
                    for nt in range(8):
                        slots = (((8 * wc + nt) * ks_all + kc) * 32
                                 + np.arange(32))
                        acc[nt] = mma(a, xbs[pc][slots], acc[nt])
        for lane, (g, t) in enumerate(lanes):
            # The quad (t = 0..3) of group g sums the norms of rows g and
            # g + 8.
            na, nb = norm[4 * g:4 * g + 4].sum(axis=0)
            for nt in range(8):
                jc = 8 * nt + 2 * t
                for h, (r, j, xn) in enumerate(((g, jc, na), (g, jc + 1, na),
                                                (g + 8, jc, nb),
                                                (g + 8, jc + 1, nb))):
                    stage[r, j] = _kappa(acc[nt, lane, h], xn,
                                         yn[64 * wc + j], kind, gamma,
                                         degree)
        # store_tile: lanes 0-15 and 16-31 take every other row, four
        # floats from column 4 (lane % 16); store4 keeps to the warp's
        # wcols columns, one vector store where the row is aligned.
        for lane in range(32):
            c = 4 * (lane & 15)
            for r in range(lane >> 4, min(16, n - i0), 2):
                addr = (i0 + r) * w + c0 + 64 * wc + c
                if w % 4 == 0 and c + 4 <= wcols:
                    assert 4 * addr % 16 == 0
                for j in range(4):
                    if c + j < wcols:
                        key = (i0 + r, c0 + 64 * wc + c + j)
                        assert key not in written
                        written[key] = stage[r, c + j]
    return written


STEP_CASES = (
    # (n, w, p, step, chunk): a ragged single step at two warps across;
    # the second, ragged column chunk at eight warps across; p resident in
    # four k-groups (the last of one k8 step) at a ragged third chunk of
    # 128 columns; p past what stays resident, walked in two chunks of p;
    # w under one warp; p = 0.
    (40, 100, 19, 0, 0),
    (300, 600, 11, 3, 1),
    (100, 260, 100, 0, 2),
    (20, 70, 400, 0, 1),
    (200, 5, 3, 0, 0),
    (30, 9, 0, 0, 0),
)


@pytest.mark.parametrize("kind", ["polynomial", "rbf"])
@pytest.mark.parametrize("case", STEP_CASES, ids=[
    "ragged", "chunk2", "p-resident", "p-tiled", "narrow", "p0"])
def test_row_step_through_the_kernel_maps(case, kind):
    n, w, p, step, chunk = case
    rng = np.random.default_rng(sum(case))
    X = rng.standard_normal((p, n)) / np.sqrt(max(p, 1))
    Xb = rng.standard_normal((p, w)) / np.sqrt(max(p, 1))
    plan = cm.gram_plan(n, w, p)
    assert plan.resident == (p < 400)
    gamma = 0.5
    got = _step_through_maps(X, Xb, plan, step, chunk, kind, gamma)
    rows = range(step * plan.rows, min(n, (step + 1) * plan.rows))
    cols = range(chunk * plan.cols, min(w, (chunk + 1) * plan.cols))
    assert rows and cols
    assert sorted(got) == [(i, j) for i in rows for j in cols]
    xn, yn = (X * X).sum(axis=0), (Xb * Xb).sum(axis=0)
    want = _kappa(X.T @ Xb, xn[:, None], yn[None, :], kind, gamma)
    for (i, j), v in got.items():
        assert abs(v - want[i, j]) <= 1e-12 * (1 + abs(want[i, j]))


# -- numerics of the product ------------------------------------------------

def gram_3xtf32(X, Xb, kind="polynomial", gamma=0.0, degree=2, mm=mm3):
    """kappa(X, Xb) with X^T Xb as the tensor-core product computes it
    (`mm`), the squared norms in fp32."""
    z = mm(X.T, Xb)
    if kind == "polynomial":
        return (z + gamma) ** int(degree)
    if kind == "rbf":
        xn = torch.sum(X * X, dim=0)[:, None]
        yn = torch.sum(Xb * Xb, dim=0)[None, :]
        return torch.exp(-gamma * torch.clamp(xn + yn - 2.0 * z, min=0.0))
    return z


def _worst(args, kw, want, **extra) -> float:
    """The largest |got - want| / (atol + rtol |want|): at most 1 within
    the registry's tolerance."""
    got = gram_3xtf32(*(torch.from_numpy(a) for a in args), **extra, **kw)
    return float(np.max(np.abs(got.numpy() - want)
                        / (TOL + TOL * np.abs(want))))


@pytest.mark.parametrize("i", range(len(ENTRY.cases)))
def test_product_matches_jax_ref_at_registry_case(jax_ref, i):
    args, kw = ENTRY.build(np.random.default_rng(1000 + i), ENTRY.cases[i])
    assert _worst(args, kw, jax_ref(*args, **kw)) <= 1.0


@pytest.mark.parametrize("kw", KINDS, ids=["polynomial", "rbf", "linear"])
def test_product_matches_jax_ref_at_stripe_width(jax_ref, kw):
    """p 19, w 512: the main path's stripe at n 4,096."""
    args, _ = ENTRY.build(np.random.default_rng(17), dict(WIDE, **kw))
    assert _worst(args, kw, jax_ref(*args, **kw)) <= 1.0


@pytest.mark.parametrize("kw", KINDS, ids=["polynomial", "rbf", "linear"])
def test_p0_gives_kappa_of_zero_as_jax_does(jax_ref, kw):
    """p = 0: every entry is kappa of an empty product, on the CPU path as
    in the JAX package (the kernel is held to the same on the card)."""
    from repro_torch.kernels.gram.ops import gram_stripe_op
    kw = dict(kw) or {"gamma": 1.5, "degree": 3}
    X, Xb = np.zeros((0, 7), np.float32), np.zeros((0, 5), np.float32)
    got = gram_stripe_op(torch.from_numpy(X), torch.from_numpy(Xb), **kw)
    want = jax_ref(X, Xb, **kw)
    assert want.shape == (7, 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_1xtf32_misses_the_tolerance_at_rbf(jax_ref):
    """Why the tensor-core product pays for three products: points
    clustered away from the origin (norms near 5, distances near 1) make
    ||x||^2 + ||y||^2 - 2 x.y cancel; one TF32 product leaves the
    registry's 2e-3 there, where 3xTF32 stays well inside it."""
    rng = np.random.default_rng(23)
    center = np.full((19, 1), 5.0 / np.sqrt(19), np.float32)
    X = (center + 0.15 * rng.standard_normal((19, 4096))).astype(np.float32)
    Xb = (center + 0.15 * rng.standard_normal((19, 512))).astype(np.float32)
    kw = {"kind": "rbf", "gamma": 0.5}
    want = jax_ref(X, Xb, **kw)
    assert _worst((X, Xb), kw, want, mm=mm1) > 1.0
    assert _worst((X, Xb), kw, want, mm=mm3) < 0.1


# -- the kernel on the card ---------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


# (n, w, p, kind): the main shape in the three kinds (gamma != 0 for the
# polynomial), ragged rows and columns, w under one warp and not a multiple
# of 4 (the epilogue), a ragged second column chunk, eight column chunks,
# p resident in narrower chunks (40, 100 also at the main shape, 300), p
# walked in chunks (313 with a ragged last column chunk, 400), p = 1 and
# p = 0.
CARD_CASES = (
    (100_000, 512, 19, {"gamma": 1.0}),
    (100_000, 512, 19, {"kind": "rbf", "gamma": 0.5}),
    (100_000, 512, 19, {"kind": "linear"}),
    (97, 12, 19, {"kind": "rbf", "gamma": 0.5}),
    (555, 37, 2, {"gamma": 0.5, "degree": 3}),
    (5001, 1, 7, {"kind": "rbf", "gamma": 0.1}),
    (3001, 600, 19, {"gamma": 1.0}),
    (20_000, 4096, 19, {"kind": "rbf", "gamma": 0.5}),
    (4000, 512, 100, {"kind": "rbf", "gamma": 0.1}),
    (3000, 333, 300, {"gamma": 0.5, "degree": 1}),
    (1000, 64, 1, {"kind": "linear"}),
    (20_000, 512, 40, {"kind": "rbf", "gamma": 0.5}),
    (100_000, 512, 100, {"gamma": 1.0}),
    (3000, 70, 313, {"kind": "rbf", "gamma": 0.05}),
    (2000, 200, 400, {"gamma": 0.5}),
    (777, 9, 0, {"gamma": 1.5, "degree": 3}),
)


def _card_inputs(case, dev, strided=False):
    n, w, p, kw = case
    rng = np.random.default_rng(n + w + p)
    X = rng.standard_normal((p, n + 3 * strided)).astype(np.float32)
    Xb = rng.standard_normal((p, w)).astype(np.float32)
    if p:
        X /= np.linalg.norm(X, axis=0, keepdims=True)
        Xb /= np.linalg.norm(Xb, axis=0, keepdims=True)
    Xt = torch.from_numpy(X).to(dev)
    # A column slice of a wider matrix: ldx = n + 3, and Xb its own slice.
    return (Xt[:, 3:] if strided else Xt), torch.from_numpy(Xb).to(dev), kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=(
    "main-poly", "main-rbf", "main-linear", "n97-w12-rbf", "w37-deg3",
    "w1-rbf", "w600", "w4096-rbf", "p100-rbf", "p300-deg1", "p1-linear",
    "p40-rbf", "main-p100", "p313-rbf", "p400", "p0-deg3"))
def test_kernel_matches_plain_on_card(case):
    from repro_torch.kernels.gram import ops
    dev = _card()
    X, Xb, kw = _card_inputs(case, dev, strided=case[0] == 3001)
    launches = ops.gram_stripe_op.launches
    got = ops.gram_stripe_op(X, Xb, **kw)
    torch.cuda.synchronize()
    assert ops.gram_stripe_op.launches == launches + 1
    registry.compare(ENTRY, got, ENTRY.ref(X, Xb, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", KINDS, ids=["polynomial", "rbf", "linear"])
def test_kernel_is_deterministic_on_card(kw):
    """No atomics and a fixed order of sums: the same bits on every launch,
    at the main shape."""
    dev = _card()
    X, Xb, _ = _card_inputs((100_000, 512, 19, {}), dev)
    first = ENTRY.op(X, Xb, **kw)
    for _ in range(2):
        assert torch.equal(ENTRY.op(X, Xb, **kw).view(torch.int32),
                           first.view(torch.int32))


@pytest.mark.cuda
def test_a_plan_that_differs_from_the_kernel_layout_is_refused_on_card():
    """The C entry recomputes the kernel's shared memory from the plan's
    fields and refuses a launch whose bytes differ, or whose chunk of p is
    not whole k-groups where p is walked."""
    from repro_torch.kernels import _build
    dev = _card()
    X, Xb, _ = _card_inputs((2000, 200, 400, {}), dev)
    out = torch.empty((2000, 200), device=dev)
    lib = _build.library()

    def launch(col_warps, krows, grid_x, smem):
        return lib.rt_gram_stripe(
            X.data_ptr(), X.stride(0), 2000, Xb.data_ptr(), Xb.stride(0),
            200, 400, cm.KINDS["polynomial"], 0.0, 2, col_warps, krows,
            grid_x, smem, out.data_ptr(), cm.stream(X))
    plan = cm.gram_plan(2000, 200, 400)
    assert launch(plan.col_warps, plan.krows, plan.grid[0], plan.smem) == 0
    assert launch(plan.col_warps, plan.krows, plan.grid[0],
                  plan.smem - 16) != 0
    krows = plan.krows - 8
    assert launch(plan.col_warps, krows, plan.grid[0],
                  cm.gram_smem_bytes(plan.col_warps, krows)) != 0
    torch.cuda.synchronize()
