"""The numerics and the layout of the fit_sketch kernel (csrc/fit_sketch.cu),
where they can be tested without the card.

- A torch emulation of the kernel's arithmetic: every product as 3xTF32
  (big = x rounded to TF32 to nearest, small = x - big read to its top 19
  bits as the tensor cores read it, small*big + big*small + big*big with
  exact products and fp32 sums), held against the JAX package's
  fit_sketch_ref at every registry case and at a fit-scale case, within the
  registry's 2e-3.
- The mma.sync m16n8k8 fragment maps of mma_tf32.cuh and the slot maps of
  fit_sketch.cu, run lane by lane in numpy: one 16 x 64 sub-tile of a warp
  goes gram -> kappa -> delta (the C fragments as A operands, contraction
  index permuted) -> new_rows (through the warp's transposed slice) ->
  rn_rows (quad sums), and must equal the plain products.
- The kernel's row split (kernels/_common.py fit_split).

Inputs are made with numpy from a seed; the JAX side runs on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fit_sketch.ref import fit_sketch_ref as jax_fit_sketch_ref
from repro_torch.kernels import _common as cm
from repro_torch.kernels import registry
from torch_tf32 import frag_c, gather_c, mm1, mm3, mma, tf32, trunc

TOL = 2e-3                # the fit_sketch registry tolerance
ENTRY = registry.get_kernel("fit_sketch")
FIT_CASES = (
    {"p": 19, "m": 20_000, "b": 512, "rp": 7},
    {"p": 19, "m": 20_000, "b": 512, "rp": 7, "kind": "rbf", "gamma": 0.5},
)


def fit_sketch_3xtf32(X, Omega, C, Ocross, V=None, kind="polynomial",
                      gamma=0.0, degree=2, mm=mm3):
    """fit_sketch with every product as the kernel computes it (`mm`)."""
    z = mm(X.T, C)
    if kind == "polynomial":
        K = (z + gamma) ** int(degree)
    elif kind == "rbf":
        xn = torch.sum(X * X, dim=0)[:, None]
        yn = torch.sum(C * C, dim=0)[None, :]
        K = torch.exp(-gamma * torch.clamp(xn + yn - 2.0 * z, min=0.0))
    else:
        K = z
    K2 = K * K
    vm = torch.ones((X.shape[1],)) if V is None else V
    return mm(K.T, Omega), mm(K, Ocross), K2.sum(dim=1), vm @ K2


def _jax_ref(args, kw):
    X, Omega, C, Ocr, V = args
    V8 = np.zeros((8, V.shape[0]), np.float32)
    V8[0] = V
    return jax_fit_sketch_ref(*(jnp.asarray(a) for a in (X, Omega, C, Ocr,
                                                         V8)), **kw)


def _worst(args, kw, mm=mm3) -> float:
    """The largest |got - want| / (atol + rtol |want|) over the outputs:
    at most 1 within the registry's tolerance."""
    got = fit_sketch_3xtf32(*(torch.from_numpy(a) for a in args), mm=mm,
                            **kw)
    want = _jax_ref(args, kw)
    return max(float(np.max(np.abs(g.numpy() - np.asarray(w))
                            / (TOL + TOL * np.abs(np.asarray(w)))))
               for g, w in zip(got, want))


def _check(args, kw):
    got = fit_sketch_3xtf32(*(torch.from_numpy(a) for a in args), **kw)
    want = _jax_ref(args, kw)
    for name, g, w in zip(("new_rows", "delta", "rn_rows", "rn_cols"), got,
                          want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=name)


def _fit_scale(case):
    args, kw = ENTRY.build(np.random.default_rng(7), case)
    X, Omega, C, Ocr, V = args
    X /= np.linalg.norm(X, axis=0, keepdims=True)
    C /= np.linalg.norm(C, axis=0, keepdims=True)
    return (X, Omega, C, Ocr, V), kw


def test_tf32_rounding_and_split():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 3.0e-5, -7.25e8])
    big = tf32(x)
    # Ties go away from zero; the low 13 bits are clear.
    assert big.tolist()[:4] == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                                -(1.0 + 2.0 ** -10)]
    assert not (big.view(torch.int32) & 0x1FFF).any()
    small = x - big
    # big + small is x exactly; big + trunc(small) within 2^-21 of x.
    assert torch.equal(big + small, x)
    rel = ((big + trunc(small)) - x).abs() / x.abs()
    assert float(rel.max()) <= 2.0 ** -21


@pytest.mark.parametrize("i", range(len(ENTRY.cases)))
def test_3xtf32_matches_jax_ref_at_registry_case(i):
    args, kw = ENTRY.build(np.random.default_rng(1000 + i), ENTRY.cases[i])
    _check(args, kw)


@pytest.mark.parametrize("case", FIT_CASES, ids=("polynomial", "rbf"))
def test_3xtf32_matches_jax_ref_at_fit_scale(case):
    """p 19, m 20,000, b 512, r' 7: the main path's block at a fifth of its
    rows, on unit-norm points as the fit feeds it."""
    _check(*_fit_scale(case))


@pytest.mark.parametrize("case", FIT_CASES, ids=("polynomial", "rbf"))
def test_1xtf32_misses_the_tolerance_at_fit_scale(case):
    """Why the kernel pays for three products: one TF32 product per flop
    leaves the registry's 2e-3 at the same inputs, where 3xTF32 stays
    well inside it."""
    args, kw = _fit_scale(case)
    assert _worst(args, kw, mm1) > 1.0
    assert _worst(args, kw, mm3) < 0.1


# -- fragment and slot maps, lane by lane -------------------------------------

def test_permuted_k_delta_equals_kc_ocross():
    """A C fragment as the A operand (a = c0, c2, c1, c3) against B rows
    loaded as b0 = row 2t, b1 = row 2t + 1 contracts over the fragment's
    columns: Kc Ocross, for random fragments."""
    rng = np.random.default_rng(0)
    for _ in range(5):
        Kc, Ocr = rng.standard_normal((16, 8)), rng.standard_normal((8, 8))
        c = frag_c(Kc)
        a = c[:, [0, 2, 1, 3]]
        b = np.array([[Ocr[2 * t, g], Ocr[2 * t + 1, g]]
                      for g, t in (divmod(lane, 4) for lane in range(32))])
        d = mma(a, b, np.zeros((32, 4)))
        np.testing.assert_allclose(gather_c(d), Kc @ Ocr, rtol=1e-12)
        # The natural order is not the contraction the C fragment holds.
        b_nat = np.array([[Ocr[t, g], Ocr[t + 4, g]]
                          for g, t in (divmod(lane, 4)
                                       for lane in range(32))])
        assert not np.allclose(gather_c(mma(a, b_nat, np.zeros((32, 4)))),
                               Kc @ Ocr)


def test_warp_sub_tile_through_the_kernel_slot_maps():
    """One warp's 16 x 64 sub-tile as fit_sketch.cu computes it: X^T and C
    from their shared-memory slots (load_x, load_cols), the gram over three
    k-steps, kappa, delta through the permuted A operand, new_rows through
    the transposed slice kt (written as float2 at (g, 8nt + 2t), read at
    (8ks + t, 16mt + g)), rn_rows as quad sums; against the plain
    products."""
    rng = np.random.default_rng(3)
    p, rp, gamma = 19, 7, 0.5
    X = rng.standard_normal((24, 16))           # p zero-padded to 24
    X[p:] = 0.0
    C = rng.standard_normal((24, 64))
    C[p:] = 0.0
    Om = rng.standard_normal((16, 8))
    Om[:, rp:] = 0.0
    Ocr = rng.standard_normal((64, 8))
    Ocr[:, rp:] = 0.0
    lanes = [divmod(lane, 4) for lane in range(32)]
    acc = np.zeros((8, 32, 4))
    for ks in range(3):
        # load_x: a = X[8ks + t (+ 4)][g (+ 8)] in the order a0 .. a3.
        a = np.array([[X[8 * ks + t + 4 * (h >> 1), g + 8 * (h & 1)]
                       for h in range(4)] for g, t in lanes])
        for nt in range(8):
            # load_cols: b0 = C[8ks + t][8nt + g], b1 four rows down.
            b = np.array([[C[8 * ks + t, 8 * nt + g],
                           C[8 * ks + t + 4, 8 * nt + g]] for g, t in lanes])
            acc[nt] = mma(a, b, acc[nt])
    acc = (acc + gamma) ** 2                    # kappa, in place
    Kc = (X.T @ C + gamma) ** 2
    np.testing.assert_allclose(np.hstack([gather_c(acc[nt])
                                          for nt in range(8)]), Kc,
                               rtol=1e-12)
    delta = np.zeros((32, 4))
    kt = np.zeros((16, 72))
    rr = np.zeros((32, 2))
    for nt in range(8):
        b = np.array([[Ocr[8 * nt + 2 * t, g], Ocr[8 * nt + 2 * t + 1, g]]
                      for g, t in lanes])
        delta = mma(acc[nt][:, [0, 2, 1, 3]], b, delta)
        for lane, (g, t) in enumerate(lanes):
            k = acc[nt, lane]
            kt[g, 8 * nt + 2 * t:8 * nt + 2 * t + 2] = k[:2]
            kt[g + 8, 8 * nt + 2 * t:8 * nt + 2 * t + 2] = k[2:]
            rr[lane] += (k[0] ** 2 + k[1] ** 2, k[2] ** 2 + k[3] ** 2)
    np.testing.assert_allclose(gather_c(delta), Kc @ Ocr, rtol=1e-12)
    new_rows = np.zeros((64, 8))
    for mt in range(4):
        nacc = np.zeros((32, 4))
        for ks in range(2):
            a = np.array([[kt[8 * ks + t, 16 * mt + g],
                           kt[8 * ks + t, 16 * mt + g + 8],
                           kt[8 * ks + t + 4, 16 * mt + g],
                           kt[8 * ks + t + 4, 16 * mt + g + 8]]
                          for g, t in lanes])
            # put_w / fetch: b0 = Omega[8ks + t][g], b1 four rows down.
            b = np.array([[Om[8 * ks + t, g], Om[8 * ks + t + 4, g]]
                          for g, t in lanes])
            nacc = mma(a, b, nacc)
        new_rows[16 * mt:16 * mt + 16] = gather_c(nacc)
    np.testing.assert_allclose(new_rows, Kc.T @ Om, rtol=1e-12)
    # The quad (t = 0..3) of group g holds rows g and g + 8.
    rn = np.zeros(16)
    for lane, (g, t) in enumerate(lanes):
        rn[g] += rr[lane, 0]
        rn[g + 8] += rr[lane, 1]
    np.testing.assert_allclose(rn, (Kc * Kc).sum(axis=1), rtol=1e-12)


# -- the row split ------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 15, 16, 17, 512, 1000, 5000, 99_840,
                               100_000, 1 << 20])
def test_fit_split_covers_each_row_once(m):
    per, ranges = cm.fit_split(m)
    assert per % cm.FIT_ROWS == 0 and per > 0
    assert ranges <= cm.FIT_RANGES
    rows = np.concatenate([np.arange(s * per, min(m, (s + 1) * per))
                           for s in range(ranges)])
    np.testing.assert_array_equal(rows, np.arange(m))
    # Every range holds rows, and no shorter range of 16-row steps would
    # fit m into the card's 132 SMs: the longest range, which sets the
    # kernel's time, is as short as the split can make it.
    assert (ranges - 1) * per < m
    assert per == cm.FIT_ROWS or (per - cm.FIT_ROWS) * cm.FIT_RANGES < m


def test_fit_split_at_the_main_path_blocks():
    """A function of m alone: the last full block of the n = 100,000 fit
    and the first one."""
    assert cm.fit_split(100_000) == (768, 131)
    assert cm.fit_split(99_840) == (768, 130)
    assert cm.fit_split(512) == (16, 32)
