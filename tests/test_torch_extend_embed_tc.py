"""The numerics and the layout of the extend_embed kernel
(csrc/extend_embed.cu), where they can be tested without the card.

- A torch emulation of the kernel's arithmetic in its orientation (queries
  as rows): the gram product Xb^T X and the projection K P^T, each as
  3xTF32 (tests/torch_tf32.py), held against the JAX package's
  extend_embed_ref at every registry case and at a serving-scale case,
  within the registry's 2e-3.
- The mma.sync m16n8k8 fragment maps and the kernel's shared-memory slot
  maps, run lane by lane in numpy: one warp's two query tiles against a
  unit of 32 training points (two steps of two n8 tiles) go load_queries
  -> gram -> kappa -> projection (the C fragments as A operands, the
  contraction index permuted, one chain per tile parity) -> the partial's
  write map, and must equal P kappa(X, Xb).
- The kernel's training split (kernels/_common.py extend_split) and its
  query tiles per warp (extend_query_tiles).

Inputs are made with numpy from a seed; the JAX side runs on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.extend_embed.ref import extend_embed_ref as jax_ref
from repro_torch.kernels import _common as cm
from repro_torch.kernels import registry
from torch_tf32 import gather_c, mm3, mma

TOL = 2e-3                # the extend_embed registry tolerance
ENTRY = registry.get_kernel("extend_embed")
SERVE_CASES = (
    {"p": 19, "n": 20_000, "r": 2, "w": 512},
    {"p": 19, "n": 20_000, "r": 2, "w": 512, "kind": "rbf", "gamma": 0.5},
)


def extend_embed_3xtf32(X, P, Xb, kind="polynomial", gamma=0.0, degree=2):
    """P kappa(X, Xb) as the kernel computes it: out^T = kappa(Xb^T X) P^T,
    both products in 3xTF32."""
    z = mm3(Xb.T, X)                                    # (w, n)
    if kind == "polynomial":
        K = (z + gamma) ** int(degree)
    elif kind == "rbf":
        xn = torch.sum(X * X, dim=0)[None, :]
        qn = torch.sum(Xb * Xb, dim=0)[:, None]
        K = torch.exp(-gamma * torch.clamp(xn + qn - 2.0 * z, min=0.0))
    else:
        K = z
    return mm3(K, P.T).T                                # (r, w)


def _check(args, kw):
    got = extend_embed_3xtf32(*(torch.from_numpy(a) for a in args), **kw)
    want = jax_ref(*(jnp.asarray(a) for a in args), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("i", range(len(ENTRY.cases)))
def test_3xtf32_matches_jax_ref_at_registry_case(i):
    _check(*ENTRY.build(np.random.default_rng(1000 + i), ENTRY.cases[i]))


@pytest.mark.parametrize("case", SERVE_CASES, ids=("polynomial", "rbf"))
def test_3xtf32_matches_jax_ref_at_serving_scale(case):
    """p 19, n 20,000, w 512, r 2: the main path's stripe at a fifth of its
    training points, on unit-norm points as the fit and the queries have
    them."""
    (X, P, Xb), kw = ENTRY.build(np.random.default_rng(7), case)
    X /= np.linalg.norm(X, axis=0, keepdims=True)
    Xb /= np.linalg.norm(Xb, axis=0, keepdims=True)
    _check((X, P, Xb), kw)


# -- fragment and slot maps, lane by lane -------------------------------------

def _kappa(z, xn, qn, kind, gamma):
    if kind == "rbf":
        return np.exp(-gamma * np.maximum(xn + qn - 2.0 * z, 0.0))
    return (z + gamma) ** 2


@pytest.mark.parametrize("kind", ["polynomial", "rbf"])
def test_warp_tiles_through_the_kernel_slot_maps(kind):
    """One warp of extend_embed.cu: MT = 2 query tiles, p = 19 zero-padded
    to 24 (three k-steps), r = 3 padded to 8, a unit of 32 training points
    with the last 5 past the range (zeros in X and P). A fragments as
    load_queries reads them, X and P^T from their slots (fetch / store),
    the gram, kappa in place with the norms of rows g, g + 8 and columns
    2t, 2t + 1, the projection with a = (c0, c2, c1, c3) into one chain per
    tile parity, and the write map; against P kappa(X, Xb)."""
    rng = np.random.default_rng(5)
    p, r, mts, pts, valid, gamma = 19, 3, 2, 32, 27, 0.5
    X = rng.standard_normal((24, pts)) / 3.0
    X[p:], X[:, valid:] = 0.0, 0.0
    Xb = rng.standard_normal((24, 16 * mts)) / 3.0
    Xb[p:] = 0.0
    P = rng.standard_normal((8, pts))
    P[r:], P[:, valid:] = 0.0, 0.0
    xn, qn = (X * X).sum(axis=0), (Xb * Xb).sum(axis=0)
    lanes = [divmod(lane, 4) for lane in range(32)]
    # load_queries: a_h = Xb[8ks + t + 4 (h >> 1)][16mt + g + 8 (h & 1)].
    A = np.array([[[[Xb[8 * ks + t + 4 * (h >> 1), 16 * mt + g + 8 * (h & 1)]
                     for h in range(4)] for g, t in lanes]
                   for ks in range(3)] for mt in range(mts)])
    # fetch / store: X slot (tile * 3 + ks) * 32 + lane holds X[8ks + t]
    # [8tile + g] and four rows down; P slot tile * 32 + lane holds
    # P[g][8tile + 2t] and the next column.
    tiles = pts // 8
    bx = np.zeros((tiles * 3 * 32, 2))
    for sl in range(len(bx)):
        g, t = lanes[sl & 31]
        k, j = 8 * ((sl >> 5) % 3) + t, 8 * ((sl >> 5) // 3) + g
        bx[sl] = X[k, j], X[k + 4, j]
    bx = bx.reshape(tiles, 3, 32, 2)
    bp = np.zeros((tiles * 32, 2))
    for sl in range(len(bp)):
        g, t = lanes[sl & 31]
        j = 8 * (sl >> 5) + 2 * t
        bp[sl] = P[g, j], P[g, j + 1]
    bp = bp.reshape(tiles, 32, 2)
    out = np.zeros((mts, 2, 32, 4))
    for st in range(tiles // 2):
        acc = np.zeros((mts, 2, 32, 4))
        for ks in range(3):
            for mt in range(mts):
                for n in range(2):
                    acc[mt, n] = mma(A[mt, ks], bx[2 * st + n, ks],
                                     acc[mt, n])
        for n in range(2):
            tile = 2 * st + n
            for mt in range(mts):
                for lane, (g, t) in enumerate(lanes):
                    jc, qa = 8 * tile + 2 * t, 16 * mt + g
                    for h, (q, j) in enumerate(((qa, jc), (qa, jc + 1),
                                                (qa + 8, jc),
                                                (qa + 8, jc + 1))):
                        acc[mt, n, lane, h] = _kappa(acc[mt, n, lane, h],
                                                     xn[j], qn[q], kind,
                                                     gamma)
                out[mt, n] = mma(acc[mt, n][:, [0, 2, 1, 3]], bp[tile],
                                 out[mt, n])
    # The gram tile through the C-fragment map, before the write map.
    np.testing.assert_allclose(
        np.hstack([gather_c(acc[0, n]) for n in range(2)]),
        _kappa(Xb[:, :16].T @ X[:, 16:32], xn[None, 16:32],
               qn[:16, None], kind, gamma), rtol=1e-12)
    got = np.full((r, 16 * mts), np.nan)
    for mt in range(mts):
        for lane, (g, t) in enumerate(lanes):
            for h in range(2):
                for cc in range(2):
                    if 2 * t + cc < r:
                        got[2 * t + cc, 16 * mt + g + 8 * h] = (
                            out[mt, 0, lane, 2 * h + cc]
                            + out[mt, 1, lane, 2 * h + cc])
    K = _kappa(X.T @ Xb, xn[:, None], qn[None, :], kind, gamma)
    np.testing.assert_allclose(got, P[:r] @ K, rtol=1e-12, atol=1e-12)


# -- the training split and the query tiles -----------------------------------

@pytest.mark.parametrize("n", [1, 97, 127, 128, 129, 5001, 16_896, 99_840,
                               100_000, 1 << 20])
def test_extend_split_covers_each_training_point_once(n):
    per, ranges = cm.extend_split(n)
    assert per % cm.EXTEND_ROWS == 0 and per > 0
    assert ranges <= cm.EXTEND_RANGES
    pts = np.concatenate([np.arange(s * per, min(n, (s + 1) * per))
                          for s in range(ranges)])
    np.testing.assert_array_equal(pts, np.arange(n))
    # Every range holds points, and no shorter range of 128-point steps
    # would fit n into 132 ranges.
    assert (ranges - 1) * per < n
    assert per == cm.EXTEND_ROWS or (per - cm.EXTEND_ROWS) * \
        cm.EXTEND_RANGES < n


def test_extend_split_at_the_main_path_and_query_tiles():
    """The split is a function of n alone: 131 ranges of 768 points at
    n = 100,000, one per SM, at any batch width. A warp takes the fewest
    query tiles whose block covers the batch: 1 up to 128 queries, 2 up to
    256, then 4."""
    assert cm.extend_split(100_000) == (768, 131)
    assert cm.extend_split(97) == (128, 1)
    tiles = {w: cm.extend_query_tiles(w)
             for w in (1, 8, 64, 128, 129, 256, 257, 512, 1024)}
    assert tiles == {1: 1, 8: 1, 64: 1, 128: 1, 129: 2, 256: 2, 257: 4,
                     512: 4, 1024: 4}
