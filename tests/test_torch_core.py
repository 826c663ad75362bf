"""The port's core modules against the JAX package on the same inputs.

Inputs and the JAX package's random draws (SRHT signs/rows, Lloyd init)
go to both sides as numpy; tolerance 2e-3 (the registry default) unless a
test states otherwise. Eigenvectors are compared as subspaces (sign
freedom), by ||U U^T - U' U'^T||.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernels_fn as jkf
from repro.core.kmeans import _lloyd as jax_lloyd
from repro.core import metrics as jmetrics
from repro.core import sketch as jsk
from repro_torch.core import kernels_fn as kf
from repro_torch.core import kmeans as km
from repro_torch.core import metrics
from repro_torch.core import sketch as sk

TOL = 2e-3


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _port_srht(jsrht):
    return sk.SRHT(signs=_t(jsrht.signs),
                   rows=torch.from_numpy(np.asarray(jsrht.rows, np.int64)),
                   n=jsrht.n, n_pad=jsrht.n_pad)


KERNELS = [("polynomial", {"gamma": 0.0, "degree": 2}),
           ("polynomial", {"gamma": 1.0, "degree": 3}),
           ("rbf", {"gamma": 0.5}), ("linear", {})]


@pytest.mark.parametrize("name,params", KERNELS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(KERNELS)])
def test_stripes_match_jax_with_ragged_tail_lhs_and_pad_tail(name, params):
    X = _rng(0).standard_normal((5, 77)).astype(np.float32)
    L = _rng(1).standard_normal((5, 40)).astype(np.float32)
    for lhs in (None, L):
        for pad_tail in (False, True):
            got = list(kf.stripe_iterator(
                kf.make_kernel(name, **params), _t(X), 16,
                lhs=None if lhs is None else _t(lhs), pad_tail=pad_tail))
            want = list(jkf.stripe_iterator(
                jkf.make_kernel(name, **params), jnp.asarray(X), 16,
                lhs=None if lhs is None else jnp.asarray(lhs),
                pad_tail=pad_tail))
            assert [s for s, _ in got] == [s for s, _ in want]
            for (_, g), (_, w) in zip(got, want):
                assert tuple(g.shape) == w.shape
                _close(g, w)
    assert got[-1][1].shape[1] == 16           # pad_tail keeps full width


def test_make_kernel_rejects_unknown_params():
    with pytest.raises(ValueError, match="gamm"):
        kf.make_kernel("rbf", gamm=1.0)
    with pytest.raises(ValueError, match="takes no params"):
        kf.make_kernel("linear", gamma=1.0)
    assert kf.kernel_names() == jkf.kernel_names()


def test_fwht_matches_jax():
    x = _rng(2).standard_normal((256, 3)).astype(np.float32)
    _close(sk.fwht(_t(x)), jsk.fwht(jnp.asarray(x)), 2e-4)
    with pytest.raises(ValueError):
        sk.fwht(torch.zeros(6))


def test_srht_fed_jax_draws_matches_jax():
    jsrht = jsk.make_srht(jax.random.PRNGKey(3), 300, 7)
    srht = _port_srht(jsrht)
    M = _rng(3).standard_normal((300, 9)).astype(np.float32)
    _close(sk.srht_apply_t(srht, _t(M)), jsk.srht_apply_t(jsrht,
                                                          jnp.asarray(M)))
    V = _rng(4).standard_normal((7, 4)).astype(np.float32)
    _close(sk.srht_apply(srht, _t(V)), jsk.srht_apply(jsrht, jnp.asarray(V)))
    # The entry formula (popcount parity) gives exactly the jnp values.
    np.testing.assert_array_equal(sk.srht_rows(srht, 37, 211).numpy(),
                                  np.asarray(jsk.srht_rows(jsrht, 37, 211)))
    with pytest.raises(ValueError):
        sk.srht_rows(srht, 10, 301)


def _subspace_gap(U1, U2):
    U1, U2 = np.asarray(U1, np.float64), np.asarray(U2, np.float64)
    return np.linalg.norm(U1 @ U1.T - U2 @ U2.T)


def test_one_pass_core_matches_jax():
    X = _rng(5).standard_normal((4, 200)).astype(np.float32)
    X /= np.linalg.norm(X, axis=0, keepdims=True)
    jsrht = jsk.make_srht(jax.random.PRNGKey(5), 200, 7)
    K = np.asarray(jkf.polynomial_kernel()(jnp.asarray(X), jnp.asarray(X)))
    W = np.asarray(jsk.srht_apply_t(jsrht, jnp.asarray(K)).T)
    want = jsk.one_pass_core(
        jnp.asarray(W), lambda Q: jsk.srht_apply_t(jsrht, Q), 3)
    srht = _port_srht(jsrht)
    got = sk.one_pass_core(_t(W), lambda Q: sk.srht_apply_t(srht, Q), 3)
    _close(got.eigvals, want.eigvals)
    assert _subspace_gap(got.U, want.U) < TOL
    # K_hat = Y^T Y is sign-free: compare it outright.
    _close(got.Y.T @ got.Y, np.asarray(want.Y.T @ want.Y))


def _blobs(seed, n=300, r=2, k=4):
    rng = _rng(seed)
    centers = 3.0 * rng.standard_normal((k, r))
    labels = rng.integers(0, k, n)
    return (centers[labels] + 0.5 * rng.standard_normal((n, r))).astype(
        np.float32)


def test_lloyd_from_injected_init_matches_jax():
    Y = _blobs(6)
    init = Y[:4].copy()
    want = jax_lloyd(jnp.asarray(Y), jnp.asarray(init), 20, 1e-6)
    got = km._lloyd(_t(Y), _t(init), 20, 1e-6)
    _close(got.centroids, want.centroids, 1e-4)
    _close(got.objective, want.objective, 1e-4)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert int(got.n_iter) == int(want.n_iter)


def test_restarts_as_a_batch_dim_match_jax_restarts():
    Y = _blobs(7, k=5)
    inits = np.stack([Y[5 * i:5 * i + 5] for i in range(4)])
    runs = [jax_lloyd(jnp.asarray(Y), jnp.asarray(c), 20, 1e-6)
            for c in inits]
    best = int(np.argmin([float(r.objective) for r in runs]))
    got = km.kmeans(_t(Y), 5, n_restarts=4, init=_t(inits))
    _close(got.objective, runs[best].objective, 1e-4)
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(runs[best].labels))


def test_kmeans_plus_plus_draws_k_distinct_data_points():
    Y = _t(_blobs(8))
    g = torch.Generator().manual_seed(0)
    init = km.kmeans_plus_plus(Y, 4, g, n_restarts=3)
    assert init.shape == (3, 4, 2)
    for c in init:
        d = torch.cdist(c, Y).min(dim=1).values
        assert float(d.max()) == 0.0           # each seed is a data point
        assert len({tuple(row.tolist()) for row in c}) == 4


def test_metrics_match_jax():
    rng = _rng(9)
    lt = rng.integers(0, 5, 400)
    lp = (lt + (rng.random(400) < 0.2)) % 5
    assert metrics.clustering_accuracy(lt, lp, 5) == \
        jmetrics.clustering_accuracy(lt, lp, 5)
    assert metrics.nmi(lt, lp) == pytest.approx(jmetrics.nmi(lt, lp),
                                                rel=1e-12)
    X = rng.standard_normal((3, 90)).astype(np.float32)
    Y = rng.standard_normal((2, 90)).astype(np.float32)
    kern, jkern = kf.make_kernel("polynomial"), jkf.make_kernel("polynomial")
    want = jmetrics.kernel_approx_error(jkern(jnp.asarray(X), jnp.asarray(X)),
                                        jnp.asarray(Y))
    assert metrics.kernel_approx_error(kern(_t(X), _t(X)), _t(Y)) == \
        pytest.approx(want, rel=TOL)
    assert metrics.kernel_approx_error_streaming(kern, _t(X), _t(Y), 32) == \
        pytest.approx(want, rel=TOL)
