"""The Nystrom and exact backends and the Theorem 1 functions against the
JAX package.

Inputs are made with numpy from seeds, and the JAX package's draws (the
Nystrom landmark indices) are fed to the port: JAX's PRNG streams cannot be
reproduced in torch. How the numerics that differ between the packages are
handled:

- `torch.linalg.eigh` and `jnp.linalg.eigh` may return an eigenvector with
  the other sign, or any basis of a degenerate eigenspace. The packages are
  compared through what neither sees: eigenvalues (rtol 2e-3, the registry
  default), K_hat_r = Y^T Y (2e-3 relative Frobenius), the subspace gap
  ||U1 U1^T - U2 U2^T||_F, and served distances (2e-3).
- Labels of a whole fit: >= 0.99 agreement up to a permutation when the
  k-means++ draws are each package's own. Fed JAX's k-means++ seeds, the
  port first flips their column j by the sign of <Y_port[j], Y_jax[j]>;
  then labels agree on >= 0.99 of the rows as they are, and centroids
  (JAX's flipped alike) within 2e-3. Served labels follow the near-tie
  rule of the registry (`near_tie_compare`).
- The rank-deficient Nystrom fit: the directions past the kernel's feature
  rank are noise whose eigenvalues differ between the packages; only the
  top ones are compared by value, and both must zero the same directions,
  none left in (0, 1e-7].
- The Theorem 1 functions run in float32 on tiny matrices: the objective
  within rtol 1e-5, best_rank_r within 1e-4.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.api import KernelKMeans as JaxKernelKMeans
from repro.api import available_backends as jax_backends
from repro.api import fit_memory_bytes as jax_memory
from repro.core import best_rank_r as jax_best_rank_r
from repro.core import brute_force_optimal as jax_brute_force
from repro.core import exact_eig as jax_exact_eig
from repro.core import kmeans_plus_plus as jax_kmeans_plus_plus
from repro.core import make_kernel as jax_make_kernel
from repro.core import nystrom as jax_nystrom
from repro.core import objective_from_labels as jax_objective
from repro.core import theorem1_bounds as jax_theorem1
from repro.core import trace_norm as jax_trace_norm
from repro.serve.extend import assign as jax_assign
from repro_torch.api import (KernelKMeans, available_backends,
                             default_nystrom_m, fit_memory_bytes,
                             get_backend, register_backend)
from repro_torch.api import backends as be
from repro_torch.core import (best_rank_r, brute_force_optimal, exact_eig,
                              gram_matrix, kernel_approx_error,
                              linearized_kmeans_from_Y, make_kernel, nystrom,
                              objective_from_labels, one_pass_kernel_kmeans,
                              theorem1_bounds, trace_norm)
from repro_torch.core.kmeans import kmeans
from repro_torch.core.metrics import clustering_accuracy
from repro_torch.data import gaussian_blobs
from repro_torch.kernels.registry import near_tie_compare
from repro_torch.serve import (ComputePolicy, Extender, MicroBatcher,
                               fit_model, from_reference)

TOL = 2e-3
BACKENDS = ("exact", "nystrom", "onepass-gaussian", "onepass-srht")
KERNELS = {"rbf": ("rbf", {"gamma": 1.0}),
           "poly": ("polynomial", {"gamma": 0.0, "degree": 2})}
FIT = dict(k=3, r=4, kernel="rbf", kernel_params={"gamma": 1.0}, block=64)
NYSTROM_M = 120


def _t(x):
    return torch.from_numpy(np.array(x))


def _khat_rel(Y1, Y2):
    """||Y1^T Y1 - Y2^T Y2||_F / ||Y2^T Y2||_F, in float64."""
    Y1, Y2 = np.asarray(Y1, np.float64), np.asarray(Y2, np.float64)
    K1, K2 = Y1.T @ Y1, Y2.T @ Y2
    return np.linalg.norm(K1 - K2) / np.linalg.norm(K2)


def _subspace_gap(U1, U2):
    U1, U2 = np.asarray(U1, np.float64), np.asarray(U2, np.float64)
    return np.linalg.norm(U1 @ U1.T - U2 @ U2.T)


def _psd(seed, n, rank):
    A = np.random.RandomState(seed).randn(n, rank)
    return (A @ A.T).astype(np.float32)


@pytest.fixture(scope="module")
def blobs():
    """The blobs of tests/test_api.py (n 240, p 4, k 3), from a numpy
    seed."""
    X, y = gaussian_blobs(np.random.default_rng(0), n=240, p=4, k=3)
    return X.numpy(), y.numpy()


@pytest.fixture(scope="module")
def jax_fits(blobs):
    X = blobs[0]
    return {name: JaxKernelKMeans(
        **FIT, backend=name,
        backend_params={"m": NYSTROM_M} if name == "nystrom" else {}
    ).fit(X, key=2) for name in ("nystrom", "exact")}


def _jax_init(jest, sign, key=2):
    """JAX's k-means++ seeds of `jest.fit(X, key)`, (n_restarts, k, r),
    column j times sign[j], the sign of <Y_port[j], Y_jax[j]>, so they sit
    in the port's eigenvector orientation."""
    _, k_km = jax.random.split(jax.random.PRNGKey(key))
    Yt = jest.embedding_.T
    init = np.array(jax.vmap(lambda kk: jax_kmeans_plus_plus(kk, Yt, 3))(
        jax.random.split(k_km, jest.n_restarts)))
    return torch.from_numpy((init * sign).astype(np.float32))


def _port_fit(X, name, jax_est=None, init=None, **kw):
    sketch = None
    if name == "nystrom" and jax_est is not None:
        sketch = _t(jax_est.model_.landmark_idx).to(torch.int64)
    return KernelKMeans(
        **FIT, backend=name,
        backend_params={"m": NYSTROM_M} if name == "nystrom" else {},
        device="cpu", **kw).fit(X, seed=0, sketch=sketch, init=init)


# -- core: Nystrom and exact against the JAX package --------------------------

@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("optimal", [False, True],
                         ids=["classical", "optimal_truncation"])
def test_nystrom_matches_jax(blobs, kernel, optimal):
    X = blobs[0]
    name, params = KERNELS[kernel]
    ref = jax_nystrom(jax.random.PRNGKey(3), jax_make_kernel(name, **params),
                      jnp.asarray(X), 40, 3, optimal_truncation=optimal)
    got = nystrom(make_kernel(name, **params), torch.from_numpy(X), 40, 3,
                  optimal_truncation=optimal, idx=_t(ref.idx))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    assert got.idx.dtype == torch.int64
    np.testing.assert_allclose(got.eigvals.numpy(), np.asarray(ref.eigvals),
                               rtol=TOL)
    assert _khat_rel(got.Y, ref.Y) < TOL
    if optimal:
        assert got.U is None and ref.U is None
    else:
        assert _subspace_gap(got.U, ref.U) < TOL


def test_nystrom_draws_distinct_landmarks_from_its_generator(blobs):
    X = torch.from_numpy(blobs[0])
    kern = make_kernel("rbf", gamma=1.0)
    a = nystrom(kern, X, 64, 2, generator=torch.Generator().manual_seed(5))
    b = nystrom(kern, X, 64, 2, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.idx, b.idx) and torch.equal(a.Y, b.Y)
    assert len(set(a.idx.tolist())) == 64
    with pytest.raises(ValueError, match="generator or landmark idx"):
        nystrom(kern, X, 64, 2)
    with pytest.raises(ValueError, match=r"\(64,\)"):
        nystrom(kern, X, 64, 2, idx=a.idx[:10])


def test_nystrom_rank_deficient_fit_zeroes_what_jax_zeroes():
    """tests/test_api.py:124 in both packages: 3 distinct points tiled, so
    the homogeneous quadratic kernel on p = 2 has feature rank <= 3 and
    r = 6 forces truncated directions; both zero the same ones."""
    base = np.asarray([[0.3, -1.2, 2.0], [1.1, 0.4, -0.7]], np.float32)
    X = np.tile(base, (1, 16))
    kw = dict(k=2, r=6, kernel="polynomial",
              kernel_params={"gamma": 0.0, "degree": 2}, backend="nystrom",
              backend_params={"m": 24}, block=16)
    jest = JaxKernelKMeans(**kw).fit(jnp.asarray(X), key=0)
    est = KernelKMeans(**kw, device="cpu").fit(
        X, seed=0, sketch=_t(jest.model_.landmark_idx))
    got, want = est.eigvals_.numpy(), np.asarray(jest.model_.eigvals)
    assert ((got == 0.0) | (got > 1e-7)).all(), got
    np.testing.assert_array_equal(got == 0.0, want == 0.0)
    assert (got == 0.0).any(), got
    np.testing.assert_allclose(got[:3], want[:3], rtol=TOL)
    Y_ext = est.embed(X)
    assert bool(torch.isfinite(Y_ext).all())
    rel = float(torch.linalg.norm(Y_ext - est.embedding_)
                / torch.linalg.norm(est.embedding_))
    assert rel <= 1e-4, rel


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_exact_eig_matches_jax(blobs, kernel):
    X = blobs[0]
    name, params = KERNELS[kernel]
    ref = jax_exact_eig(jax_make_kernel(name, **params), jnp.asarray(X), 3)
    got = exact_eig(make_kernel(name, **params), torch.from_numpy(X), 3)
    np.testing.assert_allclose(got.eigvals.numpy(), np.asarray(ref.eigvals),
                               rtol=TOL)
    assert _khat_rel(got.Y, ref.Y) < TOL
    assert _subspace_gap(got.U, ref.U) < TOL
    assert got.U.shape == (240, 3) and bool((got.eigvals >= 0).all())


# -- core: the Theorem 1 functions --------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_objective_and_best_rank_r_match_jax(seed):
    K = _psd(seed, 9, 5)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 3, 9).astype(np.int32)
    labels[labels == 2] = 1              # cluster 2 empty: the guard
    for k in (3, 4):
        np.testing.assert_allclose(
            float(objective_from_labels(torch.from_numpy(K),
                                        torch.from_numpy(labels), k)),
            float(jax_objective(jnp.asarray(K), jnp.asarray(labels), k)),
            rtol=1e-5)
    for r in (1, 3, 5):
        want = np.asarray(jax_best_rank_r(jnp.asarray(K), r))
        np.testing.assert_allclose(best_rank_r(torch.from_numpy(K), r),
                                   want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("seed", range(2))
def test_brute_force_trace_norm_and_bounds_match_jax(seed):
    K = _psd(seed, 6, 3)
    _, obj = brute_force_optimal(K, 2)
    _, want = jax_brute_force(K, 2)
    np.testing.assert_allclose(obj, want, rtol=1e-5)
    E = _psd(seed + 10, 6, 4) - K
    np.testing.assert_allclose(float(trace_norm(torch.from_numpy(E))),
                               float(jax_trace_norm(jnp.asarray(E))),
                               rtol=1e-5)
    K_hat = np.array(jax_best_rank_r(jnp.asarray(K), 2))
    np.testing.assert_allclose(
        theorem1_bounds(torch.from_numpy(K), torch.from_numpy(K_hat), 2),
        jax_theorem1(jnp.asarray(K), jnp.asarray(K_hat), 2),
        rtol=1e-4, atol=1e-4)


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 10_000), n=st.integers(4, 6),
       k=st.integers(2, 3), r=st.integers(1, 3), rank=st.integers(2, 5))
def test_theorem1_bounds_hold_hypothesis(seed, n, k, r, rank):
    """tests/test_theorem1.py's check on the port's functions."""
    K = torch.from_numpy(_psd(seed, n, rank))
    excess, bound_any, bound_best = theorem1_bounds(K, best_rank_r(K, r), k)
    tol = 1e-3 * max(1.0, abs(bound_best))
    assert excess <= bound_best + tol, (excess, bound_best)
    assert excess <= bound_any + tol, (excess, bound_any)
    assert excess >= -1e-3


# -- api: the registry --------------------------------------------------------

def test_registry_lists_the_four_backends_of_jax():
    assert available_backends() == list(BACKENDS) == jax_backends()
    with pytest.raises(ValueError, match="unknown backend"):
        get_backend("onepass-typo")
    with pytest.raises(ValueError, match="unknown backend"):
        KernelKMeans(backend="nope", device="cpu")


def test_memory_model_matches_jax_and_orders_the_backends():
    """The paper's axis: one-pass O(r'n) < nystrom O(mn) < exact O(n^2)."""
    for n, r in ((4000, 2), (100_000, 2), (50, 8)):
        for name in BACKENDS:
            assert fit_memory_bytes(name, n, r) == jax_memory(name, n, r)
        assert fit_memory_bytes("nystrom", n, r, m=1024) == jax_memory(
            "nystrom", n, r, m=1024)
        assert default_nystrom_m(n, r) == min(n, max(16 * r, 64))
    n, r = 4000, 2
    onepass = fit_memory_bytes("onepass-srht", n, r, oversampling=10)
    assert onepass == 4 * n * (r + 10)
    assert onepass < fit_memory_bytes("nystrom", n, r) < fit_memory_bytes(
        "exact", n, r) == 4 * n * n


def test_register_backend_adds_an_approximator(monkeypatch):
    monkeypatch.setattr(be, "_BACKENDS", dict(be._BACKENDS))
    register_backend("exact-copy", memory=lambda n, r, **_: 4 * n * n)(
        be.get_backend("exact")._fit)
    assert "exact-copy" in available_backends()
    assert fit_memory_bytes("exact-copy", 10, 2) == 400
    assert repr(get_backend("exact-copy")) == "<Approximator 'exact-copy'>"


# -- api: the estimator -------------------------------------------------------

@pytest.mark.parametrize("name", ["nystrom", "exact"])
def test_estimator_fit_matches_jax(blobs, jax_fits, name, tmp_path):
    X, y = blobs
    jest = jax_fits[name]
    est = _port_fit(X, name, jest)
    assert clustering_accuracy(y, est.labels_, 3) >= 0.95
    assert clustering_accuracy(np.asarray(jest.labels_), est.labels_,
                               3) >= 0.99
    np.testing.assert_allclose(est.eigvals_.numpy(),
                               np.asarray(jest.eigvals_), rtol=TOL)
    assert _khat_rel(est.embedding_, jest.embedding_) < TOL
    steps = {"nystrom": ["landmark_gram", "eig"], "exact": ["gram", "eig"]}
    assert list(est.fit_times_) == steps[name] + ["kmeans_pp", "lloyd"]
    # predict, score, save, load on the CPU.
    labels = est.predict(X)
    assert clustering_accuracy(est.labels_, labels, 3) >= 0.99
    assert est.score(X) <= 0.0 and est.score() <= 0.0
    loaded = KernelKMeans.load(est.save(str(tmp_path / name)),
                               device="cpu")
    assert loaded.spec_ == est.spec_
    assert torch.equal(loaded.predict(X), labels)
    # Fed JAX's k-means++ seeds (flipped into the port's orientation), the
    # port finds JAX's clustering label for label.
    sign = np.sign(np.sum(est.embedding_.numpy()
                          * np.asarray(jest.embedding_), axis=1))
    fed = _port_fit(X, name, jest, init=_jax_init(jest, sign))
    assert np.mean(fed.labels_.numpy() == np.asarray(jest.labels_)) >= 0.99
    np.testing.assert_allclose(fed.centroids_.numpy(),
                               np.asarray(jest.centroids_) * sign,
                               rtol=TOL, atol=TOL)


def test_exact_is_the_error_floor(blobs, jax_fits):
    """tests/test_api.py:65-79 on the port: no backend's error falls below
    the exact rank-r error by more than 1e-5."""
    X = blobs[0]
    K = gram_matrix(make_kernel("rbf", gamma=1.0), torch.from_numpy(X))
    errs = {name: kernel_approx_error(K, _port_fit(
        X, name, jax_fits.get(name)).embedding_) for name in BACKENDS}
    for name, err in errs.items():
        assert errs["exact"] - 1e-5 <= err <= errs["exact"] + 0.15, errs


def test_landmark_round_trip_and_model_Y(blobs, jax_fits):
    X = blobs[0]
    est = _port_fit(X, "nystrom", jax_fits["nystrom"])
    model = est.model_
    assert model.landmarks.shape == (4, NYSTROM_M)
    assert model.landmark_idx.dtype == torch.int64
    assert torch.equal(model.landmarks,
                       torch.from_numpy(X)[:, model.landmark_idx])
    assert model.U.shape[0] == model.n_ref == NYSTROM_M
    assert model.extension_ref is model.landmarks
    rel = float(torch.linalg.norm(est.embed(X) - est.embedding_)
                / torch.linalg.norm(est.embedding_))
    assert rel <= 1e-5, rel
    with pytest.raises(AttributeError, match="landmark"):
        model.Y
    exact = _port_fit(X, "exact").model_
    assert exact.n_ref == 240 and exact.extension_ref is exact.X_train
    np.testing.assert_allclose(exact.Y.numpy(),
                               _port_fit(X, "exact").embedding_.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_exact_refuses_a_sketch_and_partial_fit(blobs):
    X = blobs[0]
    with pytest.raises(ValueError, match="draws nothing"):
        KernelKMeans(**FIT, backend="exact", device="cpu").fit(
            X, sketch=torch.arange(4))
    for name in ("nystrom", "exact"):
        with pytest.raises(ValueError, match="one-pass"):
            KernelKMeans(**FIT, backend=name, device="cpu").partial_fit(
                X, capacity=240)


@pytest.mark.parametrize("name", ["nystrom", "exact"])
def test_a_policy_is_inert_for_the_fit(blobs, jax_fits, name):
    """A fit policy reaches only the one-pass backends; a Nystrom or exact
    fit given one equals the fit without."""
    X = blobs[0]
    plain = _port_fit(X, name, jax_fits[name])
    fused = _port_fit(X, name, jax_fits[name],
                      policy=ComputePolicy(fit_fused=True, interpret=True))
    assert torch.equal(fused.embedding_, plain.embedding_)
    assert torch.equal(fused.labels_, plain.labels_)


# -- serve: JAX models carried across -----------------------------------------

@pytest.mark.parametrize("name", ["nystrom", "exact"])
@pytest.mark.parametrize("policy", [ComputePolicy(interpret=True),
                                    ComputePolicy(embed_fused=False,
                                                  assign_fused=False)],
                         ids=["fused-plain", "two-pass"])
def test_jax_model_carried_across_serves(blobs, jax_fits, name, policy):
    X = blobs[0]
    Xq = X[:, ::3].copy()
    jm = jax_fits[name].model_
    leaves = {f: None if getattr(jm, f) is None else np.asarray(getattr(jm, f))
              for f in jm._fields[1:]}
    model = from_reference(leaves, dataclasses.asdict(jm.spec), device="cpu")
    assert (model.landmarks is None) == (name == "exact")
    want = jax_assign(jm, Xq)
    emb = Extender(model, policy=policy).embed(Xq).T.double()
    dist = ((emb[:, None, :] - model.centroids.double()[None]) ** 2).sum(
        -1).numpy()
    batcher = MicroBatcher(model, policy=policy, max_bucket=32)
    tickets = [batcher.submit(Xq[:, a:b]) for a, b in ((0, 1), (1, 9),
                                                       (9, 80))]
    out = batcher.drain()
    got = tuple(np.concatenate([out[t][i] for t in tickets]) for i in (0, 1))
    near_tie_compare(got, want, TOL, TOL, dist)
    labels, d2 = Extender(model, policy=policy).assign(Xq)
    np.testing.assert_array_equal(got[0], labels.numpy())   # bucketed ==
    np.testing.assert_array_equal(got[1].view(np.int32),    # unbatched
                                  d2.numpy().view(np.int32))


# -- the deprecated shims -----------------------------------------------------

def test_shims_warn_and_equal_the_estimator(blobs):
    X = blobs[0]
    kern = make_kernel("rbf", gamma=1.0)
    est = KernelKMeans(**FIT, backend="onepass-srht",
                       backend_params={"oversampling": 5},
                       device="cpu").fit(X, seed=4)
    with pytest.warns(DeprecationWarning, match="one_pass_kernel_kmeans"):
        res = one_pass_kernel_kmeans(kern, torch.from_numpy(X), 3, 4,
                                     oversampling=5, block=64, seed=4)
    assert torch.equal(res.Y, est.embedding_)
    assert torch.equal(res.labels, est.labels_)
    with pytest.warns(DeprecationWarning, match="fit_model"):
        model = fit_model(X, 3, 4, kernel="rbf", kernel_params={"gamma": 1.0},
                          oversampling=5, block=64, seed=4, device="cpu")
    assert model.spec == est.spec_
    assert torch.equal(model.centroids, est.centroids_)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        km = linearized_kmeans_from_Y(est.embedding_, 3,
                                      init=est.kmeans_init_)
    want = kmeans(est.embedding_.T.contiguous(), 3, init=est.kmeans_init_)
    assert torch.equal(km.labels, want.labels)
    with pytest.raises(ValueError, match="generator or init"):
        linearized_kmeans_from_Y(est.embedding_, 3)
