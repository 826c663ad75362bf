"""The port's streaming fit against the JAX package: partial_fit, re-eig,
minibatch K-means, the truncate_basis ablation, and resume from a saved
artifact.

Sizes are those of tests/test_stream.py (N = 250 points in p = 2, block
64, so chunk edges fall inside blocks and a ragged tail is staged). The
contracts inside the port (chunked == one-shot, resumed == live) hold bit
for bit, torch against torch. Across frameworks the data is made with
numpy and the JAX package's draws (SRHT signs/rows, k-means++ seeds,
minibatch indices) are fed to the port; tolerances: 2e-4 for the FWHT
(the fwht registry's), 2e-3 (the registry default) for sketch state,
eigenvalues, subspaces and centroids, and labels agreeing on >= 0.99 up
to a permutation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import KernelKMeans as JaxKernelKMeans
from repro.core.kmeans import kmeans_plus_plus as jax_kmeans_plus_plus
from repro.core.sketch import make_srht as jax_make_srht
from repro.core.sketch import one_pass_core as jax_one_pass_core
from repro.core.sketch import srht_apply_t as jax_srht_apply_t
from repro.kernels.fwht.ops import fwht_pallas
from repro.serve import save_model as jax_save_model
from repro.stream import minibatch_kmeans as jax_minibatch_kmeans
from repro_torch.api import KernelKMeans
from repro_torch.core.kernels_fn import make_kernel
from repro_torch.core.metrics import clustering_accuracy
from repro_torch.core.sketch import (SRHT, GaussianSketch, next_pow2,
                                     randomized_eig, randomized_eig_with_state,
                                     sketch_stream, srht_apply, srht_apply_t,
                                     truncate_sketch)
from repro_torch.data import gaussian_blobs
from repro_torch.kernels import fwht_op, reset_launches
from repro_torch.serve import ComputePolicy
from repro_torch.stream.accumulate import SketchAccumulator
from repro_torch.stream.minibatch import MiniBatchDraws, minibatch_kmeans

N, P, R, K, BLOCK = 250, 2, 2, 2, 64
KPARAMS = {"gamma": 0.0, "degree": 2}
TOL = 2e-3
FWHT_TOL = 2e-4
CHUNKS = ((0, 100), (100, 164), (164, N))
_POLY = dict(k=K, r=R, kernel="polynomial", kernel_params=KPARAMS,
             block=BLOCK)


def _est(**kw):
    return KernelKMeans(**_POLY, device="cpu", **kw)


def _jax_est(**kw):
    return JaxKernelKMeans(**_POLY, **kw)


@pytest.fixture(scope="module")
def X():
    X, _ = gaussian_blobs(np.random.default_rng(0), N, P, K, spread=0.3,
                          center_scale=2.0)
    return X.numpy()


def _assert_models_equal(a, b):
    """Every FittedModel leaf bit-identical, the spec equal."""
    assert a.spec == b.spec
    for name in a._fields[1:]:
        va, vb = getattr(a, name), getattr(b, name)
        if va is None or vb is None:
            assert va is None and vb is None, name
        else:
            assert torch.equal(va, vb), name


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _subspace_gap(U1, U2):
    U1, U2 = np.asarray(U1, np.float64), np.asarray(U2, np.float64)
    return np.linalg.norm(U1 @ U1.T - U2 @ U2.T)


def _sketch(model, n=N):
    return SRHT(signs=torch.from_numpy(np.array(model.sketch_signs)),
                rows=torch.from_numpy(np.array(model.sketch_rows, np.int64)),
                n=n, n_pad=next_pow2(n))


def _jax_init(key, Y, n_restarts=10):
    """The k-means++ seeds JAX's kmeans(k_km, Y) draws for key=`key`."""
    _, k_km = jax.random.split(jax.random.PRNGKey(key))
    return np.array(jax.vmap(lambda kk: jax_kmeans_plus_plus(kk, Y, K))(
        jax.random.split(k_km, n_restarts)))


def _jax_minibatch_draws(key, Y, batch, steps):
    """The draws of repro.stream.minibatch.minibatch_kmeans(key, ...)."""
    k_init, k_loop = jax.random.split(key)
    init = np.array(jax_kmeans_plus_plus(k_init, Y, K))

    def step(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.randint(sub, (batch,), 0, Y.shape[0])

    _, idx = jax.lax.scan(step, k_loop, None, length=steps)
    return MiniBatchDraws(init=torch.from_numpy(init),
                          idx=torch.from_numpy(np.array(idx)))


# -- the FWHT hook --------------------------------------------------------

@pytest.mark.parametrize("n,b", [(250, 20), (64, 3), (1000, 7)])
def test_srht_apply_t_with_fwht_op_matches_jax_pallas(n, b):
    srht = jax_make_srht(jax.random.PRNGKey(n), n, 9)
    M = np.random.default_rng(n).standard_normal((n, b)).astype(np.float32)
    want = jax_srht_apply_t(
        srht, jnp.asarray(M), lambda x: fwht_pallas(x, interpret=True))
    port = SRHT(signs=torch.from_numpy(np.array(srht.signs)),
                rows=torch.from_numpy(np.array(srht.rows, np.int64)),
                n=n, n_pad=next_pow2(n))
    reset_launches()
    got = srht_apply_t(port, torch.from_numpy(M), fwht_op)
    assert fwht_op.launches == 0          # CPU tensors: the plain version
    _close(got, want, FWHT_TOL)
    assert torch.equal(got, srht_apply_t(port, torch.from_numpy(M)))
    V = torch.from_numpy(M[:9].copy())
    assert torch.equal(srht_apply(port, V, fwht_op), srht_apply(port, V))


def test_randomized_eig_equals_the_accumulator(X):
    """sketch_stream / randomized_eig (one pass over stripes) and the
    accumulator (block border updates) are the same fit. Three full
    blocks, so the accumulator's W has no staged tail."""
    kern = make_kernel("polynomial", **KPARAMS)
    Xb = torch.from_numpy(X[:, :3 * BLOCK].copy())
    gen = torch.Generator().manual_seed(3)
    out = randomized_eig_with_state(kern, Xb, R, oversampling=5,
                                    block=BLOCK, fwht_fn=fwht_op,
                                    generator=gen)
    acc = SketchAccumulator(kern, 3 * BLOCK, R, sketch=out.sketch,
                            oversampling=5, block=BLOCK)
    eig = acc.add(Xb).eig()
    W = sketch_stream(kern, Xb, out.sketch, BLOCK)
    _close(W, acc.state_arrays()["stream_w"])
    _close(out.eig.eigvals, eig.eigvals)
    assert _subspace_gap(out.eig.U, eig.U) < TOL
    again = randomized_eig(kern, Xb, R, oversampling=5, block=BLOCK,
                           sketch=out.sketch)
    assert torch.equal(again.eigvals, out.eig.eigvals)
    with pytest.raises(ValueError, match="generator or a sketch"):
        randomized_eig(kern, Xb, R)


# -- contracts inside the port ----------------------------------------------

@pytest.mark.parametrize("backend", ["onepass-srht", "onepass-gaussian"])
def test_partial_fit_bit_identical_to_fit(X, backend):
    ref = _est(backend=backend).fit(X, seed=7)
    est = _est(backend=backend)
    for lo, hi in CHUNKS:
        est.partial_fit(X[:, lo:hi], seed=7, capacity=N, reeig=(hi == N))
    _assert_models_equal(est.model_, ref.model_)
    assert torch.equal(est.labels_, ref.labels_)
    assert est.inertia_ == ref.inertia_
    np.testing.assert_array_equal(ref.model_.stream_counts.numpy(),
                                  [(N // BLOCK) * BLOCK, N])


def test_partial_fit_chunking_invariant(X):
    a = _est()
    for lo, hi in ((0, 3), (3, 131), (131, N)):
        a.partial_fit(X[:, lo:hi], seed=11, capacity=N, reeig=(hi == N))
    b = _est().partial_fit(X, seed=11, capacity=N)
    _assert_models_equal(a.model_, b.model_)


def test_partial_fit_first_call_contract(X):
    with pytest.raises(ValueError, match="capacity"):
        _est().partial_fit(X[:, :64], seed=0)
    est = _est()
    est.backend = "nystrom"           # no streaming state
    with pytest.raises(ValueError, match="one-pass"):
        est.partial_fit(X[:, :64], seed=0, capacity=64)
    est = _est().partial_fit(X[:, :64], seed=0, capacity=N, reeig=False)
    with pytest.raises(ValueError, match="feature rows"):
        est.partial_fit(np.zeros((P + 1, 5), np.float32))
    with pytest.raises(ValueError, match="2-D"):
        est.partial_fit(np.zeros((P,), np.float32))
    with pytest.raises(ValueError, match="first partial_fit only"):
        est.partial_fit(X[:, 64:70], sketch=est._acc.sketch)
    est.policy = ComputePolicy(fit_fused=True, interpret=True)
    with pytest.raises(ValueError, match="changed mid-stream"):
        est.partial_fit(X[:, 64:70])
    with pytest.raises(RuntimeError, match="partial_fit"):
        _est().reeig_now()


def test_accumulator_capacity_guard(X):
    est = _est().partial_fit(X[:, :64], seed=0, capacity=64)
    with pytest.raises(ValueError, match="capacity"):
        est.partial_fit(X[:, :1])


def test_stream_progress_counters(X):
    est = _est()
    assert est.stream_progress == {}
    est.partial_fit(X[:, :100], seed=4, capacity=N, reeig=False)
    assert est.model_ is None                      # the cheap steady state
    prog = est.stream_progress
    assert prog["n_added"] == 100 and prog["capacity"] == N
    assert prog["n_applied"] == 64 and prog["n_pending"] == 36
    assert prog["reeigs"] == 0
    est.partial_fit(X[:, 100:], reeig=True)
    prog = est.stream_progress
    assert prog["n_added"] == N and prog["reeigs"] == 1
    assert 0.0 <= prog["approx_err_estimate"] <= 1.0
    assert est.model_ is not None and est.labels_.shape == (N,)
    with pytest.raises(ValueError, match="kmeans_mode"):
        est.reeig_now(kmeans_mode="nope")
    assert est.stream_progress["reeigs"] == 1


def test_resume_through_an_artifact_equals_live(X, tmp_path):
    live = _est()
    live.partial_fit(X[:, :150], seed=5, capacity=N)
    live.save(str(tmp_path / "a"))
    resumed = KernelKMeans.load(str(tmp_path / "a"), device="cpu")
    assert resumed.labels_ is None and resumed.model_ is not None
    live.partial_fit(X[:, 150:])
    resumed.partial_fit(X[:, 150:], seed=5)
    _assert_models_equal(resumed.model_, live.model_)
    _assert_models_equal(resumed.model_, _est().fit(X, seed=5).model_)


def test_accumulator_from_model_requires_stream_state(X):
    model = _est().fit(X[:, :64], seed=0).model_
    stripped = model._replace(stream_w=None, stream_row_norms2=None,
                              stream_counts=None)
    with pytest.raises(ValueError, match="stream"):
        SketchAccumulator.from_model(stripped)
    acc = SketchAccumulator.from_model(model, fwht_fn=fwht_op)
    assert acc.fwht_fn is fwht_op and acc.n_added == 64


def test_minibatch_kmeans_own_draws_are_deterministic(X):
    Y = torch.from_numpy(X.T.copy())
    a = minibatch_kmeans(Y, K, 64, 40, generator=torch.Generator()
                         .manual_seed(6))
    b = minibatch_kmeans(Y, K, 64, 40, generator=torch.Generator()
                         .manual_seed(6))
    assert torch.equal(a.labels, b.labels) and a.n_steps == 40
    assert a.centroids.shape == (K, P)
    with pytest.raises(ValueError, match="generator or draws"):
        minibatch_kmeans(Y, K)


# -- against the JAX package -------------------------------------------------

@pytest.mark.parametrize("steps", [1, 40])
def test_minibatch_kmeans_matches_jax_on_its_draws(X, steps):
    Y = jnp.asarray(X.T)
    key = jax.random.PRNGKey(6)
    want = jax_minibatch_kmeans(key, Y, K, 64, steps)
    draws = _jax_minibatch_draws(key, Y, 64, steps)
    got = minibatch_kmeans(torch.from_numpy(X.T.copy()), K, draws=draws)
    _close(got.centroids, want.centroids)
    _close(got.objective, want.objective, 1e-4 * float(want.objective))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))


@pytest.mark.parametrize("mode", ["full", "minibatch"])
def test_partial_fit_on_jax_draws_matches_jax(X, mode):
    kw = dict(kmeans_mode=mode, minibatch_size=64, minibatch_steps=30)
    ref = _jax_est(backend_params={"oversampling": 5})
    for lo, hi in CHUNKS:
        ref.partial_fit(X[:, lo:hi], key=9, capacity=N, reeig=(hi == N),
                        **kw)
    Y = ref.embedding_.T
    if mode == "full":
        init = torch.from_numpy(_jax_init(9, Y))
    else:
        init = _jax_minibatch_draws(jax.random.split(
            jax.random.PRNGKey(9))[1], Y, 64, 30)
    est = _est(backend_params={"oversampling": 5})
    for lo, hi in CHUNKS:
        est.partial_fit(X[:, lo:hi], capacity=N, reeig=(hi == N),
                        sketch=_sketch(ref.model_) if lo == 0 else None,
                        init=init if hi == N else None, **kw)
    m, rm = est.model_, ref.model_
    np.testing.assert_array_equal(m.stream_counts.numpy(),
                                  np.asarray(rm.stream_counts))
    _close(m.stream_w, rm.stream_w)
    _close(m.stream_row_norms2, rm.stream_row_norms2)
    _close(m.eigvals, rm.eigvals)
    assert _subspace_gap(m.U, rm.U) < TOL
    assert clustering_accuracy(np.asarray(ref.labels_), est.labels_,
                               K) >= 0.99
    assert est.stream_progress["approx_err_estimate"] == pytest.approx(
        ref.stream_progress["approx_err_estimate"], abs=TOL)


def test_truncate_basis_repair_matches_jax(X):
    """backend_params of the JAX package no longer raise in the port: a
    truncate_basis fit (Alg. 1 line 3 read literally), with fwht_fn
    passed too, holds against the JAX fit made with the same draws on
    what the ablation determines: the sketch, and its rank-r truncation
    W_r within 2e-3.

    Past W_r the ablation is ill-conditioned in the reference itself: QR
    of the rank-r W_r fills the other r' - r columns of Q from roundoff,
    and the core solve depends on them. A 1e-7 relative perturbation of W
    moves JAX's own eigenvalues by more than 1% (asserted below), so the
    eigenvalues of the two packages are not compared."""
    params = {"oversampling": 5, "truncate_basis": True}
    ref = _jax_est(backend_params=params).fit(X, key=2)
    init = torch.from_numpy(_jax_init(2, ref.embedding_.T))
    est = _est(backend_params={**params, "fwht_fn": fwht_op})
    est.fit(X, sketch=_sketch(ref.model_), init=init)
    assert est.spec_.backend_params == params       # the callable stays out
    _close(est.model_.stream_w, ref.model_.stream_w)
    W = np.array(ref.model_.stream_w)
    U, S, Vt = np.linalg.svd(W.astype(np.float64), full_matrices=False)
    _close(truncate_sketch(torch.from_numpy(W), R),
           (U[:, :R] * S[None, :R]) @ Vt[:R])
    assert torch.isfinite(est.eigvals_).all() and est.labels_.shape == (N,)
    plain = _est(backend_params={"oversampling": 5}).fit(
        X, sketch=_sketch(ref.model_), init=init)
    assert not torch.equal(plain.eigvals_, est.eigvals_)  # the flag acts
    streamed = _est(backend_params={**params, "fwht_fn": fwht_op})
    for lo, hi in CHUNKS:
        streamed.partial_fit(X[:, lo:hi], capacity=N, reeig=(hi == N),
                             sketch=_sketch(ref.model_) if lo == 0 else None,
                             init=init if hi == N else None)
    _assert_models_equal(streamed.model_, est.model_)

    m = ref.model_
    srht = jax_make_srht(jax.random.PRNGKey(0), N, R + 5)._replace(
        signs=m.sketch_signs, rows=m.sketch_rows)

    def jax_eigvals(W):
        u, s, vt = jnp.linalg.svd(W, full_matrices=False)
        Wr = (u[:, :R] * s[None, :R]) @ vt[:R]
        return np.array(jax_one_pass_core(
            Wr, lambda Q: jax_srht_apply_t(srht, Q), R).eigvals)

    noise = np.random.default_rng(1).standard_normal(W.shape)
    moved = jax_eigvals(jnp.asarray(W * (1 + 1e-7 * noise), jnp.float32))
    base = jax_eigvals(jnp.asarray(W))
    assert np.max(np.abs(moved - base) / base) > 1e-2


def test_resume_from_a_jax_artifact_matches_jax(X, tmp_path):
    """JAX streams 150 columns and saves; the port loads that artifact and
    streams the rest, as JAX's own resumed estimator does (2e-3); and the
    port's live stream on the same draws resumes bit for bit."""
    live = _jax_est(backend_params={"oversampling": 5})
    live.partial_fit(X[:, :150], key=5, capacity=N)
    path = jax_save_model(live.model_, str(tmp_path / "jax"))
    ref = JaxKernelKMeans.load(path)
    ref.partial_fit(X[:, 150:], key=5)
    init = torch.from_numpy(_jax_init(5, ref.embedding_.T))
    port = KernelKMeans.load(path, device="cpu",
                             backend_params={"fwht_fn": fwht_op})
    port.partial_fit(X[:, 150:], init=init)
    m, rm = port.model_, ref.model_
    _close(m.stream_w, rm.stream_w)
    _close(m.eigvals, rm.eigvals)
    assert _subspace_gap(m.U, rm.U) < TOL
    assert clustering_accuracy(np.asarray(ref.labels_), port.labels_,
                               K) >= 0.99
    own = _est(backend_params={"oversampling": 5})
    own.partial_fit(X[:, :150], capacity=N, sketch=_sketch(live.model_),
                    init=torch.from_numpy(_jax_init(5, live.embedding_.T)))
    own.save(str(tmp_path / "port"))
    resumed = KernelKMeans.load(str(tmp_path / "port"), device="cpu")
    for est in (own, resumed):
        est.partial_fit(X[:, 150:], init=init)
    _assert_models_equal(resumed.model_, own.model_)


def test_gaussian_partial_fit_on_jax_draws_matches_jax(X):
    ref = _jax_est(backend="onepass-gaussian",
                   backend_params={"oversampling": 5})
    for lo, hi in CHUNKS:
        ref.partial_fit(X[:, lo:hi], key=3, capacity=N, reeig=(hi == N))
    est = _est(backend="onepass-gaussian",
               backend_params={"oversampling": 5})
    omega = GaussianSketch(torch.from_numpy(np.array(
        ref.model_.sketch_omega)))
    for lo, hi in CHUNKS:
        est.partial_fit(X[:, lo:hi], capacity=N, reeig=(hi == N),
                        sketch=omega if lo == 0 else None,
                        init=(torch.from_numpy(_jax_init(
                            3, ref.embedding_.T)) if hi == N else None))
    _close(est.model_.stream_w, ref.model_.stream_w)
    _close(est.eigvals_, ref.eigvals_)
    assert clustering_accuracy(np.asarray(ref.labels_), est.labels_,
                               K) >= 0.99
