"""The slice end to end against the JAX package: fit, then serve.

Segmentation shape (p = 19, K = 7, r = 2, l = 5, block 128) at n = 700,
held-out queries beside it; the data is made with numpy from a seed, and
the JAX package's draws (SRHT signs/rows, the k-means++ seeds) are fed to
the port. Tolerances: 2e-3 (the registry default) for sketch state,
eigenvalues, subspaces and embeddings; labels by the kmeans_assign rule
(distances within tolerance, labels differ on < 1% of rows) or, for a
whole fit, >= 0.99 agreement up to a permutation.
"""
import dataclasses
import time
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.api import KernelKMeans as JaxKernelKMeans
from repro.api.backends import fit_memory_bytes as jax_memory
from repro.core.kmeans import kmeans_plus_plus as jax_kmeans_plus_plus
from repro.serve import ComputePolicy as JaxPolicy
from repro.serve.extend import assign as jax_assign
from repro.serve.policy import resolve_pallas_path
from repro_torch.api import KernelKMeans, fit_memory_bytes
from repro_torch.core.kernels_fn import make_kernel
from repro_torch.core.metrics import clustering_accuracy
from repro_torch.core.sketch import SRHT, GaussianSketch, next_pow2
from repro_torch.data import gaussian_blobs, segmentation_proxy
from repro_torch.kernels.registry import assign_compare
from repro_torch.serve import ComputePolicy, MicroBatcher, from_reference
from repro_torch.serve.extend import Extender
from repro_torch.serve.policy import resolve_kernel_path
from repro_torch.stream.accumulate import SketchAccumulator

N, NQ, P, K, R, L, BLOCK = 700, 160, 19, 7, 2, 5, 128
KPARAMS = {"gamma": 0.0, "degree": 2}
STATICS = ("polynomial", 0.0, 2)
TOL = 2e-3
FUSED_PLAIN = ComputePolicy(fit_fused=True, interpret=True)
TWO_PASS = ComputePolicy(embed_fused=False, assign_fused=False)


@pytest.fixture(scope="module")
def data():
    X, y = segmentation_proxy(np.random.default_rng(11), n=N + NQ, p=P, k=K)
    perm = np.random.default_rng(12).permutation(N + NQ)
    X, y = X.numpy()[:, perm], y.numpy()[perm]
    return X[:, :N].copy(), y[:N], X[:, N:].copy()


def _jax_fit(X, policy):
    return JaxKernelKMeans(
        k=K, r=R, kernel="polynomial", kernel_params=KPARAMS,
        backend="onepass-srht", backend_params={"oversampling": L},
        block=BLOCK, policy=policy).fit(X, key=0)


@pytest.fixture(scope="module")
def jax_fits(data):
    X = data[0]
    return {"fused": _jax_fit(X, JaxPolicy(fit_fused=True, interpret=True)),
            "canonical": _jax_fit(X, None)}


def _sketch(model):
    return SRHT(signs=torch.from_numpy(np.array(model.sketch_signs)),
                rows=torch.from_numpy(np.array(model.sketch_rows, np.int64)),
                n=N, n_pad=next_pow2(N))


def _leaves(model):
    names = ("X_train", "U", "eigvals", "centroids", "sketch_signs",
             "sketch_rows", "sketch_omega", "stream_w", "stream_row_norms2",
             "stream_counts")
    return {n: None if getattr(model, n) is None
            else np.asarray(getattr(model, n)) for n in names}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _subspace_gap(U1, U2):
    U1, U2 = np.asarray(U1, np.float64), np.asarray(U2, np.float64)
    return np.linalg.norm(U1 @ U1.T - U2 @ U2.T)


# -- (a) fit: the accumulator on the JAX sketch -----------------------------

@pytest.mark.parametrize("jax_path,policy", [("fused", FUSED_PLAIN),
                                             ("canonical", None),
                                             ("canonical", FUSED_PLAIN)],
                         ids=["fused", "canonical", "fused-vs-canonical"])
def test_fit_sketch_state_and_eig_match_jax(data, jax_fits, jax_path,
                                            policy):
    X = data[0]
    ref = jax_fits[jax_path].model_
    acc = SketchAccumulator(make_kernel("polynomial", **KPARAMS), N, R,
                            sketch=_sketch(ref), oversampling=L, block=BLOCK,
                            policy=policy, kernel_statics=STATICS)
    eig = acc.add(torch.from_numpy(X)).eig()
    st = acc.state_arrays()
    np.testing.assert_array_equal(st["stream_counts"].numpy(),
                                  np.asarray(ref.stream_counts))
    _close(st["stream_w"], ref.stream_w)
    _close(st["stream_row_norms2"], ref.stream_row_norms2)
    _close(eig.eigvals, ref.eigvals)
    assert _subspace_gap(eig.U, ref.U) < TOL


# -- (b) the port's own fit ----------------------------------------------

def test_kernel_kmeans_fit_matches_jax_labels(data, jax_fits):
    X = data[0]
    ref = jax_fits["canonical"]
    _, k_km = jax.random.split(jax.random.PRNGKey(0))   # fit(X, key=0)
    init = jax.vmap(lambda kk: jax_kmeans_plus_plus(
        kk, ref.embedding_.T, K))(jax.random.split(k_km, ref.n_restarts))
    for policy in (None, FUSED_PLAIN):
        est = KernelKMeans(k=K, r=R, kernel="polynomial",
                           kernel_params=KPARAMS, backend="onepass-srht",
                           backend_params={"oversampling": L}, block=BLOCK,
                           policy=policy, device="cpu")
        est.fit(X, sketch=_sketch(ref.model_),
                init=torch.from_numpy(np.array(init)))
        _close(est.eigvals_, ref.eigvals_)
        assert clustering_accuracy(np.asarray(ref.labels_), est.labels_,
                                   K) >= 0.99


def test_kernel_kmeans_own_draws_recover_blobs():
    X, y = gaussian_blobs(np.random.default_rng(13), 600, 3, 4, spread=0.1,
                          center_scale=2.0)
    est = KernelKMeans(k=4, r=3, kernel="linear", block=128,
                       backend_params={"oversampling": 4}, device="cpu")
    labels = est.fit(X, seed=5).labels_
    assert clustering_accuracy(y, labels, 4) >= 0.99
    assert est.kmeans_init_.shape == (10, 4, 3)
    np.testing.assert_array_equal(
        KernelKMeans(k=4, r=3, kernel="linear", block=128,
                     backend_params={"oversampling": 4},
                     device="cpu").fit(X, seed=5).labels_.numpy(),
        labels.numpy())                        # same seed, same fit


def test_fit_times_split_the_fit_into_its_steps(data):
    est = KernelKMeans(k=K, r=R, kernel="polynomial", kernel_params=KPARAMS,
                       backend_params={"oversampling": L}, block=BLOCK,
                       device="cpu")
    t0 = time.perf_counter()
    est.fit(data[0], seed=3)
    wall = time.perf_counter() - t0
    times = est.fit_times_
    assert list(times) == ["block_updates", "eig", "kmeans_pp", "lloyd"]
    assert all(t >= 0 for t in times.values())
    assert sum(times.values()) <= wall


# -- (c) serving a model carried across ------------------------------------

@pytest.mark.parametrize("policy", [ComputePolicy(interpret=True), TWO_PASS],
                         ids=["fused-plain", "two-pass"])
def test_serving_a_jax_model_matches_jax(data, jax_fits, policy):
    Xq = data[2]
    jest = jax_fits["fused"]
    model = from_reference(_leaves(jest.model_),
                           dataclasses.asdict(jest.model_.spec),
                           device="cpu")
    want_labels, want_d2 = jax_assign(jest.model_, Xq, policy=jest.policy)
    _close(Extender(model, policy=policy).embed(Xq), jest.embed(Xq))
    batcher = MicroBatcher(model, policy=policy, max_bucket=64)
    tickets = [batcher.submit(Xq[:, a:b])
               for a, b in ((0, 1), (1, 8), (8, 72), (72, NQ))]
    out = batcher.drain()
    got = (np.concatenate([out[t][0] for t in tickets]),
           np.concatenate([out[t][1] for t in tickets]))
    assign_compare(got, (want_labels, want_d2), TOL, TOL)
    est = KernelKMeans.from_model(model, policy=policy)
    np.testing.assert_array_equal(est.predict(Xq).numpy(), got[0])


# -- (d) contracts inside the port --------------------------------------------

@pytest.mark.parametrize("policy", [ComputePolicy(interpret=True), TWO_PASS],
                         ids=["fused-plain", "two-pass"])
def test_bucketed_equals_unbatched_bit_for_bit(data, jax_fits, policy):
    jest = jax_fits["fused"]
    model = from_reference(_leaves(jest.model_),
                           dataclasses.asdict(jest.model_.spec),
                           device="cpu")
    ext = Extender(model, policy=policy)
    for b in (5, 64, 150):
        Xq = data[2][:, :b]
        labels, d2 = ext.assign(Xq)
        got = MicroBatcher(model, policy=policy, max_bucket=64).assign_batch(
            Xq)
        np.testing.assert_array_equal(got[0], labels.numpy())
        np.testing.assert_array_equal(got[1], d2.numpy())


@pytest.mark.parametrize("policy", [None, FUSED_PLAIN],
                         ids=["canonical", "fused-plain"])
def test_chunked_add_equals_one_shot_bit_for_bit(data, policy):
    X = torch.from_numpy(data[0])

    def acc():
        return SketchAccumulator(
            make_kernel("polynomial", **KPARAMS), N, R,
            generator=torch.Generator().manual_seed(3), oversampling=L,
            block=BLOCK, policy=policy, kernel_statics=STATICS)

    one = acc().add(X)
    chunked = acc()
    for a, b in ((0, 1), (1, 200), (200, 256), (256, 699), (699, N)):
        chunked.add(X[:, a:b])
    for name in ("stream_w", "stream_row_norms2", "stream_counts"):
        np.testing.assert_array_equal(chunked.state_arrays()[name].numpy(),
                                      one.state_arrays()[name].numpy())
    e1, e2 = one.eig(), chunked.eig()
    np.testing.assert_array_equal(e1.Y.numpy(), e2.Y.numpy())


@pytest.mark.parametrize("fused", [None, True, False])
@pytest.mark.parametrize("interpret", [None, True, False])
def test_policy_conflict_rules_match_jax_on_cpu(fused, interpret):
    # On the CPU the JAX pair is (path, path): its first half is the
    # port's one answer.
    outcomes = []
    for fn in (lambda: resolve_pallas_path(fused, interpret, "x")[0],
               lambda: resolve_kernel_path(fused, interpret, "x", "cpu")):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                outcomes.append((fn(), len(caught)))
            except ValueError:
                outcomes.append(("raises", len(caught)))
    assert outcomes[0] == outcomes[1]


def test_policy_on_the_card_runs_the_kernels():
    assert resolve_kernel_path(None, None, "x", "cuda") is True
    assert resolve_kernel_path(False, None, "x", "cuda") is False
    with pytest.raises(ValueError, match="only on the CPU"):
        resolve_kernel_path(None, True, "x", "cuda")


def test_resume_from_arrays_equals_one_shot(data):
    X = torch.from_numpy(data[0])
    kern = make_kernel("polynomial", **KPARAMS)

    def acc():
        return SketchAccumulator(
            kern, N, R, generator=torch.Generator().manual_seed(4),
            oversampling=L, block=BLOCK, policy=FUSED_PLAIN,
            kernel_statics=STATICS)

    one = acc().add(X)
    first = acc().add(X[:, :300])
    st = first.state_arrays()
    resumed = SketchAccumulator.from_arrays(
        kern, R, first.sketch, st["stream_w"], st["stream_row_norms2"],
        int(st["stream_counts"][0]), first.X_all, block=BLOCK,
        policy=FUSED_PLAIN, kernel_statics=STATICS).add(X[:, 300:])
    for name in ("stream_w", "stream_row_norms2", "stream_counts"):
        np.testing.assert_array_equal(resumed.state_arrays()[name].numpy(),
                                      one.state_arrays()[name].numpy())
    with pytest.raises(ValueError, match="inconsistent"):
        SketchAccumulator.from_arrays(kern, R, first.sketch, st["stream_w"],
                                      st["stream_row_norms2"], 400,
                                      first.X_all, block=BLOCK)


@pytest.mark.parametrize("policy", [None, FUSED_PLAIN],
                         ids=["canonical", "fused-plain"])
def test_gaussian_backend_fit_matches_jax(data, policy):
    X = data[0]
    ref = JaxKernelKMeans(
        k=K, r=R, kernel="polynomial", kernel_params=KPARAMS,
        backend="onepass-gaussian", backend_params={"oversampling": L},
        block=BLOCK).fit(X, key=1).model_
    acc = SketchAccumulator(
        make_kernel("polynomial", **KPARAMS), N, R,
        sketch=GaussianSketch(torch.from_numpy(np.array(ref.sketch_omega))),
        oversampling=L, block=BLOCK, policy=policy, kernel_statics=STATICS)
    eig = acc.add(torch.from_numpy(X)).eig()
    _close(acc.state_arrays()["stream_w"], ref.stream_w)
    _close(eig.eigvals, ref.eigvals)
    assert _subspace_gap(eig.U, ref.U) < TOL
    for name in ("onepass-srht", "onepass-gaussian"):
        assert fit_memory_bytes(name, N, R, oversampling=L) == \
            jax_memory(name, N, R, oversampling=L)


def test_estimator_surface_on_a_carried_model(data, jax_fits):
    Xq = torch.from_numpy(data[2])
    jest = jax_fits["canonical"]
    model = from_reference(_leaves(jest.model_),
                           dataclasses.asdict(jest.model_.spec),
                           device="cpu")
    est = KernelKMeans.from_model(model)
    assert torch.equal(est.transform(Xq), est.embed(Xq))
    _, d2 = est.extender().assign(Xq)
    assert est.score(Xq) == pytest.approx(-float(d2.sum()))
    with pytest.raises(RuntimeError, match="pass X"):
        est.score()
    batcher = MicroBatcher(model, max_bucket=64)
    assert batcher.warm([1, 3, 40, 500]) == [8, 64]
    assert batcher.executables == [8, 64]
    batcher.reset_stats()
    assert batcher.stats == {"queries": 0, "padded_queries": 0,
                             "batches": 0, "bucket_hits": {}}
    with pytest.raises(ValueError, match="request must be"):
        batcher.submit(np.zeros((P + 1, 3), np.float32))


def test_data_from_a_torch_generator():
    X, y = segmentation_proxy(torch.Generator().manual_seed(0), n=70)
    assert X.shape == (P, 70) and y.shape == (70,)
    torch.testing.assert_close(torch.linalg.norm(X, dim=0),
                               torch.ones(70))
    X2, _ = segmentation_proxy(torch.Generator().manual_seed(0), n=70)
    assert torch.equal(X, X2)
