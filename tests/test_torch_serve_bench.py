"""serve/bench.py's benches held against the JAX package's on the same
inputs, on the CPU: run_benches' section keys, the kernels' byte models
(extend_embed_bytes and assign_bytes against JAX's memory_contract at
pad-free shapes), benchmark_fused's stripe bytes, machine_calibration and
benchmark_backends."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.api import KernelKMeans as JaxKernelKMeans
from repro.kernels.extend_embed.ops import \
    memory_contract as jax_extend_contract
from repro.kernels.kmeans_assign.ops import \
    memory_contract as jax_assign_contract
from repro.serve.bench import benchmark_backends as jax_benchmark_backends
from repro.serve.bench import run_benches as jax_run_benches
from repro_torch.api import KernelKMeans
from repro_torch.data import blob_ring
from repro_torch.kernels.extend_embed.ops import extend_embed_bytes
from repro_torch.kernels.kmeans_assign.ops import assign_bytes
from repro_torch.serve import (benchmark_backends, benchmark_fused,
                               machine_calibration, run_benches)
from test_torch_serve_cluster import (PORT_ONLY, _sections,  # noqa: F401
                                      one_torch_thread)

KP = {"gamma": 0.0, "degree": 2}


def _data(n, seed=3):
    X, y = blob_ring(np.random.default_rng(seed), n=n)
    return X.numpy(), y.numpy()


@pytest.fixture(scope="module")
def models():
    """The same data fitted by both packages: (jax model, port model)."""
    X, _ = _data(200)
    jest = JaxKernelKMeans(k=2, r=2, kernel_params=KP, block=64).fit(
        jnp.asarray(X), key=jax.random.PRNGKey(0))
    pest = KernelKMeans(k=2, r=2, kernel_params=KP, block=64,
                        device="cpu").fit(X, seed=0)
    return jest.model_, pest.model_


def test_run_benches_sections_match_jax(models):
    jmodel, pmodel = models
    modes = ("sync", "async", "fused", "backends")
    kw = dict(modes=modes, batch_sizes=(8,), repeats=1, n_requests=8)
    want = jax_run_benches(jmodel, key=jax.random.PRNGKey(0), **kw)
    got = run_benches(pmodel, seed=0, **kw)
    assert set(want) == _sections(modes)
    assert set(got) == set(want) | PORT_ONLY
    assert got["backends"] == want["backends"]        # skipped: no data
    assert set(got["fused"]) == set(want["fused"]) | PORT_ONLY
    assert set(got["fused"]["hbm"]) == set(want["fused"]["hbm"])
    assert set(got["async"]) == set(want["async"]) - {"sharded"}


@pytest.mark.parametrize("p,n,r,w", [(19, 1024, 8, 128), (2, 512, 16, 256),
                                     (7, 2048, 24, 384)])
def test_extend_embed_bytes_match_jax_contract(p, n, r, w):
    assert extend_embed_bytes(p, n, r, w) == \
        jax_extend_contract(p, n, r, w)["hbm_bytes"]


@pytest.mark.parametrize("n,r,k", [(1024, 128, 8), (512, 256, 16),
                                   (2048, 128, 24)])
def test_assign_bytes_match_jax_contract(n, r, k):
    assert assign_bytes(n, r, k) == jax_assign_contract(n, r, k)["hbm_bytes"]


def test_benchmark_fused_counts_the_stripe(models):
    _, model = models
    got = benchmark_fused(model, width=64, repeats=1)
    spec, n = model.spec, model.n_ref
    hbm = got["hbm"]
    assert got["interpret"] is True and got["block"] == 64
    assert hbm["fused_bytes"] == extend_embed_bytes(spec.p, n, spec.r, 64)
    assert hbm["saved_bytes"] == hbm["stripe_roundtrip_bytes"] == 8 * n * 64
    assert got["speedup"] > 0


def test_machine_calibration():
    assert machine_calibration("cpu")["matmul512_ms"] > 0


def test_benchmark_backends_matches_jax():
    """At n = 256 both packages' rank-2 K-means lands in the same
    non-class basin on 4 of 5 data seeds (accuracy 0.76-0.80 in each;
    JAX's benchmark_backends docstring notes the basins), so the accuracy
    floor is held at n = 2,400 cut to 2,000, where both reach 1.0 on 5 of
    5 seeds; the two packages' accuracies must agree besides."""
    X, y = _data(2400)
    kw = dict(k=2, r=2, kernel="polynomial", kernel_params=KP, block=1000,
              repeats=1, max_n=2000)
    want = jax_benchmark_backends(jnp.asarray(X), y,
                                  key=jax.random.PRNGKey(0), **kw)
    got = benchmark_backends(X, y, seed=0, device="cpu", **kw)
    assert got["subsampled_from"] == want["subsampled_from"] == 2400
    assert got["n"] == want["n"] == 2000
    assert set(got["per_backend"]) == set(want["per_backend"])
    for name, row in got["per_backend"].items():
        ref = want["per_backend"][name]
        for key in ("n_ref", "fit_memory_bytes", "artifact_bytes"):
            assert row[key] == ref[key], (name, key)
    np.testing.assert_allclose(
        got["per_backend"]["exact"]["kernel_approx_error"],
        want["per_backend"]["exact"]["kernel_approx_error"], rtol=2e-3,
        atol=2e-3)
    for name in ("exact", "onepass-srht", "onepass-gaussian"):
        assert got["per_backend"][name]["accuracy"] >= 0.95, name
        assert want["per_backend"][name]["accuracy"] >= 0.95, name
        assert abs(got["per_backend"][name]["accuracy"]
                   - want["per_backend"][name]["accuracy"]) <= 0.01, name
