"""The port's paper-level claims on its own blob_ring, torch against torch.

The JAX package checks Alg. 1 against the paper's claims on blob_ring
(tests/test_onepass_system.py); JAX's random draws cannot be made in
torch, so the port draws its own blob_ring and is held to the same
thresholds at the same n = 1,000, polynomial d = 2, r = 2: one-pass
error within 5 % of the exact rank-2 optimum, accuracy > 0.95, plain
K-means < 0.9, one-pass below Nystrom at equal memory (l = 10 against
m = 12, mean of 5 draws), streaming error equal to the dense one at rtol
1e-4, the Gaussian sketch > 0.95. One cross-framework case feeds JAX's
blob_ring, as numpy, to the port. The geometry of blob_ring and
two_rings is checked against their parameters.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data import blob_ring as jax_blob_ring
from repro_torch.api import KernelKMeans
from repro_torch.core import (clustering_accuracy, exact_eig_from_gram,
                              gram_matrix, kernel_approx_error,
                              kernel_approx_error_streaming, nystrom,
                              one_pass_kernel_kmeans, polynomial_kernel)
from repro_torch.core.kmeans import kmeans
from repro_torch.data import blob_ring, two_rings

N = 1000


def _onepass(X, seed, backend="onepass-srht", block=512):
    return KernelKMeans(k=2, r=2, kernel="polynomial",
                        kernel_params={"gamma": 0.0, "degree": 2},
                        backend=backend,
                        backend_params={"oversampling": 10}, block=block,
                        device="cpu").fit(X, seed=seed)


@pytest.fixture(scope="module")
def rings():
    X, labels = blob_ring(0, n=N)
    kern = polynomial_kernel(gamma=0.0, degree=2)
    return X, labels, kern, gram_matrix(kern, X)


def test_ours_matches_exact_error(rings):
    X, _, _, K = rings
    err_exact = kernel_approx_error(K, exact_eig_from_gram(K, 2).Y)
    err_ours = kernel_approx_error(K, _onepass(X, 1, block=256).embedding_)
    # Table 1: both 0.40, ours within 5 % of the exact rank-2 optimum.
    assert err_ours <= 1.05 * err_exact + 1e-6


@pytest.mark.parametrize("backend", ["onepass-srht", "onepass-gaussian"])
def test_ours_high_clustering_accuracy(rings, backend):
    X, labels, _, _ = rings
    est = _onepass(X, 2, backend=backend)
    assert clustering_accuracy(labels, est.labels_, 2) > 0.95


def test_plain_kmeans_fails_nonlinear(rings):
    X, labels, _, _ = rings
    res = kmeans(X.T.contiguous(), 2,
                 generator=torch.Generator().manual_seed(3))
    assert clustering_accuracy(labels, res.labels, 2) < 0.9


def test_ours_beats_nystrom_at_equal_memory(rings):
    """At about equal column budget (r' = 12 against m = 12) the
    preconditioned sketch beats uniform-column Nystrom on error."""
    X, _, kern, K = rings
    ours, ny = [], []
    for s in range(5):
        ours.append(kernel_approx_error(K, _onepass(X, 10 + s).embedding_))
        res = nystrom(kern, X, 12, 2,
                      generator=torch.Generator().manual_seed(100 + s))
        ny.append(kernel_approx_error(K, res.Y))
    assert np.mean(ours) < np.mean(ny)


def test_streaming_error_matches_dense(rings):
    X, _, kern, K = rings
    Y = _onepass(X, 4).embedding_
    dense = kernel_approx_error(K, Y)
    stream = kernel_approx_error_streaming(kern, X, Y, block=128)
    np.testing.assert_allclose(stream, dense, rtol=1e-4)


def test_jax_blob_ring_through_the_port():
    """JAX's blob_ring(PRNGKey(0), n=1000), as numpy, meets the same
    accuracy and error thresholds through the port's Alg. 1."""
    X, labels = jax_blob_ring(jax.random.PRNGKey(0), n=N)
    X = torch.from_numpy(np.array(X))
    kern = polynomial_kernel(gamma=0.0, degree=2)
    K = gram_matrix(kern, X)
    with pytest.warns(DeprecationWarning):
        res = one_pass_kernel_kmeans(kern, X, 2, 2, oversampling=10,
                                     block=256, seed=1)
    err_exact = kernel_approx_error(K, exact_eig_from_gram(K, 2).Y)
    assert kernel_approx_error(K, res.Y) <= 1.05 * err_exact + 1e-6
    assert clustering_accuracy(np.asarray(labels), res.labels, 2) > 0.95


@pytest.mark.parametrize("source", [
    0, np.random.default_rng(5), torch.Generator().manual_seed(5)],
    ids=["int", "numpy", "torch"])
def test_blob_ring_geometry(source):
    X, labels = blob_ring(source, n=N, sigma=0.3, radius=2.0, rnoise=0.1)
    assert X.shape == (2, N) and X.dtype == torch.float32
    assert labels.shape == (N,) and labels.dtype == torch.int32
    assert int((labels == 0).sum()) == N // 2      # half blob, half ring
    radius = torch.linalg.norm(X[:, labels == 1], dim=0)
    assert abs(float(radius.mean()) - 2.0) <= 0.05
    assert abs(float(X[:, labels == 0].std()) - 0.3) <= 0.05
    # Permuted: the classes are not left in two blocks.
    assert 0 < int(labels[: N // 2].sum()) < N // 2


def test_two_rings_geometry():
    X, labels = two_rings(np.random.default_rng(6), n=N + 1, r_inner=1.0,
                          r_outer=2.0, noise=0.1)
    assert X.shape == (2, N + 1) and labels.dtype == torch.int32
    assert int((labels == 0).sum()) == (N + 1) // 2
    radius = torch.linalg.norm(X, dim=0)
    for cls, r in ((0, 1.0), (1, 2.0)):
        assert abs(float(radius[labels == cls].mean()) - r) <= 0.05
    assert 0 < int(labels[: N // 2].sum()) < N // 2
