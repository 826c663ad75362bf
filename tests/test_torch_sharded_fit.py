"""The sharded one-pass fit (repro_torch.distributed.fit) in a world of one
rank, against the unsharded port and the JAX package.

At world size 1 the engine's slab is the canonical update's border and
every step is the canonical arithmetic in its order, so the contract is
bit identity: fit and partial_fit under ComputePolicy(mesh=...) give the
unsharded fit's every model leaf, labels and embedding, on the canonical
route and on the fused one (fit_sketch on the slab's valid rows), for the
SRHT and the Gaussian sketch, under ragged chunks and from a resumed
artifact. Against JAX's KernelKMeans.fit on the same draws: sketch state
and eigenvalues within 2e-3, labels agreeing on >= 0.99. Multi-rank worlds
are tests/test_torch_distributed.py's.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.api import KernelKMeans as JaxKernelKMeans
from repro_torch.api import KernelKMeans
from repro_torch.core.kernels_fn import make_kernel
from repro_torch.core.metrics import clustering_accuracy
from repro_torch.core.sketch import SRHT, GaussianSketch, next_pow2
from repro_torch.data import gaussian_blobs
from repro_torch.distributed.fit import ShardedFitEngine
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.serve import ComputePolicy
from repro_torch.stream.accumulate import SketchAccumulator

N, P, BLOCK = 250, 2, 64
TOL = 2e-3
KW = dict(k=2, r=2, kernel="polynomial",
          kernel_params={"gamma": 0.0, "degree": 2}, block=BLOCK)
BACKENDS = ["onepass-srht", "onepass-gaussian"]
CHUNKS = ((0, 100), (100, 164), (164, N))
FUSED = {"fit_fused": True, "interpret": True}


@pytest.fixture(scope="module")
def mesh():
    made = not dist.is_initialized()
    m = make_debug_mesh(device="cpu")
    yield m
    if made:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def X():
    X, _ = gaussian_blobs(np.random.default_rng(0), N, P, 2, spread=0.3,
                          center_scale=2.0)
    return X.numpy()


def _est(backend, **policy):
    pol = ComputePolicy(**policy) if policy else None
    return KernelKMeans(backend=backend, policy=pol, device="cpu", **KW)


def _assert_fits_equal(a, b):
    """Every FittedModel leaf, the labels and the embedding bit for bit."""
    assert a.model_.spec == b.model_.spec
    for name in a.model_._fields[1:]:
        va, vb = getattr(a.model_, name), getattr(b.model_, name)
        if va is None or vb is None:
            assert va is None and vb is None, name
        else:
            assert torch.equal(va, vb), name
    assert torch.equal(a.labels_, b.labels_)
    if a.embedding_ is not None and b.embedding_ is not None:
        assert torch.equal(a.embedding_, b.embedding_)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("route", ["canonical", "fused"])
def test_sharded_fit_bit_identical(mesh, X, backend, route):
    extra = FUSED if route == "fused" else {}
    ref = _est(backend, **extra).fit(X, seed=7)
    sh = _est(backend, mesh=mesh, **extra).fit(X, seed=7)
    _assert_fits_equal(ref, sh)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("route", ["canonical", "fused"])
def test_sharded_partial_fit_ragged_chunks(mesh, X, backend, route):
    """Chunk edges inside blocks: the engine stages partial blocks as the
    canonical accumulator does."""
    extra = FUSED if route == "fused" else {}
    ref = _est(backend, **extra).fit(X, seed=7)
    est = _est(backend, mesh=mesh, **extra)
    for lo, hi in CHUNKS:
        est.partial_fit(X[:, lo:hi], seed=7, capacity=N, reeig=(hi == N))
    _assert_fits_equal(ref, est)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_resume_from_artifact(tmp_path, mesh, X, backend):
    """Saved mid-stream, resumed under the mesh: the single-host resume,
    and the live sharded stream, bit for bit."""
    path = str(tmp_path / "art")
    live = _est(backend, mesh=mesh)
    live.partial_fit(X[:, :164], seed=7, capacity=N)
    live.save(path)
    live.partial_fit(X[:, 164:], seed=7)
    single = KernelKMeans.load(path, device="cpu")
    single.partial_fit(X[:, 164:], seed=7)
    sharded = KernelKMeans.load(path, device="cpu",
                                policy=ComputePolicy(mesh=mesh))
    sharded.partial_fit(X[:, 164:], seed=7)
    _assert_fits_equal(single, sharded)
    _assert_fits_equal(live, sharded)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_fit_matches_jax(mesh, X, backend):
    """JAX's draws fed to the sharded port fit."""
    jest = JaxKernelKMeans(backend=backend, **KW).fit(X, key=7)
    jm = jest.model_
    if backend == "onepass-srht":
        sketch = SRHT(signs=torch.from_numpy(np.array(jm.sketch_signs)),
                      rows=torch.from_numpy(np.array(jm.sketch_rows,
                                                     np.int64)),
                      n=N, n_pad=next_pow2(N))
    else:
        sketch = GaussianSketch(omega=torch.from_numpy(
            np.array(jm.sketch_omega)))
    sh = _est(backend, mesh=mesh).fit(X, seed=7, sketch=sketch)
    for name in ("stream_w", "stream_row_norms2", "eigvals"):
        np.testing.assert_allclose(getattr(sh.model_, name).numpy(),
                                   np.asarray(getattr(jm, name)), rtol=TOL,
                                   atol=TOL)
    assert clustering_accuracy(np.asarray(jest.labels_), sh.labels_.numpy(),
                               2) >= 0.99


def test_policy_swap_mid_stream_raises(mesh, X):
    est = _est("onepass-srht")
    est.partial_fit(X[:, :BLOCK], seed=0, capacity=N, reeig=False)
    est.policy = ComputePolicy(mesh=mesh)
    with pytest.raises(ValueError, match="ComputePolicy changed"):
        est.partial_fit(X[:, BLOCK:2 * BLOCK], reeig=False)


def test_policy_mesh_fields(mesh):
    pol = ComputePolicy(mesh=mesh)
    assert pol.sharded and pol.shards == 1
    assert not ComputePolicy().sharded and ComputePolicy().shards == 1
    assert pol.replace(fit_fused=True).mesh is mesh
    assert pol == ComputePolicy(mesh=mesh)
    with pytest.raises(ValueError, match="no axis 'pod'"):
        ComputePolicy(mesh=mesh, mesh_axis="pod")


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_slabs_and_gather(mesh, X, backend):
    """Under a mesh the accumulator holds this rank's padded slabs (L rows:
    n_pad for the SRHT, the capacity for a Gaussian sketch at one rank);
    state_arrays gathers the logical (capacity, r') rows."""
    acc = SketchAccumulator(make_kernel("polynomial", gamma=0.0, degree=2),
                            N, 2, generator=torch.Generator().manual_seed(0),
                            block=BLOCK, sketch_type=backend.split("-")[1],
                            policy=ComputePolicy(mesh=mesh))
    acc.add(torch.from_numpy(X))
    L = next_pow2(N) if backend == "onepass-srht" else N
    assert acc.W.shape == (L, 12) and acc.row_norms2.shape == (L,)
    st = acc.state_arrays()
    assert st["stream_w"].shape == (N, 12)
    assert torch.equal(st["stream_w"], acc.W[:N])
    assert torch.equal(acc._engine.pad_rows(st["stream_w"]), acc.W)
    assert acc._engine.N == L and acc._engine.L == L


def test_engine_requires_statics_for_the_fused_route(mesh):
    sketch = GaussianSketch(omega=torch.zeros((8, 3)))
    with pytest.raises(ValueError, match="kernel_statics"):
        ShardedFitEngine(mesh, "data", sketch,
                         make_kernel("polynomial", gamma=0.0, degree=2),
                         fit_fused=True)
    with pytest.raises(ValueError, match="no axis 'rows'"):
        ShardedFitEngine(mesh, "rows", sketch,
                         make_kernel("polynomial", gamma=0.0, degree=2))
