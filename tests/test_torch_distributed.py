"""The port's distributed package against the JAX package and across gloo
worlds.

In this process (a world of one rank, gloo): the mesh helpers and their
refusals, distributed_fwht against JAX's fwht, Alg. 1 on a mesh against
JAX's distributed_one_pass_kernel_kmeans on the same draws, the
ShardedExtender against JAX's Extender and the port's, checkpoints (a
JAX-written one restored, onto a mesh too; CheckpointManager), the fault
tolerance of tests/test_fault.py, benchmark_fit_scaling and the launcher.

Spawned worlds of 2 and 4 ranks (tests/torch_dist_worker.py, one world per
size running every check, FileStores in tmp_path, a join deadline): the
butterfly (and on a 2 x 2 mesh), the sharded fit (srht and Gaussian, the
canonical and the fused route), the ShardedExtender and MicroBatcher on a
mesh, Alg. 1 on a mesh and restore onto a mesh. The JAX references and
the single-host ones are computed here, never in a rank.

Tolerances: 2e-4 for the FWHT (the fwht registry's), 2e-3 for sketch
state, eigenvalues and embeddings (the registry default and the JAX
multi-device contract of tests/fit_dist_checks.py); labels agree on
>= 0.99 up to a permutation. On a fixed mesh chunked == one-shot and
resumed == live hold bit for bit, and every rank holds the same bits of
each replicated result.
"""
import contextlib
import dataclasses
import io
import pathlib
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.api import KernelKMeans as JaxKernelKMeans
from repro.core.kernels_fn import polynomial_kernel as jax_polynomial
from repro.core.sketch import SRHT as JaxSRHT
from repro.core.sketch import fwht as jax_fwht
from repro.core.sketch import sketch_stream as jax_sketch_stream
from repro.distributed import cluster as jax_cluster
from repro.distributed.checkpoint import save_checkpoint as jax_save_ckpt
from repro.serve.extend import Extender as JaxExtender
from repro_torch.api import KernelKMeans
from repro_torch.core.kernels_fn import make_kernel
from repro_torch.core.metrics import clustering_accuracy
from repro_torch.core.sketch import next_pow2
from repro_torch.data import blob_ring, gaussian_blobs
from repro_torch.distributed.checkpoint import (CheckpointManager,
                                                local_chunk,
                                                restore_checkpoint,
                                                save_checkpoint)
from repro_torch.distributed.cluster import (
    cholesky_qr, distributed_one_pass_kernel_kmeans)
from repro_torch.distributed.dfwht import distributed_fwht
from repro_torch.distributed.fault import (HeartbeatMonitor, HostFailure,
                                           StragglerTracker, TrainSupervisor,
                                           elastic_mesh)
from repro_torch.kernels.fwht.ref import fwht_ref
from repro_torch.kernels.registry import near_tie_compare
from repro_torch.launch import cluster as launcher
from repro_torch.launch.mesh import (dp_axes, make_debug_mesh,
                                     make_production_mesh, mesh_axis,
                                     mesh_axis_sizes, tp_axis)
from repro_torch.serve import (ComputePolicy, Extender, ShardedExtender,
                               benchmark_fit_scaling, embed_sharded,
                               save_model)
from repro_torch.serve.artifact import from_reference

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tests"))
import torch_dist_worker as worker  # noqa: E402
import torch_worlds  # noqa: E402

N, NQ = 250, 101
TOL = 2e-3
FWHT_TOL = 2e-4
WORLDS = (2, 4)
BACKENDS = ("onepass-srht", "onepass-gaussian")
# Seconds a spawned world may take, start to join (it takes ~20 s).
WORLD_DEADLINE = 300
CLUSTER_N = 1024          # Alg. 1 on a mesh takes a pre-padded pow-2 n
JAX_KW = dict(k=2, r=2, kernel="polynomial",
              kernel_params={"gamma": 0.0, "degree": 2}, block=64)
PORT_KW = worker.FIT_KW


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _agree(a, b, k=2):
    return clustering_accuracy(np.asarray(a), np.asarray(b), k)


@pytest.fixture(scope="module")
def mesh1():
    """A world of one rank in this process, torn down after the module."""
    made = not dist.is_initialized()
    mesh = make_debug_mesh(device="cpu")
    yield mesh
    if made:
        dist.destroy_process_group()


# -- the inputs, the references, the spawned worlds -------------------------

def _jax_alg1(key, X, k, r, mesh, oversampling=10, block=256):
    """JAX's distributed_one_pass_kernel_kmeans step by step on `mesh`,
    with its draws. Its sketch step, distributed_sketch, stops under this
    JAX's explicit sharding (dynamic_update_slice of a sharded W), so W is
    JAX's single-host sketch_stream on the same SRHT; every later step is
    the JAX package's mesh function."""
    n = X.shape[1]
    k1, k2 = jax.random.split(key)
    signs = jax.random.rademacher(k1, (n,), dtype=jnp.float32)
    rows = jax.random.choice(k2, n, (r + oversampling,), replace=False)
    kern = jax_polynomial(gamma=0.0, degree=2)
    W = jax_sketch_stream(kern, X, JaxSRHT(signs=signs, rows=rows, n=n,
                                           n_pad=n), block=block)
    Q = jax_cluster.cholesky_qr(W, mesh)
    QtO = jax_cluster.distributed_omega_t(Q, mesh, signs, rows).T
    Bt, *_ = jnp.linalg.lstsq(QtO.T, (Q.T @ W).T)
    evals, V = jnp.linalg.eigh(0.5 * (Bt + Bt.T))
    evals, V = jnp.maximum(evals[::-1], 0.0), V[:, ::-1]
    Y = (jnp.sqrt(evals[:r])[:, None] * V[:, :r].T) @ Q.T
    labels, C, _ = jax_cluster.distributed_kmeans(Y, k, key, mesh)
    return types.SimpleNamespace(labels=labels, Y=Y, centroids=C,
                                 eigvals=evals[:r])


def _jax_cluster_draws(key, n, r_prime, k, restarts=10):
    """The signs, sampled rows and restart columns JAX's
    distributed_one_pass_kernel_kmeans(key, ...) draws."""
    k1, k2 = jax.random.split(key)
    signs = jax.random.rademacher(k1, (next_pow2(n),), dtype=jnp.float32)
    rows = jax.random.choice(k2, next_pow2(n), (r_prime,), replace=False)
    inits = [jax.random.choice(jax.random.fold_in(key, s), n, (k,),
                               replace=False) for s in range(restarts)]
    return (np.asarray(signs), np.asarray(rows, np.int64),
            np.stack([np.asarray(i, np.int64) for i in inits]))


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """Data, draws and every reference, made here: the JAX fits (their
    sketches are the ranks' draws), the single-host port fits, the models
    the ranks serve, a JAX-written checkpoint and JAX's Alg. 1 on a mesh
    of one device."""
    work = tmp_path_factory.mktemp("dist")
    X, _ = gaussian_blobs(np.random.default_rng(0), N, 2, 2, spread=0.3,
                          center_scale=2.0)
    X = X.numpy()
    Xq = (np.random.default_rng(2).standard_normal((2, NQ)) * 1.5
          ).astype(np.float32)
    inp = {"X": X, "Xq": Xq}
    rng = np.random.default_rng(5)
    for n, c in worker.FWHT_CASES:
        inp[f"fwht_{n}_{c}"] = rng.standard_normal((n, c)).astype(np.float32)
    inp["fwht2d"] = rng.standard_normal((128, 2)).astype(np.float32)
    out = {"work": work, "inp": inp, "jax": {}, "single": {}, "fused": {}}
    for backend in BACKENDS:
        jest = JaxKernelKMeans(backend=backend, **JAX_KW).fit(X, key=7)
        out["jax"][backend] = jest
        if backend == "onepass-srht":
            inp["srht_signs"] = np.asarray(jest.model_.sketch_signs)
            inp["srht_rows"] = np.asarray(jest.model_.sketch_rows, np.int64)
        else:
            inp["omega"] = np.asarray(jest.model_.sketch_omega)
        sk = worker._sketch(inp, backend)
        out["single"][backend] = KernelKMeans(backend=backend, **PORT_KW).fit(
            X, seed=7, sketch=sk)
        out["fused"][backend] = KernelKMeans(
            backend=backend, policy=ComputePolicy(fit_fused=True,
                                                  interpret=True),
            **PORT_KW).fit(X, seed=7, sketch=sk)
    # Models to serve: fitted by JAX on blob_ring, carried across.
    Xr, _ = blob_ring(np.random.default_rng(0), n=N)
    names = ("X_train", "U", "eigvals", "centroids", "sketch_signs",
             "sketch_rows", "stream_w", "stream_row_norms2", "stream_counts")
    out["models"], out["jax_models"] = {}, {}
    for kind, params, r in (("polynomial", {"gamma": 0.0, "degree": 2}, 2),
                            ("rbf", {"gamma": 1.0}, 4)):
        jm = JaxKernelKMeans(k=2, r=r, kernel=kind, kernel_params=params,
                             block=64).fit(Xr.numpy(), key=1).model_
        model = from_reference(
            {nm: None if getattr(jm, nm) is None
             else np.asarray(getattr(jm, nm)) for nm in names},
            dataclasses.asdict(jm.spec), device="cpu")
        save_model(model, str(work / f"model_{kind}"))
        out["models"][kind] = model
        out["jax_models"][kind] = jm
    # Alg. 1 on a mesh: JAX's draws and its run on a mesh of one device.
    Xc, yc = blob_ring(np.random.default_rng(1), n=CLUSTER_N)
    key = jax.random.PRNGKey(1)
    signs, rows, inits = _jax_cluster_draws(key, CLUSTER_N, 12, 2)
    inp.update(cluster_X=Xc.numpy(), cluster_signs=signs, cluster_rows=rows,
               cluster_inits=inits)
    out["jax_cluster"] = _jax_alg1(key, jnp.asarray(Xc.numpy()), 2, 2,
                                   jax.make_mesh((1,), ("data",)))
    out["cluster_truth"] = yc.numpy()
    # A checkpoint written by the JAX package.
    inp.update(ckpt_a=rng.standard_normal((8, 6)).astype(np.float32),
               ckpt_b=rng.standard_normal((5,)).astype(np.float32),
               ckpt_c=np.arange(4, dtype=np.int32).reshape(2, 2))
    jax_save_ckpt(str(work / "ckpt"), 3,
                  {"a": jnp.asarray(inp["ckpt_a"]),
                   "b": jnp.asarray(inp["ckpt_b"]),
                   "c": jnp.asarray(inp["ckpt_c"])})
    np.savez(work / "inputs.npz", **inp)
    return out


def _spawn(work: pathlib.Path, world: int):
    wdir = work / f"world{world}"
    torch_worlds.link(work, wdir, [item.name for item in work.iterdir()
                                   if not item.name.startswith("world")])
    return torch_worlds.start(wdir, "torch_dist_worker.py",
                              [[r, world, wdir] for r in range(world)],
                              f"of {world}")


def _join(world, deadline):
    torch_worlds.join(world, deadline)
    return [dict(np.load(world.wdir / f"out_{r}.npz"))
            for r in range(len(world.procs))]


@pytest.fixture(scope="module")
def worlds(refs):
    """Both worlds at once; each rank's results by world size."""
    deadline = time.monotonic() + WORLD_DEADLINE
    started = {w: _spawn(refs["work"], w) for w in WORLDS}
    return {w: _join(started[w], deadline) for w in WORLDS}


# -- the mesh helpers ---------------------------------------------------------

def test_debug_mesh_axes(mesh1):
    assert mesh_axis_sizes(mesh1) == {"data": 1, "model": 1}
    assert dp_axes(mesh1) == ("data",)
    assert tp_axis(mesh1) == "model"
    ax = mesh_axis(mesh1, "data")
    assert (ax.size, ax.index, ax.device_type) == (1, 0, "cpu")
    with pytest.raises(ValueError, match="no axis 'pod'"):
        mesh_axis(mesh1, "pod")


def test_mesh_sizes_are_checked_against_the_world(mesh1):
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_debug_mesh(data=2, device="cpu")


def test_no_silent_downgrade(mesh1, monkeypatch):
    """A CUDA mesh over a gloo group, and a tensor on another device type
    than its mesh, raise; with no card the default device raises."""
    fake = types.SimpleNamespace(
        device_type="cuda", mesh_dim_names=("data",),
        get_group=lambda axis: mesh1.get_group("data"))
    with pytest.raises(ValueError, match="needs the nccl backend"):
        mesh_axis(fake, "data")
    with pytest.raises(ValueError, match="a tensor on meta"):
        mesh_axis(mesh1).check("test", torch.zeros(2, device="meta"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_debug_mesh()


# -- distributed FWHT ---------------------------------------------------------

@pytest.mark.parametrize("n,c", worker.FWHT_CASES)
def test_distributed_fwht_matches_jax(mesh1, n, c):
    x = np.random.default_rng(n).standard_normal((n, c)).astype(np.float32)
    got = distributed_fwht(torch.from_numpy(x), mesh1)
    _close(got, jax_fwht(jnp.asarray(x)), FWHT_TOL)
    assert torch.equal(got, fwht_ref(torch.from_numpy(x)))
    unnorm = distributed_fwht(torch.from_numpy(x), mesh1, normalize=False)
    assert torch.equal(unnorm, fwht_ref(torch.from_numpy(x), False))


def test_distributed_fwht_refuses_non_pow2(mesh1):
    with pytest.raises(ValueError, match="powers of two"):
        distributed_fwht(torch.zeros((12, 2)), mesh1)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("n,c", worker.FWHT_CASES)
def test_distributed_fwht_across_ranks(refs, worlds, world, n, c):
    """Across ranks the butterfly runs the plain FWHT's stages in its
    order: the bits of fwht_ref, within 2e-4 of JAX's fwht."""
    x = refs["inp"][f"fwht_{n}_{c}"]
    for res in worlds[world]:
        assert np.array_equal(res[f"fwht_{n}_{c}"],
                              fwht_ref(torch.from_numpy(x)).numpy())
        _close(res[f"fwht_{n}_{c}"], jax_fwht(jnp.asarray(x)), FWHT_TOL)


def test_distributed_fwht_on_a_2d_mesh(refs, worlds):
    x = refs["inp"]["fwht2d"]
    coords = set()
    for res in worlds[4]:
        _close(res["fwht2d"], jax_fwht(jnp.asarray(x)), FWHT_TOL)
        assert np.array_equal(res["fwht2d"],
                              fwht_ref(torch.from_numpy(x)).numpy())
        coords.add(tuple(res["fwht2d_coord"]))
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}


# -- the sharded fit across ranks ---------------------------------------------

def _replicated(world_res, key):
    first = world_res[0][key]
    for res in world_res[1:]:
        assert np.array_equal(res[key], first), key
    return first


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_fit_close_to_single_host(refs, worlds, world, backend):
    single = refs["single"][backend]
    res = worlds[world]
    for name in ("stream_w", "stream_row_norms2", "eigvals"):
        _close(_replicated(res, f"{backend}/one/{name}"),
               getattr(single.model_, name).numpy())
    labels = _replicated(res, f"{backend}/one/labels")
    assert _agree(labels, single.labels_) >= 0.99


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_fit_close_to_jax(refs, worlds, world, backend):
    jest = refs["jax"][backend]
    res = worlds[world]
    _close(_replicated(res, f"{backend}/one/eigvals"), jest.eigvals_)
    _close(_replicated(res, f"{backend}/one/stream_w"),
           jest.model_.stream_w)
    assert _agree(_replicated(res, f"{backend}/one/labels"),
                  jest.labels_) >= 0.99


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("pair", [("chunked", "one"), ("resumed", "live")])
def test_sharded_fit_bitwise_on_a_fixed_mesh(worlds, world, backend, pair):
    """Ragged partial_fit == the one-shot sharded fit, and a stream
    resumed from its artifact == the live one, bit for bit."""
    a, b = pair
    for res in worlds[world]:
        for name in ("stream_w", "stream_row_norms2", "eigvals", "U",
                     "centroids", "labels"):
            assert np.array_equal(res[f"{backend}/{a}/{name}"],
                                  res[f"{backend}/{b}/{name}"]), name


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_fused_fit_close_to_unsharded_fused(refs, worlds, world,
                                                    backend):
    fused = refs["fused"][backend]
    res = worlds[world]
    _close(_replicated(res, f"{backend}/fused/stream_w"),
           fused.model_.stream_w)
    _close(_replicated(res, f"{backend}/fused/stream_row_norms2"),
           fused.model_.stream_row_norms2)
    _close(_replicated(res, f"{backend}/fused/eigvals"), fused.eigvals_)
    assert _agree(_replicated(res, f"{backend}/fused/labels"),
                  fused.labels_) >= 0.99


# -- sharded serving ----------------------------------------------------------

def _jax_embed(refs, kind):
    return np.asarray(JaxExtender(refs["jax_models"][kind]).embed(
        jnp.asarray(refs["inp"]["Xq"])))


@pytest.mark.parametrize("kind", ["polynomial", "rbf"])
@pytest.mark.parametrize("route", ["two_pass", "fused"])
def test_sharded_extender_world1_equals_extender(refs, mesh1, kind, route):
    """At world size 1 the slab is the reference set: the bits of
    Extender on the same policy; within 2e-3 of JAX's Extender."""
    model, Xq = refs["models"][kind], refs["inp"]["Xq"]
    extra = {} if route == "two_pass" else {"embed_fused": True,
                                            "interpret": True}
    ext = ShardedExtender(model, policy=ComputePolicy(mesh=mesh1, **extra))
    want = Extender(model, policy=ComputePolicy(**extra))
    got = ext.embed(Xq)
    assert torch.equal(got, want.embed(Xq))
    _close(got, _jax_embed(refs, kind))
    labels, d2 = ext.assign(Xq, fused=False)
    want_l, want_d2 = want.assign(Xq, fused=False)
    assert torch.equal(labels, want_l) and torch.equal(d2, want_d2)
    if route == "two_pass":          # the default policy on the CPU
        assert torch.equal(embed_sharded(model, Xq, mesh1), got)


def test_sharded_extender_needs_a_mesh(refs):
    with pytest.raises(ValueError, match="needs a mesh"):
        ShardedExtender(refs["models"]["polynomial"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["polynomial", "rbf"])
@pytest.mark.parametrize("route", ["two_pass", "fused"])
def test_sharded_extender_across_ranks(refs, worlds, world, kind, route):
    """Slabs padded to a multiple of the ranks (250 over 4: 63 each, two
    zero columns; rbf, where kappa(0, x) != 0, included): the embedding
    within 2e-3 of the port's Extender and JAX's, the labels the
    single-host ones, MicroBatcher on the mesh == the unbatched sharded
    assign."""
    model, Xq = refs["models"][kind], refs["inp"]["Xq"]
    Y = Extender(model).embed(Xq)
    want = Extender(model).assign(Xq)
    dists = ((Y.T.double()[:, None, :] - model.centroids.double()[None])
             ** 2).sum(-1).numpy()
    key = f"extend/{kind}/{route}"
    res = worlds[world]
    emb = _replicated(res, f"{key}/embed")
    _close(emb, Y)
    _close(emb, _jax_embed(refs, kind))
    got = (_replicated(res, f"{key}/labels"), _replicated(res, f"{key}/d2"))
    near_tie_compare(got, want, TOL, TOL, dists)
    near_tie_compare((_replicated(res, f"{key}/batched_labels"),
                      _replicated(res, f"{key}/batched_d2")), got, TOL, TOL,
                     dists)
    _close(_replicated(res, f"extend/{kind}/embed_sharded"), Y)


# -- Alg. 1 on a mesh ---------------------------------------------------------

def _check_cluster(refs, eigvals, labels, Y):
    jres = refs["jax_cluster"]
    _close(eigvals, jres.eigvals)
    # Same draws, same restart columns: the same clusters, label for label
    # (an eigenvector's sign flips Y, not the partition).
    mism = np.asarray(labels) != np.asarray(jres.labels)
    assert mism.mean() < 0.01, f"labels differ on {mism.mean():.2%}"
    _close(np.abs(np.asarray(Y)), np.abs(np.asarray(jres.Y)))
    assert _agree(refs["cluster_truth"], labels) > 0.95


def test_distributed_kmeans_world1_matches_jax(refs, mesh1):
    inp = refs["inp"]
    out = distributed_one_pass_kernel_kmeans(
        make_kernel("polynomial", gamma=0.0, degree=2),
        torch.from_numpy(inp["cluster_X"]), k=2, r=2, mesh=mesh1,
        signs=torch.from_numpy(inp["cluster_signs"]),
        rows=torch.from_numpy(inp["cluster_rows"]),
        inits=torch.from_numpy(inp["cluster_inits"]), block=256)
    _check_cluster(refs, out.eigvals, out.labels, out.Y)


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_kmeans_across_ranks(refs, worlds, world):
    res = worlds[world]
    _check_cluster(refs, _replicated(res, "cluster/eigvals"),
                   _replicated(res, "cluster/labels"),
                   _replicated(res, "cluster/Y"))
    _replicated(res, "cluster/centroids")


def test_cholesky_qr_keeps_the_positive_directions(mesh1):
    """A rank-deficient W keeps only its positive-eigenvalue columns, and
    the basis is orthonormal."""
    rng = np.random.default_rng(3)
    W = torch.from_numpy((rng.standard_normal((64, 3))
                          @ rng.standard_normal((3, 6))).astype(np.float32))
    Q = cholesky_qr(W, mesh1)
    assert Q.shape == (64, 3)
    _close(Q.T @ Q, torch.eye(3), 1e-3)


# -- checkpoints --------------------------------------------------------------

def _like(inp):
    return {"a": torch.zeros(inp["ckpt_a"].shape),
            "b": torch.zeros(inp["ckpt_b"].shape),
            "c": np.zeros(inp["ckpt_c"].shape, np.int32)}


def test_restore_a_jax_checkpoint(refs, mesh1):
    from torch.distributed.tensor import Replicate, Shard
    inp = refs["inp"]
    got, step = restore_checkpoint(str(refs["work"] / "ckpt"), _like(inp))
    assert step == 3
    assert torch.equal(got["a"], torch.from_numpy(inp["ckpt_a"]))
    assert got["c"].dtype == np.int32
    np.testing.assert_array_equal(got["c"], inp["ckpt_c"])
    on_mesh, _ = restore_checkpoint(
        str(refs["work"] / "ckpt"), _like(inp), mesh=mesh1,
        pspecs={"a": Shard(0), "b": Shard(0), "c": Replicate()})
    assert torch.equal(on_mesh["b"], torch.from_numpy(inp["ckpt_b"]))
    assert on_mesh["c"].dtype == torch.int32
    with pytest.raises(ValueError, match="pspecs has 2 leaves"):
        restore_checkpoint(str(refs["work"] / "ckpt"), _like(inp),
                           mesh=mesh1, pspecs={"a": Shard(0), "b": Shard(0)})


@pytest.mark.parametrize("world,mesh", [(2, "1d"), (4, "1d"), (4, "2d")])
def test_restore_onto_a_mesh_across_ranks(refs, worlds, world, mesh):
    """Each rank gets its chunk, split as Shard(dim) splits it (b of 5
    rows over 4 ranks: 2, 2, 1 and an empty chunk)."""
    from torch.distributed.tensor import Replicate, Shard
    inp = refs["inp"]
    specs = ({"a": Shard(0), "b": Shard(0), "c": Replicate()}
             if mesh == "1d" else
             {"a": (Shard(0), Shard(1)), "b": (Replicate(), Shard(0)),
              "c": (Replicate(), Replicate())})
    shape = (world,) if mesh == "1d" else (2, 2)
    for res in worlds[world]:
        coord = [int(c) for c in res[f"ckpt/{mesh}/coord"]]
        fake = types.SimpleNamespace(get_coordinate=lambda: coord,
                                     size=lambda i: shape[i])
        for leaf in ("a", "b", "c"):
            spec = specs[leaf]
            spec = spec if isinstance(spec, tuple) else (spec,)
            want = local_chunk(torch.from_numpy(inp[f"ckpt_{leaf}"]), fake,
                               spec)
            assert np.array_equal(res[f"ckpt/{mesh}/{leaf}"], want.numpy())
        assert int(res[f"ckpt/{mesh}/step"]) == 3
    sizes = [res[f"ckpt/{mesh}/b"].shape[0] for res in worlds[world]]
    if (world, mesh) == (4, "1d"):
        assert sizes == [2, 2, 1, 0]


def test_checkpoint_manager_round_trip(tmp_path, mesh1):
    from torch.distributed.tensor import Shard
    mgr = CheckpointManager(str(tmp_path), save_every=2, keep=2,
                            async_saves=False)
    state = {"w": torch.arange(12, dtype=torch.float32).reshape(6, 2)}
    for step in range(1, 8):
        path = mgr.maybe_save(step, {"w": state["w"] + step})
        assert (path is None) == bool(step % 2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_4", "step_6"]
    got, step = mgr.restore_latest({"w": torch.zeros(6, 2)}, mesh=mesh1,
                                   pspecs={"w": Shard(0)})
    assert step == 6 and torch.equal(got["w"], state["w"] + 6)


def test_async_checkpoint_then_restore(tmp_path):
    from repro_torch.distributed.checkpoint import wait_for_async_saves
    mgr = CheckpointManager(str(tmp_path), save_every=1, keep=3)
    mgr.maybe_save(1, {"x": torch.ones(3)})
    wait_for_async_saves()
    got, step = mgr.restore_latest({"x": torch.zeros(3)})
    assert step == 1 and torch.equal(got["x"], torch.ones(3))
    save_checkpoint(str(tmp_path), 9, {"x": torch.full((3,), 9.0)})
    assert mgr.restore_latest({"x": torch.zeros(3)})[1] == 9


# -- fault tolerance (tests/test_fault.py on the port) ------------------------

def test_heartbeat_detection():
    clock = [0.0]
    mon = HeartbeatMonitor(["h0", "h1", "h2"], timeout_s=10,
                           clock=lambda: clock[0])
    clock[0] = 5.0
    mon.beat("h0")
    mon.beat("h1")
    clock[0] = 12.0
    assert mon.dead_hosts() == ["h2"]
    assert set(mon.healthy_hosts()) == {"h0", "h1"}


def test_straggler_tracker():
    tr = StragglerTracker(factor=2.0)
    for _ in range(10):
        for h in ("h0", "h1", "h2", "h3"):
            tr.record(h, 1.0)
        tr.record("slow", 5.0)
    assert tr.stragglers() == ["slow"]
    assert tr.action("slow") == "skip-last-microbatch"
    assert tr.action("h0") == "none"


def test_elastic_mesh_shrinks_data_axis():
    assert elastic_mesh(64, 8, 16) == ((32, 16), ("data", "model"))
    assert elastic_mesh(54, 8, 16) == ((16, 16), ("data", "model"))
    with pytest.raises(RuntimeError):
        elastic_mesh(1, 8, 16)


def test_supervisor_restart_from_checkpoint(tmp_path, mesh1):
    """A failure mid-run: the supervisor restores the latest checkpoint
    (onto the mesh) and finishes the steps, the state uncorrupted."""
    from torch.distributed.tensor import Replicate
    mgr = CheckpointManager(str(tmp_path), save_every=1, keep=5,
                            async_saves=False)
    failures = {"armed": True}

    def step_fn(state, step):
        if step == 5 and failures["armed"]:
            failures["armed"] = False
            raise HostFailure("preempted", healthy_hosts=30)
        return {"x": state["x"] + 1.0}

    sup = TrainSupervisor(mgr, lambda: {"x": torch.zeros(())},
                          max_restarts=3)
    final, report = sup.run({"x": torch.zeros(())}, step_fn, n_steps=8,
                            mesh=mesh1, pspecs={"x": Replicate()})
    assert report.restarts == 1
    assert report.completed_steps == 8
    assert float(final["x"]) == 8.0
    assert report.remesh_events[0][1] == (8, 16)


def test_supervisor_budget_exhausted(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_every=1, keep=2,
                            async_saves=False)

    def step_fn(state, step):
        raise HostFailure("flapping")

    sup = TrainSupervisor(mgr, lambda: {"x": torch.zeros(())},
                          max_restarts=2)
    mgr.maybe_save(1, {"x": torch.zeros(())})
    with pytest.raises(RuntimeError):
        sup.run({"x": torch.zeros(())}, step_fn, n_steps=3)


# -- the bench and the launcher ---------------------------------------------

def test_benchmark_fit_scaling(refs, mesh1):
    bench = benchmark_fit_scaling(refs["models"]["polynomial"],
                                  ns=(128, 256),
                                  repeats=1,
                                  policy=ComputePolicy(mesh=mesh1))
    assert bench["shards"] == 1 and bench["device"] == "cpu"
    assert [row["n"] for row in bench["rows"]] == [128, 256]
    for row in bench["rows"]:
        assert row["sharded_cols_per_sec"] > 0 and row["single_cols_per_sec"]
        assert row["bytes"]["fwht_slab"] == 8 * next_pow2(row["n"]) * 64
        assert row["bytes"]["fit_sketch"] > 0 and row["bytes"]["srht_t"] > 0


@pytest.mark.parametrize("distributed", [False, True])
def test_launcher_prints_the_jax_lines(mesh1, distributed):
    args = ["--device", "cpu", "--dataset", "rings"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert launcher.main(args + (["--distributed"] if distributed
                                     else [])) == 0
    lines = out.getvalue().splitlines()
    assert lines[0] == (f"n=4000 k=2 r=2 l=10 kernel=polynomial "
                        f"distributed={distributed}")
    fields = dict(line.split(None, 1) if not line.startswith("sketch")
                  else ("sketch", line) for line in lines[1:])
    assert float(fields["accuracy"]) > 0.9
    assert 0 <= float(fields["approx"].split()[-1]) < 1
