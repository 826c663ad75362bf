"""One rank of a gloo world for tests/test_torch_distributed.py.

    python tests/torch_dist_worker.py RANK WORLD WORKDIR

WORKDIR holds `store` (the FileStore), `inputs.npz` and the artifacts the
test made; the rank runs every check of the world on the port's
distributed path and writes what it got to `out_<RANK>.npz`. The test
compares: no JAX runs here, and no check asserts here, so every
comparison is a test of its own in the parent process.
"""
import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api import KernelKMeans
from repro_torch.core.kernels_fn import make_kernel
from repro_torch.core.sketch import SRHT, GaussianSketch, next_pow2
from repro_torch.distributed.checkpoint import restore_checkpoint
from repro_torch.distributed.cluster import distributed_one_pass_kernel_kmeans
from repro_torch.distributed.dfwht import distributed_fwht
from repro_torch.launch.mesh import (make_debug_mesh, make_mesh, mesh_axis,
                                     open_world, run_process)
from repro_torch.serve import (ComputePolicy, MicroBatcher, ShardedExtender,
                               embed_sharded, load_model)

# The sizes of tests/test_torch_distributed.py.
FIT_KW = dict(k=2, r=2, kernel="polynomial",
              kernel_params={"gamma": 0.0, "degree": 2}, block=64,
              device="cpu")
CHUNKS = ((0, 100), (100, 164), (164, 250))
RESUME_AT = 164
FWHT_CASES = ((64, 4), (512, 3), (8, 1))


def _np(t):
    return t.detach().cpu().numpy()


def _slab(x, ax):
    rows = x.shape[0] // ax.size
    return x[ax.index * rows:(ax.index + 1) * rows]


def check_fwht(mesh, inp, res):
    ax = mesh_axis(mesh, "data")
    for n, c in FWHT_CASES:
        x = torch.from_numpy(inp[f"fwht_{n}_{c}"])
        got = distributed_fwht(_slab(x, ax).contiguous(), mesh, "data")
        res[f"fwht_{n}_{c}"] = _np(ax.all_gather_cat(got))


def check_fwht_2d(inp, res):
    """The butterfly over the data dim of a (2, 2) mesh: ranks that share
    a data coordinate hold the same slab."""
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    ax = mesh_axis(mesh, "data")
    x = torch.from_numpy(inp["fwht2d"])
    got = distributed_fwht(_slab(x, ax).contiguous(), mesh, "data")
    res["fwht2d"] = _np(ax.all_gather_cat(got))
    res["fwht2d_coord"] = np.asarray(mesh.get_coordinate())


def _sketch(inp, backend):
    if backend == "onepass-srht":
        n = int(inp["X"].shape[1])
        return SRHT(signs=torch.from_numpy(inp["srht_signs"]),
                    rows=torch.from_numpy(inp["srht_rows"]), n=n,
                    n_pad=next_pow2(n))
    return GaussianSketch(omega=torch.from_numpy(inp["omega"]))


def _model_arrays(res, key, est):
    m = est.model_
    for name in ("stream_w", "stream_row_norms2", "eigvals", "U",
                 "centroids"):
        res[f"{key}/{name}"] = _np(getattr(m, name))
    res[f"{key}/labels"] = _np(est.labels_)


def check_fit(mesh, inp, res, workdir, rank):
    X = inp["X"]
    n = X.shape[1]
    for backend in ("onepass-srht", "onepass-gaussian"):
        sk = _sketch(inp, backend)
        pol = ComputePolicy(mesh=mesh)
        one = KernelKMeans(backend=backend, policy=pol, **FIT_KW).fit(
            X, seed=7, sketch=sk)
        _model_arrays(res, f"{backend}/one", one)
        est = KernelKMeans(backend=backend, policy=pol, **FIT_KW)
        for lo, hi in CHUNKS:
            est.partial_fit(X[:, lo:hi], seed=7, capacity=n,
                            reeig=(hi == n), sketch=sk if lo == 0 else None)
        _model_arrays(res, f"{backend}/chunked", est)
        live = KernelKMeans(backend=backend, policy=pol, **FIT_KW)
        live.partial_fit(X[:, :RESUME_AT], seed=7, capacity=n, sketch=sk)
        path = live.save(os.path.join(workdir, f"art_{backend}_{rank}"))
        live.partial_fit(X[:, RESUME_AT:], seed=7)
        _model_arrays(res, f"{backend}/live", live)
        resumed = KernelKMeans.load(path, device="cpu", policy=pol)
        resumed.partial_fit(X[:, RESUME_AT:], seed=7)
        _model_arrays(res, f"{backend}/resumed", resumed)
        fused = KernelKMeans(
            backend=backend, policy=ComputePolicy(
                mesh=mesh, fit_fused=True, interpret=True),
            **FIT_KW).fit(X, seed=7, sketch=sk)
        _model_arrays(res, f"{backend}/fused", fused)


def check_extend(mesh, inp, res, workdir):
    Xq = torch.from_numpy(inp["Xq"])
    for kind in ("polynomial", "rbf"):
        model = load_model(os.path.join(workdir, f"model_{kind}"),
                           device="cpu")
        for route, extra in (("two_pass", {}),
                             ("fused", {"embed_fused": True,
                                        "interpret": True})):
            pol = ComputePolicy(mesh=mesh, **extra)
            ext = ShardedExtender(model, policy=pol)
            key = f"extend/{kind}/{route}"
            res[f"{key}/embed"] = _np(ext.embed(Xq))
            labels, d2 = ext.assign(Xq)
            res[f"{key}/labels"], res[f"{key}/d2"] = _np(labels), _np(d2)
            batcher = MicroBatcher(model, max_bucket=64, policy=pol)
            labels, d2 = batcher.assign_batch(Xq)
            res[f"{key}/batched_labels"], res[f"{key}/batched_d2"] = labels, d2
        res[f"extend/{kind}/embed_sharded"] = _np(
            embed_sharded(model, Xq, mesh))


def check_cluster(mesh, inp, res):
    ax = mesh_axis(mesh, "data")
    out = distributed_one_pass_kernel_kmeans(
        make_kernel("polynomial", gamma=0.0, degree=2),
        torch.from_numpy(inp["cluster_X"]), k=2, r=2, mesh=mesh,
        signs=torch.from_numpy(inp["cluster_signs"]),
        rows=torch.from_numpy(inp["cluster_rows"]),
        inits=torch.from_numpy(inp["cluster_inits"]), block=256)
    res["cluster/eigvals"] = _np(out.eigvals)
    res["cluster/centroids"] = _np(out.centroids)
    res["cluster/labels"] = _np(ax.all_gather_cat(out.labels))
    res["cluster/Y"] = _np(ax.all_gather_cat(out.Y, dim=1))


def check_checkpoint(inp, res, workdir, world):
    from torch.distributed.tensor import Replicate, Shard
    like = {"a": torch.zeros(inp["ckpt_a"].shape),
            "b": torch.zeros(inp["ckpt_b"].shape),
            "c": np.zeros(inp["ckpt_c"].shape, np.int32)}
    ckpt = os.path.join(workdir, "ckpt")
    meshes = {"1d": (make_debug_mesh(data=world, device="cpu"),
                     {"a": Shard(0), "b": Shard(0), "c": Replicate()})}
    if world == 4:
        meshes["2d"] = (make_mesh((2, 2), ("data", "model"), "cpu"),
                        {"a": (Shard(0), Shard(1)), "b": (Replicate(),
                                                          Shard(0)),
                         "c": (Replicate(), Replicate())})
    for name, (mesh, pspecs) in meshes.items():
        got, step = restore_checkpoint(ckpt, like, mesh=mesh, pspecs=pspecs)
        for leaf in ("a", "b", "c"):
            res[f"ckpt/{name}/{leaf}"] = _np(got[leaf])
        res[f"ckpt/{name}/step"] = np.asarray(step)
        res[f"ckpt/{name}/coord"] = np.asarray(mesh.get_coordinate())


def main():
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    with open_world("cpu", datetime.timedelta(seconds=120),
                    store=dist.FileStore(os.path.join(workdir, "store"),
                                         world), rank=rank, size=world):
        inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
        res = {}
        mesh = make_debug_mesh(data=world, device="cpu")
        check_fwht(mesh, inp, res)
        if world == 4:
            check_fwht_2d(inp, res)
        check_fit(mesh, inp, res, workdir, rank)
        check_extend(mesh, inp, res, workdir)
        check_cluster(mesh, inp, res)
        check_checkpoint(inp, res, workdir, world)
        np.savez(os.path.join(workdir, f"out_{rank}.npz"), **res)
        dist.barrier()


if __name__ == "__main__":
    run_process(main)
