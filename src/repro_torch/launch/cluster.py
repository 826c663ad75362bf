"""Launcher for the paper's pipeline: one-pass randomized kernel K-means.

One process by default; --distributed runs Alg. 1 on a mesh over every
rank of the world (distributed/cluster.py). Under torchrun each rank is
one process on one card; without a launcher the world is this process.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.cluster --n 4000 --k 2 --r 2
  PYTHONPATH=src python -m repro_torch.launch.cluster --dataset seg --k 7 \
      --l 5
  PYTHONPATH=src torchrun --standalone --nproc_per_node=1 \
      -m repro_torch.launch.cluster --distributed --dataset seg

The card by default (--device cpu for a gloo world on the CPU). Prints
the JAX launcher's lines, from rank 0. Unlike the JAX launcher, whose
--k defaults to 2 whatever the data set, --k defaults to the data set's
class count (seg: 7).
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch


def alg1_draws(seed: int, n_pad: int, r_prime: int, k: int,
               restarts: int, device) -> tuple:
    """The SRHT's signs and sampled rows and each restart's k initial
    columns, from one seed on the host, so every rank draws the same."""
    gen = torch.Generator().manual_seed(seed)
    signs = (torch.randint(0, 2, (n_pad,), generator=gen) * 2 - 1).float()
    rows = torch.randperm(n_pad, generator=gen)[:r_prime]
    inits = torch.stack([torch.randperm(n_pad, generator=gen)[:k]
                         for _ in range(restarts)])
    return signs.to(device), rows.to(device), inits


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="rings", choices=["rings", "seg",
                                                           "blobs"])
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--k", type=int, default=None,
                    help="clusters (default: the data set's, 2 for blobs)")
    ap.add_argument("--r", type=int, default=2)
    ap.add_argument("--l", type=int, default=10, help="oversampling")
    ap.add_argument("--kernel", default="polynomial")
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--gamma", type=float, default=0.0)
    ap.add_argument("--block", type=int, default=512)
    ap.add_argument("--backend", default="onepass-srht",
                    choices=["onepass-srht", "onepass-gaussian", "nystrom",
                             "exact"],
                    help="approximation backend (one-process path; "
                         "--distributed always runs the sharded one-pass)")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.api.estimator import resolve_device
    from repro_torch.data import blob_ring, gaussian_blobs, segmentation_proxy
    from repro_torch.launch.mesh import open_world

    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    if args.dataset == "rings":
        X, labels = blob_ring(rng, n=args.n)
        k = 2
    elif args.dataset == "seg":
        X, labels = segmentation_proxy(rng, n=args.n if args.n != 4000
                                       else 2310)
        k = 7
    else:
        k = args.k or 2
        X, labels = gaussian_blobs(rng, n=args.n, p=16, k=k)
    # A world made here ends with main (launch/mesh.py).
    with open_world(device) if args.distributed else \
            contextlib.nullcontext():
        return _run(args, X.to(device), labels, args.k or k, device)


def _run(args, X, labels, k, device) -> int:
    import torch.distributed as dist

    from repro_torch.api import KernelKMeans
    from repro_torch.core import (clustering_accuracy, make_kernel, nmi,
                                  kernel_approx_error_streaming)
    from repro_torch.core.sketch import next_pow2

    kernel_params = ({"gamma": args.gamma, "degree": args.degree}
                     if args.kernel == "polynomial" else
                     {"gamma": args.gamma} if args.kernel == "rbf" else {})
    kern = make_kernel(args.kernel, **kernel_params)
    n = X.shape[1]
    t0 = time.perf_counter()
    if args.distributed:
        from repro_torch.distributed.cluster import \
            distributed_one_pass_kernel_kmeans
        from repro_torch.launch.mesh import make_debug_mesh, mesh_axis
        world = dist.get_world_size()
        mesh = make_debug_mesh(data=world, device=device)
        n_pad = next_pow2(n)
        n_pad = max(n_pad, world * -(-n_pad // world))
        Xp = torch.nn.functional.pad(X, (0, n_pad - n))
        signs, rows, inits = alg1_draws(args.seed + 1, n_pad,
                                        args.r + args.l, k, 10, device)
        res = distributed_one_pass_kernel_kmeans(
            kern, Xp, k=k, r=args.r, mesh=mesh, signs=signs, rows=rows,
            inits=inits, block=args.block)
        ax = mesh_axis(mesh, "data")
        pred = ax.all_gather_cat(res.labels)[:n]
        Y = ax.all_gather_cat(res.Y, dim=1)[:, :n]
        rank = dist.get_rank()
    else:
        backend_params = ({"oversampling": args.l}
                          if args.backend.startswith("onepass-") else {})
        est = KernelKMeans(k=k, r=args.r, kernel=args.kernel,
                           kernel_params=kernel_params, backend=args.backend,
                           backend_params=backend_params, block=args.block,
                           device=device)
        est.fit(X, seed=args.seed + 1)
        pred, Y = est.labels_, est.embedding_
        rank = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0

    err = kernel_approx_error_streaming(kern, X, Y, block=args.block)
    pred = pred.cpu().numpy()
    if rank == 0:
        print(f"n={n} k={k} r={args.r} l={args.l} kernel={args.kernel} "
              f"distributed={args.distributed}")
        print(f"wall time        {dt:.2f} s")
        print(f"approx error     {err:.4f}")
        print(f"accuracy         {clustering_accuracy(labels, pred, k):.4f}")
        print(f"nmi              {nmi(labels, pred):.4f}")
        print(f"sketch memory    {n * (args.r + args.l) * 4 / 2**20:.1f}"
              f" MiB (O(r'n); full K would be {n ** 2 * 4 / 2**30:.2f} GiB)")
    return 0


if __name__ == "__main__":
    from repro_torch.launch.mesh import run_process
    run_process(main)
