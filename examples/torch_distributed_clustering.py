"""The paper's pipeline distributed over a mesh on the PyTorch/CUDA port
(examples/distributed_clustering.py, on repro_torch).

Data columns sharded over the ranks of the world, kernel stripes computed
rank-locally, SRHT preconditioning through the butterfly distributed
FWHT, Cholesky-QR, distributed Lloyd (distributed/cluster.py). One
process per rank, as torchrun starts them; without a launcher the world
is this process.

Run: PYTHONPATH=src torchrun --standalone --nproc_per_node=1 \
         examples/torch_distributed_clustering.py
     PYTHONPATH=src python examples/torch_distributed_clustering.py \
         --device cpu                      # a gloo world of one rank
"""
import argparse

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import clustering_accuracy, make_kernel
from repro_torch.data import blob_ring
from repro_torch.distributed.cluster import distributed_one_pass_kernel_kmeans
from repro_torch.launch.cluster import alg1_draws
from repro_torch.launch.mesh import (make_debug_mesh, mesh_axis, open_world,
                                     run_process)


def main(dev: torch.device) -> None:
    # The world ends with the block, the mesh's hold on its groups first
    # (launch/mesh.py close_world).
    with open_world(dev) as world:
        mesh = make_debug_mesh(data=world, device=dev)
        n = 4096                               # power of two (pre-padded)
        # Every rank makes the same data and draws from the same seeds.
        X, labels = blob_ring(np.random.default_rng(0), n=n)
        signs, rows, inits = alg1_draws(1, n, 2 + 10, 2, 10, dev)

        res = distributed_one_pass_kernel_kmeans(
            make_kernel("polynomial", gamma=0.0, degree=2), X.to(dev), k=2,
            r=2, mesh=mesh, signs=signs, rows=rows, inits=inits, block=512)

        pred = mesh_axis(mesh, "data").all_gather_cat(res.labels)
        acc = clustering_accuracy(labels, pred.cpu(), 2)
        if dist.get_rank() == 0:
            print(f"ranks={world} n={n} accuracy={acc:.3f} "
                  f"eigvals={np.round(res.eigvals.cpu().numpy(), 1)}")
        assert acc > 0.95
        if world > 1:
            dist.barrier()    # no rank tears down while another runs


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    run_process(main, torch.device(ap.parse_args().device))
