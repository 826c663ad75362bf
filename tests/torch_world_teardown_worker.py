"""One rank of a world that breaks, for tests/test_torch_world_teardown.py
and chip_smoke's phase 12. Every rank leaves through launch/mesh.py's
run_process.

    python tests/torch_world_teardown_worker.py launcher DEVICE TIMEOUT \
        -- LAUNCHER ARGS

The serving launcher (repro_torch.launch.serve_cluster.main) on a world
this wrapper makes from torchrun's variables with a group timeout of
TIMEOUT seconds, so that the launcher does not own it. On rank 0 every
MicroBatcher on a mesh fails its compute (assign_requests raises
ValueError("injected compute failure")): under --sharded --bench async
that is rank 0's first pumped flush, after its FLUSH went out, while
each follower runs the flush's collectives in follow().

    python tests/torch_world_teardown_worker.py order RANK STORE ORDER END \
        HOLDER TIMEOUT

A gloo world of 2 through the FileStore STORE: rank 0 broadcasts a
header, then rank 1 enters an all_reduce that rank 0 never joins. ORDER
says who leaves first: "broken_first" (rank 0 waits until rank 1's
all_reduce failed at the timeout and rank 1 is on its way out) or
"healthy_first" (rank 0 leaves at once; rank 1's all_reduce fails on the
closed connection). END says how each rank leaves its world: "raise"
(an exception leaves the world block: run_process's BROKEN_EXIT) or
"close" (close_world(broken=True), then code 0). HOLDER "mesh" serves
the collectives on a DeviceMesh held to the end, "none" on the default
group.
"""
import datetime
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import (close_world, make_debug_mesh,
                                     open_world, run_process)
from torch_worlds import rendezvous

INJECTED = "injected compute failure"


def launcher(device, timeout, argv):
    from repro_torch.launch import serve_cluster
    from repro_torch.serve.batcher import MicroBatcher
    with open_world(device, datetime.timedelta(seconds=float(timeout))):
        if dist.get_rank() == 0:
            inner = MicroBatcher.assign_requests

            def broken(self, big, widths):
                if self.policy.mesh is not None:
                    raise ValueError(INJECTED)
                return inner(self, big, widths)
            MicroBatcher.assign_requests = broken
        return serve_cluster.main(argv)


def order(rank, store, order, end, holder, timeout):
    fs = dist.FileStore(store, 2)
    rendezvous(fs, int(rank), 2)
    with open_world("cpu", datetime.timedelta(seconds=float(timeout)),
                    store=fs, rank=int(rank), size=2):
        mesh = make_debug_mesh(2, 1, device="cpu") if holder == "mesh" \
            else None
        group = mesh.get_group("data") if mesh is not None else None
        head = torch.full((4,), 7 if rank == "0" else 0, dtype=torch.int64)
        dist.broadcast(head, src=0, group=group)
        if rank == "1":
            t0 = time.monotonic()
            try:
                dist.all_reduce(torch.ones(1024), group=group)
            except RuntimeError as exc:
                print(f"rank 1: the all_reduce raised after "
                      f"{time.monotonic() - t0:.1f} s: {exc}", flush=True)
                fs.set("left", "1")
                if end == "raise":
                    raise
            else:
                raise AssertionError("an all_reduce rank 0 never joined "
                                     "returned")
        elif order == "broken_first":
            fs.wait(["left"], datetime.timedelta(seconds=60))
            time.sleep(0.5)
        if rank == "0" and end == "raise":
            raise RuntimeError("rank 0 left a collective half made")
        close_world(broken=True)
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[0] == "launcher":
        at = args.index("--")
        run_process(launcher, args[1], args[2], args[at + 1:])
    run_process(order, *args[1:])
