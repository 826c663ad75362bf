"""One rank of a gloo world for tests/test_torch_serve_pump.py.

    python tests/torch_serve_pump_worker.py RANK WORLD WORKDIR PART TIMEOUT

WORKDIR holds `store` (the FileStore), `model/` (an artifact the JAX
package wrote) and `inputs.npz` (the requests side by side, their
widths, the fake clock's steps between them). Every scenario serves on
ComputePolicy(mesh=(WORLD, 1) mesh, the kernel paths through their plain
versions) and runs its pumped batchers on every rank, built in the same
order; the process group's timeout is TIMEOUT seconds, counted once
every rank is up (tests/torch_worlds.py rendezvous). PART "all" runs,
in order:

  refuse  a pumped AsyncBatcher: a follower's submit, poll and start
          raise, rank 0's follow() raises; rank 0's stop() ends the
          followers' follow();
  drain   the requests through rank 0's pumped AsyncBatcher under a fake
          clock (deadline flushes by poll(), full-bucket flushes by
          submit()); the followers follow; then every rank drains the
          same flushes' requests through a mesh MicroBatcher;
  live    a client thread on rank 0 submits while the pump thread runs;
          after stop(), a barrier and an all_reduce on every rank;
  swap    a ModelRegistry row with a pumped scheduler, its pump thread
          live, swapped on rank 0 to the model with its centroid rows
          reversed (version 2) under pending requests, then served on;
          the followers serve it through follow(); then every rank
          drains the same requests on the old model and on its own copy
          of the new one.

PART "fail" runs on a short timeout. First rank 0's pump thread idles
for 1.6 timeouts with the keep-alive at a fifth of one, then serves one
request and stops: its NOPs keep the followers' waits alive. Then rank
0's first flush of a new batcher raises after its FLUSH went out: rank
0's futures carry the error and each follower's follow() raises (the
seconds it took are written). Then each rank ends the world as broken
(launch/mesh.py close_world) and leaves through run_process's os._exit
with code 0. Each rank writes out_RANK.npz: every flush's results as
its batcher saw them, and the drains'. No check asserts here; the test
compares.
"""
import datetime
import os
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import (close_world, make_debug_mesh, open_world,
                                     run_process)
from repro_torch.serve import (AsyncBatcher, ComputePolicy, MicroBatcher,
                               ModelRegistry, load_model)
from repro_torch.serve import pump
from repro_torch.serve.pump import PUMP
from torch_worlds import rendezvous

MAX_BUCKET = 128
MAX_WAIT_MS = 5.0
SWAP_BEFORE, SWAP_AFTER = slice(0, 4), slice(4, 8)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance_ms(self, ms):
        self.t += ms / 1e3


def recorded(ab):
    """Every flush of `ab` on this rank, as (widths, [(labels, d2)])."""
    log = []
    inner = ab.batcher.assign_requests

    def assign_requests(big, widths):
        out = inner(big, widths)
        log.append((list(widths), out))
        return out
    ab.batcher.assign_requests = assign_requests
    return log


def put(res, key, results):
    """Results of requests in order, as one labels and one d2 array."""
    res[f"{key}/labels"] = np.concatenate([r[0] for r in results])
    res[f"{key}/d2"] = np.concatenate([r[1] for r in results])


def drain_groups(model, pol, reqs, log):
    """The requests of each logged flush, drained through a mesh
    MicroBatcher (collective: every rank, the same groups)."""
    mb = MicroBatcher(model, policy=pol, max_bucket=MAX_BUCKET)
    out, at = [], 0
    for widths, _ in log:
        for r in reqs[at:at + len(widths)]:
            mb.submit(r)
        out += mb.drain()
        at += len(widths)
    return out


def refuse(rank, model, pol, reqs, res):
    ab = AsyncBatcher(model, max_bucket=MAX_BUCKET, policy=pol)
    calls = {"submit": lambda: ab.submit(reqs[0]), "poll": ab.poll,
             "start": ab.start} if rank else {"follow": ab.follow}
    for name, call in calls.items():
        try:
            call()
            res[f"refuse/{name}"] = 0
        except RuntimeError:
            res[f"refuse/{name}"] = 1
    if rank == 0:
        ab.stop()
    else:
        res["refuse/flushes"] = ab.follow()


def against_drain(rank, model, pol, reqs, steps, res):
    clock = FakeClock()
    ab = AsyncBatcher(model, max_wait_ms=MAX_WAIT_MS, clock=clock,
                      max_bucket=MAX_BUCKET, policy=pol)
    log = recorded(ab)
    if rank == 0:
        futs, inline, deadline = [], 0, 0
        for r, dt in zip(reqs, steps):
            futs.append(ab.submit(r))
            inline += ab.pending_requests == 0
            clock.advance_ms(dt)
            deadline += ab.poll() > 0
        ab.stop()
        res["drain/inline"], res["drain/deadline"] = inline, deadline
        put(res, "drain/futures", [f.result(timeout=0) for f in futs])
    else:
        res["drain/followed"] = ab.follow()
    res["drain/groups"] = np.asarray([len(w) for w, _ in log])
    put(res, "drain/async", [r for _, out in log for r in out])
    put(res, "drain/drain", drain_groups(model, pol, reqs, log))


def live(rank, model, pol, reqs, res):
    ab = AsyncBatcher(model, max_wait_ms=2.0, max_bucket=MAX_BUCKET,
                      policy=pol)
    log = recorded(ab)
    if rank == 0:
        futs = []
        ab.start()

        def client():
            for r in reqs:
                futs.append(ab.submit(r))
                time.sleep(5e-4)
        thread = threading.Thread(target=client)
        thread.start()
        thread.join()
        ab.stop()
        res["live/requests"] = len(futs)
        res["live/stranded"] = sum(not f.done() for f in futs)
        res["live/errors"] = sum(f.exception(timeout=0) is not None
                                 for f in futs if f.done())
        res["live/pump_errors"] = ab.pump_errors
    else:
        res["live/followed"] = ab.follow()
    res["live/flushes"] = len(log)
    put(res, "live/async", [r for _, out in log for r in out])
    put(res, "live/drain", drain_groups(model, pol, reqs, log))
    dist.barrier()
    t = torch.ones(1)
    dist.all_reduce(t)
    res["live/all_reduce"] = t.item()


def swap(rank, model, pol, reqs, res):
    reg = ModelRegistry()
    reg.register("row", model, version=1)
    sched = reg.scheduler("row", max_wait_ms=1e5, max_bucket=MAX_BUCKET,
                          policy=pol)
    sched.batcher.warm([8, 64])        # the buckets the swap replays
    # At most 16 queries each: the four stay under the widest bucket.
    before = [r[:, :16] for r in reqs[SWAP_BEFORE]]
    after = [r[:, :16] for r in reqs[SWAP_AFTER]]
    if rank == 0:
        sched.start()
        pending = [sched.submit(r) for r in before]
        res["swap/pending_at_swap"] = sum(not f.done() for f in pending)
        model_b = model._replace(centroids=torch.flip(model.centroids, [0]))
        report = reg.swap("row", model_b, version=2)
        res["swap/done_after_swap"] = sum(f.done() for f in pending)
        res["swap/drained"] = report.drained_requests
        res["swap/warmed"] = np.asarray(report.buckets_warmed)
        new = reg.scheduler("row")
        res["swap/old_stopped"] = int(sched.stopped)
        res["swap/new_running"] = int(new.running)
        futs = [new.submit(r) for r in after]
        new.flush()
        put(res, "swap/old", [f.result(timeout=0) for f in pending])
        put(res, "swap/new", [f.result(timeout=0) for f in futs])
        served = reg.get("row")
        res["swap/version"] = reg.version("row")
        reg.unregister("row")
    else:
        try:
            reg.swap("row", model)
            res["swap/refused_on_follower"] = 0
        except RuntimeError:
            res["swap/refused_on_follower"] = 1
        res["swap/followed"] = reg.follow("row")
        served = reg.get("row")
        res["swap/version"] = reg.version("row")
        res["swap/stopped"] = int(reg.scheduler("row").stopped)
    for name in served._fields[1:]:
        leaf = getattr(served, name)
        if leaf is not None:
            res[f"swap/leaf/{name}"] = leaf.numpy().copy()
    for key, m, part in (("old", model, before), ("new", served, after),
                         ("old_after", model, after)):
        mb = MicroBatcher(m, policy=pol, max_bucket=MAX_BUCKET)
        for r in part:
            mb.submit(r)
        put(res, f"swap/drain_{key}", mb.drain())


def keep_alive(rank, model, pol, reqs, res, timeout):
    pump.KEEPALIVE_S = timeout / 5
    ab = AsyncBatcher(model, max_wait_ms=100.0, max_bucket=MAX_BUCKET,
                      policy=pol)
    if rank == 0:
        ab.start()
        time.sleep(1.6 * timeout)
        fut = ab.submit(reqs[0])
        ab.stop()
        res["alive/served"] = int(fut.exception(timeout=0) is None)
    else:
        res["alive/followed"] = ab.follow()
    res["alive/messages"] = PUMP.counts()["messages"]


def fail(rank, model, pol, reqs, res):
    ab = AsyncBatcher(model, max_bucket=MAX_BUCKET, policy=pol)
    if rank == 0:
        def broken(big, widths):
            raise ValueError("injected compute failure")
        ab.batcher.assign_requests = broken
        fut = ab.submit(reqs[0])
        try:
            ab.flush()
        except ValueError:
            pass
        res["fail/future_error"] = str(fut.exception(timeout=0))
        return
    t0 = time.monotonic()
    try:
        ab.follow()
        res["fail/raised"] = 0
    except Exception as exc:                      # gloo's timeout or close
        res["fail/raised"] = 1
        res["fail/error"] = type(exc).__name__
    res["fail/seconds"] = time.monotonic() - t0


def main():
    rank, world, workdir, part, timeout = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        float(sys.argv[5]))
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    rendezvous(store, rank, world)
    with open_world("cpu", datetime.timedelta(seconds=timeout),
                    store=store, rank=rank, size=world):
        run(rank, world, workdir, part, timeout)


def run(rank, world, workdir, part, timeout):
    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    offs = np.cumsum(np.concatenate([[0], inp["widths"]]))
    reqs = [np.ascontiguousarray(inp["queries"][:, a:b])
            for a, b in zip(offs, offs[1:])]
    model = load_model(os.path.join(workdir, "model"), device="cpu")
    mesh = make_debug_mesh(world, 1, device="cpu")
    pol = ComputePolicy(mesh=mesh, embed_fused=True, assign_fused=True,
                        interpret=True)
    res = {}
    out = os.path.join(workdir, f"out_{rank}.npz")
    if part == "fail":
        keep_alive(rank, model, pol, reqs, res, timeout)
        fail(rank, model, pol, reqs, res)
        np.savez(out, **res)
        # The collective rank 0 left half made broke the world.
        close_world(broken=True)
        return
    PUMP.reset_counts()
    refuse(rank, model, pol, reqs, res)
    against_drain(rank, model, pol, reqs, inp["steps"], res)
    live(rank, model, pol, reqs, res)
    swap(rank, model, pol, reqs, res)
    for key, val in PUMP.counts().items():
        res[f"pump/{key}"] = val
    np.savez(out, **res)
    dist.barrier()


if __name__ == "__main__":
    run_process(main)
