"""How a world of the port ends (launch/mesh.py: open_world, close_world,
run_process), on gloo worlds of 2 ranks, one process a rank
(tests/torch_world_teardown_worker.py), all started together.

The launcher's broken flush: serve_cluster.main with --device cpu
--interpret --sharded --bench async --smoke on a world the wrapper made
with a LAUNCH_TIMEOUT_S group timeout, rank 0's compute made to fail on
its first pumped flush, after the FLUSH went out. Rank 0 exits with
BROKEN_EXIT and its log holds the injected error; rank 1, in follow(),
raises on the collective the flush left half made and exits with
BROKEN_EXIT too, within the group's timeout (plus MARGIN_S) of rank 0's
exit. No code is negative (no signal) and no log holds "terminate
called", the abort a gloo rank met in the interpreter's shutdown after
a broken collective.

The forced exit orders: rank 1 enters an all_reduce rank 0 never joins
(ORDER_TIMEOUT_S group timeout); the broken rank leaves first or the
healthy one does; each rank leaves its world by an exception (code
BROKEN_EXIT) or through close_world(broken=True) (code 0); the
collectives run on a DeviceMesh held to the end or on the default
group. Every case ends with the codes its way of leaving gives, within
the timeout plus MARGIN_S, and no abort.

In this process, on gloo worlds of one rank: close_world's order after a
normal end and after an exception, open_world leaving a world it did not
make, and a batcher of a world that ended without close_world.
"""
import itertools
import time

import numpy as np
import pytest
import torch.distributed as dist

import torch_worlds
from repro_torch.api import KernelKMeans
from repro_torch.data import blob_ring
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import BROKEN_EXIT
from repro_torch.serve import (DEFAULT_REGISTRY, AsyncBatcher,
                               ComputePolicy)
from repro_torch.serve.pump import PUMP
from torch_world_teardown_worker import INJECTED

LAUNCH_TIMEOUT_S = 20.0
ORDER_TIMEOUT_S = 3.0
MARGIN_S = 40.0             # the ranks' start-up under load included
DEADLINE_S = 120.0          # every world, start to join
ABORT = "terminate called"
ORDERS = list(itertools.product(("broken_first", "healthy_first"),
                                ("raise", "close"), ("mesh", "none")))
LAUNCHER = ["--device", "cpu", "--interpret", "--sharded", "--bench",
            "async", "--smoke", "--queries", "128", "--repeats", "1",
            "--bench-passes", "1", "--batch-sizes", "8,64",
            "--async-requests", "32"]


def _case(order):
    return "-".join(order)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's ranks: {name: [(code, seconds to exit, log)]}."""
    work = tmp_path_factory.mktemp("world_teardown")
    t_start = time.monotonic()
    started = {}
    wdir = work / "launcher"
    wdir.mkdir()
    store = torch_worlds.agent_store(DEADLINE_S)
    args = ["launcher", "cpu", LAUNCH_TIMEOUT_S, "--", *LAUNCHER,
            "--artifact-dir", wdir / "art" / "demo",
            "--bench-out", wdir / "bench.json"]
    started["launcher"] = torch_worlds.start(
        wdir, "torch_world_teardown_worker.py", [args, args], "launcher",
        [torch_worlds.torchrun_env(store, 2, r) for r in range(2)])
    for order in ORDERS:
        wdir = work / _case(order)
        wdir.mkdir()
        started[_case(order)] = torch_worlds.start(
            wdir, "torch_world_teardown_worker.py",
            [["order", r, wdir / "store", *order, ORDER_TIMEOUT_S]
             for r in range(2)], _case(order))
    ended = torch_worlds.wait(list(started.values()),
                              t_start + DEADLINE_S, since=t_start)
    del store
    return {name: [(code, seconds,
                    (world.wdir / f"log_{r}.txt").read_text())
                   for r, (code, seconds) in enumerate(ranks)]
            for (name, world), ranks in zip(started.items(), ended)}


def _no_abort(ranks):
    for r, (code, _, log) in enumerate(ranks):
        assert code is not None and code >= 0, (r, code, log[-3000:])
        assert ABORT not in log, (r, log[-3000:])


def test_failed_leader_exits_with_its_code(worlds):
    """Rank 0, whose pumped flush failed, prints the injected error and
    exits with BROKEN_EXIT."""
    code, _, log = worlds["launcher"][0]
    assert INJECTED in log, log[-3000:]
    assert code == BROKEN_EXIT > 0, (code, log[-3000:])


def test_follower_leaves_within_the_timeout(worlds):
    """Rank 1 raises out of follow() on the broken collective and exits
    with BROKEN_EXIT within the group's timeout of rank 0's exit."""
    (_, t0, _), (code, t1, log) = worlds["launcher"]
    assert code == BROKEN_EXIT > 0, (code, log[-3000:])
    assert "follow" in log, log[-3000:]
    assert t1 - t0 < LAUNCH_TIMEOUT_S + MARGIN_S, (t0, t1)


def test_no_launcher_rank_aborts(worlds):
    _no_abort(worlds["launcher"])


@pytest.mark.parametrize("order", ORDERS, ids=_case)
def test_forced_exit_order(worlds, order):
    """Each rank ends with the code of its way of leaving, in time (from
    the start of every world), and none by a signal or an abort."""
    _, end, _ = order
    ranks = worlds[_case(order)]
    _no_abort(ranks)
    want = BROKEN_EXIT if end == "raise" else 0
    for r, (code, seconds, log) in enumerate(ranks):
        assert code == want, (r, code, log[-3000:])
        assert seconds < ORDER_TIMEOUT_S + MARGIN_S, (r, seconds)
    assert "the all_reduce raised" in ranks[1][2], ranks[1][2][-3000:]


# -- close_world on a world of one rank, in this process ---------------------

@pytest.fixture(scope="module")
def model():
    X, _ = blob_ring(np.random.default_rng(0), n=256)
    return KernelKMeans(k=2, r=2, kernel="polynomial",
                        kernel_params={"gamma": 0.0, "degree": 2},
                        device="cpu").fit(X, seed=1).model_


@pytest.fixture
def fresh(monkeypatch):
    """No world before the test and none after it; whether a world broke
    is this test's alone."""
    assert not dist.is_initialized()
    monkeypatch.setitem(mesh_mod._ENDED, "broken", False)
    yield
    mesh_mod.close_world()


def test_close_world_retires_holders_in_order(fresh, model):
    """A normal end: the pumped batcher's pending request is flushed and
    its STOP sent (rank 0 of a world of one), the pumped registry row
    goes, the mesh lets go of its groups, the world ends."""
    sent = PUMP.counts()["messages"]
    with mesh_mod.open_world("cpu"):
        mesh = mesh_mod.make_debug_mesh(device="cpu")
        ab = AsyncBatcher(model, policy=ComputePolicy(mesh=mesh))
        fut = ab.submit(np.zeros((2, 8), np.float32))
        DEFAULT_REGISTRY.register("teardown-row", model)
        DEFAULT_REGISTRY.scheduler("teardown-row",
                                   policy=ComputePolicy(mesh=mesh))
    labels, _ = fut.result(timeout=0)
    assert labels.shape == (8,) and ab.stopped
    # FLUSH, the batcher's STOP, the row's scheduler's STOP.
    assert PUMP.counts()["messages"] - sent == 3
    assert "teardown-row" not in DEFAULT_REGISTRY.names()
    assert not mesh._pg_registry and not dist.is_initialized()
    assert not mesh_mod.world_broke()


def test_exception_ends_the_world_as_broken(fresh, model):
    """An exception leaving the block abandons the pumped batcher (its
    pending future fails, nothing is sent) and aborts the world."""
    sent = PUMP.counts()["messages"]
    with pytest.raises(ValueError, match="the block failed"):
        with mesh_mod.open_world("cpu"):
            mesh = mesh_mod.make_debug_mesh(device="cpu")
            ab = AsyncBatcher(model, policy=ComputePolicy(mesh=mesh))
            fut = ab.submit(np.zeros((2, 8), np.float32))
            raise ValueError("the block failed")
    with pytest.raises(RuntimeError, match="abandoned"):
        fut.result(timeout=0)
    assert ab.stopped and ab.stop() == 0
    assert PUMP.counts()["messages"] == sent
    assert not dist.is_initialized() and mesh_mod.world_broke()


def test_open_world_leaves_a_world_it_did_not_make(fresh):
    """Neither a normal end nor an exception ends a world that was there
    before the block; close_world ends it, and again does nothing."""
    mesh_mod.init_world("cpu")
    with mesh_mod.open_world("cpu"):
        pass
    with pytest.raises(KeyError):
        with mesh_mod.open_world("cpu"):
            raise KeyError("inside")
    assert dist.is_initialized() and not mesh_mod.world_broke()
    mesh_mod.close_world()
    mesh_mod.close_world()
    assert not dist.is_initialized()


def test_a_batcher_of_a_world_ended_elsewhere_is_abandoned(fresh, model):
    """A pumped batcher left live by a world that ended without
    close_world is abandoned by the next world's end, not stopped over a
    group that is gone; that world still ends."""
    mesh_mod.init_world("cpu")
    stale = AsyncBatcher(model, policy=ComputePolicy(
        mesh=mesh_mod.make_debug_mesh(device="cpu")))
    dist.destroy_process_group()
    with mesh_mod.open_world("cpu"):
        pass
    assert stale.stopped and not dist.is_initialized()
    assert not mesh_mod.world_broke()
