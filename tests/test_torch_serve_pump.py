"""The rank-0 pump (repro_torch.serve.pump): sharded async serving and the
hot swap of a sharded row over gloo worlds of 2 and 4 ranks, against a
mesh MicroBatcher drain and against the JAX package's AsyncBatcher on a
mesh.

A small model is fitted once by the JAX package (segmentation shape,
n = 300, p = 19, K = 7, r = 2, block 64) and carried into the port by its
artifact; 40 requests of widths 1-64 drawn with numpy from a seed slice
the held-out points, and a fake clock steps 0-2.5 ms between them (the
deadline is 5 ms, the widest bucket 128 queries), so both deadline and
full-bucket flushes fire. Each world's ranks run
tests/torch_serve_pump_worker.py (one process a rank, the worlds of 2
and 4 and a world of 2 that idles past its timeout and then breaks a
flush started together, each with its own deadline and a process-group
timeout).

Tolerances: on every rank, the pumped flushes equal a mesh MicroBatcher
drain of the same requests bit for bit (labels and the bits of d2); every
rank's flushes equal rank 0's bit for bit; against JAX's AsyncBatcher(m,
mesh=jax.make_mesh((1,), ("data",))) labels by the near-tie rule and d2
within rtol = atol = 2e-3. The JAX mesh's axis is of the Auto type, the
one JAX's serving path is written for (newer JAX makes Explicit axes by
default, which its sharded extension does not take).
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.api import KernelKMeans as JaxKernelKMeans
from repro.serve import AsyncBatcher as JaxAsyncBatcher
from repro.serve import ComputePolicy as JaxComputePolicy
from repro.serve import save_model as jax_save_model
from repro_torch.data import segmentation_proxy
from repro_torch.kernels.registry import near_tie_compare, sq_distances
from repro_torch.serve import (AsyncBatcher, ComputePolicy, Extender,
                               load_model, pump)
import torch_worlds

N, NQ, P, K, R, BLOCK = 300, 400, 19, 7, 2, 64
N_REQUESTS, MAX_WIDTH, MAX_STEP_MS = 40, 64, 2.5
MAX_BUCKET, MAX_WAIT_MS = 128, 5.0       # the worker's
TOL = 2e-3
WORLDS = (2, 4)
TIMEOUT_S = 60.0           # the worlds' process-group timeout
FAIL_TIMEOUT_S = 5.0       # the broken world's
WORLD_DEADLINE = 150.0     # seconds for every world, start to join


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _same_bits(got_labels, got_d2, want_labels, want_d2):
    assert np.array_equal(got_labels, want_labels)
    assert np.array_equal(np.asarray(got_d2).view(np.int32),
                          np.asarray(want_d2).view(np.int32))


def _run_world(work, name, world, part, timeout, deadline):
    """One world's ranks started together and joined; each rank's
    out_RANK.npz."""
    wdir = work / name
    torch_worlds.link(work, wdir, ("inputs.npz", "model"))
    torch_worlds.run(wdir, "torch_serve_pump_worker.py",
                     [[r, world, wdir, part, timeout] for r in range(world)],
                     name, deadline)
    return [dict(np.load(wdir / f"out_{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX model and its artifact, the requests, and every world's
    ranks' outputs (the worlds run together, each in a thread)."""
    work = tmp_path_factory.mktemp("serve_pump")
    X, _ = segmentation_proxy(np.random.default_rng(21), n=N + NQ, p=P, k=K)
    X = X.numpy()[:, np.random.default_rng(22).permutation(N + NQ)]
    jm = JaxKernelKMeans(
        k=K, r=R, kernel="polynomial",
        kernel_params={"gamma": 0.0, "degree": 2}, backend="onepass-srht",
        backend_params={"oversampling": 5}, block=BLOCK).fit(
            X[:, :N], key=0).model_
    jax_save_model(jm, str(work / "model"))
    rng = np.random.RandomState(0)
    widths = rng.randint(1, MAX_WIDTH + 1, size=N_REQUESTS)
    starts = [rng.randint(0, NQ - w + 1) for w in widths]
    Xq = X[:, N:]
    queries = np.concatenate([Xq[:, a:a + w] for a, w in zip(starts, widths)],
                             axis=1).astype(np.float32)
    steps = rng.uniform(0.0, MAX_STEP_MS, size=N_REQUESTS)
    np.savez(work / "inputs.npz", queries=queries, widths=widths,
             steps=steps)
    deadline = time.monotonic() + WORLD_DEADLINE
    plan = {f"world{w}": (w, "all", TIMEOUT_S) for w in WORLDS}
    plan["fail"] = (2, "fail", FAIL_TIMEOUT_S)
    outs, failed = {}, {}

    def spawn(name, world, part, timeout):
        try:
            outs[name] = _run_world(work, name, world, part, timeout,
                                    deadline)
        except AssertionError as exc:
            failed[name] = exc

    threads = [threading.Thread(target=spawn, args=(name,) + args,
                                daemon=True) for name, args in plan.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    offs = np.cumsum(np.concatenate([[0], widths]))
    reqs = [queries[:, a:b] for a, b in zip(offs, offs[1:])]
    return {"jm": jm, "reqs": reqs, "outs": outs, "failed": failed,
            "model": load_model(str(work / "model"), device="cpu")}


def _world(runs, world):
    name = f"world{world}"
    if name in runs["failed"]:
        raise runs["failed"][name]
    return runs["outs"][name]


@pytest.mark.parametrize("world", WORLDS)
def test_pumped_async_equals_mesh_drain(runs, world):
    """Deadline and full-bucket flushes through rank 0's pump equal a
    mesh MicroBatcher drain of the same requests, bit for bit, on every
    rank; every rank ran rank 0's flushes, with rank 0's bits."""
    outs = _world(runs, world)
    zero = outs[0]
    assert zero["drain/inline"] > 0 and zero["drain/deadline"] > 0
    assert int(zero["drain/groups"].sum()) == N_REQUESTS
    _same_bits(zero["drain/futures/labels"], zero["drain/futures/d2"],
               zero["drain/async/labels"], zero["drain/async/d2"])
    for rank, out in enumerate(outs):
        assert np.array_equal(out["drain/groups"], zero["drain/groups"])
        if rank:
            assert int(out["drain/followed"]) == len(zero["drain/groups"])
        _same_bits(out["drain/async/labels"], out["drain/async/d2"],
                   out["drain/drain/labels"], out["drain/drain/d2"])
        _same_bits(out["drain/async/labels"], out["drain/async/d2"],
                   zero["drain/async/labels"], zero["drain/async/d2"])


@pytest.mark.parametrize("world", WORLDS)
def test_pumped_async_agrees_with_jax(runs, world):
    """The same requests, coalesced as rank 0 flushed them, through JAX's
    AsyncBatcher on a mesh: labels by the near-tie rule, d2 within
    2e-3."""
    zero = _world(runs, world)[0]
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    jab = JaxAsyncBatcher(runs["jm"], max_wait_ms=MAX_WAIT_MS,
                          clock=FakeClock(), max_bucket=MAX_BUCKET,
                          policy=JaxComputePolicy(mesh=mesh))
    futs, at = [], 0
    for size in zero["drain/groups"]:
        futs += [jab.submit(r) for r in runs["reqs"][at:at + size]]
        jab.flush()
        at += size
    want = (np.concatenate([np.asarray(f.result(timeout=0)[0])
                            for f in futs]),
            np.concatenate([np.asarray(f.result(timeout=0)[1])
                            for f in futs]))
    model = runs["model"]
    plain = Extender(model, policy=ComputePolicy(embed_fused=False,
                                                 assign_fused=False))
    Y = plain.embed(torch.from_numpy(np.concatenate(runs["reqs"], axis=1)))
    near_tie_compare((zero["drain/futures/labels"], zero["drain/futures/d2"]),
                     want, TOL, TOL, sq_distances(Y, model.centroids))


@pytest.mark.parametrize("world", WORLDS)
def test_live_pump_strands_nothing(runs, world):
    """A client thread submits while rank 0's pump thread runs: every
    future resolves without error; the followers ran rank 0's flushes and
    returned; a barrier and an all_reduce then complete on every rank."""
    outs = _world(runs, world)
    zero = outs[0]
    assert int(zero["live/requests"]) == N_REQUESTS
    assert int(zero["live/stranded"]) == 0
    assert int(zero["live/errors"]) == 0 and int(zero["live/pump_errors"]) == 0
    for rank, out in enumerate(outs):
        if rank:
            assert int(out["live/followed"]) == int(zero["live/flushes"])
        assert float(out["live/all_reduce"]) == world
        _same_bits(out["live/async/labels"], out["live/async/d2"],
                   out["live/drain/labels"], out["live/drain/d2"])


@pytest.mark.parametrize("world", WORLDS)
def test_swap_of_sharded_row_under_pending_requests(runs, world):
    """Requests pending at rank 0's swap resolve on the old model, later
    ones on the new (its centroid rows reversed, so the labels permute);
    0 stranded; every follower's row holds rank 0's leaves bit for bit
    under version 2, and its follow() returned at unregister."""
    outs = _world(runs, world)
    zero = outs[0]
    assert int(zero["swap/pending_at_swap"]) == 4
    assert int(zero["swap/done_after_swap"]) == 4
    assert int(zero["swap/drained"]) == 4
    assert list(zero["swap/warmed"]) == [8, 64]
    assert int(zero["swap/old_stopped"]) == 1
    assert int(zero["swap/new_running"]) == 1
    _same_bits(zero["swap/old/labels"], zero["swap/old/d2"],
               zero["swap/drain_old/labels"], zero["swap/drain_old/d2"])
    _same_bits(zero["swap/new/labels"], zero["swap/new/d2"],
               zero["swap/drain_new/labels"], zero["swap/drain_new/d2"])
    assert np.array_equal(zero["swap/new/labels"],
                          K - 1 - zero["swap/drain_old_after/labels"])
    leaves = [k for k in zero if k.startswith("swap/leaf/")]
    assert "swap/leaf/centroids" in leaves
    for rank, out in enumerate(outs):
        assert int(out["swap/version"]) == 2
        assert sorted(k for k in out if k.startswith("swap/leaf/")) == \
            sorted(leaves)
        for key in leaves:
            assert out[key].dtype == zero[key].dtype
            assert np.array_equal(out[key].view(np.uint8),
                                  zero[key].view(np.uint8)), (rank, key)
        _same_bits(out["swap/drain_new/labels"], out["swap/drain_new/d2"],
                   zero["swap/drain_new/labels"], zero["swap/drain_new/d2"])
        if rank:
            assert int(out["swap/followed"]) == 2     # old drain, new flush
            assert int(out["swap/stopped"]) == 1


@pytest.mark.parametrize("world", WORLDS)
def test_followers_refuse_the_front_door(runs, world):
    """A follower's submit, poll, start and swap raise; rank 0's follow()
    raises; rank 0's stop() ends the followers' follow()."""
    outs = _world(runs, world)
    assert int(outs[0]["refuse/follow"]) == 1
    for out in outs[1:]:
        for call in ("submit", "poll", "start"):
            assert int(out[f"refuse/{call}"]) == 1, call
        assert int(out["refuse/flushes"]) == 0
        assert int(out["swap/refused_on_follower"]) == 1


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_counts_the_same_messages(runs, world):
    """What rank 0 broadcast is what each follower received: the same
    messages, broadcasts and bytes."""
    outs = _world(runs, world)
    for key in ("messages", "broadcasts", "bytes"):
        counts = {int(out[f"pump/{key}"]) for out in outs}
        assert len(counts) == 1 and counts.pop() > 0, key


def test_keep_alive_holds_idle_followers(runs):
    """Rank 0's pump thread idles 1.6 group timeouts: its NOPs (one a
    fifth of a timeout) keep the follower's wait alive, and the request
    after the idle is served and followed."""
    if "fail" in runs["failed"]:
        raise runs["failed"]["fail"]
    zero, one = runs["outs"]["fail"]
    assert int(zero["alive/served"]) == 1
    assert int(one["alive/followed"]) == 1
    # FLUSH, STOP and the NOPs (about one a second), alike on both ranks.
    assert int(zero["alive/messages"]) == int(one["alive/messages"]) >= 3


def test_compute_failure_fails_the_world_fast(runs):
    """Rank 0's flush breaks after its FLUSH went out: the batch's
    future carries the error, and the follower raises out of follow()
    within the group's timeout instead of waiting for ever."""
    if "fail" in runs["failed"]:
        raise runs["failed"]["fail"]
    zero, one = runs["outs"]["fail"]
    assert "injected compute failure" in str(zero["fail/future_error"])
    assert int(one["fail/raised"]) == 1
    assert float(one["fail/seconds"]) < FAIL_TIMEOUT_S + 10.0


# -- the messages, in this process -------------------------------------------

def test_swap_message_carries_the_model_bit_for_bit(runs):
    model = runs["model"]._replace(
        centroids=torch.flip(runs["model"].centroids, [0]))
    meta, body = pump.pack_swap(model, 7, [8, 64], None, "cpu")
    got, version, bw, sw = pump.unpack_swap(
        pump.Message(pump.SWAP, 3, meta, body))
    assert (version, bw, sw) == (7, [8, 64], None)
    assert got.spec == model.spec
    for name in model._fields[1:]:
        want = getattr(model, name)
        have = getattr(got, name)
        if want is None:
            assert have is None, name
            continue
        assert have.dtype == want.dtype and have.shape == want.shape, name
        assert torch.equal(have.view(-1).view(torch.uint8),
                           want.contiguous().view(-1).view(torch.uint8)), name


def test_flush_message_carries_the_requests(runs):
    reqs = runs["reqs"][:5]
    widths = [r.shape[1] for r in reqs]
    big = np.concatenate(reqs, axis=1)
    body = pump.pack_flush(widths, big, "cpu")
    got_w, payload = pump.unpack_flush(
        pump.Message(pump.FLUSH, 1, len(widths), body), P)
    assert got_w == widths
    assert np.array_equal(payload.numpy().view(np.int32),
                          big.view(np.int32))
    assert body.numel() == 8 * len(widths) + 4 * big.size


def test_an_unpumped_batcher_is_its_own_front_door(runs):
    ab = AsyncBatcher(runs["model"], max_bucket=MAX_BUCKET)
    assert not ab.pumped and ab.leader and ab.generation is None
    with pytest.raises(RuntimeError, match="follow"):
        ab.follow()
    ab.stop()
