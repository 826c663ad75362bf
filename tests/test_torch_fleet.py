"""The port's fleet tier: the contracts of tests/test_fleet.py torch
against torch, and the same tier against the JAX package's.

Stat merging, pin-guarded GC, routing, admission control, adaptive
per-bucket waits, canary-then-promote rollouts and the front door run on
the CPU at the JAX file's sizes (N 250, P 2, R 2, K 2, block 64, l = 10),
the model fitted by the port on its own blob_ring. All timing is driven
by fake clocks (no sleeps), except the soak bench, whose pumps are live.

Against the JAX package: the Router places keys and picks least-loaded
workers identically (blake2b ring), AdmissionController and
AdaptiveWaitController decide identically on the same scripted inputs,
and a store published by JAX is served by the port's 2-replica Fleet
with labels equal to JAX's Fleet by the near-tie rule (distances within
1e-4) through a rollout that ends in the same state and versions.
"""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.analysis import locks
from repro.api import KernelKMeans as JaxKernelKMeans
from repro.data import blob_ring as jax_blob_ring
from repro.fleet import AdaptiveWaitController as JaxWaitController
from repro.fleet import AdmissionController as JaxAdmission
from repro.fleet import Fleet as JaxFleet
from repro.fleet import Router as JaxRouter
from repro.fleet import ShedError as JaxShedError
from repro.serve import LatencyStats as JaxLatencyStats
from repro.serve import VersionStore as JaxVersionStore
from repro_torch.api import KernelKMeans
from repro_torch.data import blob_ring
from repro_torch.fleet import (AdaptiveWaitController, AdmissionController,
                               Fleet, FleetWorker, RolloutManager, Router,
                               ShedError, benchmark_fleet)
from repro_torch.kernels.registry import near_tie_compare
from repro_torch.serve import (AsyncBatcher, ComputePolicy, Extender,
                               LatencyStats, VersionStore, assign)
from repro_torch.serve.latency import Histogram

N, P, R, K, BLOCK = 250, 2, 2, 2, 64
CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance_ms(self, ms):
        self.t += ms / 1e3


@pytest.fixture(scope="module")
def model():
    X, _ = blob_ring(0, n=N)
    return KernelKMeans(k=K, r=R, kernel="polynomial",
                        kernel_params={"gamma": 0.0, "degree": 2},
                        backend_params={"oversampling": 10}, block=BLOCK,
                        device=CPU).fit(X, seed=1).model_


@pytest.fixture(scope="module")
def model_b(model):
    # Reversed centroid rows: same geometry, permuted labels — which
    # version served a request is readable from its labels.
    return model._replace(centroids=model.centroids.flip(0).contiguous())


@pytest.fixture()
def store(tmp_path, model):
    s = VersionStore(str(tmp_path / "versions"))
    s.publish(model)
    return s


def _requests(widths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(P, w).astype(np.float32) for w in widths]


def _worker(worker_id, store, **kw):
    return FleetWorker(worker_id, store, device=CPU, **kw)


# ---------------------------------------------------------------------------
# LatencyStats.merge: tier aggregation must equal a single stream
# ---------------------------------------------------------------------------

def _record(stats, t0, wait_ms, extra_ms, bucket):
    stats.record(t0, t0 + wait_ms / 1e3, t0 + (wait_ms + extra_ms) / 1e3,
                 queries=3, bucket=bucket)


def test_merge_equals_single_stream_on_interleaved_samples():
    rng = np.random.RandomState(7)
    workers = [LatencyStats(slo_ms=50.0) for _ in range(3)]
    single = LatencyStats(slo_ms=50.0)
    for i in range(300):
        wait, extra = rng.exponential(5.0), rng.exponential(30.0)
        bucket = int(2 ** rng.randint(3, 7))
        _record(workers[i % 3], float(i), wait, extra, bucket)
        _record(single, float(i), wait, extra, bucket)
    merged = LatencyStats.merged(workers)
    got, want = merged.summary(), single.summary()
    # Fixed shared edges: percentiles and counters are exact; the means
    # fold float sums in another order and may differ in the last ulp.
    for d in (got, want):
        d["latency_ms"]["mean"] = round(d["latency_ms"]["mean"], 9)
        for row in d["per_bucket"].values():
            row["mean"] = round(row["mean"], 9)
    assert got == want
    assert merged.requests == 300 and merged.queries == 900
    assert workers[0].requests == 100     # non-mutating


def test_merge_is_exact_at_every_percentile():
    a, b = LatencyStats(), LatencyStats()
    single = LatencyStats()
    for i, ms in enumerate([0.1, 1.0, 5.0, 42.0, 999.0, 0.5, 7.0, 80.0]):
        target = a if i % 2 == 0 else b
        _record(target, 0.0, ms / 2, ms / 2, None)
        _record(single, 0.0, ms / 2, ms / 2, None)
    m = LatencyStats.merged([a, b])
    for q in (1.0, 25.0, 50.0, 90.0, 95.0, 99.0, 100.0):
        assert m.total.percentile(q) == single.total.percentile(q)
        assert m.queue_wait.percentile(q) == single.queue_wait.percentile(q)


def test_merge_rejects_mismatched_slo():
    a, b = LatencyStats(slo_ms=50.0), LatencyStats(slo_ms=100.0)
    with pytest.raises(ValueError, match="different SLO"):
        a.merge(b)
    empty = LatencyStats()                # an empty aggregate adopts it
    empty.merge(b)
    assert empty.slo_ms == 100.0
    dirty = LatencyStats()                # one with samples refuses
    _record(dirty, 0.0, 1.0, 1.0, None)
    with pytest.raises(ValueError, match="different SLO"):
        dirty.merge(b)


def test_histogram_merge_folds_counts_min_max():
    a, b = Histogram(), Histogram()
    for ms in (1.0, 2.0, 3.0):
        a.record(ms)
    for ms in (0.5, 10.0):
        b.record(ms)
    out = a.merge(b)
    assert out is a
    assert a.n == 5
    assert a.min == 0.5 and a.max == 10.0
    assert abs(a.total - 16.5) < 1e-9


# ---------------------------------------------------------------------------
# VersionStore pins: GC must never delete a version a worker holds
# ---------------------------------------------------------------------------

def test_gc_spares_pinned_versions(tmp_path, model):
    s = VersionStore(str(tmp_path / "v"))
    v1 = s.publish(model)
    v2 = s.publish(model)
    v3 = s.publish(model)
    s.pin(v1, "w0")
    s.pin(v1, "w1")
    assert s.pins(v1) == ["w0", "w1"]
    assert s.gc(keep=1) == [v2]           # pinned v1 survives
    assert s.versions() == [v1, v3]
    s.load(v1, device=CPU)
    s.unpin(v1, "w0")                     # one of two pins is not enough
    assert s.gc(keep=1) == []
    s.unpin(v1, "w1")
    assert s.gc(keep=1) == [v1]
    assert s.versions() == [v3]
    assert s.pins(v1) == []


def test_pin_unpin_edge_cases(tmp_path, model):
    s = VersionStore(str(tmp_path / "v"))
    v1 = s.publish(model)
    with pytest.raises(FileNotFoundError):
        s.pin(v1 + 7, "w0")
    s.pin(v1, "w0")
    s.unpin(v1, "w0")
    s.unpin(v1, "w0")                     # idempotent
    s.unpin(v1 + 7, "w0")                 # a ghost: no-op
    assert s.pins(v1) == []


def test_worker_pin_lifecycle_guards_gc(store, model_b):
    w = _worker("w0", store, clock=FakeClock())
    v1 = w.version
    assert store.pins(v1) == ["w0"]
    v2 = store.publish(model_b)
    store.gc(keep=1)
    assert v1 in store.versions()
    w.swap_to(v2)                         # pin new BEFORE old released
    assert store.pins(v2) == ["w0"] and store.pins(v1) == []
    assert w.registry.get("served").centroids.device.type == CPU
    assert store.gc(keep=1) == [v1]
    w.stop()
    assert store.pins(v2) == []


@pytest.mark.parametrize("build", ["worker", "fleet"])
def test_no_device_means_the_card_and_never_a_fallback(store, monkeypatch,
                                                       build):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if build == "worker":
            FleetWorker("w0", store)
        else:
            Fleet(store, n_workers=2)
    assert store.pins(store.latest()) == []   # refused before pinning


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------

class StubWorker:
    def __init__(self, worker_id, depth=0):
        self.worker_id = worker_id
        self._depth = depth

    def depth(self):
        return self._depth


def test_least_loaded_routes_to_smallest_queue():
    ws = [StubWorker("a", 5), StubWorker("b", 2), StubWorker("c", 9)]
    r = Router(ws)
    assert r.route().worker_id == "b"
    ws[1]._depth = 100
    assert r.route().worker_id == "a"     # the load signal is live
    ws[0]._depth = ws[2]._depth = 100
    assert r.route().worker_id == "a"     # ties break by id


def test_hash_routing_is_sticky_and_covers_the_fleet():
    r = Router([StubWorker(f"w{i}") for i in range(4)], policy="hash")
    keys = [f"session-{i}" for i in range(400)]
    first = {k: r.route(k).worker_id for k in keys}
    assert first == {k: r.route(k).worker_id for k in keys}
    assert len(set(first.values())) == 4


def test_hash_routing_remaps_only_the_removed_workers_keys():
    r = Router([StubWorker(f"w{i}") for i in range(4)], policy="hash")
    keys = [f"k{i}" for i in range(500)]
    before = {k: r.route(k).worker_id for k in keys}
    r.remove("w2")
    after = {k: r.route(k).worker_id for k in keys}
    moved = [k for k in keys if before[k] != after[k]]
    assert all(before[k] == "w2" for k in moved)
    assert not any(after[k] == "w2" for k in keys)


@pytest.mark.parametrize("case", ["duplicate", "ghost", "no-key", "policy",
                                  "empty"])
def test_router_membership_errors(case):
    if case == "duplicate":
        with pytest.raises(ValueError, match="duplicate"):
            Router([StubWorker("a")]).add(StubWorker("a"))
    elif case == "ghost":
        with pytest.raises(KeyError):
            Router([StubWorker("a")]).remove("ghost")
    elif case == "no-key":
        with pytest.raises(ValueError, match="routing key"):
            Router([StubWorker("a")], policy="hash").route()
    elif case == "policy":
        with pytest.raises(ValueError, match="policy"):
            Router([], policy="round-robin")
    else:
        with pytest.raises(RuntimeError, match="no workers"):
            Router([]).route()


@pytest.mark.parametrize("n_workers,vnodes", [(2, 64), (4, 64), (5, 8)])
def test_router_places_keys_as_jax_does(n_workers, vnodes):
    ids = [f"w{i}" for i in range(n_workers)]
    ours = Router([StubWorker(i) for i in ids], policy="hash", vnodes=vnodes)
    theirs = JaxRouter([StubWorker(i) for i in ids], policy="hash",
                       vnodes=vnodes)
    keys = [f"key-{i}" for i in range(1000)]
    assert [ours.route(k).worker_id for k in keys] == \
        [theirs.route(k).worker_id for k in keys]
    ours.remove("w1")
    theirs.remove("w1")
    assert [ours.route(k).worker_id for k in keys] == \
        [theirs.route(k).worker_id for k in keys]


def test_least_loaded_picks_as_jax_does():
    rng = np.random.RandomState(3)
    ws = [StubWorker(f"w{i}") for i in range(4)]
    ours, theirs = Router(ws), JaxRouter(ws)
    for _ in range(200):
        for w, d in zip(ws, rng.randint(0, 4, size=4)):
            w._depth = int(d)
        assert ours.route().worker_id == theirs.route().worker_id


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------

def test_static_cap_sheds_queue_full():
    ac = AdmissionController(max_queue_depth=10)
    assert ac.admit(StubWorker("a", depth=6), 4).worker_id == "a"
    with pytest.raises(ShedError) as ei:
        ac.admit(StubWorker("a", depth=7), 4)
    assert ei.value.reason == "queue-full"
    assert ei.value.depth == 7 and ei.value.limit == 10
    assert ac.admitted == 1 and ac.shed == 1 and ac.shed_rate == 0.5


def test_breaker_tightens_cap_until_p99_recovers():
    ac = AdmissionController(max_queue_depth=100, slo_ms=50.0,
                             shed_factor=0.5)
    assert ac.effective_depth() == 100
    assert ac.update(80.0) is True
    assert ac.effective_depth() == 50
    with pytest.raises(ShedError) as ei:
        ac.admit(StubWorker("a", depth=60), 1)
    assert ei.value.reason == "slo-breach"
    assert ac.update(10.0) is False
    assert ac.effective_depth() == 100
    ac.admit(StubWorker("a", depth=60), 1)
    assert ac.summary()["shed_by_reason"] == {"slo-breach": 1}


@pytest.mark.parametrize("kwargs", [{"max_queue_depth": 0},
                                    {"shed_factor": 0.0}])
def test_admission_validates_construction(kwargs):
    with pytest.raises(ValueError):
        AdmissionController(**kwargs)


def test_admission_decides_as_jax_does():
    """One scripted sequence of tier p99 updates and (depth, width)
    requests: the same admits, sheds, reasons and summary."""
    rng = np.random.RandomState(11)
    ours = AdmissionController(max_queue_depth=64, slo_ms=100.0,
                               shed_factor=0.25)
    theirs = JaxAdmission(max_queue_depth=64, slo_ms=100.0,
                          shed_factor=0.25)
    for step in range(300):
        if step % 10 == 0:
            p99 = float(rng.uniform(0.0, 200.0))
            assert ours.update(p99) == theirs.update(p99)
        w = StubWorker("w0", depth=int(rng.randint(0, 80)))
        width = int(rng.randint(1, 40))
        got = want = "admit"
        try:
            ours.admit(w, width)
        except ShedError as e:
            got = (e.reason, e.depth, e.limit)
        try:
            theirs.admit(w, width)
        except JaxShedError as e:
            want = (e.reason, e.depth, e.limit)
        assert got == want
    assert ours.summary() == theirs.summary()
    assert ours.shed > 0 and ours.admitted > 0


# ---------------------------------------------------------------------------
# Per-bucket deadlines + the AIMD wait controller
# ---------------------------------------------------------------------------

def test_per_bucket_wait_overrides_the_flush_deadline(model):
    clock = FakeClock()
    ab = AsyncBatcher(model, max_wait_ms=5.0, clock=clock, max_bucket=128)
    ab.set_bucket_wait(8, 1.0)
    ab.submit(_requests([3])[0])          # coalesces to bucket 8
    clock.advance_ms(1.0)
    assert ab.due()                       # the override applies
    assert ab.poll() == 1
    ab.submit(_requests([3])[0])
    ab.submit(_requests([30])[0])         # now bucket 64: the default
    clock.advance_ms(2.0)
    assert not ab.due()
    clock.advance_ms(3.0)
    assert ab.poll() == 2
    assert ab.bucket_wait(8) == 1.0 and ab.bucket_wait(64) == 5.0
    with pytest.raises(ValueError):
        ab.set_bucket_wait(8, 0.0)


def test_controller_decreases_wait_on_breached_bucket(store):
    clock = FakeClock()
    w = _worker("w0", store, max_wait_ms=8.0, slo_ms=200.0, clock=clock)
    ctl = AdaptiveWaitController(200.0, min_samples=1, min_wait_ms=0.25)
    w.submit(_requests([3])[0])           # 150 ms >> budget 100 ms
    clock.advance_ms(150.0)
    w.flush()
    (adj,) = ctl.step(w)
    assert adj["action"] == "decrease"
    assert adj["wait_after_ms"] == 4.0    # multiplicative: 8 -> 4
    assert w.scheduler().bucket_wait(adj["bucket"]) == 4.0
    assert ctl.step(w) == []              # no fresh traffic: hold
    for _ in range(12):
        w.submit(_requests([3])[0])
        clock.advance_ms(150.0)
        w.flush()
        ctl.step(w)
    assert w.scheduler().bucket_wait(adj["bucket"]) == 0.25
    w.stop()


def test_controller_increases_wait_on_comfortable_bucket(store):
    clock = FakeClock()
    w = _worker("w0", store, max_wait_ms=2.0, slo_ms=200.0, clock=clock)
    ctl = AdaptiveWaitController(200.0, min_samples=8, increase_ms=0.5,
                                 max_wait_ms=3.0)
    for _ in range(8):                    # fast traffic: ~1 ms
        w.submit(_requests([3])[0])
        clock.advance_ms(1.0)
        w.flush()
    (adj,) = ctl.step(w)
    assert adj["action"] == "increase"
    assert adj["wait_after_ms"] == 2.5    # additive
    for _ in range(4):
        for _ in range(8):
            w.submit(_requests([3])[0])
            clock.advance_ms(1.0)
            w.flush()
        ctl.step(w)
    assert w.scheduler().bucket_wait(adj["bucket"]) == 3.0
    w.stop()


def test_controller_needs_min_samples_before_acting(store):
    clock = FakeClock()
    w = _worker("w0", store, max_wait_ms=2.0, slo_ms=200.0, clock=clock)
    ctl = AdaptiveWaitController(200.0, min_samples=8)
    for _ in range(7):                    # one short of the window
        w.submit(_requests([3])[0])
        clock.advance_ms(1.0)
        w.flush()
    assert ctl.step(w) == []
    w.stop()


@pytest.mark.parametrize("kwargs", [{"slo_ms": 0.0},
                                    {"slo_ms": 100.0,
                                     "decrease_factor": 1.0}])
def test_controller_validates_construction(kwargs):
    with pytest.raises(ValueError):
        AdaptiveWaitController(**kwargs)


class _StubScheduler:
    def __init__(self):
        self.waits = {}

    def bucket_wait(self, bucket):
        return self.waits.get(int(bucket), 2.0)

    def set_bucket_wait(self, bucket, ms):
        self.waits[int(bucket)] = float(ms)


class _StatsWorker:
    """Duck-typed worker: a LatencyStats and a scheduler of waits."""

    def __init__(self, worker_id, stats):
        self.worker_id = worker_id
        self.latency = stats
        self._sched = _StubScheduler()

    def scheduler(self):
        return self._sched


def test_wait_controller_adjusts_as_jax_does():
    rng = np.random.RandomState(13)
    kw = dict(min_samples=4, min_wait_ms=0.25, max_wait_ms=16.0)
    ours = AdaptiveWaitController(120.0, **kw)
    theirs = JaxWaitController(120.0, **kw)
    a = _StatsWorker("w0", LatencyStats(slo_ms=120.0))
    b = _StatsWorker("w0", JaxLatencyStats(slo_ms=120.0))
    steps = 0
    for period in range(40):
        for _ in range(int(rng.randint(0, 12))):
            bucket = int(2 ** rng.randint(3, 7))
            ms = float(rng.choice([rng.exponential(10.0),
                                   rng.uniform(40.0, 200.0)]))
            for w in (a, b):
                _record(w.latency, float(period), ms / 4, ms * 3 / 4, bucket)
        got, want = ours.step(a), theirs.step(b)
        assert got == want
        steps += len(got)
    assert a._sched.waits == b._sched.waits and steps > 0


# ---------------------------------------------------------------------------
# Rollouts: canary-then-promote, rollback on breach
# ---------------------------------------------------------------------------

def test_rollout_promotes_canary_first_then_fleet(store, model_b):
    clock = FakeClock()
    workers = [_worker(f"w{i}", store, clock=clock) for i in range(3)]
    v1 = workers[0].version
    v2 = store.publish(model_b)
    seen = []
    mgr = RolloutManager(workers, store, budget_ms=100.0,
                         probe=lambda w: seen.append(
                             [x.version for x in workers]) or 0.0)
    rep = mgr.rollout()
    assert rep.promoted and rep.state == "done"
    assert [s for s, _ in rep.timeline] == \
        ["canary", "probing", "promoting", "done"]
    assert seen == [[v2, v1, v1]]         # only the canary had swapped
    assert all(w.version == v2 for w in workers)
    assert rep.old_versions == {"w0": v1, "w1": v1, "w2": v1}
    assert set(rep.swaps) == {f"w{i}->v{v2}" for i in range(3)}
    assert mgr.rollout() is None          # idempotent
    for w in workers:
        w.stop()


def test_breached_probe_rolls_back_and_restores_version(store, model_b):
    clock = FakeClock()
    workers = [_worker(f"w{i}", store, clock=clock) for i in range(2)]
    v1 = workers[0].version
    v2 = store.publish(model_b)
    mgr = RolloutManager(workers, store, budget_ms=100.0,
                         probe=lambda w: 350.0)
    pend = [w.submit(r) for w in workers for r in _requests([4])]
    rep = mgr.rollout(v2)
    for w in workers:
        w.flush()
    assert not rep.promoted and rep.state == "rolled-back"
    assert [s for s, _ in rep.timeline] == ["canary", "probing",
                                            "rolled-back"]
    assert all(w.version == v1 for w in workers)
    assert rep.canary_p95_ms == 350.0
    assert set(rep.swaps) == {f"w0->v{v2}", f"w0->v{v1}"}
    assert sum(not f.done() for f in pend) == 0
    assert v2 in store.versions()
    assert store.pins(v1) == ["w0", "w1"]          # guard pin released
    for w in workers:
        w.stop()


def test_single_worker_rollback_survives_concurrent_gc(store, model_b):
    clock = FakeClock()
    w = _worker("w0", store, clock=clock)
    v1 = w.version
    v2 = store.publish(model_b)

    def probe_with_gc(worker):
        store.gc(keep=1)                  # hostile GC mid-decision
        return 999.0

    rep = RolloutManager([w], store, budget_ms=10.0).rollout(
        v2, probe=probe_with_gc)
    assert rep.state == "rolled-back" and w.version == v1
    assert torch.equal(store.load(v1, device=CPU).centroids,
                       store.load(w.version, device=CPU).centroids)
    w.stop()


# ---------------------------------------------------------------------------
# Fleet front door, end to end
# ---------------------------------------------------------------------------

def test_fleet_routed_labels_match_direct_assignment(store, model):
    clock = FakeClock()
    with Fleet(store, n_workers=3, clock=clock, max_wait_ms=2.0,
               device=CPU) as fleet:
        reqs = _requests([5, 17, 2, 31, 9, 24], seed=3)
        futs = [fleet.submit(r) for r in reqs]
        assert fleet.depth() == sum(r.shape[1] for r in reqs)
        fleet.flush()
        got = np.concatenate([f.result()[0] for f in futs])
        want, _ = assign(model, np.concatenate(reqs, axis=1))
        np.testing.assert_array_equal(got, want.numpy())
        assert fleet.latency().requests == len(reqs)
    assert all(store.pins(v) == [] for v in store.versions())


def test_fleet_overload_sheds_but_keeps_admitted_p99_in_slo(store):
    clock = FakeClock()
    fleet = Fleet(store, n_workers=2, max_queue_depth=8, slo_ms=250.0,
                  clock=clock, max_wait_ms=2.0, device=CPU)
    futs, shed = [], 0
    for r in _requests([4] * 32, seed=5):
        clock.advance_ms(1.0)
        try:
            futs.append(fleet.submit(r))
        except ShedError as e:
            assert e.reason == "queue-full"
            shed += 1
    fleet.flush()
    assert shed > 0
    assert len(futs) == 4                        # 2 workers x depth 8 / 4
    assert sum(not f.done() for f in futs) == 0
    stats = fleet.latency()
    assert stats.total.percentile(99.0) <= 250.0
    assert stats.slo_violations == 0
    assert fleet.admission.shed_rate == shed / 32
    assert fleet.stats()["admission"]["shed_by_reason"] == \
        {"queue-full": shed}
    fleet.stop()


def test_fleet_control_loop_closes_both_feedbacks(store):
    clock = FakeClock()
    fleet = Fleet(store, n_workers=2, slo_ms=100.0, max_queue_depth=100,
                  clock=clock, max_wait_ms=2.0, device=CPU)
    for r in _requests([3] * 4):
        fleet.submit(r)
        clock.advance_ms(3.0)             # past every deadline
    ctl = fleet.control()
    assert ctl["completed"] == 4
    assert ctl["breaker_open"] is False
    assert ctl["p99_ms"] <= 100.0
    fleet.admission.update(500.0)
    with pytest.raises(ShedError) as ei:
        fleet.submit(_requests([60])[0])  # over the tightened cap of 50
    assert ei.value.reason == "slo-breach"
    fleet.stop()


def test_fleet_rollout_and_sync_follow_the_store(store, model, model_b):
    clock = FakeClock()
    fleet = Fleet(store, n_workers=2, clock=clock, rollout_budget_ms=100.0,
                  device=CPU)
    assert fleet.sync() is None
    v2 = store.publish(model_b)
    rep = fleet.sync()
    assert rep is not None and rep.promoted
    assert fleet.stats()["versions"] == {"w0": v2, "w1": v2}
    r = _requests([16], seed=9)[0]
    fut = fleet.submit(r)
    fleet.flush()
    want_new, _ = assign(model_b, r)
    want_old, _ = assign(model, r)
    np.testing.assert_array_equal(fut.result()[0], want_new.numpy())
    assert not torch.equal(want_new, want_old)
    fleet.stop()
    assert all(store.pins(v) == [] for v in store.versions())


def test_benchmark_fleet_on_the_cpu(model):
    """The soak bench with live pumps: its own gates hold (no shed in the
    sweep, shed > 0 under overload with admitted p99 in the SLO, promote
    and rollback with 0 stranded futures)."""
    out = benchmark_fleet(model, worker_counts=(1, 2), n_requests=24,
                          seed=np.random.default_rng(0), max_bucket=64,
                          device=CPU)
    assert [row["workers"] for row in out["sweep"]] == [1, 2]
    assert all(row["queries_per_sec"] > 0 for row in out["sweep"])
    assert out["scaling"]["workers_max"] == 2
    assert out["overload"]["shed"] > 0 and out["overload"]["within_slo"]
    assert out["rollout"]["stranded_futures"] == 0
    assert out["rollout"]["promote"]["promoted"]
    assert out["rollout"]["rollback"]["state"] == "rolled-back"


# ---------------------------------------------------------------------------
# The same tier against the JAX package's, on one JAX-published store
# ---------------------------------------------------------------------------

def _plain_distances(model, Xq):
    plain = Extender(model, policy=ComputePolicy(embed_fused=False,
                                                 assign_fused=False))
    emb = plain.embed(torch.from_numpy(Xq)).T.double()
    return ((emb[:, None, :] - model.centroids.double()[None]) ** 2
            ).sum(-1).numpy()


def _serve_both(ours, theirs, reqs):
    futs = [(ours.submit(r), theirs.submit(r)) for r in reqs]
    ours.flush()
    theirs.flush()
    got = [np.concatenate([f[0].result()[i] for f in futs]) for i in (0, 1)]
    want = [np.concatenate([np.asarray(f[1].result()[i]) for f in futs])
            for i in (0, 1)]
    return got, want


def test_port_fleet_serves_a_jax_published_store(tmp_path):
    X, _ = jax_blob_ring(jax.random.PRNGKey(0), n=N)
    jm = JaxKernelKMeans(k=K, r=R, kernel="polynomial",
                         kernel_params={"gamma": 0.0, "degree": 2},
                         backend_params={"oversampling": 10},
                         block=BLOCK).fit(X, key=jax.random.PRNGKey(1)).model_
    jm_b = jm._replace(centroids=jm.centroids[::-1])
    # One store each (the pin owners w0, w1 would collide in one), the
    # same JAX-written artifacts in both.
    roots = [str(tmp_path / name) for name in ("port", "jax")]
    JaxVersionStore(roots[1]).publish(jm)
    shutil.copytree(roots[1], roots[0])
    clock = FakeClock()
    ours = Fleet(roots[0], n_workers=2, clock=clock, device=CPU,
                 rollout_budget_ms=100.0)
    theirs = JaxFleet(roots[1], n_workers=2, clock=clock,
                      rollout_budget_ms=100.0)
    widths = np.random.RandomState(0).randint(1, 65, size=12)
    reqs = _requests(widths, seed=0)
    Xcat = np.concatenate(reqs, axis=1)
    served = ours.workers[0].registry.get("served")
    got, want = _serve_both(ours, theirs, reqs)
    near_tie_compare(got, want, 1e-4, 1e-4, _plain_distances(served, Xcat))
    assert ours.stats()["versions"] == theirs.stats()["versions"]

    v2 = [JaxVersionStore(root).publish(jm_b) for root in roots]
    assert v2[0] == v2[1]
    reports = [ours.rollout(v2[0]), theirs.rollout(v2[1])]
    assert [r.state for r in reports] == ["done", "done"]
    assert reports[0].promoted == reports[1].promoted
    assert [s for s, _ in reports[0].timeline] == \
        [s for s, _ in reports[1].timeline]
    assert set(reports[0].swaps) == set(reports[1].swaps)
    assert reports[0].old_versions == reports[1].old_versions
    assert ours.stats()["versions"] == theirs.stats()["versions"] == \
        {"w0": v2[0], "w1": v2[0]}
    got_b, want_b = _serve_both(ours, theirs, reqs)
    near_tie_compare(got_b, want_b, 1e-4, 1e-4, _plain_distances(
        ours.workers[0].registry.get("served"), Xcat))
    assert np.array_equal(got_b[0], K - 1 - got[0])
    ours.stop()
    theirs.stop()
    store = VersionStore(roots[0])
    assert all(store.pins(v) == [] for v in store.versions())


# ---------------------------------------------------------------------------
# The lock contract, checked by the JAX package's analysis pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["worker", "router", "admission"])
def test_fleet_declares_and_passes_lock_contract(name):
    rel = f"src/repro_torch/fleet/{name}.py"
    src = open(os.path.join(REPO, rel)).read()
    assert "# guarded-by: _lock" in src
    assert locks.check_file(os.path.join(REPO, rel), rel) == []
