"""Fleet: the multi-worker front door — route, admit, serve, roll out.

One object owns the whole tier:

    store ---------- shared VersionStore (the artifact bus on disk)
    workers[N] ----- FleetWorker replicas, each a private ModelRegistry
                     pinned to a version
    router --------- least-loaded / consistent-hash request placement
    admission ------ per-worker queue caps + SLO breaker (ShedError)
    wait_controller- AIMD per-bucket max_wait_ms tuning
    rollouts ------- canary-then-promote version rollouts

`submit(Xq, key=)` is the serving call: route -> admit (may raise
ShedError) -> worker enqueue; `control()` is one control-loop period:
poll every worker's deadline, merge per-worker LatencyStats into the
tier summary, feed tier p99 to the admission breaker and the per-bucket
breakdowns to the wait controller. The loop is cooperative (the caller
— a bench, a CLI, an event loop — owns the cadence), exactly like
AsyncBatcher.poll(): deterministic under test, pump-threaded in a real
deployment by calling start() on each worker's scheduler.

Bit-identity note: routing only decides WHICH replica runs a request,
and every replica serves an identical artifact version between
rollouts, so results are independent of the routing policy — the same
invariance micro-batching already guarantees within one worker.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.fleet.admission import AdmissionController
from repro_torch.fleet.controller import AdaptiveWaitController
from repro_torch.fleet.rollout import RolloutManager, RolloutReport
from repro_torch.fleet.router import Router
from repro_torch.fleet.worker import FleetWorker
from repro_torch.serve.latency import LatencyStats
from repro_torch.serve.versions import VersionStore


class Fleet:
    """N serving replicas behind one admission-controlled front door.

    store / store_root: the shared VersionStore (must hold >= 1 version).
    n_workers: replica count.
    routing: "least-loaded" | "hash" (see fleet/router.py).
    slo_ms: the tier's latency SLO — drives per-request violation
        accounting on every worker, the admission breaker, AND the
        adaptive wait controller's budget.
    max_queue_depth: admission cap per worker (query columns).
    max_wait_ms: initial flush deadline for every worker/bucket.
    rollout_budget_ms: canary post-swap p95 gate (default: slo_ms).
    adaptive_wait: False disables the wait controller (the knob stays
        at max_wait_ms everywhere).
    worker_kwargs: forwarded to every FleetWorker (device=, clock=,
        block=, policy=, ... — all replicas get the same construction;
        device defaults to the card).
    """

    def __init__(self, store, n_workers: int = 2, *,
                 routing: str = "least-loaded",
                 slo_ms: float = 250.0,
                 max_queue_depth: int = 2048,
                 max_wait_ms: float = 2.0,
                 shed_factor: float = 0.5,
                 rollout_budget_ms: Optional[float] = None,
                 adaptive_wait: bool = True,
                 version: Optional[int] = None,
                 **worker_kwargs):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.store = store if isinstance(store, VersionStore) \
            else VersionStore(str(store))
        self.slo_ms = float(slo_ms)
        self.workers: List[FleetWorker] = [
            FleetWorker(f"w{i}", self.store, version=version,
                        max_wait_ms=max_wait_ms, slo_ms=slo_ms,
                        **worker_kwargs)
            for i in range(int(n_workers))]
        self.router = Router(self.workers, policy=routing)
        self.admission = AdmissionController(
            max_queue_depth=max_queue_depth, slo_ms=slo_ms,
            shed_factor=shed_factor)
        self.wait_controller = (
            AdaptiveWaitController(slo_ms, max_wait_ms=max(
                max_wait_ms * 8, max_wait_ms)) if adaptive_wait else None)
        self.rollouts = RolloutManager(
            self.workers, self.store,
            budget_ms=(rollout_budget_ms if rollout_budget_ms is not None
                       else self.slo_ms))

    # -- serving ---------------------------------------------------------

    def submit(self, Xq, key: Optional[str] = None):
        """Route + admit + enqueue one request; returns its Future.

        Raises ShedError when admission refuses (the caller's backoff
        signal — nothing was enqueued anywhere)."""
        worker = self.router.route(key)
        return self.admission.admit(worker, Xq.shape[1]).submit(Xq)

    def poll(self) -> int:
        """Fire every worker's deadline trigger; returns requests run."""
        return sum(w.poll() for w in self.workers)

    def flush(self) -> int:
        """Force-flush every worker (drain the tier)."""
        return sum(w.flush() for w in self.workers)

    def depth(self) -> int:
        """Total queued query columns across the tier."""
        return sum(w.depth() for w in self.workers)

    def control(self) -> Dict:
        """One control period: poll deadlines, close both feedback loops.

        Merges per-worker LatencyStats into the tier summary, feeds the
        tier p99 to the admission breaker and the per-bucket breakdowns
        to the wait controller. Returns {"completed", "p99_ms",
        "breaker_open", "wait_adjustments"} — the soak bench's
        control-loop trace."""
        completed = self.poll()
        stats = self.latency()
        p99 = stats.total.percentile(99.0)
        breaker = self.admission.update(p99)
        adjust: List[Dict] = []
        if self.wait_controller is not None:
            for w in self.workers:
                adjust.extend(self.wait_controller.step(w))
        return {"completed": completed, "p99_ms": p99,
                "breaker_open": breaker, "wait_adjustments": adjust}

    # -- monitoring ------------------------------------------------------

    def latency(self) -> LatencyStats:
        """Tier-level aggregate: exact merge of every worker's stats."""
        return LatencyStats.merged([w.latency for w in self.workers])

    def latency_summary(self) -> Dict:
        return self.latency().summary()

    def stats(self) -> Dict:
        """JSON-ready tier health: per-worker rows + admission counters."""
        return {
            "workers": [w.stats() for w in self.workers],
            "admission": self.admission.summary(),
            "versions": {w.worker_id: w.version for w in self.workers},
            "latency": self.latency_summary(),
        }

    # -- lifecycle -------------------------------------------------------

    def rollout(self, version: Optional[int] = None,
                **kwargs) -> Optional[RolloutReport]:
        """Canary-then-promote the fleet to `version` (default latest)."""
        return self.rollouts.rollout(version, **kwargs)

    def sync(self) -> Optional[RolloutReport]:
        """Follower mode: rollout iff the store has a newer version."""
        return self.rollout()

    def stop(self) -> int:
        """Drain and retire every worker, release all pins; returns the
        requests the final drains flushed."""
        return sum(w.stop() for w in self.workers)

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, *exc_info) -> None:
        self.stop()
