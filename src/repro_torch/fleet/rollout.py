"""Fleet-wide rollout: canary-then-promote with SLO-gated rollback.

A single-process hot-swap (ModelRegistry.swap) already makes one
replica's flip safe; a fleet needs an ORDER. The state machine here is
the standard one:

    idle -> canary     ONE worker (the canary) warm-swaps to the target
                       version; everyone else keeps serving the old one
    canary -> probing  post-swap traffic is driven through the canary
                       and its p95 measured — through the REAL serving
                       path, warmed executables, on the canary only
    probing -> promoting   p95 <= budget: the remaining workers swap,
                           one by one (each is a warm swap, so the
                           fleet never has a cold replica)
    probing -> rolled-back p95 > budget: the canary swaps BACK to the
                           version it came from; nobody else ever saw
                           the bad version
    promoting -> done

Every transition is a warm `FleetWorker.swap_to` — in-flight requests
drain into the model that accepted them, so a rollout (or a rollback)
strands zero futures; the soak bench re-asserts it. Version pins make
the rollback always possible: the canary's OLD version stays pinned by
every not-yet-promoted worker, so no GC between canary and verdict can
delete the escape hatch.

The probe is injectable (`probe=`) because the gate is POLICY: the
default drives synthetic requests via `FleetWorker.probe_p95_ms`; a real
deployment would point it at shadow traffic; tests inject verdicts.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.fleet.worker import FleetWorker
from repro_torch.serve.versions import VersionStore

STATES = ("idle", "canary", "probing", "promoting", "done", "rolled-back")


@dataclasses.dataclass
class RolloutReport:
    """What one rollout did (the bench's rollout-timeline section)."""
    version: int                      # target version
    old_versions: Dict[str, int]      # worker_id -> version before
    canary_id: str
    canary_p95_ms: float              # the gate measurement
    budget_ms: float                  # promotion threshold
    promoted: bool                    # False = rolled back
    state: str                        # terminal state: done | rolled-back
    timeline: List[Tuple[str, float]]  # (state, seconds since start)
    wall_s: float
    swaps: Dict[str, Dict] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["timeline"] = [[s, t] for s, t in self.timeline]
        return d


class RolloutManager:
    """Drive canary-then-promote rollouts over a worker set.

    workers: the fleet's replicas; the FIRST is the canary by default
        (deterministic — rollouts are reproducible in tests).
    store: the shared VersionStore (targets default to its latest()).
    budget_ms: post-swap canary p95 threshold gating promotion.
    probe: callable(worker) -> p95_ms; defaults to the worker's
        synthetic self-probe.
    """

    def __init__(self, workers: Sequence[FleetWorker], store: VersionStore,
                 *, budget_ms: float,
                 probe: Optional[Callable[[FleetWorker], float]] = None):
        if not workers:
            raise ValueError("rollout needs at least one worker")
        self.workers = list(workers)
        self.store = store
        self.budget_ms = float(budget_ms)
        self.probe = probe if probe is not None \
            else (lambda w: w.probe_p95_ms())
        self.state = "idle"
        self.history: List[RolloutReport] = []

    def rollout(self, version: Optional[int] = None,
                canary: Optional[FleetWorker] = None,
                probe: Optional[Callable[[FleetWorker], float]] = None
                ) -> Optional[RolloutReport]:
        """Roll the fleet to `version` (default: store latest).

        Returns None when every worker already serves the target (a
        follower poll loop calls this unconditionally); otherwise the
        RolloutReport with the terminal state. Exactly one rollout runs
        at a time by construction — the manager is the fleet's single
        control loop, same single-writer discipline as RetrainWorker.
        """
        target = int(version if version is not None
                     else (self.store.latest() or 0))
        if target == 0:
            raise FileNotFoundError(f"no versions under {self.store.root}")
        old = {w.worker_id: w.version for w in self.workers}
        if all(v == target for v in old.values()):
            return None
        canary = canary if canary is not None else self.workers[0]
        probe = probe if probe is not None else self.probe
        t0 = time.perf_counter()
        timeline: List[Tuple[str, float]] = []
        swaps: Dict[str, Dict] = {}

        def enter(state: str) -> None:
            self.state = state
            timeline.append((state, time.perf_counter() - t0))

        def swap(worker: FleetWorker, v: int) -> None:
            rep = worker.swap_to(v)
            swaps[f"{worker.worker_id}->v{v}"] = {
                "flip_ms": rep.flip_ms, "warm_s": rep.warm_s,
                "drained_requests": rep.drained_requests}

        canary_old = canary.version
        # The canary's swap releases ITS pin on the outgoing version; on
        # a single-worker fleet nothing else would protect the rollback
        # target from a concurrent GC between swap and verdict. The
        # manager holds its own pin across the decision window.
        guard = f"rollout-guard-{canary.worker_id}"
        self.store.pin(canary_old, guard)
        try:
            enter("canary")
            swap(canary, target)
            enter("probing")
            p95 = float(probe(canary))
            if p95 > self.budget_ms:
                # Breach: the canary returns to the exact version it
                # left — still pinned by the guard (and by every
                # not-yet-promoted worker), so the load cannot fail.
                swap(canary, canary_old)
                enter("rolled-back")
                report = RolloutReport(
                    version=target, old_versions=old,
                    canary_id=canary.worker_id, canary_p95_ms=p95,
                    budget_ms=self.budget_ms, promoted=False,
                    state="rolled-back", timeline=timeline,
                    wall_s=time.perf_counter() - t0, swaps=swaps)
                self.history.append(report)
                return report
            enter("promoting")
            for w in self.workers:
                if w is not canary and w.version != target:
                    swap(w, target)
            enter("done")
        finally:
            self.store.unpin(canary_old, guard)
        report = RolloutReport(
            version=target, old_versions=old, canary_id=canary.worker_id,
            canary_p95_ms=p95, budget_ms=self.budget_ms, promoted=True,
            state="done", timeline=timeline,
            wall_s=time.perf_counter() - t0, swaps=swaps)
        self.history.append(report)
        return report
