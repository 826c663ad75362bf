"""Fleet tier: N serving workers behind one admission-controlled door.

The single-process serving stack (repro_torch.serve) ends at one
ModelRegistry in one process. This package is the tier above it:

    worker.py      FleetWorker — one replica: a private ModelRegistry
                   pinned to a VersionStore version (pin-before-load
                   closes the publish/GC race)
    router.py      Router — least-loaded or consistent-hash placement
    admission.py   AdmissionController / ShedError — queue-depth caps +
                   SLO breaker; shed at the door, keep admitted p99
                   bounded
    controller.py  AdaptiveWaitController — AIMD per-bucket max_wait_ms
                   tuning off the per-bucket latency breakdown
    rollout.py     RolloutManager — canary-then-promote version rollouts
                   gated on post-swap p95, rollback on breach
    tier.py        Fleet — the front door composing all of the above
    bench.py       benchmark_fleet — the gated soak bench

Workers communicate ONLY through the shared VersionStore on disk — no
in-memory channel — so the in-process topology used by tests and benches
is honestly the multi-process one. The modules, names and behaviour are
the JAX package's (repro.fleet); the replicas load onto `device=`, the
card unless the caller passes device="cpu".
"""
from repro_torch.fleet.admission import AdmissionController, ShedError
from repro_torch.fleet.bench import benchmark_fleet
from repro_torch.fleet.controller import AdaptiveWaitController
from repro_torch.fleet.rollout import RolloutManager, RolloutReport
from repro_torch.fleet.router import Router
from repro_torch.fleet.tier import Fleet
from repro_torch.fleet.worker import FleetWorker

__all__ = [
    "AdaptiveWaitController",
    "AdmissionController",
    "Fleet",
    "FleetWorker",
    "RolloutManager",
    "RolloutReport",
    "Router",
    "ShedError",
    "benchmark_fleet",
]
