"""AdaptiveWaitController: close the batching-vs-deadline loop per bucket.

`max_wait_ms` is the one knob with a real trade behind it: wait longer
and requests coalesce into bigger (cheaper per query) buckets; wait less
and every request keeps more deadline headroom. The per-bucket latency
breakdown (`LatencyStats.by_bucket`) is exactly the signal that says
which way each bucket should move — a fat p95 in ONE bucket is an
under-headroomed deadline there, not a fleet-wide problem — and the
per-bucket deadline override (`AsyncBatcher.set_bucket_wait`) is the
actuator. This module is the loop between them, AIMD-shaped like every
stable congestion controller:

    p95(bucket) >  budget       multiplicative DECREASE of the bucket's
                                wait (shed batching, buy headroom NOW —
                                breaches are expensive and lag the knob)
    p95(bucket) <= recover *    additive INCREASE (creep batching back
                   budget       one step per control period — cheap to
                                undo if the tail comes back)

where budget = slo_ms * headroom: the controller steers the bucket's p95
toward a fraction of the SLO, not the SLO itself, so compute jitter
lands in margin instead of violations. Decisions are per (worker,
bucket), only on fresh samples (a bucket that saw no traffic since the
last step holds), and bounded to [min_wait_ms, max_wait_ms] so a noisy
window can never drive the deadline to zero (no batching at all) or to
the SLO (no headroom at all).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.fleet.worker import FleetWorker


class AdaptiveWaitController:
    """AIMD controller over per-bucket flush deadlines.

    slo_ms: the latency SLO the fleet serves under.
    headroom: fraction of the SLO the per-bucket p95 may use before the
        controller trades batching away (budget = slo_ms * headroom).
    recover: fraction of the budget below which batching creeps back.
    min_wait_ms / max_wait_ms: hard bounds on any bucket's deadline.
    increase_ms / decrease_factor: the AI / MD step sizes.
    min_samples: fresh requests a bucket needs since the last step
        before its p95 is trusted (tiny windows are all jitter).
    """

    def __init__(self, slo_ms: float, *, headroom: float = 0.5,
                 recover: float = 0.5, min_wait_ms: float = 0.25,
                 max_wait_ms: float = 50.0, increase_ms: float = 0.5,
                 decrease_factor: float = 0.5, min_samples: int = 8):
        if slo_ms <= 0:
            raise ValueError(f"slo_ms must be positive, got {slo_ms!r}")
        if not 0.0 < headroom <= 1.0:
            raise ValueError(f"headroom must be in (0, 1], got {headroom}")
        if not 0.0 < decrease_factor < 1.0:
            raise ValueError(f"decrease_factor must be in (0, 1), "
                             f"got {decrease_factor}")
        if min_wait_ms <= 0 or max_wait_ms < min_wait_ms:
            raise ValueError(f"need 0 < min_wait_ms <= max_wait_ms, got "
                             f"{min_wait_ms} / {max_wait_ms}")
        self.slo_ms = float(slo_ms)
        self.budget_ms = float(slo_ms) * float(headroom)
        self.recover = float(recover)
        self.min_wait_ms = float(min_wait_ms)
        self.max_wait_ms = float(max_wait_ms)
        self.increase_ms = float(increase_ms)
        self.decrease_factor = float(decrease_factor)
        self.min_samples = int(min_samples)
        # (worker_id, bucket) -> requests seen at the last decision, so a
        # step only acts on buckets with fresh traffic. Single-writer
        # (the fleet's control loop), so no lock of its own.
        self._seen: Dict[Tuple[str, int], int] = {}

    def step(self, worker: FleetWorker) -> List[Dict]:
        """One control period for one worker; returns the adjustments.

        Each row: {worker, bucket, requests, p95_ms, wait_before_ms,
        wait_after_ms, action} with action in decrease/increase/hold —
        the rollout-timeline-style trace the fleet bench records.
        """
        sched = worker.scheduler()
        out: List[Dict] = []
        for bucket, hist in sorted(worker.latency.by_bucket.items()):
            key = (worker.worker_id, int(bucket))
            fresh = hist.n - self._seen.get(key, 0)
            before = sched.bucket_wait(bucket)
            if fresh < self.min_samples:
                continue                      # no fresh signal: hold
            self._seen[key] = hist.n
            p95 = hist.percentile(95.0)
            if p95 > self.budget_ms:
                after = max(before * self.decrease_factor,
                            self.min_wait_ms)
                action = "decrease"
            elif p95 <= self.budget_ms * self.recover:
                after = min(before + self.increase_ms, self.max_wait_ms)
                action = "increase"
            else:
                after, action = before, "hold"
            if after != before:
                sched.set_bucket_wait(bucket, after)
            out.append({"worker": worker.worker_id, "bucket": int(bucket),
                        "requests": int(hist.n), "fresh": int(fresh),
                        "p95_ms": float(p95),
                        "wait_before_ms": float(before),
                        "wait_after_ms": float(after), "action": action})
        return out

    def rebind(self) -> None:
        """Forget per-worker sample watermarks (after a worker set
        change or a latency-stats reset, stale watermarks would make
        every bucket look sample-starved or over-fresh)."""
        self._seen.clear()
