"""Admission control: shed load BEFORE it poisons the tail latency.

An overloaded serving tier has exactly two choices: queue everything and
watch p99 blow through the SLO for *every* request, or reject the excess
at the front door and keep the admitted traffic's latency bounded. This
module is the second choice, two mechanisms deep:

queue-depth cap   each worker may hold at most `max_queue_depth` query
                  columns; a request that would push its routed worker
                  past the cap is shed (`ShedError`, reason
                  "queue-full"). The cap IS the latency bound: admitted
                  work never waits behind more than max_queue_depth
                  columns of compute, so admitted p99 stays within the
                  SLO by construction — the property the fleet soak
                  bench gates.

SLO breaker       `update(p99_ms)` feeds the tier-level p99 (merged
                  LatencyStats) back in; while it breaches `slo_ms` the
                  controller tightens the effective cap by
                  `shed_factor` (reason "slo-breach" sheds) until the
                  tail recovers — classic closed-loop load shedding:
                  the breach signal lags, so the breaker keeps shedding
                  harder than the static cap until the signal clears.

Shedding is typed (`ShedError`), never silent: the caller sees which
worker, what depth, which reason — a load balancer retries elsewhere, a
client backs off. Counters (admitted/shed per reason) are the bench's
shed-rate read-out, lock-guarded because submits race the breaker update.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from repro_torch.fleet.worker import FleetWorker


class ShedError(RuntimeError):
    """A request the fleet refused to enqueue (typed, never silent).

    reason is "queue-full" (static per-worker cap) or "slo-breach" (the
    breaker tightened the cap while tier p99 exceeds the SLO)."""

    def __init__(self, worker_id: str, depth: int, limit: int,
                 reason: str):
        self.worker_id = worker_id
        self.depth = int(depth)
        self.limit = int(limit)
        self.reason = reason
        super().__init__(
            f"shed ({reason}): worker {worker_id!r} queue depth {depth} "
            f"+ request would exceed limit {limit}")


class AdmissionController:
    """Per-worker queue caps + an SLO feedback breaker.

    max_queue_depth: admitted query columns a worker may queue (the
        static cap; sized so cap/throughput < the SLO budget).
    slo_ms: tier p99 target for the breaker (None disables feedback —
        the static cap still applies).
    shed_factor: multiplier on the cap while the breaker is open
        (0.5 = admit only half a queue until p99 recovers).
    """

    def __init__(self, max_queue_depth: int = 2048,
                 slo_ms: Optional[float] = None,
                 shed_factor: float = 0.5):
        if max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1, "
                             f"got {max_queue_depth}")
        if not 0.0 < shed_factor <= 1.0:
            raise ValueError(f"shed_factor must be in (0, 1], "
                             f"got {shed_factor}")
        self.max_queue_depth = int(max_queue_depth)
        self.slo_ms = slo_ms
        self.shed_factor = float(shed_factor)
        self._lock = threading.Lock()
        self._breaker_open = False            # guarded-by: _lock
        self._last_p99_ms = 0.0               # guarded-by: _lock
        self._admitted = 0                    # guarded-by: _lock
        self._shed: Dict[str, int] = {}       # guarded-by: _lock

    # -- feedback --------------------------------------------------------

    def update(self, p99_ms: float) -> bool:
        """Feed the tier p99 back in; returns True while the breaker is
        open (tier p99 over SLO -> effective caps tightened)."""
        with self._lock:
            self._last_p99_ms = float(p99_ms)
            self._breaker_open = (self.slo_ms is not None
                                  and p99_ms > self.slo_ms)
            return self._breaker_open

    @property
    def breaker_open(self) -> bool:
        with self._lock:
            return self._breaker_open

    def effective_depth(self) -> int:
        """The cap currently enforced (tightened while the breaker is
        open, never below one bucket's worth of columns)."""
        with self._lock:
            open_ = self._breaker_open
        if not open_:
            return self.max_queue_depth
        return max(int(self.max_queue_depth * self.shed_factor), 1)

    # -- the gate --------------------------------------------------------

    def admit(self, worker: FleetWorker, width: int) -> FleetWorker:
        """Admit a `width`-column request onto `worker` or raise ShedError.

        Returns the worker so the fleet's submit reads
        `admission.admit(router.route(key), w).submit(Xq)`."""
        limit = self.effective_depth()
        depth = worker.depth()
        if depth + int(width) > limit:
            reason = "slo-breach" if self.breaker_open else "queue-full"
            with self._lock:
                self._shed[reason] = self._shed.get(reason, 0) + 1
            raise ShedError(worker.worker_id, depth, limit, reason)
        with self._lock:
            self._admitted += 1
        return worker

    # -- read-outs -------------------------------------------------------

    @property
    def admitted(self) -> int:
        with self._lock:
            return self._admitted

    @property
    def shed(self) -> int:
        with self._lock:
            return sum(self._shed.values())

    @property
    def shed_rate(self) -> float:
        """Shed requests / offered requests (0.0 before any traffic)."""
        with self._lock:
            shed = sum(self._shed.values())
            offered = self._admitted + shed
        return shed / offered if offered else 0.0

    def summary(self) -> Dict:
        """JSON-ready counters (the bench's overload section)."""
        with self._lock:
            shed = dict(self._shed)
            return {
                "max_queue_depth": self.max_queue_depth,
                "effective_depth": self.max_queue_depth if not
                self._breaker_open else max(
                    int(self.max_queue_depth * self.shed_factor), 1),
                "slo_ms": self.slo_ms,
                "breaker_open": self._breaker_open,
                "last_p99_ms": self._last_p99_ms,
                "admitted": self._admitted,
                "shed": sum(shed.values()),
                "shed_by_reason": shed,
                "shed_rate": (sum(shed.values()) /
                              (self._admitted + sum(shed.values()))
                              if self._admitted + sum(shed.values())
                              else 0.0),
            }
