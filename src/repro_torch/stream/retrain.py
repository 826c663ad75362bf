"""The closed loop: drift trigger -> refit -> publish -> warm hot-swap.

`RetrainWorker` watches a `DriftMonitor` and, when a window fires,
drives the whole rollout against the existing serve stack:

    1. refit      `refit_fn(report)` produces the replacement
                  FittedModel — typically `KernelKMeans.partial_fit`
                  over the accumulated window, or a spec-driven refit
                  (`spec_to_estimator(old.spec).fit(X_accum, seed)`)
    2. publish    `VersionStore.publish()` commits it as the next
                  immutable version (atomic, GC'ed per the store policy)
    3. swap       `ModelRegistry.swap()` warms the new row off the
                  serving path and flips atomically; the outgoing
                  AsyncBatcher drains into the OLD model, so no future
                  is ever stranded (SwapReport.drained_requests counts
                  the tail)
    4. rebind     the monitor re-references the new model and opens a
                  fresh window

Like the async scheduler, the worker is deterministic-first: `step()` is
the cooperative entry point (tests and single-threaded loops call it
directly); `start()/stop()` wrap it in a daemon poll thread for real
deployments. Every completed rollout is a `RetrainReport`, whose
detect_to_swap_s is the headline number the "stream" bench section
tracks. The loop is the JAX package's (repro.stream.retrain).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.serve.artifact import FittedModel
from repro_torch.serve.registry import ModelRegistry, SwapReport
from repro_torch.serve.versions import VersionStore
from repro_torch.stream.drift import DriftMonitor, DriftReport


@dataclasses.dataclass
class RetrainReport:
    """One drift-triggered rollout, fully measured."""
    name: str
    version: int                 # published version of the new model
    drift: DriftReport           # the window that fired
    swap: SwapReport
    refit_s: float
    publish_s: float
    swap_s: float
    detect_to_swap_s: float      # trigger read -> flip committed

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["drift"] = self.drift.to_dict()
        d["swap"] = self.swap.to_dict()
        return d


class RetrainWorker:
    """Background (or cooperative) drift-to-swap loop for one model row.

    name/registry: the serving row to roll over.
    store: the VersionStore every refit publishes into.
    monitor: the DriftMonitor whose report() is the trigger.
    refit_fn: DriftReport -> FittedModel; owns how to refit (from the
        estimator's accumulated partial_fit state, a spec-driven refit
        on fresh data, ...).
    cooldown_s: minimum spacing between rollouts — a still-drifting
        window right after a swap must not re-fire before the new model
        has seen traffic.
    """

    def __init__(self, name: str, registry: ModelRegistry,
                 store: VersionStore, monitor: DriftMonitor,
                 refit_fn: Callable[[DriftReport], FittedModel], *,
                 cooldown_s: float = 0.0, clock=time.monotonic):
        self.name = name
        self.registry = registry
        self.store = store
        self.monitor = monitor
        self.refit_fn = refit_fn
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self.reports: List[RetrainReport] = []
        self.checks = 0
        self._last_rollout: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        # A refit that raises must not kill the poll loop silently.
        self.errors = 0
        self.last_error: Optional[BaseException] = None

    # -- cooperative entry point -----------------------------------------

    def step(self) -> Optional[RetrainReport]:
        """Check the monitor once; run the full rollout if it fired.

        Returns the RetrainReport of a completed rollout, else None
        (no drift, or still inside the cooldown window)."""
        self.checks += 1
        now = self.clock()
        if (self._last_rollout is not None
                and now - self._last_rollout < self.cooldown_s):
            return None
        report = self.monitor.report()
        if not report.fired:
            return None
        t0 = self.clock()
        model = self.refit_fn(report)
        t1 = self.clock()
        version = self.store.publish(model)
        t2 = self.clock()
        swap = self.registry.swap(self.name, model, version=version)
        t3 = self.clock()
        self.monitor.rebind(model)
        out = RetrainReport(
            name=self.name, version=version, drift=report, swap=swap,
            refit_s=t1 - t0, publish_s=t2 - t1, swap_s=t3 - t2,
            detect_to_swap_s=t3 - t0)
        self.reports.append(out)
        self._last_rollout = self.clock()
        return out

    @property
    def retrains(self) -> int:
        return len(self.reports)

    # -- background poll loop --------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None

    def start(self, poll_s: float = 0.1) -> "RetrainWorker":
        """Spawn the daemon poll thread (step() every poll_s)."""
        if self._thread is not None:
            raise RuntimeError("retrain worker already running")
        self._stop_event.clear()

        def loop():
            while not self._stop_event.wait(poll_s):
                try:
                    self.step()
                except Exception as exc:
                    self.errors += 1
                    self.last_error = exc

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="RetrainWorker")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._stop_event.set()
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "RetrainWorker":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.stop()
