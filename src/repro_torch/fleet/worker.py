"""FleetWorker: one serving replica — registry + pinned version + queue.

A worker is process-shaped: it owns a private `ModelRegistry` (one row),
talks to the rest of the fleet ONLY through the shared `VersionStore` on
disk (the artifact bus — this is what makes the same object runnable as N
threads in one process for tests/CI or as N real processes behind a
socket front door), and records a pin refcount (`VersionStore.pin`) for
whichever version it currently serves, so the store's GC can never delete
an artifact a replica still serves or may roll back to.

Lifecycle:

    FleetWorker(id, store)   load + pin the store's latest (or a pinned
                             `version=`) into the private registry, on
                             `device=` (the card unless the caller
                             passes device="cpu"; never a fallback)
    submit(Xq) -> Future     enqueue on the worker's AsyncBatcher (the
                             router/admission tier in front decides WHICH
                             worker; the worker never sheds on its own)
    poll()/flush()           deadline-driven / forced flush passthrough
    sync() -> bool           poll the store: swap to latest if newer
                             (the follower path of a fleet-wide rollout)
    swap_to(version)         warm hot-swap to a pinned version — the
                             canary/promote/rollback primitive; re-pins
                             atomically (pin new BEFORE unpin old, so the
                             store never sees a moment where neither is
                             protected)
    stop()                   drain + retire the scheduler, release pins

The worker deliberately adds no locking of its own around serving: the
registry row flip (`ModelRegistry.swap`) and the scheduler queue already
carry the machine-checked lock contracts (see repro.analysis L-rules);
the worker's only mutable state — the pinned version — is guarded here.

Futures resolve to numpy arrays (the batcher copies results to the
host), so a pump thread serving on the card hands no CUDA tensor to
another thread; every load and swap lands on the worker's one device.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.serve.registry import ModelRegistry, SwapReport
from repro_torch.serve.scheduler import AsyncBatcher
from repro_torch.serve.versions import VersionStore


class FleetWorker:
    """One serving replica over a shared VersionStore.

    worker_id: stable identity — the pin-refcount owner name and the
        consistent-hash ring anchor, so it must be unique fleet-wide and
        survive restarts for hash stability.
    version: pin this version instead of the store's latest.
    max_wait_ms / slo_ms / clock / batcher kwargs go to the worker's
        AsyncBatcher (every worker of a fleet gets the same ones).
    device: where the replica's models load, first and on every swap
        ("cuda" by default; raises when no card is available rather
        than serving on the CPU).
    """

    def __init__(self, worker_id: str, store: VersionStore, *,
                 version: Optional[int] = None,
                 max_wait_ms: float = 5.0,
                 slo_ms: Optional[float] = None,
                 clock=None, device="cuda", **batcher_kwargs):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"worker {worker_id!r}: replicas load onto the card by "
                f"default and no CUDA device is available; pass "
                f"device='cpu' to serve on the CPU")
        self.worker_id = str(worker_id)
        self.store = store
        self.registry = ModelRegistry()
        self._name = "served"                 # the single registry row
        v = version if version is not None else store.latest()
        if v is None:
            raise FileNotFoundError(
                f"worker {worker_id!r}: no versions under {store.root}; "
                f"publish one before starting the fleet")
        # Pin BEFORE load: between latest() and load() a concurrent GC
        # could sweep the version; the pin makes the read safe (and a
        # pin on a just-GC'ed version raises loudly instead of serving
        # a half-deleted artifact).
        store.pin(v, self.worker_id)
        self.registry.load_version(self._name, str(store.root), version=v,
                                   device=self.device)
        self._version = v                     # guarded-by: _lock
        self._lock = threading.Lock()
        kwargs: Dict = dict(batcher_kwargs)
        kwargs["max_wait_ms"] = max_wait_ms
        kwargs["slo_ms"] = slo_ms
        if clock is not None:
            kwargs["clock"] = clock
        self._scheduler_kwargs = kwargs
        self.registry.scheduler(self._name, **kwargs)

    # -- serving ---------------------------------------------------------

    def scheduler(self) -> AsyncBatcher:
        """The CURRENT AsyncBatcher (hot-swaps retire old handles)."""
        return self.registry.scheduler(self._name)

    def submit(self, Xq):
        """Enqueue one request; the fleet front door calls this after
        routing + admission."""
        return self.scheduler().submit(Xq)

    def poll(self) -> int:
        return self.scheduler().poll()

    def flush(self) -> int:
        return self.scheduler().flush()

    def depth(self) -> int:
        """Queued query columns — the router's load signal and the
        admission controller's shed signal."""
        return self.scheduler().pending_width

    @property
    def latency(self):
        """The worker's LatencyStats (survives hot-swaps by design)."""
        return self.scheduler().latency

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    # -- rollout primitives ---------------------------------------------

    def sync(self) -> Optional[SwapReport]:
        """Follow the store: swap to latest() when it is newer.

        Returns the SwapReport when a swap happened, None otherwise —
        the polling-follower path (a fleet-wide rollout is this, ordered
        canary-first by the RolloutManager)."""
        latest = self.store.latest()
        if latest is None or latest == self.version:
            return None
        return self.swap_to(latest)

    def swap_to(self, version: int) -> SwapReport:
        """Warm hot-swap this replica to a pinned `version`.

        Pin-new -> load -> registry.swap (drains in-flight requests into
        the outgoing model; zero stranded futures by the swap contract)
        -> unpin-old. Swapping to the current version is a cheap no-op
        shaped as a swap (idempotent promote)."""
        version = int(version)
        self.store.pin(version, self.worker_id)
        model = self.store.load(version, device=self.device)
        report = self.registry.swap(self._name, model, version=version)
        with self._lock:
            old, self._version = self._version, version
        if old != version:
            self.store.unpin(old, self.worker_id)
        return report

    def stop(self) -> int:
        """Retire the replica: drain the scheduler, release the pin.
        Returns the requests the final drain flushed."""
        drained = self.scheduler().stop()
        self.store.unpin(self.version, self.worker_id)
        return drained

    # -- monitoring ------------------------------------------------------

    def stats(self) -> Dict:
        """One JSON-ready health row (the fleet bench's per-worker dump)."""
        lat = self.latency
        return {
            "worker_id": self.worker_id,
            "version": self.version,
            "depth": self.depth(),
            "requests": lat.requests,
            "p95_ms": lat.total.percentile(95.0),
            "slo_violations": lat.slo_violations,
        }

    def probe_p95_ms(self, n_requests: int = 8, width: int = 8,
                     seed: int = 0) -> float:
        """Drive `n_requests` synthetic probes through THIS replica and
        return their end-to-end p95 (ms), measured on the worker's own
        clock. This is the canary gate's default health signal: it runs
        post-swap, through the real serving path (warmed executables),
        and touches only this worker."""
        from repro_torch.serve.latency import Histogram

        rng = np.random.RandomState(seed)
        p = self.registry.get(self._name).spec.p
        clock = self.scheduler().clock
        hist = Histogram()
        for _ in range(int(n_requests)):
            t0 = clock()
            fut = self.submit(rng.randn(p, width).astype(np.float32))
            self.flush()
            fut.result()
            hist.record((clock() - t0) * 1e3)
        return hist.percentile(95.0)
