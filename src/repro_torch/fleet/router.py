"""Request routing over fleet workers: least-loaded and consistent-hash.

Two policies, picked per Router (the fleet front door owns exactly one):

least-loaded   route every request to the worker with the smallest queue
               depth (pending query columns), ties broken by ring order —
               the throughput policy: keeps all replicas' batching windows
               evenly fed, so no worker's bucket sits half-full while
               another's overflows.

hash           consistent hashing of a caller-supplied routing key onto a
               ring of virtual nodes — the affinity policy: the same key
               always lands on the same worker (session/cache locality),
               and adding or removing ONE worker remaps only ~1/N of the
               key space instead of reshuffling everything. Hashes are
               blake2b, never Python's hash(): routing must be stable
               across processes and PYTHONHASHSEED.

The worker set is mutable (a fleet may retire a replica), so membership
is lock-guarded and the hash ring is rebuilt on change; routing itself
reads an immutable snapshot of the ring — the machine-checked guarded-by
contract below is what keeps a rebuild from racing a route.
"""
from __future__ import annotations

import bisect
import hashlib
import threading
from typing import List, Optional, Sequence, Tuple

from repro_torch.fleet.worker import FleetWorker

POLICIES = ("least-loaded", "hash")


def _hash64(s: str) -> int:
    """Stable 64-bit point on the ring (blake2b, process-independent)."""
    return int.from_bytes(hashlib.blake2b(s.encode(), digest_size=8)
                          .digest(), "big")


class Router:
    """Route requests to one of N FleetWorkers.

    policy: "least-loaded" (default) or "hash".
    vnodes: virtual nodes per worker on the hash ring — more vnodes =
        smoother key-space split (64 keeps the max/min worker share
        within ~2x for small fleets).
    """

    def __init__(self, workers: Sequence[FleetWorker],
                 policy: str = "least-loaded", vnodes: int = 64):
        if policy not in POLICIES:
            raise ValueError(f"unknown routing policy {policy!r}; "
                             f"have {POLICIES}")
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.policy = policy
        self.vnodes = int(vnodes)
        self._lock = threading.Lock()
        self._workers: List[FleetWorker] = []         # guarded-by: _lock
        self._ring: List[Tuple[int, int]] = []        # guarded-by: _lock
        for w in workers:
            self.add(w)

    # -- membership ------------------------------------------------------

    def add(self, worker: FleetWorker) -> None:
        with self._lock:
            if any(w.worker_id == worker.worker_id for w in self._workers):
                raise ValueError(
                    f"duplicate worker id {worker.worker_id!r} on the "
                    f"ring; ids are the hash anchors and must be unique")
            self._workers.append(worker)
            self._ring = self._build_ring(self._workers)

    def remove(self, worker_id: str) -> FleetWorker:
        with self._lock:
            for i, w in enumerate(self._workers):
                if w.worker_id == worker_id:
                    self._workers.pop(i)
                    self._ring = self._build_ring(self._workers)
                    return w
        raise KeyError(f"no worker {worker_id!r} on the ring")

    @property
    def workers(self) -> List[FleetWorker]:
        """Snapshot of the current membership (copy; safe to iterate)."""
        with self._lock:
            return list(self._workers)

    def _build_ring(self, workers: List[FleetWorker]
                    ) -> List[Tuple[int, int]]:
        """Sorted (point, worker_index) ring over vnodes per worker."""
        ring = []
        for i, w in enumerate(workers):
            for v in range(self.vnodes):
                ring.append((_hash64(f"{w.worker_id}#{v}"), i))
        ring.sort()
        return ring

    # -- routing ---------------------------------------------------------

    def route(self, key: Optional[str] = None) -> FleetWorker:
        """Pick the worker for one request.

        `key` is required under the hash policy (it IS the affinity) and
        ignored under least-loaded."""
        with self._lock:
            workers = list(self._workers)
            ring = self._ring
        if not workers:
            raise RuntimeError("no workers on the ring")
        if self.policy == "hash":
            if key is None:
                raise ValueError("hash routing needs a routing key")
            point = _hash64(str(key))
            # First vnode clockwise from the key's point (wraparound).
            i = bisect.bisect_right(ring, (point, len(workers)))
            return workers[ring[i % len(ring)][1]]
        # Least-loaded: min depth, ties to the lowest index so repeated
        # routing over an idle fleet is deterministic.
        return min(workers, key=lambda w: (w.depth(), w.worker_id))
