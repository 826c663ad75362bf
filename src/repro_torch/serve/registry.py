"""Multi-model registry + model lifecycle: load, serve, warm hot-swap, GC.

A registry row owns a FittedModel's whole serving lifetime: the model
itself, lazily a MicroBatcher (sync) and an AsyncBatcher (async,
SLO-accounted) — each remembered together with its construction kwargs —
and the optional version tag it was published under, so
`registry.batcher("segmentation").assign_batch(Xq)` or
`registry.scheduler("segmentation").submit(Xq)` is the whole serving call
and `registry.latency_summary("segmentation")` the monitoring read-out.

Model replacement comes in two shapes:

  cold  `register(name, model, overwrite=True)` — drops the row's cached
        batchers (and their bucket history) and stops the old scheduler.
        The first query of each bucket on the new row pays its first
        launch.
  warm  `swap(name, model)` — pre-builds the new row's batchers with the
        SAME construction kwargs, warms every bucket the old row ever
        served (replaying stats["bucket_hits"]), carries the old
        LatencyStats over, and only then atomically flips the row.
        The old AsyncBatcher is drained into the OLD model — requests it
        accepted resolve against the version that accepted them — and
        retired (post-flip submits on the stale handle raise). The
        returned SwapReport makes the downtime a measured number.

Versioned artifacts live in serve/versions.py (`<root>/v_<N>/` on the
checkpoint layer's atomic-rename commit); `publish()`/`load_version()`
connect a row to a store. Loading is artifact-directory based and lands
on the card unless the caller passes device="cpu"; registering the same
name twice requires overwrite=True to avoid silently hot-swapping a
live model.

On the card the warm phase pays each bucket's first launch (and, for
the first model of a process, the kernels' build) before the flip, so
the swapped-in row serves its first request at steady-state speed.

A row whose scheduler is pumped (a policy with a mesh; serve/pump.py)
is swapped on rank 0 of the mesh axis, which broadcasts SWAP (the new
model's spec and leaves, its version, the widths it warms) before it
warms; every other rank serves the row through follow(name), which
mirrors each step of the swap in the same order. Retiring a pumped row
(unregister, register(overwrite=True)) stops its scheduler, whose STOP
ends the followers' loop.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional

from repro_torch.serve import pump
from repro_torch.serve.artifact import FittedModel, load_model, save_model
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.pump import PUMP
from repro_torch.serve.scheduler import AsyncBatcher
from repro_torch.serve.versions import VersionStore

_MISSING = object()


@dataclasses.dataclass
class SwapReport:
    """What a warm hot-swap measured (the "swap" section of the bench
    file serializes this via to_dict()).

    warm_s is paid OFF the serving path (the old row keeps serving while
    the new one warms); flip_ms is the only window in which neither
    row is authoritative — the measured swap downtime. p95_before_ms is
    the total-latency p95 of the surviving LatencyStats at flip time;
    p95_after_ms stays None until post-swap traffic has run (the swap
    bench fills it from the same surviving stats).
    """
    name: str
    old_version: Optional[int]
    new_version: Optional[int]
    buckets_warmed: List[int]
    warm_s: float
    flip_ms: float
    drain_s: float
    drained_requests: int
    requests_before: int
    p95_before_ms: float
    p95_after_ms: Optional[float] = None

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _Row:
    """One model's serving state; construction kwargs are remembered so
    cache hits can detect conflicting overrides and a hot-swap can
    rebuild the row identically."""
    model: FittedModel
    version: Optional[int] = None
    batcher: Optional[MicroBatcher] = None
    batcher_kwargs: Dict = dataclasses.field(default_factory=dict)
    scheduler: Optional[AsyncBatcher] = None
    scheduler_kwargs: Dict = dataclasses.field(default_factory=dict)


class ModelRegistry:
    def __init__(self):
        self._rows: Dict[str, _Row] = {}      # guarded-by: _lock
        # One lock for row-map mutation AND lazy batcher construction:
        # swap() flips under it, so a flip is atomic against concurrent
        # batcher()/scheduler() lookups and other swaps. The guarded-by
        # annotation above is a checked contract (repro.analysis.locks,
        # rule L001): _rows is mutated only under `with self._lock`.
        self._lock = threading.Lock()

    def register(self, name: str, model: FittedModel,
                 overwrite: bool = False,
                 version: Optional[int] = None) -> FittedModel:
        """Cold registration; see the module docstring for cold vs warm.

        The replaced row's scheduler (if any) is stopped and drained —
        its pending futures resolve against the model they were
        submitted to — and the row's bucket history is dropped.
        """
        with self._lock:
            if name in self._rows and not overwrite:
                raise ValueError(f"model {name!r} already registered "
                                 f"(overwrite=True to replace)")
            old = self._rows.get(name)
            self._rows[name] = _Row(model=model, version=version)
        self._retire(old)
        return model

    def get(self, name: str) -> FittedModel:
        return self._row(name).model

    def version(self, name: str) -> Optional[int]:
        """Version tag the row was registered/swapped under (None when
        the model never came from a version store)."""
        return self._row(name).version

    def unregister(self, name: str) -> None:
        with self._lock:
            old = self._rows.pop(name, None)
        self._retire(old)

    def unregister_meshed(self) -> None:
        """Unregister every row that serves on a mesh (its batcher's or
        its scheduler's policy has one), as the world ends: their
        batchers hold the mesh's groups."""
        with self._lock:
            names = [name for name, row in self._rows.items()
                     if any(b is not None and b.policy.mesh is not None
                            for b in (row.batcher, row.scheduler and
                                      row.scheduler.batcher))]
        for name in names:
            self.unregister(name)

    def names(self) -> List[str]:
        return sorted(self._rows)

    def _row(self, name: str) -> _Row:
        row = self._rows.get(name)
        if row is None:
            raise KeyError(f"no model {name!r}; have {self.names()}")
        return row

    @staticmethod
    def _retire(row: Optional[_Row]) -> None:
        """Stop + flush a dropped row's AsyncBatcher so no future is
        orphaned; its stale handle rejects later submits. A pumped one's
        STOP ends the followers' follow()."""
        if row is not None and row.scheduler is not None:
            row.scheduler.stop()

    # -- artifact I/O ----------------------------------------------------

    def load(self, name: str, artifact_dir: str, overwrite: bool = False,
             device="cuda") -> FittedModel:
        return self.register(name, load_model(artifact_dir, device=device),
                             overwrite)

    def save(self, name: str, artifact_dir: str) -> str:
        return save_model(self.get(name), artifact_dir)

    def publish(self, name: str, store_root: str,
                keep: Optional[int] = None) -> int:
        """Publish the row's model as the next version under store_root
        (keep-last-`keep` GC when set); returns the version number and
        tags the row with it."""
        version = VersionStore(store_root).publish(self.get(name),
                                                   keep=keep)
        self._row(name).version = version
        return version

    def load_version(self, name: str, store_root: str,
                     version: Optional[int] = None,
                     overwrite: bool = False, device="cuda") -> FittedModel:
        """Register a pinned `version` (latest when None) from a version
        store; the row remembers which version it serves."""
        store = VersionStore(store_root)
        v = version if version is not None else store.latest()
        return self.register(name, store.load(v, device=device),
                             overwrite=overwrite, version=v)

    # -- serving front-ends ----------------------------------------------

    @staticmethod
    def _check_kwargs(kind: str, name: str, recorded: Dict,
                      requested: Dict) -> None:
        """A cache hit must not silently ignore kwargs: a caller asking
        for e.g. another policy would get the cached row's with no
        signal. Every requested kwarg must match the recorded
        construction exactly (passing none always hits the cache)."""
        for key, val in requested.items():
            have = recorded.get(key, _MISSING)
            if have is val or (have is not _MISSING and have == val):
                continue
            raise ValueError(
                f"{kind}({name!r}) is cached with construction kwargs "
                f"{recorded}; conflicting override {key}={val!r} would be "
                f"silently ignored — match the cached construction, or "
                f"swap()/re-register the model to rebuild it")

    def batcher(self, name: str, **kwargs) -> MicroBatcher:
        """Per-model MicroBatcher, cached so its bucket stats persist.

        kwargs are honoured on first construction for a given name and
        remembered; a later call passing DIFFERENT kwargs raises (they
        include policy=, which picks the compute paths; see
        serve/policy.py).
        """
        with self._lock:
            row = self._row(name)
            if row.batcher is None:
                row.batcher = MicroBatcher(row.model, **kwargs)
                row.batcher_kwargs = dict(kwargs)
            else:
                self._check_kwargs("batcher", name, row.batcher_kwargs,
                                   kwargs)
            return row.batcher

    def scheduler(self, name: str, **kwargs) -> AsyncBatcher:
        """Per-model AsyncBatcher, cached so its LatencyStats accumulate
        across callers (the SLO read-out is per model, not per client).

        Same kwargs contract as batcher(): remembered at construction,
        conflicting later overrides raise. The caller owns start()/stop()
        of the pump thread.
        """
        with self._lock:
            row = self._row(name)
            if row.scheduler is None:
                row.scheduler = AsyncBatcher(row.model, **kwargs)
                row.scheduler_kwargs = dict(kwargs)
            else:
                self._check_kwargs("scheduler", name, row.scheduler_kwargs,
                                   kwargs)
            return row.scheduler

    def latency_summary(self, name: str) -> Dict:
        """LatencyStats summary of a model's async path (see
        serve/latency.py); raises KeyError until scheduler(name) exists."""
        row = self._row(name)
        if row.scheduler is None:
            raise KeyError(f"no async scheduler for {name!r}; call "
                           f"scheduler({name!r}) first")
        return row.scheduler.latency.summary()

    # -- warm hot-swap ---------------------------------------------------

    def swap(self, name: str, model: FittedModel,
             version: Optional[int] = None) -> SwapReport:
        """Warm hot-swap `name` to `model`; returns the measured SwapReport.

        Ordering — everything expensive happens BEFORE the flip, while
        the old row keeps serving:

          1. build the new row's MicroBatcher / AsyncBatcher with the old
             row's recorded construction kwargs (same policy, same
             buckets, same clock); the new AsyncBatcher inherits the old
             row's LatencyStats object, so p50/p95 history and SLO
             counters survive the swap;
          2. warm every bucket the old row ever served by replaying its
             stats["bucket_hits"] widths through the new row (both the
             sync batcher's and the scheduler's inner one);
          3. atomically flip the row under the registry lock — the
             measured flip window, the only downtime there is;
          4. restart the pump iff the old one was running, then drain the
             old AsyncBatcher into the OLD model (its accepted requests
             resolve against the version that accepted them) and retire
             it: submits on the stale handle now raise instead of
             stranding futures in a pump-less queue.

        A pumped row swaps on rank 0 only: steps 1-2 run under the
        pump's sequencer after a SWAP broadcast, and the drain of step 4
        goes out as FLUSH and STOP messages of the old generation; the
        followers mirror all of it in follow().
        """
        with self._lock:
            old = self._row(name)
            old_batcher, old_scheduler = old.batcher, old.scheduler
        pumped = old_scheduler is not None and old_scheduler.pumped
        if pumped and not old_scheduler.leader:
            raise RuntimeError(
                f"swap({name!r}) of a pumped row runs on rank 0 of its mesh "
                f"axis; the other ranks mirror it in follow({name!r})")
        batcher_widths = (old_batcher.executables
                          if old_batcher is not None else None)
        scheduler_widths = (old_scheduler.batcher.executables
                            if old_scheduler is not None else None)
        t0 = time.perf_counter()
        with PUMP.lock if pumped else contextlib.nullcontext():
            new = self._successor(old, old_batcher, old_scheduler, model,
                                  version)
            if pumped:
                device = old_scheduler.batcher.model.device
                meta, body = pump.pack_swap(model, version, batcher_widths,
                                            scheduler_widths, device)
                PUMP.send(old_scheduler.axis, device, pump.SWAP,
                          new.scheduler.generation, meta, body)
            warmed = self._warm(new, batcher_widths, scheduler_widths)
        resume_pump = old_scheduler is not None and old_scheduler.running
        warm_s = time.perf_counter() - t0
        stats = old_scheduler.latency if old_scheduler is not None else None
        p95_before = (stats.total.percentile(95.0)
                      if stats is not None else 0.0)
        requests_before = stats.requests if stats is not None else 0

        t1 = time.perf_counter()
        with self._lock:
            # The warm phase ran unlocked (the old row kept serving); the
            # flip only commits if nothing about the row changed meanwhile
            # — not the row itself (a concurrent register/swap) and not
            # its serving state (a concurrent first batcher()/scheduler()
            # call would otherwise be silently discarded and retired).
            if (self._rows.get(name) is not old
                    or old.batcher is not old_batcher
                    or old.scheduler is not old_scheduler):
                raise RuntimeError(
                    f"model {name!r} changed concurrently during swap; "
                    f"retry against the current row")
            self._rows[name] = new
        flip_ms = (time.perf_counter() - t1) * 1e3

        if resume_pump:
            new.scheduler.start()
        t2 = time.perf_counter()
        drained = self._drain(old)
        return SwapReport(
            name=name, old_version=old.version, new_version=version,
            buckets_warmed=warmed, warm_s=warm_s,
            flip_ms=flip_ms, drain_s=time.perf_counter() - t2,
            drained_requests=drained, requests_before=requests_before,
            p95_before_ms=p95_before)

    @staticmethod
    def _successor(old: _Row, old_batcher: Optional[MicroBatcher],
                   old_scheduler: Optional[AsyncBatcher],
                   model: FittedModel, version: Optional[int]) -> _Row:
        """Step 1 of a swap: the new row's batchers, built with the old
        row's recorded construction kwargs; the new AsyncBatcher takes
        over the old one's LatencyStats."""
        new = _Row(model=model, version=version)
        if old_batcher is not None:
            new.batcher = MicroBatcher(model, **old.batcher_kwargs)
            new.batcher_kwargs = dict(old.batcher_kwargs)
        if old_scheduler is not None:
            kwargs = dict(old.scheduler_kwargs)
            kwargs["latency"] = old_scheduler.latency   # survives the swap
            new.scheduler = AsyncBatcher(model, **kwargs)
            new.scheduler_kwargs = dict(old.scheduler_kwargs)
        return new

    @staticmethod
    def _warm(new: _Row, batcher_widths, scheduler_widths) -> List[int]:
        """Step 2 of a swap: the buckets the old row served, through the
        new row's sync batcher and its scheduler's; the widths warmed."""
        warmed: List[int] = []
        if batcher_widths is not None:
            warmed += new.batcher.warm(batcher_widths)
        if scheduler_widths is not None:
            warmed += new.scheduler.batcher.warm(scheduler_widths)
        return sorted(set(warmed))

    # -- the followers of a pumped row -----------------------------------

    def follow(self, name: str) -> int:
        """A follower's serving loop for the row `name`, whose scheduler
        is pumped: run rank 0's flushes of the row's schedulers, mirror
        its swaps, until the STOP of the scheduler the row serves through
        (rank 0 retired the row). Returns the flushes run. The set-up
        before it is SPMD: every rank registers the row and builds its
        batchers with rank 0's kwargs."""
        with self._lock:
            row = self._row(name)
        sched = row.scheduler
        if sched is None or not sched.pumped:
            raise ValueError(f"follow({name!r}): the row has no pumped "
                             f"scheduler (a policy with a mesh)")
        if sched.leader:
            raise RuntimeError(f"follow({name!r}) runs on the followers; "
                               f"rank 0 of the mesh axis is the front door")
        live = {sched.generation: sched}
        flushes = 0
        while live:
            msg = PUMP.receive(sched.axis, row.model.device)
            if msg.kind == pump.NOP:
                continue
            if msg.kind == pump.SWAP:
                new = self._follow_swap(name, msg)
                live[new.generation] = new
                continue
            target = live.get(msg.gen)
            if target is None:
                raise RuntimeError(
                    f"pump: rank 0 sent {pump.KINDS[msg.kind]} for batcher "
                    f"generation {msg.gen}; row {name!r} here serves "
                    f"generations {sorted(live)}")
            if msg.kind == pump.FLUSH:
                target.follow_flush(msg)
                flushes += 1
            else:
                target.stop()
                del live[msg.gen]
        return flushes

    def _follow_swap(self, name: str, msg: pump.Message) -> AsyncBatcher:
        """A follower's side of swap(): the same row built from rank 0's
        leaves and kwargs, warmed at rank 0's widths, flipped; returns the
        new scheduler. The old one serves on until its STOP."""
        with self._lock:
            old = self._row(name)
        model, version, batcher_widths, scheduler_widths = \
            pump.unpack_swap(msg)
        if (batcher_widths is None) != (old.batcher is None):
            raise RuntimeError(f"swap({name!r}): rank 0's row and this "
                               f"rank's differ in their sync batcher")
        new = self._successor(old, old.batcher, old.scheduler, model,
                              version)
        if new.scheduler.generation != msg.gen:
            raise RuntimeError(
                f"pump: rank 0's new scheduler of {name!r} is generation "
                f"{msg.gen}, this rank's {new.scheduler.generation}")
        self._warm(new, batcher_widths, scheduler_widths)
        with self._lock:
            self._rows[name] = new
        return new.scheduler

    @staticmethod
    def _drain(row: _Row) -> int:
        """Retire a flipped-out row; returns requests its stop() flushed."""
        if row.scheduler is None:
            return 0
        return row.scheduler.stop()


# Process-wide default registry.
DEFAULT_REGISTRY = ModelRegistry()


def register(name: str, model: FittedModel,
             overwrite: bool = False) -> FittedModel:
    return DEFAULT_REGISTRY.register(name, model, overwrite)


def get(name: str) -> FittedModel:
    return DEFAULT_REGISTRY.get(name)
