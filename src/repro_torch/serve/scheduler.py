"""Async SLO-aware request scheduling: futures + deadline-driven flush.

`MicroBatcher.drain()` is synchronous and deterministic by design —
every caller blocks until the whole coalesced batch runs. `AsyncBatcher`
keeps that exact compute path (flushes are literally
`MicroBatcher.submit()* + drain()`) and puts a latency-aware front door
on it:

    submit(Xq) -> Future     returns immediately; the request joins the
                             pending window and its enqueue timestamp is
                             taken
    flush trigger            whichever fires first:
                               - the pending window reaches max_bucket
                                 query columns (a full steady-state batch
                                 is ready -> flushing now costs nothing),
                                 checked at submit time;
                               - the OLDEST pending request has waited
                                 its bucket's deadline (max_wait_ms unless
                                 set_bucket_wait overrides it), checked by
                                 poll()/the pump thread.
    completion               the flushed batch runs through the bucketed
                             assignment path; each request's Future
                             resolves to its (labels, d2) numpy slice and
                             its enqueue->flush->complete timestamps land
                             in a LatencyStats (serve/latency.py)

Determinism: all scheduling state lives behind one lock and the clock is
injectable, so tests drive deadline semantics with a fake clock and
explicit poll() calls — no sleeps. A background pump thread
(`start()`/`stop()`, or the context manager) is available for real
deployments where nobody polls.

Batch membership does not change results on the card: query columns are
independent through the extension, and the kernels' summation order over
the training points is a function of n alone (kernels/_common.py
extend_split), so a query gets the same bits whatever batch, bucket or
offset it lands in. An async flush therefore equals a synchronous drain
of the same requests bit for bit however the two coalesced. On the CPU
the plain path is a torch matmul whose bits may depend on the batch
width; there the two agree bit for bit when they coalesce the same
batches.

Futures hold numpy arrays only (`MicroBatcher.assign_batch` copies the
results to the host), so no CUDA tensor outlives a flush in a client's
hands. The compute paths follow `policy=ComputePolicy(...)`, forwarded
with block/min_bucket/max_bucket to the inner MicroBatcher.

With policy.mesh the batcher is pumped (serve/pump.py), at any world
size: rank 0 of the mesh axis is the front door (submit, poll, flush,
start and stop keep their meaning there) and broadcasts every flush
before it runs it; every other rank calls follow(), which runs rank 0's
flushes in order until its STOP. Unlike the sync path, where every rank
makes each call, a follower has no front door: its submit, poll and
start raise.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.serve import pump
from repro_torch.serve.artifact import FittedModel
from repro_torch.serve.batcher import MicroBatcher, bucket_size
from repro_torch.serve.latency import LatencyStats
from repro_torch.serve.pump import PUMP


class _Pending(NamedTuple):
    """One queued request: payload + future + its enqueue timestamp."""
    Xq: np.ndarray
    future: Future
    enqueue_ts: float


class AsyncBatcher:
    """Deadline-driven async front door over MicroBatcher's bucketed path.

    max_wait_ms: latency deadline — the longest any request may sit in the
        pending window before a flush is forced. Lower = lower p99, less
        coalescing; higher = bigger batches, better throughput.
    slo_ms: end-to-end latency SLO recorded per request (None disables).
    clock: monotonic-seconds callable; injectable for deterministic tests.
    latency: a LatencyStats to record into (a warm swap hands the old
        row's over); None makes a fresh one.
    Remaining kwargs (policy, block, min_bucket, max_bucket) go straight
    to the inner MicroBatcher.
    """

    def __init__(self, model: FittedModel, *, max_wait_ms: float = 5.0,
                 slo_ms: Optional[float] = None,
                 clock=time.monotonic, latency: Optional[LatencyStats] = None,
                 **batcher_kwargs):
        self.batcher = MicroBatcher(model, **batcher_kwargs)
        self.max_wait_ms = float(max_wait_ms)
        self.clock = clock
        self.latency = latency if latency is not None \
            else LatencyStats(slo_ms=slo_ms)
        # lock-order: _flush_lock -> _lock
        # flush() nests the window lock inside the drain lock; nothing
        # may acquire the pair inverted (taking _flush_lock while
        # holding _lock would deadlock against a concurrent flush).
        # The guarded-by annotations below are a checked contract
        # (repro.analysis.locks reads this file; rules L001/L002): an
        # annotated field is written only under its lock.
        self._queue: List[_Pending] = []      # guarded-by: _lock
        # Per-bucket deadline overrides (milliseconds), keyed by the pow-2
        # execution bucket the CURRENT pending window would coalesce into:
        # a bucket whose latency shows deadline pressure gets a shorter
        # wait, a comfortably fast one a longer one. Unset buckets fall
        # back to max_wait_ms. Read by due(); written by set_bucket_wait().
        self._bucket_wait: Dict[int, float] = {}  # guarded-by: _lock
        self._lock = threading.Lock()         # guards the pending window
        self._flush_lock = threading.Lock()   # serializes inner drains
        self._thread: Optional[threading.Thread] = None  # guarded-by: _lock
        self._stop_event = threading.Event()
        self._stopped = False                 # guarded-by: _lock
        # Pump-thread health: a flush that raises has already delivered
        # the exception to that batch's futures; the pump must survive to
        # serve later requests. Counter + last error are the monitoring
        # surface.
        self.pump_errors = 0
        self.last_pump_error: Optional[BaseException] = None
        # The rank-0 pump (serve/pump.py), when the policy has a mesh: the
        # mesh axis the messages go over and this batcher's generation
        # tag. A pumped flush takes PUMP.lock inside _flush_lock, never
        # the other way round, and never while holding _lock.
        self.axis = (self.batcher.extender.ax
                     if self.batcher.policy.mesh is not None else None)
        self.generation = PUMP.generation() if self.pumped else None
        self._stop_sent = False               # guarded-by: _flush_lock
        self._last_sent = time.monotonic()    # guarded-by: _flush_lock
        self._abandoned = False               # guarded-by: _lock
        if self.pumped:
            PUMP.enlist(self)

    @property
    def pumped(self) -> bool:
        """True when the policy has a mesh: flushes go through the pump."""
        return self.axis is not None

    @property
    def leader(self) -> bool:
        """True on rank 0 of the mesh axis (and whenever unpumped): the
        rank that takes requests."""
        return self.axis is None or self.axis.index == 0

    def _front_door(self, what: str) -> None:
        if not self.leader:
            raise RuntimeError(
                f"{what} on a follower: rank 0 of the mesh axis takes every "
                f"request of a pumped AsyncBatcher and decides every flush; "
                f"this rank runs follow()")

    # -- request side ----------------------------------------------------

    def submit(self, Xq) -> "Future[Tuple[np.ndarray, np.ndarray]]":
        """Enqueue one (p, b) request; resolves to (labels (b,), d2 (b,)).

        Flushes inline when this submit fills the window to max_bucket —
        the full-batch trigger — so a saturating client never waits on the
        deadline.
        """
        self._front_door("submit()")
        Xq = self.batcher.validate_request(Xq)
        fut: Future = Future()
        with self._lock:
            # Checked under the lock so a submit racing stop() either
            # lands in the queue stop() is about to flush, or raises —
            # it can never enqueue into a retired, pump-less batcher
            # where the future would be stranded forever.
            if self._stopped:
                raise RuntimeError(
                    "submit() on a stopped AsyncBatcher: nothing would "
                    "ever flush this request (after a hot-swap, get the "
                    "current scheduler from the registry)")
            self._queue.append(_Pending(Xq, fut, self.clock()))
            full = self._pending_width_locked() >= self.batcher.max_bucket
        if full:
            self.flush()
        return fut

    def _pending_width_locked(self) -> int:
        return sum(p.Xq.shape[1] for p in self._queue)

    @property
    def pending_requests(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def pending_width(self) -> int:
        """Total query columns currently waiting for a flush."""
        with self._lock:
            return self._pending_width_locked()

    # -- flush side ------------------------------------------------------

    def set_bucket_wait(self, bucket: int, max_wait_ms: float) -> None:
        """Override the flush deadline for one pow-2 execution bucket;
        buckets not overridden keep the constructor's max_wait_ms."""
        if max_wait_ms <= 0:
            raise ValueError(f"max_wait_ms must be positive, "
                             f"got {max_wait_ms!r}")
        with self._lock:
            self._bucket_wait[int(bucket)] = float(max_wait_ms)

    def bucket_wait(self, bucket: int) -> float:
        """Effective flush deadline (ms) for one pow-2 bucket."""
        with self._lock:
            return self._bucket_wait.get(int(bucket), self.max_wait_ms)

    def due(self, now: Optional[float] = None) -> bool:
        """True when the oldest pending request has hit the deadline.

        The deadline is per execution bucket when overridden
        (set_bucket_wait): the wait that applies is the one for the
        bucket the CURRENT pending window would coalesce into — as the
        window grows into a larger bucket, that bucket's wait takes
        over."""
        now = self.clock() if now is None else now
        with self._lock:
            if not self._queue:
                return False
            if self._bucket_wait:
                b = bucket_size(self._pending_width_locked(),
                                self.batcher.min_bucket,
                                self.batcher.max_bucket)
                wait = self._bucket_wait.get(b, self.max_wait_ms)
            else:
                wait = self.max_wait_ms
            return (now - self._queue[0].enqueue_ts) * 1e3 >= wait

    def poll(self) -> int:
        """Flush if the deadline trigger fires; returns requests completed.

        The cooperative scheduling entry point: an event loop (or test)
        calls poll() at whatever cadence it likes; the pump thread is
        poll() in a loop.
        """
        self._front_door("poll()")
        return self.flush() if self.due() else 0

    def flush(self) -> int:
        """Run all pending requests now; returns requests completed.

        The batch is handed to the inner MicroBatcher exactly as drain()
        would see it. Futures resolve in submission order; on compute
        failure every future in the batch carries the exception instead
        of the batch dying silently. Pumped, the batch is first broadcast
        as one FLUSH and every rank runs drain()'s coalesced path on the
        payload it carried (_broadcast_flush).
        """
        with self._flush_lock:
            with self._lock:
                batch, self._queue = self._queue, []
            if not batch:
                return 0
            flush_ts = self.clock()
            try:
                if self.pumped:
                    self._last_sent = time.monotonic()
                    results = self._broadcast_flush(batch)
                else:
                    for p in batch:
                        self.batcher.submit(p.Xq)
                    results = self.batcher.drain()
            except Exception as exc:
                for p in batch:
                    if p.future.set_running_or_notify_cancel():
                        p.future.set_exception(exc)
                raise
            # drain() must return exactly one result per request handed
            # to it; a mismatch means something enqueued on the inner
            # batcher directly and a silent zip would scatter results to
            # the wrong futures.
            if len(results) != len(batch):
                exc = RuntimeError(
                    f"flush expected {len(batch)} results, drained "
                    f"{len(results)}: the inner MicroBatcher had foreign "
                    f"pending requests")
                for p in batch:
                    if p.future.set_running_or_notify_cancel():
                        p.future.set_exception(exc)
                raise exc
            complete_ts = self.clock()
            # The pow-2 execution bucket this flush ran through (oversized
            # batches chunk into max_bucket pieces, so the clamp is also
            # the dominant bucket); keys the per-bucket breakdown.
            width = sum(p.Xq.shape[1] for p in batch)
            bucket = bucket_size(width, self.batcher.min_bucket,
                                 self.batcher.max_bucket)
            # LatencyStats mutation stays inside the flush lock: record()
            # is read-modify-write on histogram counts, and a pump-thread
            # flush can overlap a submit-triggered inline flush.
            for p in batch:
                self.latency.record(p.enqueue_ts, flush_ts, complete_ts,
                                    queries=p.Xq.shape[1], bucket=bucket)
        # A client may have cancel()ed its future while the request sat in
        # the pending window; set_result on a cancelled future raises
        # InvalidStateError and would strand every LATER future in the
        # batch. set_running_or_notify_cancel() claims the future
        # atomically (False = it was cancelled -> drop the result).
        for p, res in zip(batch, results):
            if p.future.set_running_or_notify_cancel():
                p.future.set_result(res)
        return len(batch)

    def _broadcast_flush(self, batch: List[_Pending]) -> List:
        """Rank 0's pumped flush: FLUSH, then the coalesced drain of the
        payload it carried, both under the sequencer."""
        widths = [p.Xq.shape[1] for p in batch]
        body = pump.pack_flush(widths, np.concatenate(
            [p.Xq for p in batch], axis=1), self.batcher.model.device)
        with PUMP.lock:
            PUMP.send(self.axis, self.batcher.model.device, pump.FLUSH,
                      self.generation, len(widths), body)
            return self.batcher.assign_requests(pump.flush_payload(
                body, len(widths), self.batcher.model.spec.p), widths)

    # -- the followers ---------------------------------------------------

    def follow(self) -> int:
        """A follower's serving loop: run each of rank 0's flushes of this
        batcher, in order, until its STOP (rank 0's stop()); then retire.
        Returns the flushes run. The set-up before it is SPMD: every rank
        builds this batcher, and warms it, as rank 0 does."""
        if self.leader:
            raise RuntimeError("follow() runs on the followers; rank 0 of "
                               "the mesh axis is the front door")
        flushes = 0
        while True:
            msg = PUMP.receive(self.axis, self.batcher.model.device)
            if msg.kind == pump.NOP:
                continue
            if msg.gen != self.generation:
                raise RuntimeError(
                    f"pump: rank 0 sent {pump.KINDS[msg.kind]} for batcher "
                    f"generation {msg.gen}; this rank follows generation "
                    f"{self.generation} (build pumped batchers in the same "
                    f"order on every rank)")
            if msg.kind == pump.FLUSH:
                self.follow_flush(msg)
                flushes += 1
            elif msg.kind == pump.STOP:
                self.stop()
                return flushes
            else:
                raise RuntimeError(f"pump: a {pump.KINDS[msg.kind]} message "
                                   f"reached AsyncBatcher.follow(); a "
                                   f"registry row follows with "
                                   f"ModelRegistry.follow()")

    def follow_flush(self, msg: pump.Message) -> List:
        """Run one FLUSH message through drain()'s coalesced path; the
        per-request (labels, d2), as rank 0's futures receive them."""
        widths, payload = pump.unpack_flush(msg, self.batcher.model.spec.p)
        return self.batcher.assign_requests(payload, widths)

    # -- background pump -------------------------------------------------

    def _pump_period(self) -> float:
        """Pump poll period: a quarter of the SHORTEST active deadline."""
        with self._lock:
            waits = list(self._bucket_wait.values())
        return max(min(waits + [self.max_wait_ms]) / 4e3, 1e-4)

    @property
    def running(self) -> bool:
        """True while the background pump thread is alive."""
        return self._thread is not None

    @property
    def stopped(self) -> bool:
        """True once stop() retired this batcher (submits now raise)."""
        return self._stopped

    def start(self) -> "AsyncBatcher":
        """Spawn the daemon pump thread (poll() every quarter deadline).

        The check-and-spawn is one critical section: two concurrent
        start() calls must not both see `_thread is None` and leak a
        second pump. Build the kernels first (a warm-up on the calling
        thread) so the pump's first flush does not pay the build.
        """

        self._front_door("start()")

        def pump_loop():
            # Re-read the period every cycle: set_bucket_wait may shorten
            # a deadline below the constructor's.
            while not self._stop_event.wait(self._pump_period()):
                try:
                    if not self.poll() and self.pumped:
                        self._keep_alive()
                except Exception as exc:   # batch futures carry the error
                    self.pump_errors += 1
                    self.last_pump_error = exc

        with self._lock:
            if self._stopped:
                raise RuntimeError("cannot start a stopped AsyncBatcher")
            if self._thread is not None:
                raise RuntimeError("pump thread already running")
            self._stop_event.clear()
            thread = threading.Thread(target=pump_loop, daemon=True,
                                      name="AsyncBatcher-pump")
            self._thread = thread
        thread.start()
        return self

    def _keep_alive(self) -> None:
        """An idle pump thread on rank 0: a NOP once KEEPALIVE_S has
        passed since this batcher's last message, so that a follower's
        wait stays inside the process group's timeout."""
        with self._flush_lock:
            if time.monotonic() - self._last_sent < pump.KEEPALIVE_S:
                return
            with PUMP.lock:
                PUMP.send(self.axis, self.batcher.model.device, pump.NOP,
                          self.generation)
            self._last_sent = time.monotonic()

    def stop(self) -> int:
        """Retire this batcher: stop the pump, flush pending, reject
        all later submits. Idempotent — a second stop() is a no-op that
        flushes an empty queue. Returns the requests flushed by THIS
        call (what a hot-swap drained into the outgoing model).

        The thread handle is claimed under _lock (two concurrent stop()
        calls must not both join-and-clear it), but join() happens
        OUTSIDE: the pump's poll()->flush() takes _lock, so joining while
        holding it would deadlock. Pumped, rank 0 then broadcasts STOP,
        once, after the last FLUSH (under _flush_lock), and the followers
        leave follow(); a follower's stop() retires it and sends nothing.
        """
        with self._lock:
            self._stopped = True
            thread, self._thread = self._thread, None
            abandoned = self._abandoned
        if abandoned:
            return 0
        if thread is not None:
            self._stop_event.set()
            thread.join()
        flushed = self.flush()
        if self.pumped and self.leader:
            with self._flush_lock:
                if not self._stop_sent:
                    with PUMP.lock:
                        PUMP.send(self.axis, self.batcher.model.device,
                                  pump.STOP, self.generation)
                    self._stop_sent = True
        return flushed

    def abandon(self) -> int:
        """Retire this batcher without a collective, as a world whose
        collective broke ends (launch/mesh.py close_world): later submits
        raise, the pump thread is told to stop and not waited for (it may
        sit in the broken collective until the group goes), the pending
        requests' futures carry an error, and no STOP goes out: after a
        broken collective no message is sure to arrive. A later stop()
        does nothing. Returns the requests failed."""
        with self._lock:
            self._stopped = self._abandoned = True
            self._thread = None
            batch, self._queue = self._queue, []
        self._stop_event.set()
        exc = RuntimeError("AsyncBatcher abandoned: its world ended after "
                           "a broken collective")
        for p in batch:
            if p.future.set_running_or_notify_cancel():
                p.future.set_exception(exc)
        return len(batch)

    def __enter__(self) -> "AsyncBatcher":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.stop()
