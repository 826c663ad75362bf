"""Fleet soak bench: q/s vs p99 vs worker count, shed-rate, rollouts.

The "fleet" section of the serving bench file (the JAX package's
schema) — the deliverable that turns the serving tier's three claims into
gated numbers:

  sweep      sustained request traffic against 1..N-worker fleets (pump
             threads running, so replica flushes overlap in real
             threads): tier q/s and merged p50/p95/p99 per worker count;
  overload   a flood far past the per-worker admission caps: shed-rate
             MUST exceed zero while the ADMITTED requests' p99 stays
             within the SLO (both asserted here, then gated vs the
             baseline) — the whole point of shedding;
  rollout    a canary-then-promote to a fresh version under pending
             traffic (zero stranded futures asserted), then a rollout
             whose canary probe breaches the budget — rolled back, the
             prior version restored fleet-wide (asserted);
  adaptive   the wait controller's per-bucket adjustment trace + final
             deadlines, so the batching-vs-headroom loop is observable.

Like every bench here, first-launch cost is paid in a warmup pass per
worker on the calling thread, before any pump starts (each replica owns
its batchers — that is what makes it a replica), and wall numbers come
from steady state. Every wall interval ends with each future's numpy
result in hand, so it covers the device work it names. Traffic comes
from a numpy seed (an int or a Generator).
"""
from __future__ import annotations

import tempfile
import time
from typing import Dict, List, Sequence, Union

import numpy as np

from repro_torch.fleet.admission import ShedError
from repro_torch.fleet.tier import Fleet
from repro_torch.serve.artifact import FittedModel
from repro_torch.serve.bench import _warm_all_buckets
from repro_torch.serve.versions import VersionStore


def _warm(fleet: Fleet) -> None:
    """Run every reachable bucket once on every replica (the kernels'
    build and first launches), on the calling thread."""
    for w in fleet.workers:
        batcher = w.scheduler().batcher
        _warm_all_buckets(batcher)
        batcher.reset_stats()


def _drive(fleet: Fleet, queries: np.ndarray, widths: np.ndarray,
           control_every: int = 16) -> Dict:
    """Submit one request per width, cooperatively closing the control
    loops; returns wall time, completion and shed counts."""
    futures: List = []
    shed = 0
    off = 0
    t0 = time.perf_counter()
    for i, w in enumerate(widths):
        try:
            futures.append(fleet.submit(queries[:, off:off + int(w)]))
        except ShedError:
            shed += 1
        off += int(w)
        if (i + 1) % control_every == 0:
            fleet.control()
    fleet.flush()
    for f in futures:
        f.result()
    wall = time.perf_counter() - t0
    return {"futures": futures, "shed": shed, "wall_s": wall,
            "admitted": len(futures)}


def benchmark_fleet(model: FittedModel,
                    worker_counts: Sequence[int] = (1, 2),
                    n_requests: int = 192,
                    width_range: Sequence[int] = (1, 64),
                    max_wait_ms: float = 2.0,
                    slo_ms: float = 250.0,
                    overload_depth: int = 64,
                    seed: Union[int, np.random.Generator] = 0,
                    max_bucket: int = 256,
                    **worker_kwargs) -> Dict:
    """Run the soak phases against a temporary VersionStore; returns the
    "fleet" bench dict (schema in the module docstring). worker_kwargs
    (device=, policy=, ...) go to every replica."""
    if isinstance(seed, np.random.Generator):
        seed = int(seed.integers(0, 2 ** 31 - 1))
    rng = np.random.RandomState(seed)
    lo, hi = int(width_range[0]), int(width_range[1])
    widths = rng.randint(lo, hi + 1, size=int(n_requests))
    queries = rng.randn(model.spec.p, int(widths.sum())).astype(np.float32)

    out: Dict = {"mode": "fleet", "n_requests": int(n_requests),
                 "width_range": [lo, hi], "max_wait_ms": float(max_wait_ms),
                 "slo_ms": float(slo_ms), "routing": "least-loaded"}

    with tempfile.TemporaryDirectory() as tmp:
        store = VersionStore(tmp)
        store.publish(model)

        # -- sweep: q/s + merged percentiles per worker count ------------
        sweep = []
        for n_workers in worker_counts:
            fleet = Fleet(store, n_workers=int(n_workers),
                          slo_ms=slo_ms, max_wait_ms=max_wait_ms,
                          max_queue_depth=1 << 30,   # sweep never sheds
                          max_bucket=max_bucket, **worker_kwargs)
            _warm(fleet)
            for w in fleet.workers:          # replica flushes overlap in
                w.scheduler().start()        # real pump threads
            run = _drive(fleet, queries, widths)
            lat = fleet.latency()
            # Final controller step + per-bucket deadlines. Reported as
            # dicts/counters, never trace lists: median_benches merges
            # lists positionally, and a trace's length is timing-
            # dependent across passes.
            adjust = ([a for w_ in fleet.workers
                       for a in fleet.wait_controller.step(w_)]
                      if fleet.wait_controller is not None else [])
            waits = {w_.worker_id:
                     {str(b): w_.scheduler().bucket_wait(b)
                      for b in sorted(w_.latency.by_bucket)}
                     for w_ in fleet.workers}
            fleet.stop()
            assert run["shed"] == 0, "sweep fleet must not shed"
            sweep.append({
                "workers": int(n_workers),
                "queries": int(widths.sum()),
                "wall_s": run["wall_s"],
                "queries_per_sec": float(widths.sum()) / run["wall_s"],
                "p50_ms": lat.total.percentile(50.0),
                "p95_ms": lat.total.percentile(95.0),
                "p99_ms": lat.total.percentile(99.0),
                "slo_violations": lat.slo_violations,
                "adaptive_wait": {
                    "adjustments": len(adjust),
                    "decreases": sum(a["action"] == "decrease"
                                     for a in adjust),
                    "bucket_wait_ms": waits,
                },
            })
        out["sweep"] = sweep
        if len(sweep) > 1:
            out["scaling"] = {
                "workers_max": sweep[-1]["workers"],
                "qps_vs_1_worker": (sweep[-1]["queries_per_sec"] /
                                    sweep[0]["queries_per_sec"]),
            }

        # -- overload: flood past the caps -------------------------------
        fleet = Fleet(store, n_workers=int(worker_counts[-1]),
                      slo_ms=slo_ms, max_wait_ms=max_wait_ms,
                      max_queue_depth=int(overload_depth),
                      max_bucket=max_bucket, **worker_kwargs)
        _warm(fleet)
        futures: List = []
        shed = 0
        breaker_seen = False
        off = 0
        # No polling between submits: the flood outruns the drain — the
        # shape of a real overload spike — so queues hit the caps fast.
        for i, w in enumerate(widths):
            try:
                futures.append(fleet.submit(queries[:, off:off + int(w)]))
            except ShedError:
                shed += 1
            off += int(w)
            if (i + 1) % 32 == 0:
                ctl = fleet.control()
                breaker_seen = breaker_seen or ctl["breaker_open"]
        fleet.flush()
        for f in futures:
            f.result()
        lat = fleet.latency()
        admitted_p99 = lat.total.percentile(99.0)
        adm = fleet.admission.summary()
        fleet.stop()
        offered = len(futures) + shed
        assert shed > 0, (
            f"overload flood ({offered} requests vs depth "
            f"{overload_depth}/worker) shed nothing — admission is broken")
        assert admitted_p99 <= slo_ms, (
            f"admitted-request p99 {admitted_p99:.1f} ms breached the "
            f"{slo_ms:.0f} ms SLO under overload — the queue cap is not "
            f"bounding latency")
        out["overload"] = {
            "workers": int(worker_counts[-1]),
            "max_queue_depth": int(overload_depth),
            "offered": offered,
            "admitted": len(futures),
            "shed": shed,
            "shed_rate": shed / offered,
            "shed_by_reason": adm["shed_by_reason"],
            "admitted_p99_ms": admitted_p99,
            "slo_ms": float(slo_ms),
            "within_slo": bool(admitted_p99 <= slo_ms),
            "breaker_opened": bool(breaker_seen),
        }

        # -- rollout: canary-then-promote, then a gated rollback ---------
        # The centroid rows reversed (torch has no negative-step slice).
        reversed_ = model._replace(
            centroids=model.centroids.flip(0).contiguous())
        v2 = store.publish(reversed_)
        fleet = Fleet(store, n_workers=int(worker_counts[-1]),
                      version=1, slo_ms=slo_ms, max_wait_ms=max_wait_ms,
                      max_queue_depth=1 << 30, max_bucket=max_bucket,
                      **worker_kwargs)
        _warm(fleet)
        # Pending traffic across the rollout: the canary's swap must
        # drain these into the OLD model, stranding none.
        pend = [fleet.submit(queries[:, i * 4:(i + 1) * 4])
                for i in range(min(8, int(widths.sum()) // 4))]
        t0 = time.perf_counter()
        promote = fleet.rollout(v2)
        promote_s = time.perf_counter() - t0
        fleet.flush()
        stranded = sum(not f.done() for f in pend)
        assert promote is not None and promote.promoted, \
            f"canary-then-promote failed: {promote}"
        assert all(w.version == v2 for w in fleet.workers), \
            "promotion left workers on the old version"
        assert stranded == 0, f"rollout stranded {stranded} futures"

        # Rollback: v3's canary probe breaches the budget by fiat (the
        # gate is policy; the bench injects the breach verdict so the
        # ROLLBACK path — not the probe — is what's measured).
        v3 = store.publish(reversed_)
        pend = [fleet.submit(queries[:, i * 4:(i + 1) * 4])
                for i in range(min(8, int(widths.sum()) // 4))]
        rollback = fleet.rollout(v3, probe=lambda w: float("inf"))
        fleet.flush()
        stranded_rb = sum(not f.done() for f in pend)
        fleet.stop()
        assert rollback is not None and rollback.state == "rolled-back", \
            f"breached canary did not roll back: {rollback}"
        assert all(w.version == v2 for w in fleet.workers), \
            "rollback did not restore the prior version fleet-wide"
        assert stranded_rb == 0, \
            f"rollback stranded {stranded_rb} futures"
        out["rollout"] = {
            "promote_s": promote_s,
            "promote": promote.to_dict(),
            "rollback": rollback.to_dict(),
            "stranded_futures": int(stranded + stranded_rb),
            "version_restored": True,
        }
    return out
