"""Serving benchmarks: eight modes, one bench dict (run_benches).

  sync    `benchmark_assign` — bucketed assignments/sec per batch size
          through MicroBatcher (one warmup call per size pays the first
          launch of its bucket); on a sharded policy every rank times the
          same number of (collective) calls;
  async   `benchmark_async` — request traffic through AsyncBatcher with
          deadline-driven flushing; reports the LatencyStats summary
          (p50/p95/p99, queue wait, SLO violations) plus throughput;
  fused   `benchmark_fused` — the extension stripe through the
          extend_embed kernel against the two-pass gram + projection,
          with each stripe's bytes from the kernels' own byte counts;
  swap    `benchmark_swap` — async traffic with a warm hot-swap
          (registry.swap) in the middle: measured flip duration plus p95
          before/after from the surviving LatencyStats;
  backends `benchmark_backends` — every backend fitted through
          KernelKMeans on the same data: accuracy, approximation error,
          fit s and memory model, artifact bytes, serving q/s;
  stream  `benchmark_stream` — the streaming fit (repro_torch.stream):
          partial_fit accumulation throughput, the re-eig cost, and the
          detection-to-swap latency of one full drift rollout (trigger ->
          refit -> publish -> warm swap) against a real VersionStore +
          ModelRegistry;
  fit_scaling  `benchmark_fit_scaling` — partial_fit cols/s single-host
          against the sharded fit (distributed/fit.py) on an n sweep,
          with each block's bytes from the kernels' own counts;
  fleet   `repro_torch.fleet.benchmark_fleet` — the replica tier's soak.

These are the JAX package's benches (repro.serve.bench) with its schema
and section keys; where it read XLA's cost analysis the port counts bytes
with the kernels' byte models (kernels/*/ops.py), and every bench dict
also names the `device`. Randomness comes from a seed (numpy or a
torch.Generator); every wall-clock read on the card follows a
`torch.cuda.synchronize()`, so a time covers the device work it names.
`write_bench` writes the port's own file, BENCH_serve_torch.json by
default (BENCH_serve.json belongs to the JAX package's regression gate).

Schema (run_benches; each bench alone returns its section):

    {"model": {...spec...}, "backend": "cuda" | "cpu", "device": name,
     "calibration": {"matmul512_ms": ...},
     "sharded": false | {"shards": s, "axis": "data"},
     "batch_sizes": [...],
     "results": [{"batch_size": b, "bucket": B, "calls": c, "wall_s": t,
                  "assignments_per_sec": qps}, ...],
     "bucket_executables": [...],
     "async": {"max_wait_ms": ..., "wall_s": ..., "queries_per_sec": ...,
               "latency": <LatencyStats.summary()>},
     "fused": {"fused": {...}, "two_pass": {...}, "speedup": ...,
               "hbm": {"two_pass_bytes": ..., "fused_bytes": ...,
                       "saved_bytes": ..., "saved_ratio": ...}},
     "swap": {"flip_ms": ..., "warm_s": ..., "drain_s": ...,
              "buckets_warmed": [...], "drained_requests": ...,
              "p95_before_ms": ..., "p95_after_ms": ...,
              "stranded_futures": 0},
     "backends": {"per_backend": {"onepass-srht": {"accuracy": ...,
                  "kernel_approx_error": ..., "fit_s": ...,
                  "fit_memory_bytes": ..., "artifact_bytes": ...,
                  "n_ref": ..., "assignments_per_sec": ...}, ...}},
     "stream": {"partial_fit_chunks_per_sec": ...,
                "partial_fit_cols_per_sec": ..., "reeig_s": ...,
                "rollout": {"detect_to_swap_s": ..., "refit_s": ...,
                            "publish_s": ..., "swap_s": ...,
                            "stranded_futures": 0, "retrains": 1}},
     "fit_scaling": {"shards": s, "rows": [...]},
     "fleet": {"sweep": [...], "overload": {...}, "rollout": {...}}}
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serve.artifact import FittedModel
from repro_torch.serve.batcher import MicroBatcher, bucket_size
from repro_torch.serve.registry import ModelRegistry
from repro_torch.serve.scheduler import AsyncBatcher

BENCH_PATH = "BENCH_serve_torch.json"


def _sync(device) -> None:
    """Wait for the card before a host-clock read (no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _min_call_time(fn, repeats: int, device, min_total_s: float = 0.25,
                   max_calls: int = 1000):
    """(best per-call seconds, calls made, total wall seconds).

    Throughput from the BEST of an auto-calibrated number of calls
    (timeit's estimator): serving calls finish in ~ms, where a mean over
    a fixed handful of calls is dominated by scheduler/GC outliers.
    `repeats` is the floor; the count is raised until ~min_total_s of
    samples back the minimum. The caller must have warmed `fn` already.
    """
    def timed():
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        return time.perf_counter() - t0

    est = timed()
    calls = max(int(repeats),
                min(max_calls, int(min_total_s / max(est, 1e-9)) + 1))
    times = [est] + [timed() for _ in range(calls - 1)]
    return min(times), calls, sum(times)


def _traffic(p: int, n_requests: int, width_range: Sequence[int],
             seed: int):
    """Request widths uniform in width_range and their (p, sum) queries."""
    rng = np.random.RandomState(seed)
    lo, hi = int(width_range[0]), int(width_range[1])
    widths = rng.randint(lo, hi + 1, size=n_requests)
    queries = rng.randn(p, int(widths.sum())).astype(np.float32)
    return widths, queries


def _warm_all_buckets(batcher: MicroBatcher) -> None:
    """One zero batch per pow-2 bucket in [min_bucket, max_bucket]:
    steady-state percentiles, not first-launch spikes."""
    bsz = batcher.min_bucket
    widths = []
    while bsz <= batcher.max_bucket:
        widths.append(bsz)
        bsz *= 2
    batcher.warm(widths)


def benchmark_assign(model: FittedModel,
                     batch_sizes: Sequence[int] = (64, 512),
                     repeats: int = 5, seed: int = 0,
                     block: Optional[int] = None, policy=None,
                     max_bucket: int = 1024) -> Dict:
    """Drive synthetic query load through a MicroBatcher; returns the dict
    documented in the module docstring."""
    rng = np.random.RandomState(seed)
    batcher = MicroBatcher(model, block=block, policy=policy,
                           max_bucket=max_bucket)
    # Each call of a batcher sharded over ranks is collective: every rank
    # makes the same fixed `repeats` calls, uncalibrated. (That is the
    # sync contract; the async bench is driven by rank 0 instead, which
    # owns the front door: serve/pump.py.)
    collective = policy is not None and policy.shards > 1
    results = []
    for b in batch_sizes:
        Xq = torch.from_numpy(rng.randn(model.spec.p, b).astype(
            np.float32)).to(model.device)
        batcher.assign_batch(Xq)                    # warmup: first launch
        best, calls, wall = _min_call_time(
            lambda: batcher.assign_batch(Xq), repeats, model.device,
            max_calls=repeats if collective else 1000)
        results.append({
            "batch_size": int(b),
            "bucket": bucket_size(b, batcher.min_bucket, batcher.max_bucket),
            "calls": int(calls),
            "wall_s": wall,
            "assignments_per_sec": b / best,
        })
    return {
        "model": dataclasses.asdict(model.spec),
        "backend": model.device.type,
        "device": _device_name(model.device),
        "batch_sizes": [int(b) for b in batch_sizes],
        "results": results,
        "bucket_executables": batcher.executables,
    }


def benchmark_async(model: FittedModel,
                    n_requests: int = 256,
                    width_range: Sequence[int] = (1, 64),
                    max_wait_ms: float = 2.0,
                    slo_ms: float = 250.0,
                    seed: int = 0,
                    block: Optional[int] = None, policy=None,
                    max_bucket: int = 1024) -> Optional[Dict]:
    """Request traffic through AsyncBatcher; returns latency percentiles.

    Submits n_requests of uniformly random widths in width_range, polling
    the deadline between submits (cooperative mode — the bench IS the
    event loop, so numbers are not polluted by pump-thread jitter), then
    flushes the tail. Every pow-2 bucket the traffic can hit is warmed
    first.

    On a policy with a mesh the batcher is pumped (serve/pump.py): every
    rank builds and warms it, rank 0 drives the traffic and stops it,
    and every other rank follows; a follower returns None.
    """
    widths, queries = _traffic(model.spec.p, n_requests, width_range, seed)
    async_batcher = AsyncBatcher(model, max_wait_ms=max_wait_ms,
                                 slo_ms=slo_ms, block=block, policy=policy,
                                 max_bucket=max_bucket)
    _warm_all_buckets(async_batcher.batcher)
    async_batcher.batcher.reset_stats()
    if not async_batcher.leader:
        async_batcher.follow()
        return None

    futures = []
    off = 0
    _sync(model.device)
    t0 = time.perf_counter()
    for w in widths:
        futures.append(async_batcher.submit(queries[:, off:off + w]))
        off += w
        async_batcher.poll()
    async_batcher.flush()
    for fut in futures:
        fut.result()                              # all resolved by flush
    _sync(model.device)
    wall = time.perf_counter() - t0
    async_batcher.stop()                          # pumped: the STOP
    total_q = int(widths.sum())
    return {
        "mode": "async",
        "n_requests": int(n_requests),
        "width_range": [int(width_range[0]), int(width_range[1])],
        "max_wait_ms": float(max_wait_ms),
        "wall_s": wall,
        "queries_per_sec": total_q / wall,
        "latency": async_batcher.latency.summary(),
        "bucket_executables": async_batcher.batcher.executables,
    }


def benchmark_swap(model: FittedModel,
                   new_model: Optional[FittedModel] = None,
                   n_requests: int = 128,
                   width_range: Sequence[int] = (1, 64),
                   max_wait_ms: float = 2.0,
                   slo_ms: float = 250.0,
                   seed: int = 0,
                   block: Optional[int] = None, policy=None,
                   max_bucket: int = 1024) -> Dict:
    """Async traffic with a warm hot-swap in the middle; measures the flip.

    Half the requests run against the original model, registry.swap()
    flips to `new_model` (default: a re-wrap of the same fit — the
    same-spec refresh case every real redeploy hits), the other half run
    against the swapped-in row. All timing comes from the surviving
    LatencyStats, so p95_before/p95_after are directly comparable — the
    after number includes the before samples (cumulative histogram): a
    swap that stalled traffic shows up as p95_after >> p95_before.
    Every future is checked resolved; `stranded_futures` must be 0.
    """
    widths, queries = _traffic(model.spec.p, n_requests, width_range, seed)
    reg = ModelRegistry()
    reg.register("swap-bench", model, version=1)
    sched = reg.scheduler("swap-bench", max_wait_ms=max_wait_ms,
                          slo_ms=slo_ms, block=block, policy=policy,
                          max_bucket=max_bucket)
    # Warm every reachable bucket so the percentiles measure steady-state
    # serving (and the swap's warm phase has a full history to replay).
    _warm_all_buckets(sched.batcher)

    half = n_requests // 2
    pend_n = min(4, half)
    futures = []
    off = 0

    def drive(target, lo_i, hi_i, flush=True):
        nonlocal off
        for w in widths[lo_i:hi_i]:
            futures.append(target.submit(queries[:, off:off + w]))
            off += w
            if flush:
                target.poll()
        if flush:
            target.flush()

    _sync(model.device)
    t0 = time.perf_counter()
    drive(sched, 0, half - pend_n)
    # The last pre-swap requests stay PENDING at flip time: the swap's
    # drain — not a client flush — must resolve them through the old
    # model, so drained_requests measures the real pending-at-flip path.
    drive(sched, half - pend_n, half, flush=False)
    report = reg.swap("swap-bench",
                      new_model if new_model is not None
                      else model._replace(), version=2)
    sched2 = reg.scheduler("swap-bench")
    drive(sched2, half, n_requests)
    _sync(model.device)
    wall = time.perf_counter() - t0
    report.p95_after_ms = sched2.latency.total.percentile(95.0)
    stranded = sum(not f.done() for f in futures)
    reg.unregister("swap-bench")
    out = {"mode": "swap", "n_requests": int(n_requests),
           "width_range": [int(width_range[0]), int(width_range[1])],
           "max_wait_ms": float(max_wait_ms),
           "wall_s": wall, "stranded_futures": int(stranded)}
    out.update({k: v for k, v in report.to_dict().items()
                if k not in ("name", "old_version", "new_version")})
    return out


def benchmark_stream(model: FittedModel, n_chunks: int = 8,
                     chunk_cols: int = 128, repeats: int = 3,
                     seed: int = 0, block: Optional[int] = None,
                     max_wait_ms: float = 2.0) -> Dict:
    """The streaming-fit path (repro_torch.stream) as bench numbers.

    Three read-outs:

      partial_fit_*_per_sec  accumulation throughput: chunks folded with
                             reeig=False (the steady-state ingest path) —
                             best pass of `repeats`, each on a fresh
                             accumulator;
      reeig_s                re-eig cost at full capacity (one_pass_core
                             + full K-means re-cluster), best of
                             `repeats` after a warmup call;
      rollout                detection-to-swap latency of one REAL drift
                             rollout — drifted async traffic observed by
                             a DriftMonitor, RetrainWorker.step() doing
                             refit -> VersionStore.publish -> warm
                             registry.swap — with the zero-stranded-
                             futures invariant re-checked.

    The accumulation/re-eig section streams random data through the
    model's spec (coerced to a one-pass backend) on the model's device;
    the rollout is a self-contained 1-d drift demo there.
    """
    import tempfile

    from repro_torch.api import KernelKMeans
    from repro_torch.serve.versions import VersionStore
    from repro_torch.stream import DriftMonitor, RetrainWorker

    spec, device = model.spec, model.device
    backend = (spec.backend if spec.backend.startswith("onepass-")
               else "onepass-srht")
    blk = min(block or spec.block, chunk_cols)
    capacity = int(n_chunks) * int(chunk_cols)
    gen = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((spec.p, capacity), generator=gen, device=device)

    def one_pass():
        est = KernelKMeans(k=spec.k, r=spec.r, kernel=spec.kernel,
                           kernel_params=spec.kernel_params,
                           backend=backend, block=blk, device=device)
        est.partial_fit(X[:, :chunk_cols], seed=seed, capacity=capacity,
                        reeig=False)               # warmup chunk
        _sync(device)
        t0 = time.perf_counter()
        for i in range(1, n_chunks):
            est.partial_fit(X[:, i * chunk_cols:(i + 1) * chunk_cols],
                            reeig=False)
        _sync(device)
        return time.perf_counter() - t0, est

    walls = []
    for _ in range(max(int(repeats), 1)):
        wall, est = one_pass()
        walls.append(wall)
    accum_best = min(walls)

    est.reeig_now()                                # warmup
    reeig_times = []
    for _ in range(max(int(repeats), 1)):
        _sync(device)
        t0 = time.perf_counter()
        est.reeig_now()
        _sync(device)
        reeig_times.append(time.perf_counter() - t0)

    # One full drift rollout against a real store + registry.
    from repro_torch.data import blobs_1d
    rng = np.random.RandomState(0)
    X0 = blobs_1d(rng, (-2.0, 2.0), n_per=80)[0]
    Xd = blobs_1d(rng, (3.0, 8.0), n_per=80)[0]
    demo = KernelKMeans(k=2, r=2, kernel="linear", backend="onepass-srht",
                        block=64, device=device)
    demo.partial_fit(X0, seed=seed, capacity=X0.shape[1] + Xd.shape[1])
    with tempfile.TemporaryDirectory() as tmp:
        store = VersionStore(tmp, keep=2)
        reg = ModelRegistry()
        reg.register("stream-bench", demo.model_,
                     version=store.publish(demo.model_))
        sched = reg.scheduler("stream-bench", max_wait_ms=max_wait_ms)
        mon = DriftMonitor(demo.model_, ref_labels=demo.labels_,
                           min_queries=64)
        worker = RetrainWorker("stream-bench", reg, store, mon,
                               lambda rep: demo.partial_fit(Xd).model_)
        chunks = [Xd[:, i * 20:(i + 1) * 20] for i in range(8)]
        futures = [sched.submit(ch) for ch in chunks]
        sched.flush()
        for ch, fut in zip(chunks, futures):
            mon.observe(ch, fut.result()[0])
        pending = sched.submit(Xd[:, :8])          # drained by the swap
        rollout = worker.step()
        if rollout is None:
            raise RuntimeError("drift rollout did not fire")
        stranded = sum(not f.done() for f in futures + [pending])
        reg.unregister("stream-bench")             # retire the new row

    return {
        "mode": "stream",
        "stream_backend": backend,
        "chunk_cols": int(chunk_cols),
        "n_chunks": int(n_chunks),
        "capacity": capacity,
        "block": int(blk),
        "partial_fit_chunks_per_sec": (n_chunks - 1) / accum_best,
        "partial_fit_cols_per_sec":
            (n_chunks - 1) * chunk_cols / accum_best,
        "reeig_s": min(reeig_times),
        "rollout": {
            "detect_to_swap_s": float(rollout.detect_to_swap_s),
            "refit_s": float(rollout.refit_s),
            "publish_s": float(rollout.publish_s),
            "swap_s": float(rollout.swap_s),
            "drift_chi2": float(rollout.drift.chi2),
            "drained_requests": int(rollout.swap.drained_requests),
            "stranded_futures": int(stranded),
            "retrains": int(worker.retrains),
        },
    }


def median_benches(benches: Sequence[Dict]) -> Dict:
    """Per-leaf median across K same-shape bench dicts.

    A single bench pass's async latency section moves with transient
    machine state even after min-of-N per-call timing, so a caller runs
    the benches K times and keeps the element-wise median. Non-numeric
    leaves (and bools/strings) take the first pass's value.
    """
    def merge(vals):
        v0 = vals[0]
        if isinstance(v0, dict):
            # Timing-dependent sections (the async per-bucket breakdown)
            # can legitimately differ in keys across passes — a request
            # that coalesced into bucket 512 on pass 1 may land in 1024
            # on pass 2. Median over the passes that saw the key.
            return {k: merge([v[k] for v in vals
                              if isinstance(v, dict) and k in v])
                    for k in v0}
        if isinstance(v0, list):
            return [merge([v[i] for v in vals]) for i in range(len(v0))]
        if isinstance(v0, bool) or not isinstance(v0, (int, float)):
            return v0
        med = statistics.median(vals)
        # Even pass counts give float midpoints; round (not truncate)
        # integer leaves like calls / slo_violations.
        return round(med) if isinstance(v0, int) else float(med)

    benches = list(benches)
    return benches[0] if len(benches) == 1 else merge(benches)


def format_bench(bench: Dict) -> str:
    """Human-readable lines for a bench dict."""
    lines = []
    for row in bench.get("results", []):
        lines.append(f"batch {row['batch_size']:>6d} "
                     f"(bucket {row['bucket']:>5d}): "
                     f"{row['assignments_per_sec']:>12.0f} assignments/sec")
    if "async" in bench:
        a = bench["async"]
        lat = a["latency"]["latency_ms"]
        lines.append(f"async: {a['queries_per_sec']:>12.0f} queries/sec  "
                     f"p50 {lat['p50']:.2f} ms  p95 {lat['p95']:.2f} ms  "
                     f"p99 {lat['p99']:.2f} ms  SLO violations "
                     f"{a['latency']['slo_violations']}")
    if "swap" in bench:
        s = bench["swap"]
        after = (f"{s['p95_after_ms']:.2f}"
                 if s.get("p95_after_ms") is not None else "—")
        lines.append(
            f"swap: flip {s['flip_ms']:.3f} ms  warm {s['warm_s']:.3f} s "
            f"(buckets {s['buckets_warmed']})  p95 {s['p95_before_ms']:.2f}"
            f" -> {after} ms  stranded futures {s['stranded_futures']}")
    if "stream" in bench:
        st = bench["stream"]
        ro = st["rollout"]
        lines.append(
            f"stream: partial_fit {st['partial_fit_cols_per_sec']:>10.0f} "
            f"cols/sec ({st['partial_fit_chunks_per_sec']:.1f} chunks/sec "
            f"@ {st['chunk_cols']} cols)  re-eig {st['reeig_s'] * 1e3:.1f}"
            f" ms @ n={st['capacity']}")
        lines.append(
            f"  drift rollout: detect->swap {ro['detect_to_swap_s']:.3f} s"
            f" (refit {ro['refit_s']:.3f} s, publish {ro['publish_s']:.3f}"
            f" s, swap {ro['swap_s']:.3f} s)  stranded futures "
            f"{ro['stranded_futures']}")
    if "backends" in bench and "per_backend" in bench["backends"]:
        for name, row in sorted(bench["backends"]["per_backend"].items()):
            lines.append(
                f"backend {name:>16s}: acc {row['accuracy']:.3f}  "
                f"err {row['kernel_approx_error']:.3f}  "
                f"fit {row['fit_s']:6.2f} s / "
                f"{row['fit_memory_bytes'] / 1e6:8.2f} MB  "
                f"serve {row['assignments_per_sec']:>10.0f} q/s "
                f"(n_ref {row['n_ref']})")
    if "fleet" in bench:
        fl = bench["fleet"]
        for row in fl["sweep"]:
            lines.append(
                f"fleet {row['workers']} worker"
                f"{'s' if row['workers'] != 1 else ''}: "
                f"{row['queries_per_sec']:>10.0f} q/s  "
                f"p50 {row['p50_ms']:.2f} ms  p95 {row['p95_ms']:.2f} ms  "
                f"p99 {row['p99_ms']:.2f} ms")
        ov = fl["overload"]
        lines.append(
            f"  overload (depth {ov['max_queue_depth']}): shed "
            f"{ov['shed']}/{ov['offered']} ({ov['shed_rate']:.0%})  "
            f"admitted p99 {ov['admitted_p99_ms']:.2f} ms "
            f"{'<=' if ov['within_slo'] else '>'} SLO {ov['slo_ms']:.0f} ms")
        ro = fl["rollout"]
        lines.append(
            f"  rollout: promote v{ro['promote']['version']} in "
            f"{ro['promote']['wall_s']:.3f} s (canary p95 "
            f"{ro['promote']['canary_p95_ms']:.2f} ms)  rollback "
            f"v{ro['rollback']['version']} -> {ro['rollback']['state']}  "
            f"stranded futures {ro['stranded_futures']}")
    if "fit_scaling" in bench:
        fs = bench["fit_scaling"]
        for row in fs["rows"]:
            by = row["bytes"]
            lines.append(
                f"fit n={row['n']:>6d} ({fs['shards']} shard"
                f"{'s' if fs['shards'] != 1 else ''}): single "
                f"{row['single_cols_per_sec']:>9.0f} cols/sec  sharded "
                f"{row['sharded_cols_per_sec']:>9.0f} cols/sec  block "
                f"fit_sketch {by['fit_sketch'] / 1e6:.2f} MB, srht_t "
                f"{by['srht_t'] / 1e6:.2f} MB")
    if "fused" in bench:
        f = bench["fused"]
        hbm = f["hbm"]
        interp = " (interpret)" if f["interpret"] else ""
        lines.append(
            f"fused stripe{interp}: "
            f"{f['fused']['queries_per_sec']:>10.0f} q/s  vs two-pass "
            f"{f['two_pass']['queries_per_sec']:>10.0f} q/s  "
            f"(speedup {f['speedup']:.2f}x)")
        lines.append(
            f"  stripe bytes: two-pass {hbm['two_pass_bytes'] / 1e6:.2f} MB"
            f" -> fused {hbm['fused_bytes'] / 1e6:.2f} MB  "
            f"(saves {hbm['saved_ratio']:.0%})")
    if "calibration" in bench:
        lines.append(f"calibration: 512 x 512 matmul "
                     f"{bench['calibration']['matmul512_ms']:.4f} ms")
    return "\n".join(lines)


def write_bench(path: Optional[str], bench: Dict) -> str:
    """Write `bench` as JSON to `path` (None: BENCH_PATH); returns it."""
    path = path or BENCH_PATH
    with open(path, "w") as f:
        json.dump(bench, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def _fit_block_bytes(p: int, n: int, b: int, rp: int, shards: int) -> Dict:
    """Bytes of the last block update (q + b = n) at capacity n, from the
    kernels' own counts: the kappa stripe (as the gram kernel would move
    it), the canonical route's srht_t, the sharded route's fwht of one
    rank's (N / shards, b) slab, and the fused route's fit_sketch."""
    from repro_torch.core.sketch import next_pow2
    from repro_torch.kernels.fit_sketch.ops import fit_sketch_bytes
    from repro_torch.kernels.fwht.ops import fwht_bytes, srht_t_bytes
    from repro_torch.kernels.gram.ops import gram_stripe_bytes
    n_pad = next_pow2(n)
    return {"kappa_stripe": gram_stripe_bytes(p, n, b),
            "srht_t": srht_t_bytes(n, b, rp, n_pad),
            "fwht_slab": fwht_bytes(max(n_pad // shards, 1), b),
            "fit_sketch": fit_sketch_bytes(p, n, b, rp),
            "source": "kernels/*/ops.py byte counts"}


def benchmark_fit_scaling(model: FittedModel, ns: Sequence[int] = (128, 256,
                                                                   512),
                          repeats: int = 3, seed: int = 0,
                          block: Optional[int] = None,
                          policy=None) -> Dict:
    """The sharded one-pass fit against the single-host accumulator on an
    n sweep.

    For each n: n columns streamed chunk by chunk through
    `KernelKMeans.partial_fit(reeig=False)` (the steady-state ingest
    path), under a mesh ComputePolicy (every rank of the world when
    `policy` is None) and under the same policy without its mesh, so both
    take the same route (canonical or fused); cols/s of each, the best pass of
    `repeats` on a fresh estimator (the first chunk, untimed, pays the
    first launches). At world size 1, "sharded" measures the engine's cost
    over the canonical path at equal bits. Collective: every rank calls
    it. Each row carries the block's bytes (_fit_block_bytes).
    """
    import torch.distributed as dist

    from repro_torch.api import KernelKMeans
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.serve.policy import ComputePolicy

    spec, device = model.spec, model.device
    backend = (spec.backend if spec.backend.startswith("onepass-")
               else "onepass-srht")
    chunk = min(block or spec.block, min(int(n) for n in ns))
    if policy is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        policy = ComputePolicy(mesh=make_debug_mesh(data=world,
                                                    device=device))
    rp = spec.r + int(spec.backend_params.get("oversampling", 10))

    def one_pass(n_chunks, capacity, X, pol):
        est = KernelKMeans(k=spec.k, r=spec.r, kernel=spec.kernel,
                           kernel_params=spec.kernel_params,
                           backend=backend, block=chunk,
                           backend_params={"oversampling": rp - spec.r},
                           policy=pol, device=device)
        est.partial_fit(X[:, :chunk], seed=seed, capacity=capacity,
                        reeig=False)               # warmup chunk
        _sync(device)
        t0 = time.perf_counter()
        for i in range(1, n_chunks):
            est.partial_fit(X[:, i * chunk:(i + 1) * chunk], reeig=False)
        _sync(device)
        return time.perf_counter() - t0

    gen = torch.Generator(device=device).manual_seed(seed)
    rows, seen = [], set()
    for n in ns:
        n_chunks = max(int(n) // chunk, 2)
        capacity = n_chunks * chunk
        if capacity in seen:    # small n collapse onto one capacity
            continue
        seen.add(capacity)
        X = torch.randn((spec.p, capacity), generator=gen, device=device)
        single = min(one_pass(n_chunks, capacity, X,
                              policy.replace(mesh=None))
                     for _ in range(max(int(repeats), 1)))
        sharded = min(one_pass(n_chunks, capacity, X, policy)
                      for _ in range(max(int(repeats), 1)))
        cols = (n_chunks - 1) * chunk
        rows.append({
            "n": int(capacity), "chunk_cols": int(chunk),
            "single_cols_per_sec": cols / single,
            "sharded_cols_per_sec": cols / sharded,
            "sharded_over_single": single / sharded,
            "bytes": _fit_block_bytes(spec.p, capacity, chunk, rp,
                                      policy.shards)})
    return {"mode": "fit_scaling", "fit_backend": backend,
            "shards": int(policy.shards), "chunk_cols": int(chunk),
            "repeats": int(repeats), "device": _device_name(device),
            "rows": rows}


def _stripe_traffic(model: FittedModel, width: int) -> Dict:
    """Bytes of one serving stripe of `width` queries, from the kernels'
    own counts: two-pass is the gram stripe (the (n, width) stripe
    written) plus the projection (the stripe read back, P read, the
    embedding written); fused is the extend_embed kernel, whose stripe
    never reaches memory. n is the extension height: the landmark count
    of a Nystrom fit, the training count otherwise."""
    from repro_torch.kernels.extend_embed.ops import extend_embed_bytes
    from repro_torch.kernels.gram.ops import gram_stripe_bytes
    spec = model.spec
    p, n, r = spec.p, model.n_ref, spec.r
    two_pass = (gram_stripe_bytes(p, n, width)
                + 4 * (r * n + n * width + r * width))
    fused = extend_embed_bytes(p, n, r, width)
    return {
        "two_pass_bytes": float(two_pass),
        "two_pass_source": "kernels.gram.ops.gram_stripe_bytes + the "
                           "projection's 4 (r n + n w + r w)",
        "fused_bytes": float(fused),
        "fused_source": "kernels.extend_embed.ops.extend_embed_bytes",
        "stripe_roundtrip_bytes": float(2 * 4 * n * width),
        "saved_bytes": float(two_pass - fused),
        "saved_ratio": float((two_pass - fused) / two_pass)
        if two_pass else 0.0,
    }


def benchmark_fused(model: FittedModel, width: int = 512, repeats: int = 5,
                    seed: int = 0, block: Optional[int] = None,
                    interpret: Optional[bool] = None) -> Dict:
    """Fused extend_embed stripe against the two-pass gram + projection,
    on the same (p, width) queries.

    Embeds the batch through both engines (the first call of each paid
    outside the timed loop; every timed call ends in a synchronize) and
    reports throughput each plus the stripe's bytes (_stripe_traffic). On
    CPU tensors the fused engine runs the kernel's plain version
    (interpret=True unless given), so its time there is not the kernel's.
    """
    from repro_torch.serve.extend import Extender
    from repro_torch.serve.policy import ComputePolicy
    device = model.device
    block_w = min(block or model.spec.block, width)
    if interpret is None and device.type == "cpu":
        interpret = True
    engines = {
        "fused": Extender(model, block_w, policy=ComputePolicy(
            embed_fused=True, interpret=interpret)),
        "two_pass": Extender(model, block_w,
                             policy=ComputePolicy(embed_fused=False)),
    }
    gen = torch.Generator(device=device).manual_seed(seed)
    Xq = torch.randn((model.spec.p, width), generator=gen, device=device)
    out: Dict = {"mode": "fused", "width": int(width),
                 "block": int(block_w), "repeats": int(repeats),
                 "backend": device.type, "device": _device_name(device),
                 "interpret": bool(interpret)}
    for name, ext in engines.items():
        ext.embed(Xq)                                 # first launch
        best, calls, wall = _min_call_time(lambda: ext.embed(Xq), repeats,
                                           device)
        out[name] = {"wall_s": wall, "calls": int(calls),
                     "queries_per_sec": width / best}
    out["speedup"] = (out["fused"]["queries_per_sec"] /
                      out["two_pass"]["queries_per_sec"])
    out["hbm"] = _stripe_traffic(model, block_w)
    return out


# benchmark_backends' fit cache, bounded to ONE sweep: keyed by a data
# fingerprint (shape and first two moments), the fit config and the seed;
# a new (data, config) evicts the previous sweep's models.
_BACKEND_FIT_CACHE: Dict = {}


def benchmark_backends(X, labels, k: int, r: int,
                       backends: Optional[Sequence[str]] = None,
                       kernel: str = "polynomial",
                       kernel_params: Optional[Dict] = None,
                       block: int = 512, batch_size: int = 256,
                       repeats: int = 3, seed: int = 0, policy=None,
                       max_n: int = 4000, device=None) -> Dict:
    """The paper's comparison as a bench section: every registered
    backend fitted through KernelKMeans on the same data, and per backend

      accuracy            best-permutation clustering accuracy vs labels
      kernel_approx_error streaming ||K - Y^T Y||_F / ||K||_F
      fit_s               fit wall time (backend + K-means), synchronized
      fit_memory_bytes    the backend's memory model (O(r'n) one-pass,
                          O(mn) Nystrom, O(n^2) exact)
      artifact_bytes      the saved model's array payload
      n_ref               serving extension height (m for Nystrom, n else)
      assignments_per_sec bucketed serving throughput at `batch_size`
                          through a MicroBatcher on `policy`

    X (p, n) lands on `device` (X's own when it is a tensor, else the
    card). The exact backend forms the n x n gram, so X is cut to its
    first `max_n` columns (a uniform subsample for the shuffled synthetic
    sets), recorded as `subsampled_from`. Fits are cached per (data,
    config, seed) for one sweep, so repeated passes re-time only the
    serving loop.
    """
    from repro_torch.api import (KernelKMeans, available_backends,
                                 fit_memory_bytes)
    from repro_torch.api.estimator import resolve_device
    from repro_torch.core.metrics import (clustering_accuracy,
                                          kernel_approx_error_streaming)
    from repro_torch.serve.artifact import _array_state

    if device is None and isinstance(X, torch.Tensor):
        device = X.device
    device = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32, device=device)
    if isinstance(labels, torch.Tensor):
        labels = labels.cpu().numpy()
    labels = np.asarray(labels)
    backends = list(backends) if backends else available_backends()
    full_n = int(X.shape[1])
    if full_n > max_n:
        X, labels = X[:, :max_n], labels[:max_n]
    n = int(X.shape[1])
    data_print = (tuple(X.shape), float(X.sum()), float((X * X).sum()))
    cfg = (data_print, n, int(k), int(r), kernel,
           tuple(sorted((kernel_params or {}).items())), int(block),
           int(seed), str(device))
    if _BACKEND_FIT_CACHE.get("cfg") != cfg:
        _BACKEND_FIT_CACHE.clear()
        _BACKEND_FIT_CACHE["cfg"] = cfg
    gen = torch.Generator(device=device).manual_seed(seed)
    per_backend: Dict[str, Dict] = {}
    for name in backends:
        cached = _BACKEND_FIT_CACHE.get((cfg, name))
        if cached is None:
            est = KernelKMeans(k=k, r=r, kernel=kernel,
                               kernel_params=kernel_params, backend=name,
                               block=block, device=device)
            _sync(device)
            t0 = time.perf_counter()
            est.fit(X, seed=seed)
            _sync(device)
            fit_s = time.perf_counter() - t0
            model = est.model_
            err = kernel_approx_error_streaming(model.kernel_fn(), X,
                                                est.embedding_, block=block)
            cached = {"model": model, "row": {
                "accuracy": float(clustering_accuracy(labels, est.labels_,
                                                      k)),
                "kernel_approx_error": float(err),
                "fit_s": float(fit_s),
                "fit_memory_bytes": int(fit_memory_bytes(
                    name, n, r, **est.backend_params)),
                "artifact_bytes": sum(int(v.nbytes) for v in
                                      _array_state(model).values()),
                "n_ref": model.n_ref,
            }}
            _BACKEND_FIT_CACHE[(cfg, name)] = cached
        model = cached["model"]
        batcher = MicroBatcher(model, policy=policy)
        Xq = torch.randn((model.spec.p, batch_size), generator=gen,
                         device=device)
        batcher.assign_batch(Xq)                     # first launches
        best, calls, wall = _min_call_time(
            lambda: batcher.assign_batch(Xq), repeats, device)
        per_backend[name] = dict(cached["row"],
                                 assignments_per_sec=batch_size / best,
                                 calls=int(calls), wall_s=wall)
    out = {"mode": "backends", "n": n, "k": int(k), "r": int(r),
           "batch_size": int(batch_size), "device": _device_name(device),
           "per_backend": per_backend}
    if full_n > n:
        out["subsampled_from"] = full_n
    return out


def machine_calibration(device=None) -> Dict:
    """Machine-speed probe stored in every bench file: the best time of a
    512 x 512 torch.mm on `device` (the card when None), synchronized,
    over at least 10 calls."""
    from repro_torch.api.estimator import resolve_device
    device = resolve_device(device)
    x = torch.ones((512, 512), device=device)
    torch.mm(x, x)                                    # first launch
    best, _, _ = _min_call_time(lambda: torch.mm(x, x), 10, device,
                                min_total_s=0.2)
    return {"matmul512_ms": best * 1e3}


BENCH_MODES = ("sync", "async", "fused", "swap", "backends", "stream",
               "fit_scaling", "fleet")


def run_benches(model: FittedModel, modes: Sequence[str] = ("sync", "async"),
                batch_sizes: Sequence[int] = (64, 512), repeats: int = 5,
                seed: int = 0, block: Optional[int] = None, policy=None,
                max_bucket: int = 1024, n_requests: int = 256,
                max_wait_ms: float = 2.0, slo_ms: float = 250.0,
                data: Optional[Tuple] = None) -> Dict:
    """Run the requested bench modes (BENCH_MODES) into one bench dict,
    the JAX package's sections.

    `policy` (a ComputePolicy) picks the serving paths; its mesh shards
    the sync and async benches (ShardedExtender; the async one through
    the rank-0 pump, serve/pump.py), and fit_scaling runs on it (on a
    world of every rank when it has none). The other modes run
    unsharded, as the JAX package's do; over more than one rank the
    lifecycle sections (swap, stream, fleet) run on rank 0 alone, as on
    JAX's one controller, and only rank 0's dict holds them and the async
    section. `data=(X, labels)` enables the "backends" mode; without it
    the section records that it was skipped.
    """
    import torch.distributed as dist

    from repro_torch.serve.policy import ComputePolicy
    policy = policy if policy is not None else ComputePolicy()
    local = policy.replace(mesh=None)
    rank0 = (policy.mesh is None or not dist.is_initialized()
             or dist.get_rank() == 0)
    device = model.device
    bench: Dict = {
        "model": dataclasses.asdict(model.spec),
        "backend": device.type,
        "device": _device_name(device),
        "calibration": machine_calibration(device),
        "sharded": ({"shards": int(policy.shards),
                     "axis": policy.mesh_axis}
                    if policy.mesh is not None else False),
    }
    if "sync" in modes:
        bench.update(benchmark_assign(
            model, batch_sizes=batch_sizes, repeats=repeats, seed=seed,
            block=block, policy=policy, max_bucket=max_bucket))
    if "async" in modes:
        section = benchmark_async(
            model, n_requests=n_requests, max_wait_ms=max_wait_ms,
            slo_ms=slo_ms, seed=seed, block=block, policy=policy,
            max_bucket=max_bucket)
        if section is not None:
            bench["async"] = section
    if "fused" in modes:
        bench["fused"] = benchmark_fused(model, repeats=repeats, seed=seed,
                                         block=block,
                                         interpret=policy.interpret)
    if "swap" in modes and rank0:
        bench["swap"] = benchmark_swap(
            model, n_requests=max(n_requests // 2, 32),
            max_wait_ms=max_wait_ms, slo_ms=slo_ms, seed=seed, block=block,
            policy=local, max_bucket=max_bucket)
    if "stream" in modes and rank0:
        bench["stream"] = benchmark_stream(model, repeats=repeats,
                                           seed=seed, block=block,
                                           max_wait_ms=max_wait_ms)
    if "fit_scaling" in modes:
        bench["fit_scaling"] = benchmark_fit_scaling(
            model, repeats=repeats, seed=seed, block=block,
            policy=(ComputePolicy(mesh=policy.mesh,
                                  mesh_axis=policy.mesh_axis)
                    if policy.mesh is not None else None))
    if "fleet" in modes and rank0:
        # Imported here: repro_torch.fleet composes the serve layer.
        from repro_torch.fleet import benchmark_fleet
        bench["fleet"] = benchmark_fleet(
            model, max_wait_ms=max_wait_ms, slo_ms=slo_ms, seed=seed,
            block=block, policy=local, device=device)
    if "backends" in modes:
        if data is None:
            bench["backends"] = {"skipped": "no (X, labels) data passed"}
        else:
            X, labels = data
            spec = model.spec
            bench["backends"] = benchmark_backends(
                X, labels, k=spec.k, r=spec.r, kernel=spec.kernel,
                kernel_params=spec.kernel_params, block=block or spec.block,
                repeats=repeats, seed=seed,
                policy=ComputePolicy(interpret=policy.interpret),
                device=device)
    return bench
