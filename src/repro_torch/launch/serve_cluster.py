"""Serving launcher: fit -> persist artifact -> load -> drive query load.

The end-to-end check of the estimator API and repro_torch.serve on
synthetic data (blob_ring), for ANY approximation backend (--backend
onepass-srht | onepass-gaussian | nystrom | exact), on the card unless
--device cpu is given:

  1. fit a kernel clustering through `repro_torch.api.KernelKMeans`,
  2. save the FittedModel artifact and load it back through the registry,
  3. verify the artifact serves correctly:
       - out-of-sample embeddings of the TRAINING points reproduce the
         fitted linearization Y (rel err <= 1e-4; gated for low-rank
         kernels on the training-set backends and for Nystrom on every
         kernel, where the identity holds by construction),
       - bucketed/batched assignment == unbatched assignment exactly,
       - async futures == a synchronous drain of the same requests,
       - the mesh-sharded one-pass fit == the unsharded fit on the same
         (canonical) route, bit for bit on a world of one rank,
  4. drive synthetic query load and write BENCH_serve_torch.json through
     serve.run_benches (--bench sync | async | fused | swap | backends |
     stream | fit_scaling | fleet | all),
  5. with --swap, publish versions to a VersionStore (--gc-keep) and warm
     hot-swap the live registry row with async requests pending,
  6. with --stream, the drift loop: partial_fit, drifted traffic trips
     the DriftMonitor, RetrainWorker refits, publishes and swaps,
  7. with --fleet, the replica tier: routed == direct labels, pins
     against GC, canary-then-promote, a breached canary rolled back,
     overload shedding,
  8. with --sharded, the extension through a ShardedExtender over the
     world torchrun set up (or a world of one rank) against the
     single-device path, and the sync/async benches on that mesh,
  9. with --smoke, small sizes and the forced kernel paths held against
     the plain ones (labels by the near-tie rule of
     kernels/registry.py, the mismatch count printed).

These are the JAX launcher's checks (repro.launch.serve_cluster), with
the port's RNG: one torch.Generator per seed for the data and queries,
the fit's draws derived from its seed. One card admits one NCCL rank, so
--sharded runs at world size 1 too (the JAX launcher needs two devices),
and it runs every mode at any world size. Its async bench goes
through the rank-0 pump (serve/pump.py): rank 0 takes every request and
broadcasts each flush, which every rank then runs, so the collectives of
a sharded flush line up. Over more than one rank the unsharded lifecycle
checks (--swap, --stream, --fleet) and bench sections (swap, stream,
fleet) run on rank 0 alone, as on JAX's one controller: run on every
rank they would race on the shared *_versions stores.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve_cluster --device cpu \
      --smoke --swap --stream --fleet
  PYTHONPATH=src python -m repro_torch.launch.serve_cluster --n 100000 \
      --batch-sizes 64,512,4096 --queries 8192 --bench all
  PYTHONPATH=src python -m repro_torch.launch.serve_cluster --backend \
      nystrom --nystrom-m 1024 --n 100000 --bench sync
  PYTHONPATH=src torchrun --standalone --nproc_per_node=1 \
      -m repro_torch.launch.serve_cluster -- --sharded --bench sync \
      --n 100000

Under torchrun, "--" ends its options: it reads --n, --r and --l as
ambiguous abbreviations of its own and stops.

Ends. A world that main() makes (for --sharded or check 4, when no
process group exists yet) ends when main() does, through
launch/mesh.py's open_world: in order after success; aborted when an
exception leaves, say rank 0's compute failed after a FLUSH went out,
or a follower's follow() raised on the collective that flush left half
made. Run as a script (run_process), each such rank prints its
exception and exits with BROKEN_EXIT (70).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.serve.bench import BENCH_MODES


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve_cluster")
    ap.add_argument("--smoke", action="store_true",
                    help="small sizes + full round-trip verification")
    ap.add_argument("--n", type=int, default=4000, help="training points")
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--r", type=int, default=2)
    ap.add_argument("--l", type=int, default=10, help="oversampling")
    ap.add_argument("--kernel", default="polynomial")
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--gamma", type=float, default=None,
                    help="kernel gamma; defaults to 0.0 for polynomial, "
                         "1.0 for rbf")
    ap.add_argument("--block", type=int, default=512)
    ap.add_argument("--backend", default=None,
                    choices=["onepass-srht", "onepass-gaussian", "nystrom",
                             "exact"],
                    help="approximation backend (default: onepass-<sketch>)")
    ap.add_argument("--nystrom-m", type=int, default=None,
                    help="landmark count for --backend nystrom "
                         "(default: repro_torch.api's, 16r floored at 64)")
    ap.add_argument("--sketch", default="srht",
                    choices=["srht", "gaussian"],
                    help="one-pass sketch type (legacy spelling of "
                         "--backend onepass-<sketch>)")
    ap.add_argument("--artifact-dir", default="serve_artifacts/demo")
    ap.add_argument("--batch-sizes", default="64,512")
    ap.add_argument("--queries", type=int, default=2048,
                    help="synthetic queries for the equality check")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--bench", default="all",
                    choices=list(BENCH_MODES) + ["all"],
                    help="which benchmark modes land in the bench file")
    ap.add_argument("--swap", action="store_true",
                    help="exercise the model lifecycle: publish versions, "
                         "warm hot-swap under pending async traffic, GC")
    ap.add_argument("--fleet", action="store_true",
                    help="run the replica tier checks: routing parity, "
                         "gc-under-pin, canary-then-promote rollout + "
                         "probe-breached rollback, overload shedding")
    ap.add_argument("--fleet-workers", type=int, default=2,
                    help="replica count for --fleet")
    ap.add_argument("--stream", action="store_true",
                    help="run the streaming drift loop: partial_fit, "
                         "drifted async traffic trips the DriftMonitor, "
                         "RetrainWorker refits, publishes and warm-swaps "
                         "— exactly one rollout, zero stranded futures")
    ap.add_argument("--drift-chi2", type=float, default=30.0,
                    help="assignment-shift chi-square trigger threshold")
    ap.add_argument("--drift-frac-delta", type=float, default=0.25,
                    help="max cluster-population fraction delta trigger")
    ap.add_argument("--drift-min-queries", type=int, default=64,
                    help="assignment trigger stays quiet below this "
                         "window size")
    ap.add_argument("--drift-approx-threshold", type=float, default=None,
                    help="p95 kernel-approximation-error trigger "
                         "(default: disabled — exact-rank kernels keep "
                         "residuals ~0 under any shift)")
    ap.add_argument("--gc-keep", type=int, default=None,
                    help="VersionStore retention for --swap: keep the "
                         "last K published versions")
    ap.add_argument("--fused-embed", default="auto",
                    choices=["auto", "on", "off"],
                    help="extension stripe engine for the benches: the "
                         "extend_embed kernel (on), two-pass (off), the "
                         "device's default (auto)")
    ap.add_argument("--interpret", action="store_true",
                    help="take the kernel paths on CPU tensors, through "
                         "their plain versions (ComputePolicy("
                         "interpret=True)); CPU only")
    ap.add_argument("--async-requests", type=int, default=256,
                    help="request count for the async latency bench")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="AsyncBatcher flush deadline")
    ap.add_argument("--slo-ms", type=float, default=250.0,
                    help="latency SLO for violation accounting")
    ap.add_argument("--sharded", action="store_true",
                    help="shard the extension over every rank of the "
                         "world (torchrun's, or a world of one rank)")
    ap.add_argument("--bench-passes", type=int, default=None,
                    help="bench repetitions; the bench file gets the "
                         "per-metric median. Default: 1, or 3 under "
                         "--smoke; an explicit value is always honoured")
    ap.add_argument("--bench-out", default="BENCH_serve_torch.json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; no fallback) or cpu")
    return ap


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return (float(torch.linalg.norm(a - b))
            / max(float(torch.linalg.norm(b)), 1e-30))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _held_against(what: str, got, want, Y: torch.Tensor,
                  C: torch.Tensor) -> int:
    """Labels and distances of a path against a plain one by the
    registry's near-tie rule, read on the plain embedding Y (r, b) and
    the centroids C; returns the label mismatches."""
    from repro_torch.kernels import registry
    entry = registry.get_kernel("embed_assign")
    try:
        registry.near_tie_compare(got, want, entry.rtol, entry.atol,
                                  registry.sq_distances(Y, C))
    except AssertionError as e:
        raise AssertionError(f"{what}: {e}") from None
    return int((_np(got[0]) != _np(want[0])).sum())


def _world_size() -> int:
    """The world this process belongs to: the process group's, or the
    one torchrun's environment announces."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.smoke:
        args.n = min(args.n, 2000)
        args.queries = min(args.queries, 1024)
    if args.bench_passes is None:
        args.bench_passes = 3 if args.smoke else 1
    backend = args.backend or f"onepass-{args.sketch}"
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is available; the port runs on the card "
                 "unless --device cpu is given")
    if args.interpret and dev.type != "cpu":
        ap.error("--interpret runs the kernels' plain versions, which "
                 "stand in for them only on CPU tensors")
    batch_sizes = [int(b) for b in args.batch_sizes.split(",") if b.strip()]
    if not batch_sizes:
        ap.error(f"--batch-sizes {args.batch_sizes!r} parses to nothing")
    modes = BENCH_MODES if args.bench == "all" else (args.bench,)
    if args.gc_keep is not None and args.gc_keep < 1:
        ap.error("--gc-keep must be >= 1")
    if args.fleet and args.fleet_workers < 1:
        ap.error("--fleet-workers must be >= 1")
    world = _world_size()
    if world > 1 and not args.sharded:
        ap.error(f"a world of {world} ranks serves through --sharded; "
                 f"run one process otherwise")

    import contextlib

    import torch.distributed as dist

    from repro_torch.launch.mesh import open_world
    # --sharded serves on the world; check 4 fits on a mesh of it.
    needs_world = args.sharded or backend.startswith("onepass-")
    try:
        # A world this call makes ends with it (launch/mesh.py): in order,
        # or aborted when an exception leaves, so that a follower whose
        # follow() raised leaves too.
        with open_world(dev) if needs_world else contextlib.nullcontext():
            rank = dist.get_rank() if dist.is_initialized() else 0
            _run(args, backend, dev, modes, batch_sizes, world, rank)
            if world > 1:
                dist.barrier()    # no rank tears the world down under another
    finally:
        from repro_torch.serve import DEFAULT_REGISTRY
        for name in ("demo", "stream-demo"):
            DEFAULT_REGISTRY.unregister(name)
    return 0


def _run(args, backend, dev, modes, batch_sizes, world, rank) -> None:
    import torch.distributed as dist

    from repro_torch.api import KernelKMeans
    from repro_torch.data import blob_ring
    from repro_torch.kernels import OPS
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.serve import (DEFAULT_REGISTRY, ComputePolicy,
                                   ShardedExtender, assign, embed,
                                   format_bench, median_benches,
                                   run_benches, write_bench)
    from repro_torch.core.kmeans import _sq_dists
    from repro_torch.serve.extend import _projection

    def say(msg: str) -> None:
        if rank == 0:
            print(msg, flush=True)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    X, labels = blob_ring(gen, n=args.n)
    # gamma=0.0 is the homogeneous-polynomial default but makes rbf a
    # constant kernel: each kernel's own default when unset.
    gamma = args.gamma if args.gamma is not None else \
        (0.0 if args.kernel == "polynomial" else 1.0)
    params = ({"gamma": gamma, "degree": args.degree}
              if args.kernel == "polynomial" else
              {"gamma": gamma} if args.kernel == "rbf" else {})
    backend_params = {}
    if backend.startswith("onepass-"):
        backend_params["oversampling"] = args.l
    elif backend == "nystrom" and args.nystrom_m is not None:
        backend_params["m"] = args.nystrom_m
    fit_kw = dict(k=args.k, r=args.r, kernel=args.kernel,
                  kernel_params=params, backend=backend,
                  backend_params=backend_params, block=args.block,
                  device=dev)
    fit_seed = args.seed + 1

    sync()
    t0 = time.perf_counter()
    est = KernelKMeans(**fit_kw).fit(X, seed=fit_seed)
    sync()
    model = est.model_
    say(f"fit: n={args.n} r={args.r} backend={backend} "
        f"kernel={args.kernel} ({est!r}) in {time.perf_counter() - t0:.2f} "
        f"s")

    if rank == 0:
        path = est.save(args.artifact_dir)
    else:
        path = args.artifact_dir
    if world > 1:
        dist.barrier()
    served = DEFAULT_REGISTRY.load("demo", path, overwrite=True, device=dev)
    say(f"artifact saved + loaded: {path}")

    # Check 1: the extension reproduces the fitted linearization Y on the
    # training points: exact for Nystrom (its Y is the landmark extension
    # of the training columns) and for kernels of rank <= r'; a full-rank
    # kernel keeps the rank-r truncation residual, reported, not gated.
    rel = _rel(embed(served, X), est.embedding_)
    say(f"train-point round-trip rel err: {rel:.2e}")
    if backend == "nystrom" or args.kernel in ("polynomial", "linear"):
        assert rel <= 1e-4, f"extension inconsistent with fit: {rel:.2e}"
    else:
        say("  (full-rank kernel: residual is the rank-r truncation "
            "error, not gated)")

    # Check 2: bucketed/batched == unbatched == queued, the same labels.
    Xq = torch.randn((X.shape[0], args.queries), generator=gen, device=dev)
    Xq_np = _np(Xq)
    labels_direct = _np(assign(served, Xq)[0])
    batcher = DEFAULT_REGISTRY.batcher("demo")
    labels_bucketed, _ = batcher.assign_batch(Xq)
    rng = np.random.RandomState(args.seed)
    splits = np.sort(rng.choice(np.arange(1, args.queries),
                                size=min(7, args.queries - 1),
                                replace=False))
    parts = np.split(Xq_np, splits, axis=1)
    tickets = [batcher.submit(part) for part in parts]
    drained = batcher.drain()
    labels_queued = np.concatenate([drained[t][0] for t in tickets])
    assert np.array_equal(labels_direct, labels_bucketed), \
        "bucketed assignment != unbatched assignment"
    assert np.array_equal(labels_bucketed, labels_queued), \
        "queued micro-batching changed assignments"
    say(f"bucketed == unbatched == queued on {args.queries} queries "
        f"(buckets served: {batcher.executables})")

    # Check 3: async futures resolve as a synchronous drain does (the
    # unsharded row, as in the JAX launcher: no collective is involved).
    sched = DEFAULT_REGISTRY.scheduler("demo", max_wait_ms=args.max_wait_ms,
                                       slo_ms=args.slo_ms)
    futs = [sched.submit(part) for part in parts]
    sched.flush()
    labels_async = np.concatenate([f.result()[0] for f in futs])
    assert np.array_equal(labels_bucketed, labels_async), \
        "async scheduling changed assignments"
    say(f"async == sync on {args.queries} queries "
        f"({sched.latency.requests} requests recorded; per-bucket "
        f"breakdown over buckets {sorted(sched.latency.by_bucket)})")

    # The mesh: every rank of the world under --sharded; check 4 alone
    # uses a mesh of the world main opened (of one rank) otherwise.
    mesh = make_debug_mesh(data=world, device=dev) if args.sharded else None

    # Check 4: the mesh-sharded one-pass fit against the unsharded fit,
    # both on the canonical route (a policy-less fit takes it; a policy
    # would resolve fit_fused=None to the fused route on the card).
    if backend.startswith("onepass-"):
        check_mesh = mesh if mesh is not None else make_debug_mesh(
            device=dev)
        pol = ComputePolicy(fit_fused=False, mesh=check_mesh)
        est_sh = KernelKMeans(**fit_kw, policy=pol).fit(X, seed=fit_seed)
        if pol.shards == 1:
            assert torch.equal(est.labels_, est_sh.labels_), \
                "sharded fit changed training labels"
            for leaf in ("U", "eigvals", "centroids"):
                assert torch.equal(getattr(model, leaf),
                                   getattr(est_sh.model_, leaf)), \
                    f"sharded fit changed model.{leaf}"
            say("sharded fit (1 shard) bit-identical to single-host fit")
        else:
            # Across ranks the block sums change order: the contract of
            # tests/test_torch_distributed.py (registry tolerance, labels
            # agreeing on >= 0.99).
            from repro_torch.core.metrics import clustering_accuracy
            for leaf in ("stream_w", "eigvals"):
                assert torch.allclose(getattr(est_sh.model_, leaf),
                                      getattr(model, leaf), rtol=2e-3,
                                      atol=2e-3), \
                    f"sharded fit moved model.{leaf}"
            agree = clustering_accuracy(est.labels_, est_sh.labels_, args.k)
            assert agree >= 0.99, f"sharded fit labels agree on {agree}"
            say(f"sharded fit ({pol.shards} shards) within 2e-3 of the "
                f"single-host fit, labels agree on {agree:.4f}")

    # Checks 5-7 run on the unsharded row, on rank 0 alone (see the
    # module docstring).
    # Check 5 (--swap): publish versions, GC, warm hot-swap the live row
    # while async requests are pending.
    if args.swap and rank == 0:
        from repro_torch.serve import VersionStore
        store = VersionStore(args.artifact_dir + "_versions",
                             keep=args.gc_keep)
        v1 = store.publish(model)
        v2 = store.publish(model)
        # A distinguishable refresh, published LAST so it survives any
        # --gc-keep >= 1: reversed centroid rows permute the labels, so
        # post-swap labels prove which version served.
        model_b = model._replace(centroids=torch.flip(model.centroids, [0]))
        v3 = store.publish(model_b)
        say(f"published v{v1}, v{v2}, v{v3} -> {store.versions()}"
            + (f" (keep={args.gc_keep})" if args.gc_keep else ""))
        if args.gc_keep:
            assert len(store.versions()) <= args.gc_keep, \
                f"GC kept {store.versions()}, wanted <= {args.gc_keep}"
        served_b = store.load(v3, device=dev)          # pinned-version read
        w = min(args.queries, 64)
        swap_splits = [w // 3, 2 * w // 3] if w >= 3 else []
        sw_parts = np.split(Xq_np[:, :w], swap_splits, axis=1)
        pending = [sched.submit(part) for part in sw_parts]
        report = DEFAULT_REGISTRY.swap("demo", served_b, version=v3)
        assert all(f.done() for f in pending), \
            "swap stranded pending futures"
        old_labels = np.concatenate([f.result()[0] for f in pending])
        assert np.array_equal(old_labels, labels_bucketed[:w]), \
            "pre-swap requests must resolve against the old version"
        sched2 = DEFAULT_REGISTRY.scheduler("demo")
        futs = [sched2.submit(part) for part in sw_parts]
        sched2.flush()
        new_labels = np.concatenate([f.result()[0] for f in futs])
        want_new = _np(assign(served_b, Xq[:, :w])[0])
        assert np.array_equal(new_labels, want_new), \
            "post-swap requests must resolve against the new version"
        say(f"warm swap v{report.old_version} -> v{report.new_version}: "
            f"flip {report.flip_ms:.3f} ms, warm {report.warm_s:.3f} s "
            f"(buckets {report.buckets_warmed}), drained "
            f"{report.drained_requests} pending requests into the old "
            f"model; p95 before {report.p95_before_ms:.2f} ms")

    # Check 6 (--stream): the living-service loop. Gated: exactly one
    # rollout, zero stranded futures, post-swap accuracy on the drifted
    # distribution beats the stale model.
    if args.stream and rank == 0:
        from repro_torch.core.metrics import clustering_accuracy
        from repro_torch.data import blobs_1d
        from repro_torch.serve import VersionStore
        from repro_torch.stream import DriftMonitor, RetrainWorker

        rng_s = np.random.RandomState(args.seed)
        X0, _ = blobs_1d(rng_s, (-2.0, 2.0))       # initial distribution
        Xd, yd = blobs_1d(rng_s, (3.0, 8.0))       # drifted distribution
        stream_backend = (backend if backend.startswith("onepass-")
                          else "onepass-srht")
        s_est = KernelKMeans(k=2, r=2, kernel="linear",
                             backend=stream_backend, block=64, device=dev)
        s_est.partial_fit(X0, seed=args.seed + 7,
                          capacity=X0.shape[1] + Xd.shape[1])
        stale_acc = clustering_accuracy(yd, s_est.predict(Xd), 2)
        s_store = VersionStore(args.artifact_dir + "_stream_versions",
                               keep=args.gc_keep or 4)
        DEFAULT_REGISTRY.register("stream-demo", s_est.model_,
                                  overwrite=True,
                                  version=s_store.publish(s_est.model_))
        s_sched = DEFAULT_REGISTRY.scheduler(
            "stream-demo", max_wait_ms=args.max_wait_ms)
        mon = DriftMonitor(
            s_est.model_, ref_labels=s_est.labels_,
            approx_err_threshold=args.drift_approx_threshold,
            chi2_threshold=args.drift_chi2,
            frac_delta_threshold=args.drift_frac_delta,
            min_queries=args.drift_min_queries)
        worker = RetrainWorker(
            "stream-demo", DEFAULT_REGISTRY, s_store, mon,
            lambda rep: s_est.partial_fit(Xd).model_)

        # Healthy (shuffled) traffic first: the monitor must stay quiet.
        Xh = X0[:, rng_s.permutation(X0.shape[1])]
        chunks = [Xh[:, lo:lo + 20] for lo in range(0, 100, 20)]
        futs = [s_sched.submit(ch) for ch in chunks]
        s_sched.flush()
        for ch, f in zip(chunks, futs):
            mon.observe(ch, f.result()[0])
        assert worker.step() is None, \
            "drift monitor fired on in-distribution traffic"

        # Drifted traffic through the async front door; one request left
        # pending so the swap's drain path runs.
        chunks = [Xd[:, lo:lo + 20] for lo in range(0, Xd.shape[1], 20)]
        futs = [s_sched.submit(ch) for ch in chunks]
        s_sched.flush()
        for ch, f in zip(chunks, futs):
            mon.observe(ch, f.result()[0])
        pending = s_sched.submit(Xd[:, :8])
        rollout = worker.step()
        assert rollout is not None, "injected drift did not trigger"
        assert worker.step() is None and worker.retrains == 1, \
            "drift must trigger exactly one refit+swap"
        stranded = sum(not f.done() for f in futs + [pending])
        assert stranded == 0, f"{stranded} futures stranded by the swap"
        new_acc = clustering_accuracy(
            yd, KernelKMeans.from_model(
                DEFAULT_REGISTRY.get("stream-demo")).predict(Xd), 2)
        assert new_acc > stale_acc, \
            f"refit did not beat the stale model ({new_acc} vs {stale_acc})"
        say(f"stream: drift {rollout.drift.reason}; refit v"
            f"{rollout.version} detect->swap "
            f"{rollout.detect_to_swap_s:.3f} s (refit "
            f"{rollout.refit_s:.3f} s), drained "
            f"{rollout.swap.drained_requests} pending, stranded 0; "
            f"drifted-set accuracy {stale_acc:.2f} -> {new_acc:.2f}")

    # Check 7 (--fleet): replicas over ONE shared VersionStore behind the
    # routed, admission-controlled front door.
    if args.fleet and rank == 0:
        from repro_torch.fleet import Fleet, ShedError
        from repro_torch.serve import VersionStore
        f_store = VersionStore(args.artifact_dir + "_fleet_versions")
        fv1 = f_store.publish(model)
        # A generous rollout budget: the canary probe of 7c pays its
        # replicas' first launches; the breach path is forced in 7d.
        fleet = Fleet(f_store, n_workers=args.fleet_workers,
                      slo_ms=args.slo_ms, max_wait_ms=args.max_wait_ms,
                      rollout_budget_ms=60_000.0, block=args.block,
                      device=dev)
        # 7a: routing only picks the replica; labels == direct ones.
        w = min(args.queries, 64)
        f_splits = [w // 4, w // 2, 3 * w // 4] if w >= 4 else []
        f_parts = np.split(Xq_np[:, :w], f_splits, axis=1)
        futs = [fleet.submit(part) for part in f_parts]
        fleet.flush()
        fleet_labels = np.concatenate([f.result()[0] for f in futs])
        assert np.array_equal(fleet_labels, labels_bucketed[:w]), \
            "fleet-routed labels != direct assignment"
        assert {wk.version for wk in fleet.workers} == {fv1}
        say(f"fleet: {args.fleet_workers} workers pinned to v{fv1} "
            f"(pins: {f_store.pins(fv1)}), routed labels match direct "
            f"assignment on {w} queries")
        # 7b: gc(keep=1) would delete v1, but every worker pins it.
        model_b = model._replace(centroids=torch.flip(model.centroids, [0]))
        fv2 = f_store.publish(model_b)
        f_store.gc(keep=1)
        assert fv1 in f_store.versions(), \
            f"GC deleted pinned v{fv1} out from under the fleet"
        say(f"gc(keep=1) preserved pinned v{fv1} "
            f"(pins: {f_store.pins(fv1)})")
        # 7c: canary-then-promote to v2 with requests pending.
        pending = [fleet.submit(part) for part in f_parts]
        rollout = fleet.rollout(fv2)
        fleet.flush()
        assert rollout is not None and rollout.promoted, \
            f"canary-then-promote failed: {rollout}"
        assert all(wk.version == fv2 for wk in fleet.workers), \
            "promote left a worker on the old version"
        stranded = sum(not f.done() for f in pending)
        assert stranded == 0, f"rollout stranded {stranded} futures"
        old_roll = np.concatenate([f.result()[0] for f in pending])
        assert np.array_equal(old_roll, labels_bucketed[:w]), \
            "pre-rollout requests must resolve against the old version"
        futs = [fleet.submit(part) for part in f_parts]
        fleet.flush()
        new_roll = np.concatenate([f.result()[0] for f in futs])
        want_new = _np(assign(f_store.load(fv2, device=dev), Xq[:, :w])[0])
        assert np.array_equal(new_roll, want_new), \
            "post-rollout requests must resolve against the new version"
        say(f"canary-then-promote v{fv1} -> v{fv2}: {rollout.state} in "
            f"{rollout.wall_s:.3f} s (canary {rollout.canary_id} p95 "
            f"{rollout.canary_p95_ms:.2f} ms <= budget "
            f"{rollout.budget_ms:.0f} ms), 0 stranded futures")
        # 7d: a canary probe that breaches the budget rolls back.
        fv3 = f_store.publish(model)
        bad = fleet.rollout(fv3, probe=lambda wk: float("inf"))
        assert bad is not None and bad.state == "rolled-back" \
            and not bad.promoted, f"breached canary did not roll back: {bad}"
        assert all(wk.version == fv2 for wk in fleet.workers), \
            "rollback did not restore the prior version"
        assert fv3 in f_store.versions(), "rollback deleted the target"
        say(f"breached canary rolled back: fleet stays on v{fv2}, v{fv3} "
            f"intact for a retry")
        fleet.stop()
        # 7e: a flood past a tiny admission cap sheds (typed ShedError).
        tiny = Fleet(f_store, n_workers=args.fleet_workers, version=fv2,
                     slo_ms=args.slo_ms, max_wait_ms=args.max_wait_ms,
                     max_queue_depth=8, block=args.block, device=dev)
        shed = 0
        for _ in range(32):
            try:
                tiny.submit(Xq_np[:, :4])
            except ShedError as e:
                assert e.reason == "queue-full", e.reason
                shed += 1
        tiny.flush()
        rate = tiny.admission.shed_rate
        tiny.stop()
        assert shed > 0 and rate > 0.0, \
            f"flood past depth 8 shed nothing (shed={shed}, rate={rate})"
        say(f"overload: shed {shed}/32 requests past depth-8 caps "
            f"(shed_rate {rate:.0%}, typed ShedError)")

    # --sharded: the extension over the mesh against the single device.
    if mesh is not None:
        ext = ShardedExtender(served, mesh)
        rel_sh = _rel(ext.embed(Xq[:, :256]), embed(served, Xq[:, :256]))
        assert rel_sh <= 1e-5, f"sharded embed != single-device: {rel_sh:.2e}"
        say(f"sharded extension matches single-device over {world} "
            f"rank(s) (rel err {rel_sh:.2e})")

    # Benchmarks -> the bench file (only the modes asked for run).
    embed_fused = {"auto": None, "on": True, "off": False}[args.fused_embed]
    policy = ComputePolicy(embed_fused=embed_fused,
                           interpret=True if args.interpret else None,
                           mesh=mesh)
    bench = median_benches([
        run_benches(served, modes=modes, batch_sizes=batch_sizes,
                    repeats=args.repeats, seed=args.seed, policy=policy,
                    n_requests=args.async_requests,
                    max_wait_ms=args.max_wait_ms, slo_ms=args.slo_ms,
                    data=(X, labels))
        for _ in range(max(args.bench_passes, 1))])
    if rank == 0:
        write_bench(args.bench_out, bench)
    say(format_bench(bench))
    say(f"wrote {args.bench_out}")

    # Smoke also forces both kernel serving paths (their plain versions
    # on CPU tensors) against the plain paths: the kmeans_assign argmin
    # and the fused extend_embed stripe; then the served assignment
    # against a direct evaluation of y(x) = Sigma^{-1/2} U^T kappa(ref, x).
    if args.smoke:
        interp = True if dev.type == "cpu" else None
        small = Xq[:, :256]
        plain = ComputePolicy(embed_fused=False, assign_fused=False)
        lab_plain = assign(served, small, policy=plain)
        Y_two = embed(served, small, policy=plain)
        lab_kernel = assign(served, small, policy=ComputePolicy(
            assign_fused=True, interpret=interp))
        flips = _held_against("fused assignment", lab_kernel, lab_plain,
                              Y_two, served.centroids)
        say(f"fused assignment path agrees (256 queries, {flips} "
            f"near-tie label mismatches)")
        Y_fused = embed(served, small, policy=ComputePolicy(
            embed_fused=True, interpret=interp))
        rel_f = _rel(Y_fused, Y_two)
        assert rel_f <= 1e-5, \
            f"fused extend_embed stripe != two-pass: {rel_f:.2e}"
        say(f"fused extend_embed stripe agrees (rel err {rel_f:.2e})")
        Y_direct = _projection(served) @ served.kernel_fn()(
            served.extension_ref, small)
        d2min, lab_direct = torch.min(
            _sq_dists(Y_direct.T.contiguous(), served.centroids), dim=1)
        flips = _held_against(
            "direct extension", (lab_direct, d2min), lab_plain,
            Y_direct, served.centroids)
        say(f"served stack agrees with the direct {backend} extension "
            f"(256 queries, {flips} near-tie label mismatches)")
    launches = {name: op.launches for name, op in OPS.items()
                if op.launches}
    say(f"kernel launches in this process: {launches}")
    say("serve_cluster: OK")


if __name__ == "__main__":
    from repro_torch.launch.mesh import run_process
    run_process(main)
