"""Async serving walkthrough on the PyTorch/CUDA port: fit -> save ->
load -> async query -> SLO (examples/serve_async.py, on repro_torch).

  1. fit the paper's Alg. 1 once on blob+ring data,
  2. persist the FittedModel artifact and load it back via the registry,
  3. serve concurrent ragged requests through the async, SLO-accounted
     path (futures + deadline-driven flushing, a live pump thread),
  4. print the latency table and assert p99 under a generous bound.

Run: PYTHONPATH=src python examples/torch_serve_async.py [--device cpu]
(the card by default; no fallback to the CPU).
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.api import KernelKMeans
from repro_torch.data import blob_ring
from repro_torch.serve import DEFAULT_REGISTRY

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ap.add_argument("--artifact-dir", default=None,
                help="where the artifact goes (default: a temporary "
                     "directory)")
args = ap.parse_args()
dev = torch.device(args.device)

# --- 1. fit: one streaming pass over kernel stripes, then K-means -------
# (backend="nystrom" or "exact" here would change NOTHING below: the
# whole serving path is backend-agnostic.)
X, _ = blob_ring(torch.Generator(device=dev).manual_seed(0), n=2000)
est = KernelKMeans(k=2, r=2, kernel="polynomial",
                   kernel_params={"gamma": 0.0, "degree": 2}, block=512,
                   device=dev)
est.fit(X, seed=1)

# --- 2. persist + load: what a deployment actually ships ----------------
tmp = tempfile.TemporaryDirectory()
path = est.save(args.artifact_dir or f"{tmp.name}/async_demo")
served = DEFAULT_REGISTRY.load("demo", path, overwrite=True, device=dev)
print(f"artifact: {path} (n={served.spec.n}, r={served.spec.r}, "
      f"backend={served.spec.backend})")

# --- 3. async serving: futures per request, deadline-driven flush -------
# max_wait_ms is the coalescing deadline (the p99 knob); slo_ms the
# objective latency is accounted against. The registry caches the
# scheduler, so every later caller shares its latency accounting.
sched = DEFAULT_REGISTRY.scheduler("demo", max_wait_ms=5.0, slo_ms=2000.0,
                                   max_bucket=256)

# Warm the pow-2 buckets once so the table below shows steady-state
# latency, not first-launch costs.
sched.batcher.warm((8, 16, 32, 64, 128, 256))

rng = np.random.RandomState(0)
with sched:                         # starts the background pump thread
    futures = []
    for _ in range(100):            # 100 concurrent ragged requests
        width = rng.randint(1, 48)
        futures.append(sched.submit(rng.randn(served.spec.p, width)
                                    .astype(np.float32)))
    results = [f.result(timeout=60.0) for f in futures]
# leaving the context stops the pump and flushes anything still pending

labels = np.concatenate([lab for lab, _ in results])
print(f"served {len(futures)} requests / {labels.size} queries; "
      f"cluster sizes: {np.bincount(labels).tolist()}")

# --- 4. the SLO read-out ------------------------------------------------
print("\nlatency table")
print(sched.latency.format_table())

summary = DEFAULT_REGISTRY.latency_summary("demo")
p99 = summary["latency_ms"]["p99"]
assert p99 < 2000.0, f"p99 {p99:.1f} ms blew the (generous) 2 s bound"
assert summary["requests"] == 100
print(f"\nOK: p99 = {p99:.2f} ms < 2000 ms, "
      f"{summary['slo_violations']} SLO violations")
DEFAULT_REGISTRY.unregister("demo")
tmp.cleanup()
