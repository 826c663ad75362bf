"""Streaming walkthrough on the PyTorch/CUDA port: partial_fit -> serve
-> drift -> refit -> swap (examples/stream_refit.py, on repro_torch).

  1. stream the initial distribution in chunks through
     `KernelKMeans.partial_fit` (capacity leaves room to keep going),
  2. publish + register the model and serve it asynchronously,
  3. watch the served traffic with a DriftMonitor,
  4. when the distribution drifts, a RetrainWorker refits from the
     accumulated sketch, publishes the next version, and warm-swaps the
     live row: pending requests drain into the old model (zero stranded
     futures), the monitor rebinds to the new one.

Run: PYTHONPATH=src python examples/torch_stream_refit.py [--device cpu]
(the card by default; no fallback to the CPU).
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.api import KernelKMeans
from repro_torch.core.metrics import clustering_accuracy
from repro_torch.serve import DEFAULT_REGISTRY, VersionStore
from repro_torch.stream import DriftMonitor, RetrainWorker

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ap.add_argument("--store", default=None,
                help="the VersionStore root (default: a temporary "
                     "directory)")
args = ap.parse_args()
dev = torch.device(args.device)
rng = np.random.RandomState(0)


def blobs(xs, n_per=100):
    """Two-row blobs centered at the given x positions."""
    cols, labs = [], []
    for i, x0 in enumerate(xs):
        c = np.zeros((2, n_per), np.float32)
        c[0] = x0 + 0.25 * rng.randn(n_per)
        c[1] = 0.25 * rng.randn(n_per)
        cols.append(c)
        labs.append(np.full(n_per, i))
    return np.concatenate(cols, axis=1), np.concatenate(labs)


# --- 1. streaming fit: chunked ingest, re-eig at the end ----------------
# capacity sizes the sketch test matrix up front: 400 columns of room,
# 200 used now, the rest headroom for the post-drift refit. Chunked
# ingest equals a one-shot fit over the same columns bit for bit.
X0, _ = blobs((-2.0, 2.0))
est = KernelKMeans(k=2, r=2, kernel="linear", backend="onepass-srht",
                   block=64, device=dev)
for lo in range(0, 200, 50):
    est.partial_fit(X0[:, lo:lo + 50], seed=0, capacity=400,
                    reeig=(lo == 150))           # cheap ingest, one re-eig
print(f"streamed fit: {est.stream_progress}")

# --- 2. publish + serve ------------------------------------------------
tmp = tempfile.TemporaryDirectory()
store = VersionStore(args.store or f"{tmp.name}/stream_demo_versions",
                     keep=3)
DEFAULT_REGISTRY.register("stream-demo", est.model_, overwrite=True,
                          version=store.publish(est.model_))
sched = DEFAULT_REGISTRY.scheduler("stream-demo", max_wait_ms=5.0)

# --- 3. drift monitor + retrain worker ---------------------------------
monitor = DriftMonitor(est.model_, ref_labels=est.labels_,
                       chi2_threshold=30.0, min_queries=64)
worker = RetrainWorker(
    "stream-demo", DEFAULT_REGISTRY, store, monitor,
    refit_fn=lambda report: est.partial_fit(Xd).model_)

# Healthy traffic: observe what was served; the monitor stays quiet.
Xh = X0[:, rng.permutation(200)]
for lo in range(0, 200, 40):
    chunk = Xh[:, lo:lo + 40]
    fut = sched.submit(chunk)
    sched.flush()
    monitor.observe(chunk, fut.result()[0])
assert worker.step() is None, "no drift yet"

# --- 4. the distribution drifts ----------------------------------------
Xd, yd = blobs((3.0, 8.0))
stale_acc = clustering_accuracy(yd, est.predict(Xd), 2)
for lo in range(0, 200, 40):
    chunk = Xd[:, lo:lo + 40]
    fut = sched.submit(chunk)
    sched.flush()
    monitor.observe(chunk, fut.result()[0])

rollout = worker.step()                          # fires: refit+publish+swap
assert rollout is not None and worker.step() is None
new_est = KernelKMeans.from_model(DEFAULT_REGISTRY.get("stream-demo"))
new_acc = clustering_accuracy(yd, new_est.predict(Xd), 2)
print(f"drift: {rollout.drift.reason}")
print(f"rollout: v{rollout.version} in {rollout.detect_to_swap_s:.3f} s "
      f"(refit {rollout.refit_s:.3f} s, publish {rollout.publish_s:.3f} s, "
      f"swap {rollout.swap_s:.3f} s), drained "
      f"{rollout.swap.drained_requests} pending requests")
print(f"accuracy on the drifted distribution: stale {stale_acc:.2f} -> "
      f"refit {new_acc:.2f}")
assert new_acc > stale_acc
DEFAULT_REGISTRY.unregister("stream-demo")
tmp.cleanup()
