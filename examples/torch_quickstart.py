"""Quickstart on the PyTorch/CUDA port: the paper's Table-1 experiment
through the estimator API (examples/quickstart.py, on repro_torch).

One front door (`repro_torch.api.KernelKMeans`) over pluggable
approximation backends: the paper's one-pass method is the default;
Nystrom and the exact eigendecomposition are one keyword away.

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(the card by default; no fallback to the CPU).
"""
import argparse

import torch

from repro_torch.api import KernelKMeans
from repro_torch.core import clustering_accuracy, kernel_approx_error_streaming
from repro_torch.core.kmeans import kmeans
from repro_torch.data import blob_ring

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
dev = torch.device(ap.parse_args().device)

# Fig. 1 data: a Gaussian blob enclosed by a ring. K-means cannot separate
# them, the degree-2 polynomial kernel can.
X, labels = blob_ring(torch.Generator(device=dev).manual_seed(0), n=4000)

# Alg. 1 via the front door: one streaming pass over kernel stripes (K
# never materialized), SRHT-preconditioned sketch, rank-2 linearization,
# standard K-means. backend="nystrom" / "exact" swaps the approximation;
# everything downstream (predict, save, the serving stack) is
# backend-agnostic.
est = KernelKMeans(k=2, r=2, kernel="polynomial",
                   kernel_params={"gamma": 0.0, "degree": 2},
                   backend="onepass-srht",
                   backend_params={"oversampling": 10}, device=dev)
est.fit(X, seed=1)

acc = clustering_accuracy(labels, est.labels_, 2)
err = kernel_approx_error_streaming(est.model_.kernel_fn(), X,
                                    est.embedding_)
plain = clustering_accuracy(labels, kmeans(
    X.T.contiguous(), 2, generator=torch.Generator(device=dev).manual_seed(2)
).labels, 2)
print(f"one-pass kernel K-means: accuracy {acc:.3f}, approx error {err:.3f}")
print(f"plain K-means baseline:  accuracy {plain:.3f}")
assert acc > 0.95 and plain < 0.9

# The same fit is immediately servable: out-of-sample points assign
# through the extension (the production path is artifact -> registry ->
# batched / async serving; see examples/torch_serve_async.py).
X_new = torch.randn((2, 64), generator=torch.Generator(device=dev)
                    .manual_seed(3), device=dev)
print(f"assigned {est.predict(X_new).numel()} new points; "
      f"score {est.score(X_new):.2f}")
