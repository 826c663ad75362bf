"""Cluster LM activations with the paper's method on the PyTorch/CUDA port
(examples/cluster_embeddings.py, on repro_torch).

Runs a (reduced) qwen3 forward pass over synthetic prompts from two
distinct token distributions, harvests the mean-pooled logits of each
prompt, and clusters them with one-pass randomized kernel K-means (RBF
kernel). The two prompt populations must be recovered.

The JAX example's PRNG keys cannot be reproduced in torch, so the
weights, the tokens and the estimator's SRHT sketch are drawn from torch
generators on the CPU, the same draws on every device, and handed in
(`fit(..., sketch=)`); the k-means++ seeding draws from `seed=`.

Run: PYTHONPATH=src python examples/torch_cluster_embeddings.py
[--device cpu] (the card by default; no fallback to the CPU).
"""
import argparse

import torch

from repro_torch.api import KernelKMeans
from repro_torch.configs import get_config
from repro_torch.core import clustering_accuracy
from repro_torch.core.sketch import make_srht
from repro_torch.models import get_api

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
dev = torch.device(ap.parse_args().device)

cfg = get_config("qwen3-14b", smoke=True)
api = get_api(cfg)
model = api.init(cfg, tp=1, device="cpu",
                 generator=torch.Generator().manual_seed(0)).to(dev)

# Two prompt populations: tokens drawn from two disjoint 32-token sets
# (distinct "topics" in an untrained model's embedding space).
n_per, S = 64, 64
gen = torch.Generator().manual_seed(1)
pop_a = torch.randint(0, 32, (n_per, S), generator=gen)
pop_b = torch.randint(32, 64, (n_per, S), generator=gen)
tokens = torch.cat([pop_a, pop_b]).to(torch.int32).to(dev)
labels = torch.tensor([0] * n_per + [1] * n_per)

# Harvest mean-pooled final activations (projected to logits space) as the
# per-prompt embedding, unit-normalized.
with torch.no_grad():
    logits = api.forward(model, {"tokens": tokens}, 1)     # (B, S, V)
emb = logits.mean(dim=1)                                   # (B, V)
emb = emb / (emb.norm(dim=1, keepdim=True) + 1e-6)

r, oversampling = 4, 10
est = KernelKMeans(k=2, r=r, kernel="rbf", kernel_params={"gamma": 1.0},
                   backend_params={"oversampling": oversampling}, block=64,
                   device=dev)
sketch = make_srht(2 * n_per, r + oversampling,
                   torch.Generator().manual_seed(2))
sketch = sketch._replace(signs=sketch.signs.to(dev), rows=sketch.rows.to(dev))
est.fit(emb.T, seed=2, sketch=sketch)
acc = clustering_accuracy(labels, est.labels_, 2)
print(f"clustered {2 * n_per} activation vectors: accuracy {acc:.3f}")
assert acc > 0.9
