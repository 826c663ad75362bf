"""Micro-batching for the query path: pow-2 shape buckets.

  - a batch of b queries is zero-padded up to bucket(b), the next power of
    two clamped to [min_bucket, max_bucket]; results for the padded
    columns are computed and discarded (columns are independent, and the
    kernels' summation order does not depend on the batch width, so real
    queries get the bits of an unbatched run);
  - batches wider than max_bucket are chunked into full max_bucket pieces
    plus one bucketed remainder;
  - the embed stripe narrows to min(block, bucket), so a small request
    does not pay for a full-width stripe.

`MicroBatcher` also holds a coalescing request queue: `submit()` enqueues
independent requests, `drain()` runs them as one concatenated bucketed
batch and hands labels back per request, deterministic and thread-free.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sketch import next_pow2
from repro_torch.serve import extend
from repro_torch.serve.artifact import FittedModel
from repro_torch.serve.policy import ComputePolicy


def bucket_size(b: int, min_bucket: int = 8, max_bucket: int = 1024) -> int:
    """Next power of two >= b, clamped to [min_bucket, max_bucket]."""
    if b < 1:
        raise ValueError(f"batch size must be positive, got {b}")
    return max(min_bucket, min(next_pow2(b), max_bucket))


class MicroBatcher:
    """Bucketed assignment front-end for one FittedModel.

    policy: ComputePolicy selecting the compute paths (assign_fused: the
    kmeans_assign kernel, embed_fused: the extend_embed stripe; both on
    by default on the card).
    """

    def __init__(self, model: FittedModel, block: Optional[int] = None,
                 min_bucket: int = 8, max_bucket: int = 1024,
                 policy: Optional[ComputePolicy] = None):
        policy = policy if policy is not None else ComputePolicy()
        self.model = model
        self.policy = policy
        self.block = int(block or model.spec.block)
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        self.extender = extend.Extender(model, self.block, policy=policy)
        self._pending: List[np.ndarray] = []
        self.stats: Dict = {}
        self.reset_stats()

    def reset_stats(self) -> None:
        """Zero the traffic counters."""
        self.stats = {"queries": 0, "padded_queries": 0,
                      "batches": 0, "bucket_hits": {}}

    # -- bucketed one-shot path ------------------------------------------

    def assign_batch(self, Xq) -> Tuple[np.ndarray, np.ndarray]:
        """Bucketed assignment of Xq (p, b) -> (labels (b,), d2 (b,))."""
        Xq = torch.as_tensor(Xq, dtype=torch.float32,
                             device=self.extender.device)
        b = Xq.shape[1]
        if b == 0:
            return np.zeros((0,), np.int32), np.zeros((0,), np.float32)
        labels, d2 = [], []
        for start in range(0, b, self.max_bucket):
            lab, dd = self._assign_bucketed(
                Xq[:, start:start + self.max_bucket])
            labels.append(lab)
            d2.append(dd)
        return np.concatenate(labels), np.concatenate(d2)

    def _assign_bucketed(self, chunk: torch.Tensor
                         ) -> Tuple[np.ndarray, np.ndarray]:
        w = chunk.shape[1]
        bsz = bucket_size(w, self.min_bucket, self.max_bucket)
        padded = torch.nn.functional.pad(chunk, (0, bsz - w))
        lab, d2 = self.extender.assign(padded, block=min(self.block, bsz))
        self.stats["queries"] += w
        self.stats["padded_queries"] += bsz - w
        self.stats["batches"] += 1
        self.stats["bucket_hits"][bsz] = \
            self.stats["bucket_hits"].get(bsz, 0) + 1
        return lab[:w].cpu().numpy(), d2[:w].cpu().numpy()

    def warm(self, buckets) -> List[int]:
        """Run one zero batch per distinct bucket width now, so first-use
        costs (the kernel build, allocator growth) are paid off the
        serving path. Returns the bucket sizes warmed, ascending."""
        warmed = []
        for b in sorted({bucket_size(int(b), self.min_bucket,
                                     self.max_bucket) for b in buckets}):
            self.assign_batch(np.zeros((self.model.spec.p, b), np.float32))
            warmed.append(b)
        return warmed

    # -- coalescing request queue ----------------------------------------

    def validate_request(self, Xq) -> np.ndarray:
        """Shape-check one request; returns it as float32 numpy."""
        if isinstance(Xq, torch.Tensor):
            Xq = Xq.detach().cpu().numpy()
        Xq = np.asarray(Xq, np.float32)
        if Xq.ndim != 2 or Xq.shape[0] != self.model.spec.p \
                or Xq.shape[1] < 1:
            raise ValueError(f"request must be (p={self.model.spec.p}, "
                             f"b>=1), got {Xq.shape}")
        return Xq

    def submit(self, Xq) -> int:
        """Enqueue one request of queries (p, b_i); returns its ticket."""
        self._pending.append(self.validate_request(Xq))
        return len(self._pending) - 1

    def drain(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Run all pending requests as one coalesced bucketed batch.

        Returns [(labels_i, d2_i)] aligned with submission order.
        """
        if not self._pending:
            return []
        widths = [x.shape[1] for x in self._pending]
        big = np.concatenate(self._pending, axis=1)
        self._pending = []
        labels, d2 = self.assign_batch(big)
        out, off = [], 0
        for w in widths:
            out.append((labels[off:off + w], d2[off:off + w]))
            off += w
        return out

    @property
    def executables(self) -> List[int]:
        """Bucket sizes served so far (sorted)."""
        return sorted(self.stats["bucket_hits"])
