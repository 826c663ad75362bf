"""Drift detection over live serving traffic.

Two streaming estimators, both O(1) memory in the query count, decide
when the fitted model has gone stale:

  approximation error   per sampled query x, the relative residual of
                        the kernel column outside the fitted eigenbasis,
                        ||(I - U U^T) kappa(ref, x)|| / ||kappa(ref, x)||
                        — the serving-time analogue of the paper's
                        ||K - K_hat||_F / ||K||_F, accumulated in the
                        same log-spaced streaming histogram the latency
                        layer uses (serve/latency.py), so p50/p95 drift
                        read-outs cost O(buckets), not O(queries). The
                        column kappa(ref, x) comes from the gram kernel
                        (kernels.gram_stripe_op) on the card.
  assignment shift      live cluster-population fractions vs. the fitted
                        reference, scored by the chi-square statistic
                        n * sum((p_live - p_ref)^2 / p_ref) and the max
                        absolute fraction delta.

`DriftMonitor.observe()` is called from the serving loop with each
(sampled) batch and the labels it was served; `report()` folds both
estimators against their thresholds into a `DriftReport`, which
`stream/retrain.py` turns into refit -> publish -> swap. The estimators
and the report are the JAX package's (repro.stream.drift).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.gram.ops import gram_stripe_op
from repro_torch.serve import extend
from repro_torch.serve.artifact import FittedModel
from repro_torch.serve.latency import Histogram


@dataclasses.dataclass
class DriftReport:
    """One monitoring read-out; `fired` is the retrain trigger."""
    queries: int                 # labeled queries in the window
    samples: int                 # queries the approx-err estimator saw
    approx_err_p50: float
    approx_err_p95: float
    approx_err_mean: float
    chi2: float
    max_frac_delta: float
    live_fracs: List[float]
    ref_fracs: List[float]
    approx_fired: bool
    assign_fired: bool
    fired: bool
    reason: str

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def _host_labels(labels) -> np.ndarray:
    if isinstance(labels, torch.Tensor):
        return labels.detach().cpu().numpy()
    return np.asarray(labels)


class DriftMonitor:
    """Streaming drift estimators bound to one fitted model.

    ref_labels: training labels fixing the reference assignment
        distribution (numpy or a tensor on any device); None derives them
        by assigning X_train through the model (exact for the one-pass
        backends, where Y spans X_train).
    approx_err_threshold: fire when the sampled p95 relative kernel
        residual exceeds this (None disables the approx-error trigger —
        e.g. for kernels whose fitted rank is exact, where residuals stay
        ~0 under any shift and only assignment drift is informative).
    chi2_threshold / frac_delta_threshold: assignment-shift triggers;
        chi-square grows linearly in the window size under a real shift,
        so any O(1) threshold separates shift from sampling noise once
        min_queries is met.
    min_queries: assignment trigger stays quiet below this window size.
    sample_every: the approx-error estimator (one kernel-column
        evaluation per query batch) runs on every sample_every-th
        observe() call; assignment counting is always on.
    """

    def __init__(self, model: FittedModel, *,
                 ref_labels=None,
                 approx_err_threshold: Optional[float] = None,
                 chi2_threshold: float = 30.0,
                 frac_delta_threshold: float = 0.25,
                 min_queries: int = 64, sample_every: int = 1):
        self.approx_err_threshold = approx_err_threshold
        self.chi2_threshold = float(chi2_threshold)
        self.frac_delta_threshold = float(frac_delta_threshold)
        self.min_queries = int(min_queries)
        self.sample_every = max(int(sample_every), 1)
        self.rebind(model, ref_labels=ref_labels)

    # -- lifecycle -------------------------------------------------------

    def rebind(self, model: FittedModel, ref_labels=None) -> None:
        """Point the monitor at a (new) model and reset the window —
        called by the retrain worker after every swap."""
        self.model = model
        self.k = int(model.spec.k)
        self._extender = extend.Extender(model)
        self._statics = extend._kernel_statics(model.spec)
        if ref_labels is None:
            ref_labels, _ = self._extender.assign(model.X_train)
        ref_labels = _host_labels(ref_labels)
        counts = np.bincount(ref_labels, minlength=self.k).astype(np.float64)
        if counts.sum() <= 0:
            raise ValueError("reference labels are empty")
        self.ref_fracs = counts / counts.sum()
        self.reset_window()

    def reset_window(self) -> None:
        """Clear the live window (reference distribution is kept)."""
        self._counts = np.zeros(self.k, np.float64)
        self._hist = Histogram()
        self._calls = 0
        self.queries = 0
        self.samples = 0

    # -- streaming updates -----------------------------------------------

    def observe(self, Xq, labels=None) -> None:
        """Fold one served batch into the window.

        Xq: (p, b) queries; labels: the (b,) labels they were served
        (None recomputes them through the bound model). The approx-error
        estimator runs on every `sample_every`-th call.

        Xq only goes to the device on the paths that compute with it
        (label recompute, sampled error estimate). The common serving
        call — labels provided, not a sampled call — must not pay a
        host->device copy of the whole query block per observe(): this
        runs once per served batch.
        """
        if not hasattr(Xq, "shape"):        # host-side normalization only
            Xq = np.asarray(Xq, np.float32)
        if labels is None:
            labels, _ = self._extender.assign(Xq)
        labels = _host_labels(labels)
        self._counts += np.bincount(labels, minlength=self.k
                                    )[:self.k].astype(np.float64)
        self.queries += int(labels.shape[0])
        sampled = self._calls % self.sample_every == 0
        self._calls += 1
        if sampled:
            errs = self._approx_errors(Xq).cpu().numpy()
            for err in errs:
                self._hist.record(float(err))
            self.samples += int(Xq.shape[1])

    def _approx_errors(self, Xq) -> torch.Tensor:
        """Relative kernel-column residual outside the fitted basis,
        per query column: ||(I - U U^T) z|| / max(||z||, 1e-12),
        z = kappa(ref, x) from the gram kernel on the model's device."""
        model = self.model
        Xq = torch.as_tensor(Xq, dtype=torch.float32,
                             device=model.device).contiguous()
        kind, gamma, degree = self._statics
        z = gram_stripe_op(model.extension_ref.contiguous(), Xq, kind=kind,
                           gamma=gamma, degree=degree)      # (n_ref, b)
        resid = z - model.U @ (model.U.T @ z)
        num = torch.linalg.norm(resid, dim=0)
        den = torch.clamp(torch.linalg.norm(z, dim=0), min=1e-12)
        return num / den

    def sample_serving_stats(self, batcher) -> Dict:
        """Snapshot + reset a MicroBatcher's traffic counters without
        touching bucket_hits (preserve_buckets=True), so a periodic
        stats sample can never cold-start the next warm hot-swap."""
        snap = {k: (dict(v) if isinstance(v, dict) else v)
                for k, v in batcher.stats.items()}
        batcher.reset_stats(preserve_buckets=True)
        return snap

    # -- read-out --------------------------------------------------------

    def report(self) -> DriftReport:
        total = self._counts.sum()
        live = (self._counts / total if total > 0
                else np.zeros_like(self._counts))
        chi2 = float(total * np.sum(
            (live - self.ref_fracs) ** 2 / np.maximum(self.ref_fracs, 1e-9)))
        max_delta = float(np.max(np.abs(live - self.ref_fracs))
                          if total > 0 else 0.0)
        p50 = self._hist.percentile(50.0)
        p95 = self._hist.percentile(95.0)
        approx_fired = (self.approx_err_threshold is not None
                        and self._hist.n > 0
                        and p95 > self.approx_err_threshold)
        assign_fired = (total >= self.min_queries
                        and (chi2 > self.chi2_threshold
                             or max_delta > self.frac_delta_threshold))
        reasons = []
        if approx_fired:
            reasons.append(f"approx-err p95 {p95:.3g} > "
                           f"{self.approx_err_threshold:.3g}")
        if assign_fired:
            reasons.append(f"assignment shift chi2 {chi2:.3g} / "
                           f"max-delta {max_delta:.3g}")
        return DriftReport(
            queries=self.queries, samples=self.samples,
            approx_err_p50=p50, approx_err_p95=p95,
            approx_err_mean=self._hist.mean,
            chi2=chi2, max_frac_delta=max_delta,
            live_fracs=[float(v) for v in live],
            ref_fracs=[float(v) for v in self.ref_fracs],
            approx_fired=approx_fired, assign_fired=assign_fired,
            fired=approx_fired or assign_fired,
            reason="; ".join(reasons) if reasons else "no drift")
