"""Fit as a living service.

    accumulate  SketchAccumulator — exact incremental W = K Omega per
                data chunk; the engine under both one-shot `fit` and
                `KernelKMeans.partial_fit`
    minibatch   minibatch K-means in the rank-r embedding space
    drift       DriftMonitor — streaming kernel-approximation-error and
                assignment-shift estimators over sampled live traffic
    retrain     RetrainWorker — drift trigger -> refit -> publish to a
                VersionStore -> warm ModelRegistry.swap
"""
from repro_torch.stream.accumulate import SketchAccumulator
from repro_torch.stream.drift import DriftMonitor, DriftReport
from repro_torch.stream.minibatch import MiniBatchResult, minibatch_kmeans
from repro_torch.stream.retrain import RetrainReport, RetrainWorker

__all__ = ["DriftMonitor", "DriftReport", "MiniBatchResult", "RetrainReport",
           "RetrainWorker", "SketchAccumulator", "minibatch_kmeans"]
