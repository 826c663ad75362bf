"""The estimator front door (KernelKMeans) and its backends."""
from repro_torch.api.backends import (Approximator, Embedding,
                                      available_backends, default_nystrom_m,
                                      fit_memory_bytes, get_backend,
                                      register_backend)
from repro_torch.api.estimator import KernelKMeans, spec_to_estimator
from repro_torch.serve.artifact import ClusteringSpec

__all__ = ["Approximator", "ClusteringSpec", "Embedding", "KernelKMeans",
           "available_backends", "default_nystrom_m", "fit_memory_bytes",
           "get_backend", "register_backend", "spec_to_estimator"]
