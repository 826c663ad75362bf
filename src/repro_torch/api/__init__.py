"""The estimator front door (KernelKMeans) and its backends."""
from repro_torch.api.backends import (Embedding, available_backends,
                                      fit_memory_bytes, get_backend)
from repro_torch.api.estimator import KernelKMeans

__all__ = ["Embedding", "KernelKMeans", "available_backends",
           "fit_memory_bytes", "get_backend"]
