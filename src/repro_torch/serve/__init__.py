"""Serving: the in-memory FittedModel, the extension and the batcher."""
from repro_torch.serve.artifact import (ClusteringSpec, FittedModel,
                                        from_reference)
from repro_torch.serve.batcher import MicroBatcher, bucket_size
from repro_torch.serve.extend import Extender, assign, embed
from repro_torch.serve.policy import ComputePolicy, resolve_kernel_path

__all__ = ["ClusteringSpec", "ComputePolicy", "Extender", "FittedModel",
           "MicroBatcher", "assign", "bucket_size", "embed",
           "from_reference", "resolve_kernel_path"]
