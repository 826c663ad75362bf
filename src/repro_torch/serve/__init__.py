"""Serving: the FittedModel and its artifact, the extension, the batcher."""
from repro_torch.serve.artifact import (ClusteringSpec, FittedModel,
                                        fit_model, from_reference,
                                        load_model, save_model)
from repro_torch.serve.batcher import MicroBatcher, bucket_size
from repro_torch.serve.extend import Extender, assign, embed
from repro_torch.serve.policy import ComputePolicy, resolve_kernel_path

__all__ = ["ClusteringSpec", "ComputePolicy", "Extender", "FittedModel",
           "MicroBatcher", "assign", "bucket_size", "embed",
           "fit_model", "from_reference", "load_model", "resolve_kernel_path",
           "save_model"]
