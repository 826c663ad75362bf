"""Synthetic data sets (numpy or torch generators)."""
from repro_torch.data.synthetic import gaussian_blobs, segmentation_proxy

__all__ = ["gaussian_blobs", "segmentation_proxy"]
