"""Synthetic data sets (numpy or torch generators)."""
from repro_torch.data.synthetic import (blob_ring, blobs_1d, gaussian_blobs,
                                        segmentation_proxy, two_rings)

__all__ = ["two_rings", "blob_ring", "gaussian_blobs", "segmentation_proxy",
           "blobs_1d"]
