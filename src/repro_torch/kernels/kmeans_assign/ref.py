"""Plain PyTorch version of the fused K-means assignment kernel."""
import torch


def assign_ref(Y: torch.Tensor, C: torch.Tensor):
    """Y: (n, r) samples, C: (k, r) centroids.

    Returns (labels (n,) int32, min_d2 (n,) f32) with squared distances;
    ties go to the first index.
    """
    yn = torch.sum(Y * Y, dim=1)[:, None]
    cn = torch.sum(C * C, dim=1)[None, :]
    d2 = torch.clamp(yn + cn - 2.0 * (Y @ C.T), min=0.0)
    d2min, labels = torch.min(d2, dim=1)
    return labels.to(torch.int32), d2min
