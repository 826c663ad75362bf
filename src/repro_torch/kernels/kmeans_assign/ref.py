"""Plain PyTorch versions of the fused K-means assignment kernel, alone and
folded into the serving stripe."""
import torch

from repro_torch.kernels.extend_embed.ref import extend_embed_ref


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


def embed_assign_ref(X: torch.Tensor, P: torch.Tensor, Xb: torch.Tensor,
                     C: torch.Tensor, kind: str = "polynomial",
                     gamma: float = 0.0, degree: int = 2):
    """The serving stripe's assignment: the queries Xb (p, w) embedded as
    P kappa(X, Xb) (r, w), then assigned to C (k, r) -> (labels (w,)
    int32, min_d2 (w,) f32)."""
    return assign_ref(extend_embed_ref(X, P, Xb, kind, gamma, degree).T, C)
