"""Plain PyTorch version of the fused gram->projection serving stripe."""
import torch

from repro_torch.kernels.gram.ref import gram_stripe_ref


def extend_embed_ref(X: torch.Tensor, P: torch.Tensor, Xb: torch.Tensor,
                     kind: str = "polynomial", gamma: float = 0.0,
                     degree: int = 2) -> torch.Tensor:
    """P @ kappa(X, Xb). X: (p, n), P: (r, n), Xb: (p, w) -> (r, w).

    This is the two-pass path: the (n, w) stripe is materialized, then
    projected.
    """
    return P @ gram_stripe_ref(X, Xb, kind=kind, gamma=gamma, degree=degree)
