"""Plain PyTorch version of the gram-stripe kernel."""
import torch


def gram_stripe_ref(X: torch.Tensor, Xb: torch.Tensor,
                    kind: str = "polynomial", gamma: float = 0.0,
                    degree: int = 2) -> torch.Tensor:
    """K[:, block] = kappa(X, Xb). X: (p, n), Xb: (p, w) -> (n, w)."""
    z = X.T @ Xb
    if kind == "polynomial":
        return (z + gamma) ** int(degree)
    if kind == "rbf":
        xn = torch.sum(X * X, dim=0)[:, None]
        yn = torch.sum(Xb * Xb, dim=0)[None, :]
        return torch.exp(-gamma * torch.clamp(xn + yn - 2.0 * z, min=0.0))
    if kind == "linear":
        return z
    raise ValueError(f"unknown kernel kind {kind!r}")
