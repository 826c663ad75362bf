"""Plain PyTorch version of the fused fit-sketch accumulate kernel."""
from typing import Optional

import torch

from repro_torch.kernels.gram.ref import gram_stripe_ref


def fit_sketch_ref(X: torch.Tensor, Omega: torch.Tensor, C: torch.Tensor,
                   Ocross: torch.Tensor, V: Optional[torch.Tensor] = None,
                   kind: str = "polynomial", gamma: float = 0.0,
                   degree: int = 2):
    """All four contractions of K = kappa(X, C) the fit update consumes.

    X (p, m), Omega (m, r'), C (p, b), Ocross (b, r'), V (m,) row weights
    (None = all rows valid). Materializes K and returns
      new_rows (b, r') = K^T Omega    (the b new sketch rows)
      delta    (m, r') = K Ocross     (cross-term update, caller masks)
      rn_rows  (m,)    = row sums of K*K
      rn_cols  (b,)    = V-weighted column sums of K*K
    """
    K = gram_stripe_ref(X, C, kind=kind, gamma=gamma, degree=degree)
    K2 = K * K
    vm = (torch.ones((X.shape[1],), dtype=torch.float32, device=X.device)
          if V is None else V.to(torch.float32))
    return K.T @ Omega, K @ Ocross, torch.sum(K2, dim=1), vm @ K2
