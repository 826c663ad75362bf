"""Plain PyTorch versions of the FWHT kernel and its SRHT form."""
import torch


def fwht_ref(x: torch.Tensor,
             normalize: bool = True) -> torch.Tensor:  # hot-path
    """Fast Walsh-Hadamard transform along dim 0. x: (n, ...), n = 2^m.

    Iterative radix-2 butterflies, log2(n) stages in the order h = 1, 2,
    4, ...; normalize=True divides by sqrt(n) so H is orthonormal.
    """
    n = x.shape[0]
    if n & (n - 1):
        raise ValueError(f"FWHT needs power-of-two length, got {n}")
    shape = x.shape
    x = x.reshape(n, -1)
    h = 1
    while h < n:
        x = x.reshape(n // (2 * h), 2, h, -1)
        a, b = x[:, 0], x[:, 1]
        x = torch.stack([a + b, a - b], dim=1)
        h *= 2
    x = x.reshape(shape)
    if normalize:
        x = x / torch.sqrt(torch.tensor(float(n), dtype=x.dtype,
                                        device=x.device))
    return x


def srht_t_ref(M: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor,
               n_pad: int, normalize: bool = True) -> torch.Tensor:
    """Omega^T M = R^T H D M for M (m, c), m <= n_pad -> (r', c): zero-pad
    to n_pad rows, scale by the signs, transform, gather the sampled rows."""
    Mp = torch.nn.functional.pad(M, (0, 0, 0, n_pad - M.shape[0]))
    return fwht_ref(Mp * signs[:, None], normalize)[rows]
