"""The device an entry point runs on: the card unless the caller names
another; never a silent fallback to the CPU."""
import torch


def resolve_device(device) -> torch.device:
    """`device`, or the card when None; no silent fallback to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the card by default and no CUDA device "
                "is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
