"""The serving step builders of repro.train (the training half comes
with the training slice)."""
from repro_torch.train.steps import make_decode_step, make_prefill_step

__all__ = ["make_prefill_step", "make_decode_step"]
