"""The decoder-only LMs (dense, moe, vlm) of repro.models in PyTorch:
config.py (ArchConfig), layers.py (the blocks), lm.py (LM), registry.py
(get_api) and convert.py (JAX's weights carried across)."""
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import LM
from repro_torch.models.registry import ModelAPI, get_api

__all__ = ["ArchConfig", "LM", "ModelAPI", "get_api"]
