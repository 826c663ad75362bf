"""The decoder-only LMs (dense, moe, vlm), the hybrid and the ssm family
of repro.models in PyTorch: config.py (ArchConfig), layers.py (the
blocks), lm.py (LM), rglru.py (RG, the RG-LRU + local attention hybrid),
rwkv6.py (RWKV, RWKV-6 "Finch"), registry.py (get_api) and convert.py
(JAX's weights carried across)."""
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import LM
from repro_torch.models.registry import ModelAPI, get_api
from repro_torch.models.rglru import RG
from repro_torch.models.rwkv6 import RWKV

__all__ = ["ArchConfig", "LM", "ModelAPI", "RG", "RWKV", "get_api"]
