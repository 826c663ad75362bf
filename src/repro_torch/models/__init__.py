"""The LMs of repro.models in PyTorch, every family: config.py
(ArchConfig), layers.py (the blocks), lm.py (LM: dense, moe, vlm),
rglru.py (RG, the RG-LRU + local attention hybrid), rwkv6.py (RWKV,
RWKV-6 "Finch"), whisper.py (Whisper, the encoder-decoder), registry.py
(get_api) and convert.py (JAX's weights carried across)."""
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import LM
from repro_torch.models.registry import ModelAPI, get_api
from repro_torch.models.rglru import RG
from repro_torch.models.rwkv6 import RWKV
from repro_torch.models.whisper import Whisper

__all__ = ["ArchConfig", "LM", "ModelAPI", "RG", "RWKV", "Whisper",
           "get_api"]
