"""Prefill / decode step builders (the serving half of repro/train/steps.py).

make_train_step, cross_entropy and init_train_state come with the
training slice. `cfg` is kept for the JAX signature; the model carries
it.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import ModelAPI


def make_prefill_step(cfg: ArchConfig, api: ModelAPI,
                      groups: int = 1) -> Callable:
    def prefill_step(model, batch, cache):
        return api.prefill(model, batch, cache, groups)
    return prefill_step


def make_decode_step(cfg: ArchConfig, api: ModelAPI,
                     groups: int = 1) -> Callable:
    """decode_step(model, tokens, cache) -> (greedy next tokens as int32,
    logits, cache)."""
    def decode_step(model, tokens, cache):
        logits, cache = api.decode(model, tokens, cache, groups)
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tokens, logits, cache
    return decode_step
