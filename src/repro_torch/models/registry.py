"""Uniform model API over the decoder-only architectures.

The port of repro/models/registry.py for the families that models/lm.py
serves: dense, moe and vlm (seven of the ten configs). vlm serves text
only, as JAX's `_vlm_api`: the patch prefix enters through `forward`
alone. The model carries its config, so the calls take the LM where JAX
takes (params, cfg).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.models import lm
from repro_torch.models.config import ArchConfig


class ModelAPI(NamedTuple):
    init: Callable          # (cfg, tp, device=, generator=) -> LM
    forward: Callable       # (model, batch, groups) -> logits (B,S,V)
    init_cache: Callable    # (cfg, batch, max_seq, dtype, device) -> cache
    prefill: Callable       # (model, batch, cache, groups) -> (logits, cache)
    decode: Callable        # (model, tokens, cache, groups) -> (logits, cache)
    has_decode: bool = True


def _lm_api() -> ModelAPI:
    return ModelAPI(
        init=lm.LM,
        forward=lambda m, b, g: m(b["tokens"], groups=g),
        init_cache=lm.init_cache_lm,
        prefill=lambda m, b, cache, g: m.prefill(b["tokens"], cache, g),
        decode=lambda m, tokens, cache, g: m.decode(tokens, cache, g),
    )


def _vlm_api() -> ModelAPI:
    return _lm_api()._replace(
        forward=lambda m, b, g: m(b["tokens"], b.get("patches"), g))


_FAMILIES = {"dense": _lm_api, "moe": _lm_api, "vlm": _vlm_api}

# The families whose numerical core is not ported yet: each is a separate
# piece of parity work (ROADMAP.md Queue A item 5(a)).
_LATER = {
    "hybrid": "rglru.py's RG-LRU scan",
    "ssm": "rwkv6.py's chunked WKV",
    "encdec": "whisper.py's encoder and cross-attention cache",
}


def get_api(cfg: ArchConfig) -> ModelAPI:
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family ({_LATER[cfg.family]}) is "
            "not ported yet; ROADMAP.md Queue A item 5(a) ports it")
    return _FAMILIES[cfg.family]()
