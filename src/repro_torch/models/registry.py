"""Uniform model API over the architectures.

The port of repro/models/registry.py for every family, all ten configs:
dense, moe and vlm (models/lm.py), hybrid (models/rglru.py), ssm
(models/rwkv6.py) and encdec (models/whisper.py). vlm serves text only,
as JAX's `_vlm_api`: the patch prefix enters through `forward` alone;
encdec's forward and prefill take the batch's "frames" too. The model
carries its config, so the calls take the model where JAX takes (params,
cfg).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.models import lm, rglru, rwkv6, whisper
from repro_torch.models.config import ArchConfig


class ModelAPI(NamedTuple):
    init: Callable          # (cfg, tp, device=, generator=) -> a model
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


def _rg_api() -> ModelAPI:
    return _lm_api()._replace(init=rglru.RG,
                              init_cache=rglru.init_cache_rg)


def _rwkv_api() -> ModelAPI:
    return _lm_api()._replace(init=rwkv6.RWKV,
                              init_cache=rwkv6.init_cache_rwkv)


def _whisper_api() -> ModelAPI:
    return _lm_api()._replace(
        init=whisper.Whisper, init_cache=whisper.init_cache_whisper,
        forward=lambda m, b, g: m(b["tokens"], b["frames"], g),
        prefill=lambda m, b, cache, g: m.prefill(b["tokens"], b["frames"],
                                                 cache, g))


_FAMILIES = {"dense": _lm_api, "moe": _lm_api, "vlm": _vlm_api,
             "hybrid": _rg_api, "ssm": _rwkv_api, "encdec": _whisper_api}


def get_api(cfg: ArchConfig) -> ModelAPI:
    return _FAMILIES[cfg.family]()
