"""Input builders for every (arch x shape) cell (repro/launch/specs.py).

The assigned shape grid (all 10 LM-family archs):
    train_4k     seq=4096   global_batch=256   -> train_step
    prefill_32k  seq=32768  global_batch=32    -> prefill_step
    decode_32k   seq=32768  global_batch=128   -> decode_step (KV cache 32k)
    long_500k    seq=524288 global_batch=1     -> decode_step, sub-quadratic
                                                  archs only

The concrete branch (the default): real tensors drawn from a
torch.Generator on its device (the generator's device, unless `device`
is given), for smoke tests and the launchers. The abstract branch
(`abstract=True`, JAX's ShapeDtypeStructs): tensors of the same shapes
and dtypes on the "meta" device, which hold no memory and draw nothing;
the dry run (launch/dryrun.py) turns them into fake tensors. As in JAX's
abstract branch, the vlm's labels are then one (batch, seq) int32 tensor.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dtype_of

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# Archs for which long_500k decode is runnable (bounded state/window);
# everything else is a documented skip.
LONG_OK = {"recurrentgemma-2b", "rwkv6-1.6b", "mixtral-8x7b"}


def cell_supported(cfg: ArchConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and cfg.name not in LONG_OK:
        return False, ("pure full-attention arch: 500k-token decode is "
                       "quadratic/HBM-infeasible; skipped per assignment")
    return True, ""


def _generator(generator: Optional[torch.Generator],
               device) -> torch.Generator:
    if generator is not None:
        return generator
    return torch.Generator(resolve_device(device)).manual_seed(0)


def _mk(shape, dtype: torch.dtype, gen: Optional[torch.Generator],
        maxval: Optional[int] = None) -> torch.Tensor:
    """A drawn tensor, or with no generator an abstract one (meta)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    if dtype == torch.int32:
        return torch.randint(0, maxval or 2, shape, generator=gen,
                             device=gen.device, dtype=torch.int32)
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).to(dtype)


def train_inputs(cfg: ArchConfig, seq: int, batch: int,
                 generator: Optional[torch.Generator] = None,
                 device=None, *, abstract: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """Batch dict for a train step. Token budget == seq per sample;
    modality prefixes (whisper frames / pixtral patches) take their
    slice of it. abstract: meta tensors of the same shapes and dtypes."""
    gen = None if abstract else _generator(generator, device)
    act_dtype = dtype_of(cfg.dtype)
    V = cfg.vocab_size
    if cfg.family == "encdec":
        return {
            "frames": _mk((batch, cfg.n_audio_frames, cfg.d_model),
                          act_dtype, gen),
            "tokens": _mk((batch, seq), torch.int32, gen, V),
            "labels": _mk((batch, seq), torch.int32, gen, V),
        }
    if cfg.family == "vlm":
        n_patch = min(cfg.n_patch_tokens, seq // 2)
        patches = _mk((batch, n_patch, cfg.d_model), act_dtype, gen)
        tokens = _mk((batch, seq - n_patch), torch.int32, gen, V)
        if gen is None:
            return {"patches": patches, "tokens": tokens,
                    "labels": _mk((batch, seq), torch.int32, None)}
        # labels cover the patch prefix (masked -1) + text.
        labels = torch.cat([
            torch.full((batch, n_patch), -1, dtype=torch.int32,
                       device=gen.device),
            _mk((batch, seq - n_patch), torch.int32, gen, V)], dim=1)
        return {"patches": patches, "tokens": tokens, "labels": labels}
    return {"tokens": _mk((batch, seq), torch.int32, gen, V),
            "labels": _mk((batch, seq), torch.int32, gen, V)}


def prefill_inputs(cfg: ArchConfig, seq: int, batch: int,
                   generator: Optional[torch.Generator] = None,
                   device=None, *, abstract: bool = False
                   ) -> Dict[str, torch.Tensor]:
    b = train_inputs(cfg, seq, batch, generator, device, abstract=abstract)
    b.pop("labels", None)
    return b


def decode_tokens(cfg: ArchConfig, batch: int,
                  generator: Optional[torch.Generator] = None,
                  device=None, *, abstract: bool = False) -> torch.Tensor:
    gen = None if abstract else _generator(generator, device)
    return _mk((batch,), torch.int32, gen, cfg.vocab_size)


def cache_specs(cfg: ArchConfig, api, batch: int, max_seq: int,
                dtype: torch.dtype = torch.bfloat16, device=None, *,
                abstract: bool = False):
    """The zero cache (JAX's concrete branch), or with abstract=True the
    same leaves on the "meta" device (its ShapeDtypeStructs)."""
    return api.init_cache(cfg, batch, max_seq, dtype,
                          "meta" if abstract else device)
