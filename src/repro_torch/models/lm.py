"""Decoder-only LM: dense / MoE / sliding-window / VLM-backbone variants.

The port of repro/models/lm.py. Covers mixtral-8x7b, dbrx-132b,
phi4-mini, nemotron-4-340b, qwen3-14b, command-r-plus-104b and
pixtral-12b (whose patch frontend is a stub: precomputed patch
embeddings enter `forward` as a prefix).

JAX stacks the layers and drives them with lax.scan; here they are an
nn.ModuleList run by a Python loop, and the KV cache is one stacked
tensor per k and v, (n_layers, B, T, Hkv, hd), written in place by
`prefill` and `decode` (JAX returns a new cache). The cache's position
is a Python int, so a decode step needs no copy from the card.

The model lives on `device`, the card unless the caller passes
device="cpu"; without a card that default raises. Weights are drawn
from an explicit torch.Generator (a new one seeded 0 when none is
given); a model built on the "meta" device is left undrawn for
`to_empty` (as repro_torch.models.convert does).

`forward` computes tensor-parallel inside distributed/tensor_parallel.py's
context (the sharded train step's); so do `prefill` and `decode` (the
mesh's serving steps) on a model that tensor_parallel.shard_for_serving
cut: the vocab-parallel lookup, the rank's heads and its cache of their
KV heads, the MLP and expert columns, and the rank's vocab chunk of the
f32 logits, all-gathered over the model axis so that every rank returns
the whole padded vocabulary's. Outside that context they run on whole
weights. Inside sharding.activation_sharding with seq_axis "model",
`forward` and `prefill` cut the residual stream between blocks to each
rank's S / tp positions where S divides (sequence parallelism,
tensor_parallel's `stream`); prefill's last position, on the last
rank's chunk, is gathered for the logits (`tensor_parallel.last`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

Cache = Dict[str, object]       # {"k": tensor, "v": tensor, "pos": int}


def window_of(cfg: ArchConfig) -> int:
    return cfg.window if cfg.attention == "sliding" else 0


class LM(nn.Module):
    def __init__(self, cfg: ArchConfig, tp: int = 16, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        dtype = L.dtype_of(cfg.param_dtype)
        V, d = cfg.vocab_padded(tp), cfg.d_model
        self.vocab = V
        self.embed = L.empty_param((V, d), dtype, device)
        self.layers = nn.ModuleList(L.Block(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = L.RMSNorm(d, device, stream=True)
        self.unembed = L.empty_param((d, V), dtype, device)
        if device.type != "meta":
            self.reset_parameters(
                generator or torch.Generator(device).manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """lm.py:26 `init_lm`'s draws, tensor by tensor."""
        L.dense_init_(self.embed, generator, scale_dim=self.cfg.d_model)
        for blk in self.layers:
            blk.reset_parameters(generator)
        self.ln_f.reset_parameters()
        L.dense_init_(self.unembed, generator)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None,
                groups: int = 1) -> torch.Tensor:
        """tokens: (B, S_text) int; prefix_embeds: (B, S_img, d) (the
        pixtral stub). Returns logits (B, S, vocab_padded) in f32; under
        tensor-parallel compute with the vocabulary sharded, this rank's
        chunk of them (distributed/tensor_parallel.py). Under sequence
        parallelism (tensor_parallel's `stream`) the blocks run on this
        rank's positions of the whole sequence, the vlm's prefix included
        (JAX guards on the concatenated length)."""
        TP = L.tp_ops()
        if prefix_embeds is None:
            with TP.stream(tokens.shape[1]):
                return self._run(L.embed_lookup(self.embed, tokens,
                                                self.vocab), groups)
        x = L.embed_lookup(self.embed, tokens, self.vocab)  # (B, S_text, d)
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        with TP.stream(x.shape[1]):
            return self._run(TP.cut(x), groups)

    def _run(self, x: torch.Tensor, groups: int) -> torch.Tensor:
        """The blocks, the final norm and the logits on the stream x."""
        win = window_of(self.cfg)
        for blk in self.layers:
            x = L.remat(self.cfg, blk, x, groups=groups, window=win)
        return L.logits(self.ln_f(x), self.unembed, self.vocab)

    def init_cache(self, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16) -> Cache:
        return init_cache_lm(self.cfg, batch, max_seq, dtype, self.device)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: Cache,
                groups: int = 1) -> Tuple[torch.Tensor, Cache]:
        """Run the prompt, fill the KV cache, return the last position's
        logits (B, vocab_padded) in f32 (lm.py:77 `prefill_lm`)."""
        S = tokens.shape[1]
        win = window_of(self.cfg)
        with L.tp_ops().stream(S):
            x = L.embed_lookup(self.embed, tokens, self.vocab)
            for i, blk in enumerate(self.layers):
                x = blk.prefill(x, cache["k"][i], cache["v"][i], groups, win)
            x = L.tp_ops().last(self.ln_f(x))
        cache["pos"] = S
        return L.serve_logits(x, self.unembed, self.vocab), cache

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, cache: Cache,
               groups: int = 1) -> Tuple[torch.Tensor, Cache]:
        """One decode step (lm.py:121 `decode_lm`). tokens: (B,) int.
        Returns (logits (B, vocab_padded) f32, cache)."""
        x = L.embed_lookup(self.embed, tokens, self.vocab)[:, None, :]
        pos = cache["pos"]
        win = window_of(self.cfg)
        for i, blk in enumerate(self.layers):
            x = blk.decode(x, cache["k"][i], cache["v"][i], pos, groups, win)
        x = self.ln_f(x)
        cache["pos"] = pos + 1
        return L.serve_logits(x[:, 0], self.unembed, self.vocab), cache


def init_cache_lm(cfg: ArchConfig, batch: int, max_seq: int,
                  dtype: torch.dtype = torch.bfloat16, device=None) -> Cache:
    """Zeros (n_layers, batch, T, Hkv, hd) for k and v; T = max_seq, or
    min(max_seq, window) for a sliding window (lm.py:68)."""
    win = window_of(cfg)
    T = min(max_seq, win) if win else max_seq
    shape = (cfg.n_layers, batch, T, cfg.n_kv_heads, cfg.head_dim)
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "pos": 0}
