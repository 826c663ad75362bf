"""Whisper-large-v3 backbone: the encoder-decoder family.

The port of repro/models/whisper.py ([arXiv:2212.04356]): 32 encoder and
32 decoder layers, d = 1,280, 20 heads of 64, GELU MLPs. The conv audio
front end is a stub there too: frames enter as precomputed embeddings
(B, n_audio_frames, d) in cfg.dtype, the output the two-conv
downsampler would give for 30 s of audio.

- `sinusoid(S, d)` / `sinusoid_at(pos, d)` (whisper.py:23, :31): f32
  angles pos x exp(-i ln(10000) / (d // 2 - 1)) (JAX's denominator, not
  d // 2), the sin half first, then the cos half; the caller casts to
  x's dtype before the add.
- `encode` (:90): frames + sinusoid(F), each encoder block non-causal
  (`layers.Block(..., causal=False)`), then `enc_ln`. JAX's `_qkv`
  applies RoPE in every self-attention, encoder and decoder alike, on
  top of the additive sinusoid (OpenAI's Whisper does not); the port
  keeps the reference's arithmetic.
- `CrossAttention` (:39, :49, :56): wq, wk, wv, wo in the (in, out)
  layout under JAX's keys; `kv(enc)` is `_cross_kv`, the forward an
  all-ones mask over the T encoder positions through `layers.sdpa` with
  its default f32 scores; no RoPE.
- `DecBlock` (:65): ln1, attn (`layers.Attention`, causal), ln_x, xattn,
  ln2, mlp (`layers.DenseMLP`), under JAX's names.
- `Whisper` (:75): enc_layers, enc_ln, dec_layers, ln_f, embed (V_pad,
  d; drawn with scale_dim = d) and unembed. JAX stacks the layers and
  drives them with lax.scan; here they are nn.ModuleLists run by a
  Python loop, so `models.convert.whisper_from_jax` maps
  "enc_layers.<i>" and "dec_layers.<i>" to row i of JAX's stacked node.

The cache, {"k", "v": (L, B, T, H, hd), "xk", "xv": (L, B, F, H, hd) in
the cache's dtype, "pos": int}: `prefill` encodes once, writes each
layer's self-attention k and v (zeros past S; a prompt longer than T is
refused, as `Attention.prefill` does) and the cross K/V of the encoder
output cast to the cache's dtype, and sets pos = S; `decode` adds
sinusoid_at(pos), attends over its slots <= pos, then over xk and xv
cast to x's dtype (whisper.py:186), and never writes them. Both write
the cache in place (JAX returns a new one), as models/lm.py's do.

Dtypes follow JAX's promotion. The launchers' cache is f32 and holds
bf16 values exactly, so the cross K/V a decode step reads are the bits
the forward computes. torch.matmul refuses mixed dtypes, so every cast
JAX's promotion makes is written out. `maybe_shard` is the identity on
one device and is left out. With `cfg.remat` a forward that autograd
records runs each encoder and decoder block (the cross K/V products
included, as in JAX's scan body) under activation checkpointing
(`layers.remat`); serving does not record, so remat does not touch it.
The model lives on the card unless the caller passes device="cpu"; its
weights are drawn from an explicit torch.Generator, and a model on
"meta" is left undrawn.

`forward` computes tensor-parallel inside distributed/tensor_parallel.py's
context (the sharded train step's), where the step gave the blocks their
model-axis shards: the vocab-parallel embedding and logits, every
self-attention (encoder and decoder) and cross-attention by heads, every
MLP by columns. The encoder output passes `copy_to_model` once before the
decoder loop: each layer's K/V projection gives it a partial gradient,
and one all-reduce sums them all. Under sequence parallelism
(sharding.activation_sharding with seq_axis "model"; tensor_parallel's
`stream`) the encoder's stream holds each rank's F / tp frames where F
divides and the decoder's each rank's S / tp positions where S divides,
each on its own guard (whisper's 1,500 frames at tp 16 stay whole); the
encoder output is all-gathered over the frames where they were cut
(`gather_from_model`, whose reduce-scatter backward sums the layers'
partial gradients), the cross-attention gathers its queries over S and
reduce-scatters its wo sum. So do `prefill` and `decode` (the
mesh's serving steps) on a model that tensor_parallel.shard_for_serving
cut: the encoder's attention on the rank's held heads (`layers.Attention.
forward` with `serve_heads`) and its MLP by columns, each decoder
self-attention on its heads and its cache of their KV heads, each
cross-attention on its held wq / wo heads over the xk / xv of its held
wk / wv KV heads (written once at prefill into the caller's dict), and
the logits of the whole padded vocabulary on every rank. Outside that
context they run on whole weights.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

Cache = Dict[str, object]    # {"k", "v", "xk", "xv": tensor, "pos": int}


def _inv_freq(d: int, device=None) -> torch.Tensor:
    """exp(-i ln(10000) / (d // 2 - 1)), i < d // 2, in f32 as JAX's."""
    step = torch.tensor(math.log(10000.0), dtype=torch.float32,
                        device=device) / (d // 2 - 1)
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)
    return torch.exp(-dim * step)


def sinusoid(S: int, d: int, device=None) -> torch.Tensor:
    """whisper.py:23 `_sinusoid`: (S, d) f32, [sin | cos]."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    ang = pos * _inv_freq(d, device)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def sinusoid_at(pos: int, d: int, device=None) -> torch.Tensor:
    """whisper.py:31 `_sinusoid_at`: (d,) f32 at one position."""
    ang = float(pos) * _inv_freq(d, device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class CrossAttention(nn.Module):
    """whisper.py:39 `init_cross_attention`'s parameters."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.head_dim
        nq, nkv = cfg.n_heads, cfg.n_kv_heads
        self.wq = L.empty_param((d, nq * hd), dtype, device)
        self.wk = L.empty_param((d, nkv * hd), dtype, device)
        self.wv = L.empty_param((d, nkv * hd), dtype, device)
        self.wo = L.empty_param((nq * hd, d), dtype, device)
        # ((h0, h1), (k0, k1)): the query heads and the KV heads this rank
        # holds, set by tensor_parallel.shard_for_serving; None when whole.
        self.serve_heads = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            L.dense_init_(w, generator)

    def tp_axis(self):
        """The model axis where this module computes tensor-parallel on the
        train step's shards, else None (whole, or held for serving). wq's
        width in its computed layout: Whisper.encode asks outside the
        block, where the gather at each use has not yet run."""
        axis = L.tp_ops().active()
        width = L.sharding_ops().compute_shape(self.wq)[1]
        if axis is not None and self.serve_heads is None and \
                width != self.cfg.n_heads * self.cfg.head_dim:
            return axis
        return None

    def kv(self, enc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """whisper.py:49 `_cross_kv`: enc (B, T, d) -> k, v (B, T, Hkv,
        hd); tensor-parallel, the KV heads this rank's query heads read:
        in training from the step's shards (enc's gradient is then a
        partial sum: Whisper.forward sums it), in serving from the held
        wk / wv columns (`serve_heads`)."""
        cfg = self.cfg
        B, T, _ = enc.shape
        wk, wv, nkv = self.wk, self.wv, cfg.n_kv_heads
        axis = self.tp_axis()
        if axis is not None:
            TP = L.tp_ops()
            spans = TP.attention_spans(cfg, axis.size)
            wk, wv = (TP.take(w, 1, spans[n], axis)
                      for n, w in (("wk", wk), ("wv", wv)))
            k0, k1 = TP.kv_span(cfg.n_heads, cfg.q_per_kv, axis.size,
                                axis.index)
            nkv = k1 - k0
        elif self.serve_heads is not None:
            k0, k1 = self.serve_heads[1]
            nkv = k1 - k0
        shape = (B, T, nkv, cfg.head_dim)
        return (enc @ wk).reshape(shape), (enc @ wv).reshape(shape)

    def forward(self, x: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        """whisper.py:56 `apply_cross_attention`: x (B, S, d) attends to
        every one of the T positions of k, v (B, T, Hkv, hd);
        tensor-parallel, this rank's query heads (in training wq gathered
        where they are not its chunk; in serving held, `serve_heads`) over
        the KV heads of `kv`, wo row-parallel and summed over the axis."""
        cfg, TP = self.cfg, L.tp_ops()
        axis = self.tp_axis()
        held = self.serve_heads is not None
        x = TP.block_in(x, held or axis is not None)
        B, S, _ = x.shape
        mask = torch.ones((1, 1, S, k.shape[1]), dtype=torch.bool,
                          device=x.device)
        if held:
            axis, wq, wo = TP.active(), self.wq, self.wo
            heads, kvs = self.serve_heads
        elif axis is None:
            q = (x @ self.wq).reshape(B, S, cfg.n_heads, cfg.head_dim)
            return TP.block_out(L.sdpa(q, k, v, mask, cfg.q_per_kv)
                                @ self.wo, False)
        else:
            spans = TP.attention_spans(cfg, axis.size)
            wq = TP.take(self.wq, 1, spans["wq"], axis)
            wo = TP.take(self.wo, 0, spans["wo"], axis)
            heads = TP.head_span(cfg.n_heads, axis.size, axis.index)
            kvs = TP.kv_span(cfg.n_heads, cfg.q_per_kv, axis.size,
                             axis.index)
        q = (x @ wq).reshape(B, S, heads[1] - heads[0], cfg.head_dim)
        k, v, group = L.kv_group(k, v, heads, kvs, cfg.q_per_kv)
        return TP.block_out(L.sdpa(q, k, v, mask, group) @ wo)


class DecBlock(nn.Module):
    """whisper.py:65 `init_dec_block`: self-attention, cross-attention and
    the MLP, each pre-normed."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = L.RMSNorm(d, device, stream=True)
        self.attn = L.Attention(cfg, dtype, device)
        self.ln_x = L.RMSNorm(d, device, stream=True)
        self.xattn = CrossAttention(cfg, dtype, device)
        self.ln2 = L.RMSNorm(d, device, stream=True)
        self.mlp = L.DenseMLP(cfg, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.ln1.reset_parameters()
        self.attn.reset_parameters(generator)
        self.ln_x.reset_parameters()
        self.xattn.reset_parameters(generator)
        self.ln2.reset_parameters()
        self.mlp.reset_parameters(generator)

    def cross_and_mlp(self, x: torch.Tensor, xk: torch.Tensor,
                      xv: torch.Tensor, groups: int) -> torch.Tensor:
        x = x + self.xattn(self.ln_x(x), xk, xv)
        return x + self.mlp(self.ln2(x), groups)

    def forward(self, x: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor,
                groups: int = 1) -> torch.Tensor:
        """The body of whisper.py:111's scan (teacher-forced)."""
        x = x + self.attn(self.ln1(x))
        return self.cross_and_mlp(x, xk, xv, groups)


def _dec_body(blk: "DecBlock", x: torch.Tensor, enc: torch.Tensor,
              groups: int) -> torch.Tensor:
    """whisper.py:111's scan body: the layer's cross K/V of the encoder's
    output, then the block."""
    return blk(x, *blk.xattn.kv(enc), groups)


class Whisper(nn.Module):
    """embed + sinusoid -> DecBlock x n_layers (over the encoder's output)
    -> norm -> unembed."""

    def __init__(self, cfg: ArchConfig, tp: int = 16, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        dtype = L.dtype_of(cfg.param_dtype)
        V, d = cfg.vocab_padded(tp), cfg.d_model
        self.vocab = V
        self.enc_layers = nn.ModuleList(L.Block(cfg, dtype, device)
                                        for _ in range(cfg.n_encoder_layers))
        self.enc_ln = L.RMSNorm(d, device, stream=True)
        self.dec_layers = nn.ModuleList(DecBlock(cfg, dtype, device)
                                        for _ in range(cfg.n_layers))
        self.ln_f = L.RMSNorm(d, device, stream=True)
        self.embed = L.empty_param((V, d), dtype, device)
        self.unembed = L.empty_param((d, V), dtype, device)
        if device.type != "meta":
            self.reset_parameters(
                generator or torch.Generator(device).manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """whisper.py:75 `init_whisper`'s draws, tensor by tensor."""
        for blk in self.enc_layers:
            blk.reset_parameters(generator)
        self.enc_ln.reset_parameters()
        for blk in self.dec_layers:
            blk.reset_parameters(generator)
        self.ln_f.reset_parameters()
        L.dense_init_(self.embed, generator, scale_dim=self.cfg.d_model)
        L.dense_init_(self.unembed, generator)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """whisper.py:90 `encode`: frames (B, F, d) -> the encoder output
        (B, F, d) in the frames' dtype. Under sequence parallelism the
        encoder's stream holds each rank's F / tp frames where F divides
        (the frames carry no gradient), and its output is gathered over
        the frames for the cross K/V. Under tensor-parallel compute the
        output enters the cross-attentions through block_in once: each
        layer's K/V projection gives it a partial gradient, and one
        collective sums them all."""
        cross = self.dec_layers[0].xattn.tp_axis() is not None
        TP = L.tp_ops()
        with TP.stream(frames.shape[1]):
            x = TP.cut(frames + sinusoid(frames.shape[1], self.cfg.d_model,
                                         frames.device).to(frames.dtype))
            for blk in self.enc_layers:
                x = L.remat(self.cfg, blk, x, causal=False)
            return TP.block_in(self.enc_ln(x), cross)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The token embedding plus the sinusoid, at the stream's
        positions."""
        x = L.embed_lookup(self.embed, tokens, self.vocab)
        return x + L.tp_ops().cut(sinusoid(tokens.shape[1], self.cfg.d_model,
                                           x.device), 0).to(x.dtype)

    def forward(self, tokens: torch.Tensor, frames: torch.Tensor,
                groups: int = 1) -> torch.Tensor:
        """whisper.py:104 `forward_whisper`, teacher-forced: logits (B, S,
        vocab_padded) in f32; under tensor-parallel compute with the
        vocabulary sharded, this rank's chunk of them."""
        enc = self.encode(frames)
        with L.tp_ops().stream(tokens.shape[1]):
            x = self._embed(tokens)
            for blk in self.dec_layers:
                x = L.remat(self.cfg, _dec_body, blk, x, enc, groups)
            return L.logits(self.ln_f(x), self.unembed, self.vocab)

    def init_cache(self, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16) -> Cache:
        return init_cache_whisper(self.cfg, batch, max_seq, dtype,
                                  self.device)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, frames: torch.Tensor,
                cache: Cache, groups: int = 1) -> Tuple[torch.Tensor, Cache]:
        """whisper.py:137 `prefill_whisper`: encode once, run the prompt,
        write every layer's k, v, xk and xv into `cache`; return the last
        position's logits (B, vocab_padded) f32."""
        enc = self.encode(frames)
        TP = L.tp_ops()
        with TP.stream(tokens.shape[1]):
            x = self._embed(tokens)
            for i, blk in enumerate(self.dec_layers):
                x = x + blk.attn.prefill(blk.ln1(x), cache["k"][i],
                                         cache["v"][i])
                xk, xv = blk.xattn.kv(enc)
                cache["xk"][i].copy_(xk)
                cache["xv"][i].copy_(xv)
                x = blk.cross_and_mlp(x, xk, xv, groups)
            x = TP.last(self.ln_f(x))
        cache["pos"] = tokens.shape[1]
        return L.serve_logits(x, self.unembed, self.vocab), cache

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, cache: Cache,
               groups: int = 1) -> Tuple[torch.Tensor, Cache]:
        """whisper.py:173 `decode_whisper`: one step, tokens (B,) int.
        Returns (logits (B, vocab_padded) f32, cache)."""
        x = L.embed_lookup(self.embed, tokens, self.vocab)[:, None, :]
        pos = cache["pos"]
        x = x + sinusoid_at(pos, self.cfg.d_model, x.device).to(x.dtype)
        for i, blk in enumerate(self.dec_layers):
            x = x + blk.attn.decode(blk.ln1(x), cache["k"][i],
                                    cache["v"][i], pos)
            x = blk.cross_and_mlp(x, cache["xk"][i].to(x.dtype),
                                  cache["xv"][i].to(x.dtype), groups)
        cache["pos"] = pos + 1
        return L.serve_logits(self.ln_f(x)[:, 0], self.unembed,
                              self.vocab), cache


def init_cache_whisper(cfg: ArchConfig, batch: int, max_seq: int,
                       dtype: torch.dtype = torch.bfloat16,
                       device=None) -> Cache:
    """whisper.py:126: zeros (n_layers, batch, max_seq, Hkv, hd) for k and
    v, (n_layers, batch, n_audio_frames, Hkv, hd) for xk and xv."""
    Lb, F = cfg.n_layers, cfg.n_audio_frames
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    device = resolve_device(device)

    def zeros(T):
        return torch.zeros((Lb, batch, T, hkv, hd), dtype=dtype,
                           device=device)
    return {"k": zeros(max_seq), "v": zeros(max_seq), "xk": zeros(F),
            "xv": zeros(F), "pos": 0}
