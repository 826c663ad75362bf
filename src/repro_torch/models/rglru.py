"""RecurrentGemma-style hybrid: RG-LRU recurrent blocks + local attention.

The port of repro/models/rglru.py ([arXiv:2402.19427] Griffin /
RecurrentGemma): a repeating pattern of two residual RG-LRU blocks and
one local (sliding-window) MQA block. The RG-LRU recurrence

    r_t = sigmoid(W_a u_t);  i_t = sigmoid(W_x u_t)
    log a_t = -c * softplus(Lambda) * r_t            (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

is a diagonal linear RNN. JAX runs it with `lax.associative_scan`; torch
has none, so `rglru_scan` is a log-depth (Hillis-Steele) scan over time
with JAX's combine: ceil(log2 S) shift-and-combine steps, no Python loop
over time and no cumsum of log a (whose exp(-A) overflows f32 within
64 steps). The combine order differs from JAX's tree, so the two agree
to a tolerance, not to bits.

Arithmetic as JAX's, dtype by dtype: the projections in the parameter
dtype, the gates and the scan in f32, h cast back to x's dtype and the
last h kept in f32. `causal_conv4` keeps Python's `sum` order and JAX's
promotion: a state in f32 (both launchers pass an f32 cache) makes the
conv's output f32, and JAX then promotes `u @ W_a` to an f32 product
silently. torch.matmul refuses mixed dtypes, so `_mm` casts both sides
to the promoted dtype, as JAX does.

The model keeps the JAX package's layer order (`_layer_list`: the
(R, R, A) superblocks, then the remainder layers) in one nn.ModuleList,
R = `RGLRUBlock`, A = layers.Block at window cfg.window (rglru.py uses
cfg.window unconditionally). The cache, {"h": (n_r, B, d) f32, "conv":
(n_r, B, 3, d), "k"/"v": (n_a, B, T, Hkv, hd), "pos": int} with T =
min(max_seq, window), is written in place by `prefill` and `decode`
(JAX returns a new cache), as models/lm.py's is. The model lives on the
card unless the caller passes device="cpu"; its weights are drawn from
an explicit torch.Generator, and a model on "meta" is left undrawn.

`forward` computes tensor-parallel inside distributed/tensor_parallel.py's
context (the sharded train step's), where the step gave the blocks their
model-axis shards: the vocab-parallel embedding and logits, the
attention by heads, the MLP by columns, and each RG-LRU block by its
lru channels (`RGLRUBlock._step_tp`). So do `prefill` and `decode` (the
mesh's serving steps) on a model that tensor_parallel.shard_for_serving
cut: the attention on the rank's heads and its ring cache of their KV
head, each RG-LRU block on its held lru channels with h and the conv
state of those channels (`serve_channels`), and the logits of the whole
padded vocabulary on every rank. Outside that context they run on whole
weights. Under sequence parallelism (sharding.activation_sharding with
seq_axis "model"; tensor_parallel's `stream`) `forward` and `prefill`
hold each rank's S / tp positions of the residual stream between blocks;
each RG-LRU block gathers S at its entry (block_in), so the conv and the
scan still see every position, and reduce-scatters its w_out sum over S
(block_out).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

_C = 8.0

Cache = Dict[str, object]    # {"h", "conv", "k", "v": tensor, "pos": int}


def rglru_scan(a_log: torch.Tensor, bx: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = exp(a_log_t) * h_{t-1} + bx_t over axis 1 (time).

    a_log, bx: (B, S, dr) f32; h0: (B, dr), folded into step 0 as
    rglru.py:62 does. Each step combines every position with the one
    `shift` before it, (a1, b1) then (a2, b2) -> (a1 + a2, exp(a2) b1 +
    b2); a_log <= 0, so exp never overflows.
    """
    if h0 is not None:
        bx = torch.cat([bx[:, :1] + torch.exp(a_log[:, :1]) * h0[:, None],
                        bx[:, 1:]], dim=1)
    a, b = a_log, bx
    shift, S = 1, a.shape[1]
    while shift < S:
        b = torch.cat([b[:, :shift],
                       torch.exp(a[:, shift:]) * b[:, :-shift]
                       + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, :-shift] + a[:, shift:]], dim=1)
        shift *= 2
    return b


def causal_conv4(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, width 4. x: (B, S, dr), w: (4, dr), state:
    the last 3 inputs (B, 3, dr) or None (zeros). Returns (y, new state).

    ((0 + t0) + t1) + t2 + t3 with t_i = xp[:, i:i+S] * w[i], as Python's
    `sum` orders it in JAX; xp takes the promoted dtype of the state and x
    (jnp.concatenate's), so an f32 state gives an f32 y.
    """
    B, S, dr = x.shape
    pad = state if state is not None else x.new_zeros((B, 3, dr))
    dtype = torch.promote_types(pad.dtype, x.dtype)
    xp = torch.cat([pad.to(dtype), x.to(dtype)], dim=1)      # (B, S+3, dr)
    y = sum(xp[:, i:i + S] * w[i] for i in range(4))
    return y, xp[:, -3:]


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the promoted dtype of the two (JAX's jnp.matmul)."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return a.to(dtype) @ b.to(dtype)


class RGLRUBlock(nn.Module):
    """rglru.py:35 `init_rglru_block`'s parameters in JAX's (in, out)
    layout: the lru width is d_model, as for recurrentgemma-2b."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device=None):
        super().__init__()
        d = cfg.d_model
        self.ln = L.RMSNorm(d, device, stream=True)
        self.w_in = L.empty_param((d, d), dtype, device)      # x branch
        self.w_gate = L.empty_param((d, d), dtype, device)    # gelu gate
        self.conv_w = L.empty_param((4, d), dtype, device)
        self.w_a = L.empty_param((d, d), dtype, device)       # recur gate
        self.w_x = L.empty_param((d, d), dtype, device)       # input gate
        self.lam = L.empty_param((d,), torch.float32, device)
        self.w_out = L.empty_param((d, d), dtype, device)
        self.ln2 = L.RMSNorm(d, device, stream=True)
        self.mlp = L.DenseMLP(cfg, dtype, device)
        # [a, b): the lru channels this rank holds, set by
        # tensor_parallel.shard_for_serving; None when whole.
        self.serve_channels = None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.ln.reset_parameters()
        for w in (self.w_in, self.w_gate, self.w_a, self.w_x, self.w_out):
            L.dense_init_(w, generator)
        L.dense_init_(self.conv_w, generator, scale_dim=4)
        self.lam.copy_(torch.rand(self.lam.shape, generator=generator,
                                  device=self.lam.device))
        self.ln2.reset_parameters()
        self.mlp.reset_parameters(generator)

    def core(self, x: torch.Tensor, h0: Optional[torch.Tensor] = None,
             conv0: Optional[torch.Tensor] = None):
        """rglru.py:86 `_rglru_core`. x: (B, S, d) normed input; returns
        (branch out (B, S, d) in x's dtype, h_last (B, d) f32, conv
        state (B, 3, d))."""
        u = x @ self.w_in
        u, conv_state = causal_conv4(u, self.conv_w, conv0)
        r = torch.sigmoid(_mm(u, self.w_a).float())
        i = torch.sigmoid(_mm(u, self.w_x).float())
        log_a = -_C * F.softplus(self.lam) * r              # f32, < 0
        beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                      min=1e-9))
        h = rglru_scan(log_a, beta * (i * u.float()), h0)
        return h.to(x.dtype), h[:, -1], conv_state

    def forward(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        """rglru.py:100 `apply_rglru_block`."""
        axis = L.tp_ops().active()
        if axis is not None and self.w_in.shape[1] != self.lam.shape[0]:
            return self._step_tp(x, groups, axis)[0]    # lam is not cut
        return self.step(x, groups=groups)[0]

    def _step_tp(self, x: torch.Tensor, groups: int, axis,
                 h0: Optional[torch.Tensor] = None,
                 conv0: Optional[torch.Tensor] = None):
        """step on this rank's chunk of the lru channels, JAX's TP-only
        layout: u = xin @ w_in and the conv on the rank's channels; u
        all-gathered for w_a / w_x, whose columns give the rank's gates;
        the scan on those channels; the gate by columns; w_out
        row-parallel, summed over the axis. In training lam is whole and
        cut to the channels here (its gradient summed over the axis); in
        serving (`serve_channels`) it is held cut, and h0 / conv0 and the
        state returned are the rank's channels."""
        TP = L.tp_ops()
        n = self.w_in.shape[1]
        xin = TP.block_in(self.ln(x))
        u, conv_state = causal_conv4(xin @ self.w_in, self.conv_w, conv0)
        whole = TP.gather_from_model(u, -1, axis)
        r = torch.sigmoid(_mm(whole, self.w_a).float())
        i = torch.sigmoid(_mm(whole, self.w_x).float())
        lam = self.lam if self.serve_channels is not None else \
            TP.copy_to_model(self.lam, axis).narrow(0, axis.index * n, n)
        log_a = -_C * F.softplus(lam) * r
        beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                      min=1e-9))
        h = rglru_scan(log_a, beta * (i * u.float()), h0)
        gate = F.gelu((xin @ self.w_gate).float(),
                      approximate="tanh").to(x.dtype)
        x = x + TP.block_out((h.to(x.dtype) * gate) @ self.w_out)
        return x + self.mlp(self.ln2(x), groups), h[:, -1], conv_state

    def step(self, x: torch.Tensor, h0: Optional[torch.Tensor] = None,
             conv0: Optional[torch.Tensor] = None, groups: int = 1):
        """The block with its state in and out: (x, h_last f32, conv
        state). Prefill (no state) and rglru.py:110 `decode_rglru_block`
        (x: (B, 1, d); h0: (B, d) f32; conv0: (B, 3, d)); on a rank's
        serving channels (shard_for_serving) inside tensor-parallel
        compute, `_step_tp` with the state of those channels."""
        TP = L.tp_ops()
        if self.serve_channels is not None:
            return self._step_tp(x, groups, TP.active(), h0, conv0)
        xin = TP.block_in(self.ln(x), False)
        h, h_last, conv_state = self.core(xin, h0, conv0)
        gate = F.gelu((xin @ self.w_gate).float(),
                      approximate="tanh").to(x.dtype)
        x = x + TP.block_out((h * gate) @ self.w_out, False)
        return x + self.mlp(self.ln2(x), groups), h_last, conv_state


def superblocks(cfg: ArchConfig) -> Tuple[Tuple[str, ...], int,
                                          Tuple[str, ...]]:
    """(pattern, n_super, remainder pattern) of rglru.py:126."""
    pat = cfg.layer_pattern or ("R", "R", "A")
    n_super = cfg.n_layers // len(pat)
    return pat, n_super, cfg._pattern()[n_super * len(pat):]


def layer_kinds(cfg: ArchConfig) -> Tuple[str, ...]:
    """"R" / "A" per layer in rglru.py:187 `_layer_list`'s order."""
    pat, n_super, rem = superblocks(cfg)
    return tuple(pat) * n_super + tuple(rem)


class RG(nn.Module):
    """embed -> [(R, R, A) x n_super, remainder] -> norm -> unembed."""

    def __init__(self, cfg: ArchConfig, tp: int = 16, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        dtype = L.dtype_of(cfg.param_dtype)
        V, d = cfg.vocab_padded(tp), cfg.d_model
        self.vocab = V
        self.kinds = layer_kinds(cfg)
        self.embed = L.empty_param((V, d), dtype, device)
        self.layers = nn.ModuleList(
            RGLRUBlock(cfg, dtype, device) if c == "R"
            else L.Block(cfg, dtype, device) for c in self.kinds)
        self.ln_f = L.RMSNorm(d, device, stream=True)
        self.unembed = L.empty_param((d, V), dtype, device)
        if device.type != "meta":
            self.reset_parameters(
                generator or torch.Generator(device).manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        L.dense_init_(self.embed, generator, scale_dim=self.cfg.d_model)
        for blk in self.layers:
            blk.reset_parameters(generator)
        self.ln_f.reset_parameters()
        L.dense_init_(self.unembed, generator)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor, groups: int = 1) -> torch.Tensor:
        """rglru.py:159 `forward_rg`: logits (B, S, vocab_padded) f32;
        under tensor-parallel compute with the vocabulary sharded, this
        rank's chunk of them (distributed/tensor_parallel.py)."""
        with L.tp_ops().stream(tokens.shape[1]):
            x = L.embed_lookup(self.embed, tokens, self.vocab)
            for kind, blk in zip(self.kinds, self.layers):
                x = (L.remat(self.cfg, blk, x, groups) if kind == "R"
                     else L.remat(self.cfg, blk, x, groups,
                                  window=self.cfg.window))
            return L.logits(self.ln_f(x), self.unembed, self.vocab)

    def init_cache(self, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16) -> Cache:
        return init_cache_rg(self.cfg, batch, max_seq, dtype, self.device)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: Cache,
                groups: int = 1) -> Tuple[torch.Tensor, Cache]:
        """rglru.py:217 `prefill_rg`: run the prompt, write each R layer's
        h_last and conv state and each A layer's ring KV (the last T
        positions at slot p % T) into `cache`; return the last position's
        logits (B, vocab_padded) f32."""
        TP = L.tp_ops()
        ri = ai = 0
        with TP.stream(tokens.shape[1]):
            x = L.embed_lookup(self.embed, tokens, self.vocab)
            for kind, blk in zip(self.kinds, self.layers):
                if kind == "R":
                    x, h_last, conv = blk.step(x, groups=groups)
                    cache["h"][ri].copy_(h_last)
                    cache["conv"][ri].copy_(conv)
                    ri += 1
                else:
                    x = blk.prefill(x, cache["k"][ai], cache["v"][ai],
                                    groups, self.cfg.window)
                    ai += 1
            x = TP.last(self.ln_f(x))
        cache["pos"] = tokens.shape[1]
        return L.serve_logits(x, self.unembed, self.vocab), cache

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, cache: Cache,
               groups: int = 1) -> Tuple[torch.Tensor, Cache]:
        """rglru.py:263 `decode_rg`: one step, tokens (B,) int; returns
        (logits (B, vocab_padded) f32, cache)."""
        x = L.embed_lookup(self.embed, tokens, self.vocab)[:, None, :]
        pos = cache["pos"]
        ri = ai = 0
        for kind, blk in zip(self.kinds, self.layers):
            if kind == "R":
                x, h_last, conv = blk.step(x, cache["h"][ri],
                                           cache["conv"][ri], groups)
                cache["h"][ri].copy_(h_last)
                cache["conv"][ri].copy_(conv)
                ri += 1
            else:
                x = blk.decode(x, cache["k"][ai], cache["v"][ai], pos,
                               groups, self.cfg.window)
                ai += 1
        cache["pos"] = pos + 1
        return L.serve_logits(self.ln_f(x)[:, 0], self.unembed,
                              self.vocab), cache


def init_cache_rg(cfg: ArchConfig, batch: int, max_seq: int,
                  dtype: torch.dtype = torch.bfloat16, device=None) -> Cache:
    """rglru.py:201: zeros; h in f32 whatever `dtype` is, T =
    min(max_seq, cfg.window) ring slots per A layer."""
    kinds = layer_kinds(cfg)
    n_r, d = kinds.count("R"), cfg.d_model
    n_a = len(kinds) - n_r
    T = min(max_seq, cfg.window)
    device = resolve_device(device)
    kv = (n_a, batch, T, cfg.n_kv_heads, cfg.head_dim)
    return {"h": torch.zeros((n_r, batch, d), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((n_r, batch, 3, d), dtype=dtype,
                                device=device),
            "k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device), "pos": 0}
