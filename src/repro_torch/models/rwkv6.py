"""RWKV-6 "Finch": attention-free linear recurrence with data-dependent decay.

The port of repro/models/rwkv6.py ([arXiv:2404.05892]). Per head (dk =
dv = rwkv_head_dim), a matrix-valued state S:

    out_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
    S_t   = diag(w_t) S_{t-1} + k_t^T v_t

with w_t = exp(-exp(w0 + tanh(x' W_a) W_b)) per channel, token-shift
mixing on every projection and a squared-ReLU channel-mix FFN.

`wkv_chunked` keeps JAX's chunked form (chunks of Lc = min(chunk, S)
tokens; S must be a multiple of Lc, as JAX asserts) and its factorized
two-sided scores r_s = r exp(lp_prev) <= 1, k_s = k exp(-lp) <= e^60 (the
decay clamp in `_time_mix`), so every product stays in f32. JAX carries
the state across chunks with `lax.scan`; here everything local to a
chunk (the masked scores, the bonus diagonal, each chunk's
sum_j k_j exp(lp_L - lp_j) (x) v_j) is computed for all chunks at once,
and a Python loop runs only the (B, H, dh, dh) state recurrence. A
decode step is the same core at S = 1.

Arithmetic as JAX's, dtype by dtype: the projections in the parameter
dtype, `mu` cast to x's dtype, the decay's LoRA as a product in x's dtype,
tanh there, then an f32 product; r, k, v, the core, ln_x and the silu
gate in f32, cast back before W_o; the channel mix's sigmoid in f32 cast
to x's dtype. torch.matmul refuses mixed dtypes, so each mixed product
casts both sides as JAX promotes them.

The cache, {"s": (L, B, H, dh, dh) f32, "tm", "cm": (L, B, d) in the
cache dtype, "pos": int}, holds each layer's state and the normed input
of the last token of its time mix (tm) and channel mix (cm). `prefill`
starts from a zero state, whatever the cache holds, and `decode`
continues it; both write the cache in place (JAX returns a new one), as
models/lm.py's do. `maybe_shard` (distributed/sharding.py) is the
identity on one device and is left out. With `cfg.remat` a forward
that autograd records runs each block under activation checkpointing
(`layers.remat`, JAX's jax.checkpoint of the scan body); serving does not
record, so remat does not touch it. The model lives on the card unless the caller passes
device="cpu"; its weights are drawn from an explicit torch.Generator,
and a model on "meta" is left undrawn.

`forward` computes tensor-parallel inside distributed/tensor_parallel.py's
context (the sharded train step's), where the step gave the blocks their
model-axis shards: the vocab-parallel embedding and logits, each block's
time mix by whole heads and its channel mix by d_ff columns
(`RWKVBlock.forward`; the module docstring there says how each splits).
So do `prefill` and `decode` (the mesh's serving steps) on a model that
tensor_parallel.shard_for_serving cut: each time mix on its held heads
with their f32 state s, each channel mix on its held chunks, tm and cm
whole (the normed inputs lie on the replicated stream), and the logits
of the whole padded vocabulary on every rank. Outside that context they
run on whole weights. Under sequence parallelism (sharding.
activation_sharding with seq_axis "model"; tensor_parallel's `stream`)
`forward` and `prefill` hold each rank's S / tp positions of the
residual stream between units: the time mix gathers S before its token
shift and reduce-scatters its wo sum over S; the channel mix gathers S,
and its gated chunk of d goes back to the stream by one all-to-all
(tensor_parallel.channels_to_rows), (b, S, d / tp) to (b, S / tp, d),
1 / tp of the bytes of gathering it over d and keeping the rank's rows.
tm and cm are the gathered inputs' last positions.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

_CHUNK = 64
_LORA = 64

Cache = Dict[str, object]    # {"s", "tm", "cm": tensor, "pos": int}
State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # (s, tm, cm)


def shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None):
    """Token shift: x_{t-1} (B, S, d); prev = the previous segment's last
    token (B, d), zeros when None."""
    first = (prev[:, None] if prev is not None
             else x.new_zeros((x.shape[0], 1, x.shape[2])))
    return torch.cat([first, x[:, :-1]], dim=1)


def mix(x: torch.Tensor, xs: torch.Tensor, mu: torch.Tensor):
    return x + (xs - x) * mu.to(x.dtype)


def heads(x: torch.Tensor, H: int) -> torch.Tensor:
    B, S, d = x.shape
    return x.reshape(B, S, H, d // H)


def wkv_chunked(r, k, v, logw, u, state0, chunk: int = _CHUNK):
    """rwkv6.py:80 `_wkv_chunked`. r, k, v, logw: (B, S, H, dh) f32
    (logw < 0); u: (H, dh); state0: (B, H, dh, dh). Returns (out (B, S,
    H, dh), state (B, H, dh, dh))."""
    B, S, H, dh = r.shape
    Lc = min(chunk, S)
    if S % Lc:
        raise ValueError(f"seq {S} not divisible by chunk {Lc}")
    nC = S // Lc

    def resh(t):                                  # -> (B, H, nC, Lc, dh)
        return t.reshape(B, nC, Lc, H, dh).permute(0, 3, 1, 2, 4)

    r, k, v, lw = resh(r), resh(k), resh(v), resh(logw)
    lp = torch.cumsum(lw, dim=3)                  # decreasing along Lc
    lp_prev = lp - lw                             # lp_{t-1} (exclusive)
    r_s = r * torch.exp(lp_prev)                  # <= |r|
    k_s = k * torch.exp(-lp)                      # <= e^60 |k|
    scores = torch.einsum("bhctd,bhcjd->bhctj", r_s, k_s)
    tri = torch.tril(torch.ones((Lc, Lc), device=r.device), diagonal=-1)
    scores = scores * tri                         # strictly lower (j < t)
    out = torch.einsum("bhctj,bhcjd->bhctd", scores, v)
    diag = torch.sum(r * u[None, :, None, None, :] * k, dim=-1)
    out = out + diag[..., None] * v               # the bonus u
    lp_end = lp[:, :, :, -1:, :]                  # (B, H, nC, 1, dh)
    kd = k_s * torch.exp(lp_end)
    kv = torch.einsum("bhctd,bhcte->bhcde", kd, v)
    decay = torch.exp(lp_end.squeeze(3))[..., None]    # (B, H, nC, dh, 1)
    states = [state0]                             # the state before chunk c
    for c in range(nC):
        states.append(states[-1] * decay[:, :, c] + kv[:, :, c])
    carried = torch.stack(states[:-1], dim=2)
    out = out + torch.einsum("bhctd,bhcde->bhcte", r_s, carried)
    return out.permute(0, 2, 3, 1, 4).reshape(B, S, H, dh), states[-1]


class RWKVBlock(nn.Module):
    """rwkv6.py:32 `init_rwkv_block`'s parameters under JAX's keys, the
    projections in the (in, out) layout."""

    # The weights each tensor-parallel unit cuts (tensor_parallel's
    # compute_specs): the time mix and the channel mix.
    TIME_MIX = ("wr", "wk", "wv", "wg", "wo", "wa", "wb")
    CHANNEL_MIX = ("ck", "cv", "cr")

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.d_model, cfg.d_ff
        f32 = torch.float32
        self.ln1 = L.RMSNorm(d, device, stream=True)
        for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "w0", "u"):
            setattr(self, name, L.empty_param((d,), f32, device))
        for name in ("wr", "wk", "wv", "wg", "wo", "cr"):
            setattr(self, name, L.empty_param((d, d), dtype, device))
        self.wa = L.empty_param((d, _LORA), dtype, device)
        self.wb = L.empty_param((_LORA, d), dtype, device)
        self.ln_x = L.RMSNorm(d, device)
        self.ln2 = L.RMSNorm(d, device, stream=True)
        self.mu_ck = L.empty_param((d,), f32, device)
        self.mu_cr = L.empty_param((d,), f32, device)
        self.ck = L.empty_param((d, f), dtype, device)
        self.cv = L.empty_param((f, d), dtype, device)
        # Set by tensor_parallel.shard_for_serving (None when whole): the
        # channels [a, b) of the time mix's heads this rank holds, and
        # its chunk [c0, c1) of d in the channel mix (cr's columns).
        self.serve_heads = None
        self.serve_chunk = None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for norm in (self.ln1, self.ln_x, self.ln2):
            norm.reset_parameters()
        for mu in (self.mu_r, self.mu_k, self.mu_v, self.mu_w, self.mu_g,
                   self.mu_ck, self.mu_cr):
            mu.fill_(0.5)
        self.w0.fill_(-0.6)
        for w in (self.wr, self.wk, self.wv, self.wg, self.wa, self.wb,
                  self.wo, self.ck, self.cv, self.cr):
            L.dense_init_(w, generator)
        self.u.copy_(0.5 * torch.randn(self.u.shape, generator=generator,
                                       device=self.u.device))

    def time_mix(self, x: torch.Tensor, state0: torch.Tensor,
                 x_prev: Optional[torch.Tensor] = None):
        """rwkv6.py:131 `_time_mix`. x: (B, S, d) normed. Returns (out,
        new state)."""
        cfg = self.cfg
        B, S, d = x.shape
        H = d // cfg.rwkv_head_dim
        xs = shift(x, x_prev)
        r = mix(x, xs, self.mu_r) @ self.wr
        k = mix(x, xs, self.mu_k) @ self.wk
        v = mix(x, xs, self.mu_v) @ self.wv
        g = mix(x, xs, self.mu_g) @ self.wg
        xw = mix(x, xs, self.mu_w)
        loglog_w = self.w0 + torch.tanh(xw @ self.wa).float() \
            @ self.wb.float()
        logw = -torch.exp(loglog_w)                        # < 0, f32
        # Per-chunk cumulative |log decay| <= 60: exp(-lp) <= e^60 in f32.
        logw = torch.clamp(logw, min=-60.0 / max(cfg.rwkv_chunk, 1))

        def to_h(t):
            return heads(t.float(), H)

        out, state = wkv_chunked(
            to_h(r), to_h(k), to_h(v), heads(logw, H),
            self.u.reshape(H, cfg.rwkv_head_dim), state0, cfg.rwkv_chunk)
        out = self.ln_x(out.reshape(B, S, d))
        out = (out * F.silu(g.float())).to(x.dtype)
        return out @ self.wo, state

    def channel_mix(self, x: torch.Tensor,
                    x_prev: Optional[torch.Tensor] = None):
        """rwkv6.py:163 `_channel_mix`."""
        xs = shift(x, x_prev)
        k = mix(x, xs, self.mu_ck) @ self.ck
        r = mix(x, xs, self.mu_cr) @ self.cr
        kk = F.relu(k)
        return torch.sigmoid(r.float()).to(x.dtype) * ((kk * kk) @ self.cv)

    def step(self, x: torch.Tensor, state0: Optional[torch.Tensor] = None,
             tm_prev: Optional[torch.Tensor] = None,
             cm_prev: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, State]:
        """rwkv6.py:172 `apply_rwkv_block`: (x, (state, tm, cm)); no
        state0 is a zero state, no tm / cm a zero shift. Under
        tensor-parallel compute each unit whose weights the train step
        cut, or that tensor_parallel.shard_for_serving cut (`serve_heads`:
        the time mix's heads, whose state it carries; `serve_chunk`: the
        channel mix), runs on its shard; tm and cm are the last position
        of the whole normed inputs (gathered where the stream is cut)."""
        axis = L.tp_ops().active()
        x, state, tm = self._time(x, axis, state0, tm_prev)
        x, cm = self._channel(x, axis, cm_prev)
        return x, (state, tm, cm)

    def forward(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        """The block from a zero state (`step`)."""
        return self.step(x)[0]

    def _time(self, x: torch.Tensor, axis,
              state0: Optional[torch.Tensor] = None,
              x_prev: Optional[torch.Tensor] = None):
        """x plus the time mix of its normed input, the unit entered and
        left through tensor_parallel's block_in / block_out (so on every
        position where the stream is cut): (that sum, the state, a copy
        of the normed input's last position; a view would keep the whole
        input alive)."""
        TP = L.tp_ops()
        tp = self.serve_heads is not None or (
            axis is not None and self.wr.shape[1] != self.cfg.d_model)
        xin = TP.block_in(self.ln1(x), tp)
        if tp:
            a, state = self._time_mix_tp(xin, axis, state0, x_prev)
        else:
            if state0 is None:
                dh = self.cfg.rwkv_head_dim
                state0 = xin.new_zeros(
                    (xin.shape[0], xin.shape[2] // dh, dh, dh),
                    dtype=torch.float32)
            a, state = self.time_mix(xin, state0, x_prev)
        return x + TP.block_out(a, tp), state, xin[:, -1].clone()

    def _channel(self, x: torch.Tensor, axis,
                 x_prev: Optional[torch.Tensor] = None):
        """x plus the channel mix of its normed input, as `_time`: (that
        sum, a copy of the normed input's last position)."""
        TP = L.tp_ops()
        if self.serve_chunk is not None or (
                axis is not None and self.ck.shape[1] != self.cfg.d_ff):
            c, last = self._channel_mix_tp(self.ln2(x), axis, x_prev)
        else:
            cin = TP.block_in(self.ln2(x), False)
            c = TP.block_out(self.channel_mix(cin, x_prev), False)
            last = cin[:, -1].clone()
        return x + c, last

    def _time_mix_tp(self, x: torch.Tensor, axis,
                     state0: Optional[torch.Tensor] = None,
                     x_prev: Optional[torch.Tensor] = None):
        """time_mix's output and state on this rank's heads, [ceil(r H /
        tp), ceil((r + 1) H / tp)), from x as block_in gives it: wr / wk /
        wv / wg column-parallel and wo row-parallel on their channels, the
        partial sums after wo returned for the caller's block_out;
        w0 and u cut to the channels; ln_x normalizes over the whole width
        (RMSNorm.forward with the axis); the state (B, heads, dh, dh) of
        those heads (zeros for None). In training the weights are the
        step's shards, gathered where the heads are not their chunk
        (`take`); the decay LoRA's tanh(xw @ wa) on the rank's wa columns
        all-gathered, (B, S, 64), times wb's columns for its channels (wb
        gathered whole: 64 x d); mu_*, w0 and u replicated, their
        gradient summed over the axis. In serving (`serve_heads`) every
        weight is held at the rank's channels and wa whole: no weight or
        LoRA collective. A rank with no head runs the same operations on
        empty heads."""
        cfg, TP = self.cfg, L.tp_ops()
        B, S, d = x.shape
        dh = cfg.rwkv_head_dim
        held = self.serve_heads is not None
        if held:
            a, b = self.serve_heads
            wr, wk, wv, wg, wo, wb = (self.wr, self.wk, self.wv, self.wg,
                                      self.wo, self.wb)
            w0, u = self.w0, self.u
        else:
            chans = TP.head_channels(d // dh, dh, axis.size)
            a, b = chans(axis.index)
            wr, wk, wv, wg = (TP.take(getattr(self, name), 1, chans, axis)
                              for name in ("wr", "wk", "wv", "wg"))
            wo = TP.take(self.wo, 0, chans, axis)
            wb = TP.gather_from_model(self.wb, 0, axis)[:, a:b]
            w0 = TP.copy_to_model(self.w0, axis)[a:b]
            u = TP.copy_to_model(self.u, axis)[a:b]
        n = (b - a) // dh

        def shared(t):             # replicated: its gradient summed
            return TP.copy_to_model(t, axis)

        xs = shift(x, x_prev)
        r = mix(x, xs, shared(self.mu_r)) @ wr
        k = mix(x, xs, shared(self.mu_k)) @ wk
        v = mix(x, xs, shared(self.mu_v)) @ wv
        g = mix(x, xs, shared(self.mu_g)) @ wg
        xw = mix(x, xs, shared(self.mu_w))
        lora = torch.tanh(xw @ self.wa)
        if not held:
            lora = TP.gather_from_model(lora, -1, axis)
        loglog_w = w0 + lora.float() @ wb.float()
        logw = -torch.exp(loglog_w)
        logw = torch.clamp(logw, min=-60.0 / max(cfg.rwkv_chunk, 1))

        def to_h(t):
            return t.float().reshape(B, S, n, dh)

        if state0 is None:
            state0 = x.new_zeros((B, n, dh, dh), dtype=torch.float32)
        out, state = wkv_chunked(to_h(r), to_h(k), to_h(v), to_h(logw),
                                 u.reshape(n, dh), state0, cfg.rwkv_chunk)
        out = self.ln_x(out.reshape(B, S, b - a), axis, (a, b))
        out = (out * F.silu(g.float())).to(x.dtype)
        return out @ wo, state

    def _channel_mix_tp(self, x: torch.Tensor, axis,
                        x_prev: Optional[torch.Tensor] = None):
        """channel_mix's output and its input's last position: ck
        column-parallel over d_ff, cv row-parallel, its partial sums
        reduce-scattered to the rank's chunk of d and there gated by the
        sigmoid of cr's columns (column-parallel over d). With the stream
        whole, the product is all-gathered over d into it (its gradient
        this rank's chunk of the whole one every rank holds); with it cut
        (x gathered over S by block_in), one all-to-all turns the rank's
        chunk of d at every position into every channel at its positions,
        (b, S / tp, d). Training's shards and serving's held chunks
        (`serve_chunk`) are the same."""
        TP = L.tp_ops()
        x = TP.block_in(x)
        xs = shift(x, x_prev)
        k = mix(x, xs, TP.copy_to_model(self.mu_ck, axis)) @ self.ck
        r = mix(x, xs, TP.copy_to_model(self.mu_cr, axis)) @ self.cr
        kk = F.relu(k)
        part = TP.scatter_from_model((kk * kk) @ self.cv, -1, axis)
        out = torch.sigmoid(r.float()).to(x.dtype) * part
        last = x[:, -1].clone()
        if TP.stream_axis() is not None:
            return TP.channels_to_rows(out, axis), last
        return TP.gather_to_stream(out, -1, axis), last


class RWKV(nn.Module):
    """embed -> RWKVBlock x n_layers -> norm -> unembed."""

    def __init__(self, cfg: ArchConfig, tp: int = 16, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        dtype = L.dtype_of(cfg.param_dtype)
        V, d = cfg.vocab_padded(tp), cfg.d_model
        self.vocab = V
        self.embed = L.empty_param((V, d), dtype, device)
        self.layers = nn.ModuleList(RWKVBlock(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = L.RMSNorm(d, device, stream=True)
        self.unembed = L.empty_param((d, V), dtype, device)
        if device.type != "meta":
            self.reset_parameters(
                generator or torch.Generator(device).manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """rwkv6.py:188 `init_rwkv`'s draws, tensor by tensor."""
        L.dense_init_(self.embed, generator, scale_dim=self.cfg.d_model)
        for blk in self.layers:
            blk.reset_parameters(generator)
        self.ln_f.reset_parameters()
        L.dense_init_(self.unembed, generator)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor, groups: int = 1) -> torch.Tensor:
        """rwkv6.py:200 `forward_rwkv`: logits (B, S, vocab_padded) f32;
        under tensor-parallel compute with the vocabulary sharded, this
        rank's chunk of them (distributed/tensor_parallel.py)."""
        with L.tp_ops().stream(tokens.shape[1]):
            x = L.embed_lookup(self.embed, tokens, self.vocab)
            for blk in self.layers:
                x = L.remat(self.cfg, blk, x)
            return L.logits(self.ln_f(x), self.unembed, self.vocab)

    def init_cache(self, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16) -> Cache:
        return init_cache_rwkv(self.cfg, batch, max_seq, dtype, self.device)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: Cache,
                groups: int = 1) -> Tuple[torch.Tensor, Cache]:
        """rwkv6.py:227 `prefill_rwkv`: run the prompt from a zero state,
        write each layer's state, tm and cm (cast to the cache's dtype)
        into `cache`; return the last position's logits (B, vocab_padded)
        f32."""
        TP = L.tp_ops()
        with TP.stream(tokens.shape[1]):
            x = L.embed_lookup(self.embed, tokens, self.vocab)
            for i, blk in enumerate(self.layers):
                x, state = blk.step(x)
                self._write(cache, i, state)
            x = TP.last(self.ln_f(x))
        cache["pos"] = tokens.shape[1]
        return L.serve_logits(x, self.unembed, self.vocab), cache

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, cache: Cache,
               groups: int = 1) -> Tuple[torch.Tensor, Cache]:
        """rwkv6.py:246 `decode_rwkv`: one step, tokens (B,) int; tm and
        cm enter in x's dtype. Returns (logits (B, vocab_padded) f32,
        cache)."""
        x = L.embed_lookup(self.embed, tokens, self.vocab)[:, None, :]
        for i, blk in enumerate(self.layers):
            x, state = blk.step(x, cache["s"][i], cache["tm"][i].to(x.dtype),
                                cache["cm"][i].to(x.dtype))
            self._write(cache, i, state)
        cache["pos"] += 1
        return L.serve_logits(self.ln_f(x)[:, 0], self.unembed,
                              self.vocab), cache

    @staticmethod
    def _write(cache: Cache, i: int, state: State) -> None:
        for key, t in zip(("s", "tm", "cm"), state):
            cache[key][i].copy_(t)


def init_cache_rwkv(cfg: ArchConfig, batch: int, max_seq: int,
                    dtype: torch.dtype = torch.bfloat16,
                    device=None) -> Cache:
    """rwkv6.py:215: zeros; s in f32 whatever `dtype` is. The state does
    not grow with the sequence, so `max_seq` sizes nothing."""
    d, dh, Lb = cfg.d_model, cfg.rwkv_head_dim, cfg.n_layers
    device = resolve_device(device)
    return {"s": torch.zeros((Lb, batch, d // dh, dh, dh),
                             dtype=torch.float32, device=device),
            "tm": torch.zeros((Lb, batch, d), dtype=dtype, device=device),
            "cm": torch.zeros((Lb, batch, d), dtype=dtype, device=device),
            "pos": 0}
