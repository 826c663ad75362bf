"""Transformer building blocks of the decoder-only LMs (PyTorch modules).

The port of repro/models/layers.py, function for function:

- `rms_norm` / `RMSNorm`: the variance in f32, the scale cast to the
  input dtype BEFORE the multiply (layers.py:31), so no f32 copy of the
  residual stream is formed and the bf16 bits follow JAX's order;
- `rope_freqs` / `apply_rope`: split halves (not interleaved), angles in
  f32, the result cast back to the input dtype;
- `sdpa` (layers.py:99 `_sdpa`): GQA grouping (B, S, Hkv, q_per_kv, hd),
  scores in the input dtype then cast to f32, masked with -1e30, the
  probabilities cast to v's dtype. Plain einsums, not torch's
  scaled_dot_product_attention, which would bring a library kernel's
  arithmetic in place of the reference's;
- `Attention`: the full-sequence form (forward), the prefill form that
  also fills one layer of the KV cache, and the one-token decode against
  a full or ring (sliding-window) cache;
- `act`, `DenseMLP` (swiglu / geglu / relu2 / gelu; gelu is the tanh
  approximation, jax.nn.gelu's default) and `MoE`, the grouped capacity
  routing of layers.py:213;
- `Block`: the pre-norm attention + MLP block;
- `remat`: a block run under activation checkpointing when cfg.remat is
  set and autograd records (JAX's `jax.checkpoint` of its scan body),
  and on its parameters gathered at their use inside the sharded step's
  sharding.gather_at_use; `remat_units`, the blocks a model runs
  through it.

Weight layout: every projection keeps the JAX package's (in, out) layout
and computes x @ W as JAX does; the MoE experts are (E, d, f) and
(E, f, d) parameters and the router an f32 (d, E) one. So
`repro_torch.models.convert.lm_from_jax` carries JAX's arrays across
without a transpose. The norms' weights are f32, the projections in
cfg.param_dtype. Initialisation draws N(0, 1) * scale_dim**-0.5 in f32
and casts to the parameter's dtype (layers.py:26 `_dense_init`), a chunk
of rows at a time so that no f32 copy of a whole weight exists.

The KV cache is written in place (JAX returns a new cache): one layer's
(B, T, Hkv, hd) view of the model's stacked cache. JAX's `maybe_shard`
calls (activation layout hints that change no value) are left out: the
port's `distributed.sharding.maybe_shard` returns its input. Where JAX's
seq_shard_acts makes them cut the sequence (sharding.activation_sharding
with seq_axis "model"), the models enter tensor_parallel's `stream`
region, and the modules here reach the stream only through its
`block_in` / `block_out` (and the stream norms, `RMSNorm(stream=True)`),
which gather S at a module's entry and reduce-scatter it at its exit.

Tensor-parallel compute: inside distributed/tensor_parallel.py's context,
the full-sequence forward of `Attention`, `DenseMLP` and `MoE` (and
`kv_group`, which whisper's cross-attention shares), and the models'
`embed_lookup` and `logits`, compute with the model-axis shard
of their weights where the sharded train step gave them one (a weight
narrower than the config's width); the module docstring there says how
each splits. Serving computes tensor-parallel in that context on a model
that tensor_parallel.shard_for_serving cut: `Attention.forward` (whisper's
encoder), `prefill` and `decode` on the rank's query heads
(`serve_heads`, held, not gathered), the KV heads they read in the
rank's cache, wo row-parallel and summed over the model axis;
`DenseMLP`, `MoE` and `embed_lookup` as in training; `serve_logits`
all-gathers the vocab chunks. Every call outside that
context runs on whole weights as above.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ArchConfig

_INIT_CHUNK = 1 << 26          # f32 elements drawn at once (256 MB)


def tp_ops():
    """distributed/tensor_parallel.py, imported on first use (the
    distributed package imports the models)."""
    from repro_torch.distributed import tensor_parallel
    return tensor_parallel


def sharding_ops():
    """distributed/sharding.py, imported on first use (as tp_ops)."""
    from repro_torch.distributed import sharding
    return sharding


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """table[tokens]; the vocab-parallel lookup (tensor_parallel's
    `embedding`) where the sharded step gave the table a vocab chunk.
    Where the stream is cut (tensor_parallel's `stream`), this rank's
    rows of it."""
    axis = tp_ops().active()
    if axis is not None and table.shape[0] != vocab:
        return tp_ops().embedding(table, tokens, axis)
    return tp_ops().cut(table[tokens])


def logits(x: torch.Tensor, unembed: torch.Tensor, vocab: int
           ) -> torch.Tensor:
    """(x @ unembed) in f32; this rank's vocab chunk of them where the
    sharded step gave the unembedding one (x's gradient summed over the
    model axis). Where the stream is cut, x (b, S / tp, d) is gathered
    over S first (tensor_parallel's block_in), so the logits cover every
    position."""
    axis = tp_ops().active()
    x = tp_ops().block_in(x, axis is not None and unembed.shape[1] != vocab)
    return (x @ unembed).float()


def serve_logits(x: torch.Tensor, unembed: torch.Tensor, vocab: int
                 ) -> torch.Tensor:
    """logits(x) over the whole padded vocabulary: where the unembedding
    holds a vocab chunk (tensor-parallel serving), the ranks' chunks
    all-gathered over the model axis, so that every rank holds the same
    logits and takes the same greedy token."""
    out = logits(x, unembed, vocab)
    axis = tp_ops().active()
    if axis is not None and unembed.shape[1] != vocab:
        out = axis.all_gather_cat(out, -1)
    return out


def dtype_of(name: str) -> torch.dtype:
    """torch dtype of a config's dtype name ("bfloat16", "float32")."""
    return getattr(torch, name)


@torch.no_grad()
def dense_init_(w: torch.Tensor, generator: torch.Generator,
                scale_dim: Optional[int] = None) -> torch.Tensor:
    """Fill w with N(0, 1) * (scale_dim or w.shape[0])**-0.5, drawn in f32
    and cast to w's dtype, `_INIT_CHUNK` elements of rows at a time."""
    scale = (scale_dim or w.shape[0]) ** -0.5
    rows = w.view(-1, w.shape[-1])
    step = max(1, _INIT_CHUNK // w.shape[-1])
    for a in range(0, rows.shape[0], step):
        part = rows[a:a + step]
        part.copy_(torch.randn(part.shape, generator=generator,
                               device=w.device,
                               dtype=torch.float32).mul_(scale))
    return w


def empty_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def remat_units(model: nn.Module) -> dict:
    """{prefix: module} of the units a model runs through `remat`, one a
    layer: the entries of its nn.ModuleLists (`layers`; whisper's
    `enc_layers` and `dec_layers`)."""
    return {f"{name}.{i}": blk for name, child in model.named_children()
            if isinstance(child, nn.ModuleList)
            for i, blk in enumerate(child)}


def remat(cfg: ArchConfig, fn, *args, **kwargs):
    """fn(*args, **kwargs), under torch.utils.checkpoint when cfg.remat is
    set and autograd is recording: only the inputs are kept and the
    backward recomputes the rest, as JAX's jax.checkpoint of a scan body
    does. The recompute runs the same operations, so no number changes;
    serving (no_grad) runs fn as it is. Inside a cut stream region
    (tensor_parallel's `stream`) the recompute re-enters it.

    Inside the sharded step's gather at each use (sharding.gather_at_use)
    the unit, fn itself or the first module among its arguments, runs on
    its parameters gathered from their shards (sharding.call_gathered),
    the gather inside the checkpointed function: the backward's recompute
    replays it, as JAX's jax.checkpoint of the scan body does, and the
    gathered copies live while the unit runs. Without remat autograd
    keeps the gathered weights that the unit's products save until the
    backward has passed them."""
    shd = sharding_ops()
    if shd.at_use() is not None:
        unit = fn if isinstance(fn, nn.Module) else next(
            a for a in args if isinstance(a, nn.Module))
        fn, args, kwargs = shd.call_gathered, (unit, fn, args, kwargs), {}
    if cfg.remat and torch.is_grad_enabled():
        axis = tp_ops().stream_axis()
        if axis is not None:
            kwargs["context_fn"] = lambda: (contextlib.nullcontext(),
                                            tp_ops().stream_as(axis))
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return fn(*args, **kwargs)


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    scale = (torch.rsqrt(var + eps) * w).to(x.dtype)
    return x * scale


class RMSNorm(nn.Module):
    """rms_norm with an f32 weight of ones (layers.py:22 `_norm_init`).
    `stream`: the norm reads the residual stream, so where the stream is
    cut (tensor_parallel's `stream`) it runs on this rank's positions and
    its weight's gradient is summed over the model axis."""

    def __init__(self, d: int, device=None, eps: float = 1e-6,
                 stream: bool = False):
        super().__init__()
        self.eps = eps
        self.stream = stream
        self.weight = empty_param((d,), torch.float32, device)

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor, axis=None,
                span: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """rms_norm; with a model `axis`, x holds this rank's channels
        [a, b) = span of the norm's width: the f32 sum of squares summed
        over the axis (both ways), the weight cut to the span (its
        gradient summed over the axis)."""
        if axis is None:
            seq = tp_ops().stream_axis() if self.stream else None
            w = self.weight if seq is None else \
                tp_ops().copy_to_model(self.weight, seq)
            return rms_norm(x, w, self.eps)
        TP, (a, b) = tp_ops(), span
        xf = x.float()
        var = TP.sum_over_model((xf * xf).sum(-1, keepdim=True),
                                axis) / self.weight.shape[0]
        w = TP.copy_to_model(self.weight, axis)[a:b]
        return x * (torch.rsqrt(var + self.eps) * w).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd), positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (hd/2,)
    angles = positions[..., None].float() * freqs             # (..., S, hd/2)
    angles = angles[..., None, :]                             # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention (full / sliding window): forward, prefill and decode paths
# ---------------------------------------------------------------------------

def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor, q_per_kv: int,
         scores_f32: bool = True) -> torch.Tensor:
    """q: (B,S,Hq,hd), k/v: (B,T,Hkv,hd), mask: (B|1, 1, S, T) bool."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, q_per_kv, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k) / (hd ** 0.5)
    if scores_f32:
        scores = scores.float()
    neg = -1e30 if scores_f32 else -3e38
    scores = scores.masked_fill(~mask[:, :, None], neg)    # (B,Hkv,g,S,T)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, Hq * hd)


def causal_mask(S: int, window: int = 0, device=None) -> torch.Tensor:
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    m = j <= i
    if window:
        m &= (i - j) < window
    return m[None, None]   # (1,1,S,S)


def _mask(S: int, window: int, causal: bool, device) -> torch.Tensor:
    if causal:
        return causal_mask(S, window, device)
    return torch.ones((1, 1, S, S), dtype=torch.bool, device=device)


def kv_group(k: torch.Tensor, v: torch.Tensor, heads: Tuple[int, int],
             kvs: Tuple[int, int], g: int):
    """(k, v, group) for sdpa over a rank's query heads [h0, h1) whose KV
    heads [k0, k1) are k and v's: the group size where the heads fall in
    whole GQA groups (or all read one KV head), else k and v repeated to
    one KV head a query head."""
    (h0, h1), (k0, k1) = heads, kvs
    if h0 == h1:                        # no head: zeros reach the sum
        return k, v, 1
    if k1 - k0 == 1:                    # every head reads one KV head
        return k, v, h1 - h0
    if h0 % g == 0 and h1 % g == 0:     # whole GQA groups
        return k, v, g
    idx = torch.tensor([h // g - k0 for h in range(h0, h1)],
                       device=k.device)
    return k[:, :, idx], v[:, :, idx], 1


class Attention(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.head_dim
        nq, nkv = cfg.n_heads, cfg.n_kv_heads
        self.wq = empty_param((d, nq * hd), dtype, device)
        self.wk = empty_param((d, nkv * hd), dtype, device)
        self.wv = empty_param((d, nkv * hd), dtype, device)
        self.wo = empty_param((nq * hd, d), dtype, device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, device)
            self.k_norm = RMSNorm(hd, device)
        # ((h0, h1), (k0, k1)): the query heads and the KV heads this rank
        # holds, set by tensor_parallel.shard_for_serving; None when whole.
        self.serve_heads = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, generator)
        if self.cfg.qk_norm:
            self.q_norm.reset_parameters()
            self.k_norm.reset_parameters()

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        B, S = x.shape[:2]
        hd = cfg.head_dim
        # The heads the weights hold: all, or a rank's serving heads.
        q = (x @ self.wq).reshape(B, S, self.wq.shape[1] // hd, hd)
        k = (x @ self.wk).reshape(B, S, self.wk.shape[1] // hd, hd)
        v = (x @ self.wv).reshape(B, S, self.wv.shape[1] // hd, hd)
        if cfg.qk_norm:
            q = self.q_norm(q)
            k = self.k_norm(k)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def forward(self, x: torch.Tensor, window: int = 0, causal: bool = True,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """layers.py:120 `apply_attention`. Entered and left through
        tensor_parallel's block_in / block_out: where the stream is cut,
        x holds this rank's positions and the attention runs on all S."""
        axis = tp_ops().active()
        if self.serve_heads is None and axis is not None and \
                self.wq.shape[1] != self.cfg.n_heads * self.cfg.head_dim:
            return self._forward_tp(x, positions, window, causal, axis)
        held = self.serve_heads is not None
        x = tp_ops().block_in(x, held)
        S = x.shape[1]
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        q, k, v = self.qkv(x, positions)
        mask = _mask(S, window, causal, x.device)
        return tp_ops().block_out(
            self._attend(q, k, v, mask, self.cfg.attn_scores_f32), held)

    def _forward_tp(self, x, positions, window, causal, axis) -> torch.Tensor:
        """forward on this rank's query heads (tensor_parallel's split) and
        the KV heads they read; the sum over the model axis after wo. A
        rank with no head runs the same operations on empty heads: it
        makes every collective the others make and adds zeros."""
        cfg, TP = self.cfg, tp_ops()
        hd, g = cfg.head_dim, cfg.q_per_kv
        spans = TP.attention_spans(cfg, axis.size)
        wq, wk, wv, wo = (TP.take(getattr(self, n), 1 if n != "wo" else 0,
                                  spans[n], axis)
                          for n in ("wq", "wk", "wv", "wo"))
        h0, h1 = TP.head_span(cfg.n_heads, axis.size, axis.index)
        k0, k1 = TP.kv_span(cfg.n_heads, g, axis.size, axis.index)
        x = TP.block_in(x)
        B, S = x.shape[:2]
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        q = (x @ wq).reshape(B, S, h1 - h0, hd)
        k = (x @ wk).reshape(B, S, k1 - k0, hd)
        v = (x @ wv).reshape(B, S, k1 - k0, hd)
        if cfg.qk_norm:
            q = rms_norm(q, TP.copy_to_model(self.q_norm.weight, axis),
                         self.q_norm.eps)
            k = rms_norm(k, TP.copy_to_model(self.k_norm.weight, axis),
                         self.k_norm.eps)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        mask = _mask(S, window, causal, x.device)
        k, v, group = kv_group(k, v, (h0, h1), (k0, k1), g)
        out = sdpa(q, k, v, mask, group, cfg.attn_scores_f32)
        return TP.block_out(out @ wo)

    def _attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: torch.Tensor, scores_f32: bool = True) -> torch.Tensor:
        """sdpa and wo for forward, prefill and decode, before the sum over
        the model axis (the callers' block_out). On a rank's serving heads
        (shard_for_serving): kv_group's grouping of the rank's heads and KV
        heads and wo's rows of those heads (zeros from a rank with no
        head, which makes the same collectives)."""
        if self.serve_heads is None:
            return sdpa(q, k, v, mask, self.cfg.q_per_kv, scores_f32) \
                @ self.wo
        heads, kvs = self.serve_heads
        k, v, group = kv_group(k, v, heads, kvs, self.cfg.q_per_kv)
        return sdpa(q, k, v, mask, group, scores_f32) @ self.wo

    def prefill(self, x: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, window: int = 0) -> torch.Tensor:
        """The causal prompt pass of lm.py:91-109: returns the attention
        output and writes this layer's cache (B, T, Hkv, hd) in place with
        the last T positions, position p at slot p % T (the ring layout
        decode continues), zeros past S. On a rank's serving heads the
        cache holds the rank's KV heads (B, T, k1 - k0, hd). Where the
        stream is cut, x and the output hold this rank's positions and
        the cache every position (block_in / block_out)."""
        held = self.serve_heads is not None
        x = tp_ops().block_in(x, held)
        B, S = x.shape[:2]
        T = k_cache.shape[1]
        q, k, v = self.qkv(x, torch.arange(S, device=x.device)[None, :])
        out = self._attend(q, k, v, causal_mask(S, window, x.device))
        if window and S > T:
            k_cache.copy_(torch.roll(k[:, -T:], S % T, dims=1))
            v_cache.copy_(torch.roll(v[:, -T:], S % T, dims=1))
        elif S > T:
            raise ValueError(f"a prompt of {S} tokens does not fit a "
                             f"full-attention cache of {T} positions")
        else:
            k_cache[:, :S] = k
            v_cache[:, :S] = v
            k_cache[:, S:] = 0
            v_cache[:, S:] = 0
        return tp_ops().block_out(out, held)

    def decode(self, x: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, pos: int,
               window: int = 0) -> torch.Tensor:
        """One-token decode (layers.py:139). x: (B,1,d); caches (B,T,Hkv,hd),
        written in place; pos: the token's absolute position.

        Full attention: T = max_seq, write at slot pos, attend to slots
        <= pos. Sliding window: T is a ring, write at pos % T, attend to
        the slots written so far (every slot once pos >= T). Decode attends
        over all T slots, masked, with the cache cast to v's dtype. On a
        rank's serving heads the cache holds the rank's KV heads.
        """
        B = x.shape[0]
        T = k_cache.shape[1]
        q, k, v = self.qkv(x, torch.full((1, 1), pos, device=x.device))
        slot = pos % T if window else pos
        if slot >= T:
            raise ValueError(f"position {pos} is past the full-attention "
                             f"cache of {T} positions")
        k_cache[:, slot] = k[:, 0]
        v_cache[:, slot] = v[:, 0]
        idx = torch.arange(T, device=x.device)
        # JAX also ands in (slot - idx) % T < T, which always holds.
        mask = ((idx <= slot) | (pos >= T)) if window else idx <= pos
        mask = mask[None, None, None, :].expand(B, 1, 1, T)
        return tp_ops().block_out(
            self._attend(q, k_cache.to(v.dtype), v_cache.to(v.dtype), mask),
            self.serve_heads is not None)


# ---------------------------------------------------------------------------
# MLPs: SwiGLU / GeGLU / squared-ReLU / GELU, dense and MoE
# ---------------------------------------------------------------------------

def gated(cfg: ArchConfig) -> bool:
    return cfg.activation in ("swiglu", "geglu")


def act(cfg: ArchConfig, a: torch.Tensor,
        b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """layers.py:196 `_act`; jax.nn.gelu is the tanh approximation."""
    if cfg.activation == "swiglu":
        return F.silu(a) * b
    if cfg.activation == "geglu":
        return F.gelu(a, approximate="tanh") * b
    if cfg.activation == "relu2":
        r = F.relu(a)
        return r * r
    return F.gelu(a, approximate="tanh")


class DenseMLP(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.d_model, cfg.d_ff
        self.w1 = empty_param((d, f), dtype, device)
        self.w2 = empty_param((f, d), dtype, device)
        if gated(cfg):
            self.w3 = empty_param((d, f), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("w1", "w2", "w3"):
            if hasattr(self, name):
                dense_init_(getattr(self, name), generator)

    def forward(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        axis = tp_ops().active()
        tp = axis is not None and self.w1.shape[1] != self.cfg.d_ff
        x = tp_ops().block_in(x, tp)        # w1 / w3 by columns, w2 by rows
        b = x @ self.w3 if gated(self.cfg) else None
        y = act(self.cfg, x @ self.w1, b) @ self.w2
        return tp_ops().block_out(y, tp)


class MoE(nn.Module):
    """Grouped capacity-based top-k MoE (layers.py:213 `apply_moe`).

    Tokens split into `groups` routing groups; per group and expert the
    top-C tokens by gate weight are gathered, run through the expert and
    scattered back weighted, C = max(1, int(top_k * Tg * capacity_factor
    / E)). Tokens past capacity get no MLP output. Slots whose gate is 0
    (an expert with fewer than C routed tokens) contribute 0; which token
    fills them differs between torch.topk and jax.lax.top_k on ties.
    """

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.cfg = cfg
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = empty_param((d, E), torch.float32, device)
        self.w1 = empty_param((E, d, f), dtype, device)
        self.w2 = empty_param((E, f, d), dtype, device)
        if gated(cfg):
            self.w3 = empty_param((E, d, f), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, f = self.cfg.d_model, self.cfg.d_ff
        dense_init_(self.w1, generator, scale_dim=d)
        dense_init_(self.w2, generator, scale_dim=f)
        if gated(self.cfg):
            dense_init_(self.w3, generator, scale_dim=d)
        dense_init_(self.router, generator)

    def route(self, xg: torch.Tensor, capacity_factor: float = 1.25,
              router: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """xg: (G, Tg, d) -> (sel_vals, sel_idx), each (G, E, C): per
        expert its C tokens of highest gate and their gates. `router`:
        the router weight as the caller computes with it (self.router by
        default)."""
        G, Tg, _ = xg.shape
        E, topk = self.cfg.n_experts, self.cfg.top_k
        router = self.router if router is None else router
        # Router matmul in the activation dtype, then upcast (as JAX).
        logits = (xg @ router.to(xg.dtype)).float()
        probs = torch.softmax(logits, dim=-1)
        top_vals, top_idx = torch.topk(probs, topk, dim=-1)     # (G,Tg,topk)
        top_vals = top_vals / top_vals.sum(-1, keepdim=True)
        gate = torch.zeros((G, Tg, E), dtype=torch.float32, device=xg.device)
        gate.scatter_(-1, top_idx, top_vals)                     # (G,Tg,E)
        C = max(1, int(topk * Tg * capacity_factor / E))
        return torch.topk(gate.transpose(1, 2), C, dim=-1)      # (G,E,C)

    def forward(self, x: torch.Tensor, groups: int = 1,
                capacity_factor: float = 1.25) -> torch.Tensor:
        # Tensor-parallel: the expert ffn dim over the model axis (JAX's
        # moe_gecf pin), the routing replicated. With the stream whole,
        # the partial sums are reduced before the gates weigh them (the
        # router's gradient sees whole expert outputs). With it cut, the
        # routing groups see every position (block_in gathers S), the
        # gated partial sums are combined into tokens and reduce-scattered
        # over S after the combine (block_out; the combine is linear), and
        # the router's gradient, a partial sum then, is summed.
        axis, seq = tp_ops().active(), tp_ops().stream_axis()
        tp = axis is not None and self.w1.shape[2] != self.cfg.d_ff
        router = self.router
        if seq is not None:
            x = tp_ops().block_in(x, tp)
            if tp:
                router = tp_ops().copy_to_model(router, axis)
        B, S, d = x.shape
        T = B * S
        G = min(groups, T)
        Tg = T // G
        xg = x.reshape(G, Tg, d)
        sel_vals, sel_idx = self.route(xg, capacity_factor, router)
        E, C = sel_idx.shape[1:]
        whole = tp and seq is None
        xs = tp_ops().copy_to_model(xg, axis) if whole else xg
        xe = xs[torch.arange(G, device=x.device)[:, None, None], sel_idx]
        a = torch.einsum("gecd,edf->gecf", xe, self.w1)
        b = (torch.einsum("gecd,edf->gecf", xe, self.w3)
             if gated(self.cfg) else None)
        y = torch.einsum("gecf,efd->gecd", act(self.cfg, a, b), self.w2)
        if whole:
            y = tp_ops().reduce_from_model(y, axis)
        y = y * sel_vals[..., None].to(y.dtype)
        # Scatter-add back to token order, in y's dtype (as JAX's .at[].add).
        out = torch.zeros((G, Tg, d), dtype=y.dtype, device=x.device)
        out.scatter_add_(1, sel_idx.reshape(G, E * C, 1).expand(G, E * C, d),
                         y.reshape(G, E * C, d))
        out = out.reshape(B, S, d)
        return out if seq is None else tp_ops().block_out(out, tp)


# ---------------------------------------------------------------------------
# Pre-norm transformer block (attention + MLP)
# ---------------------------------------------------------------------------

class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device, stream=True)
        self.attn = Attention(cfg, dtype, device)
        self.ln2 = RMSNorm(cfg.d_model, device, stream=True)
        self.mlp = (MoE if cfg.n_experts else DenseMLP)(cfg, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.ln1.reset_parameters()
        self.attn.reset_parameters(generator)
        self.ln2.reset_parameters()
        self.mlp.reset_parameters(generator)

    def forward(self, x: torch.Tensor, groups: int = 1, window: int = 0,
                causal: bool = True,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), window, causal, positions)
        return x + self.mlp(self.ln2(x), groups)

    def prefill(self, x: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, groups: int = 1,
                window: int = 0) -> torch.Tensor:
        x = x + self.attn.prefill(self.ln1(x), k_cache, v_cache, window)
        return x + self.mlp(self.ln2(x), groups)

    def decode(self, x: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, pos: int, groups: int = 1,
               window: int = 0) -> torch.Tensor:
        x = x + self.attn.decode(self.ln1(x), k_cache, v_cache, pos, window)
        return x + self.mlp(self.ln2(x), groups)
