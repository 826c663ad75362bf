"""Tensor-parallel compute over a mesh's model axis: what GSPMD derives on
JAX's side from the sharding rules (distributed/sharding.py) when it
partitions the train step's contractions, written out for eager PyTorch.
It has no JAX counterpart file.

The sharded train step (train/steps.py) gathers each parameter over the
data axes only, to `compute_specs` (JAX's TP-only spec, param_pspecs(...,
use_fsdp=False), for the leaves of a module that computes with its shard;
replicated for the rest), and runs the forward and backward inside
`tensor_parallel(axis)`. Inside it the modules of models/layers.py,
models/lm.py and models/rglru.py read `active()` and compute with their
model-axis shards:

- `Attention` by whole query heads: rank r of tp takes heads [ceil(r H /
  tp), ceil((r + 1) H / tp)) (rank 0 the most; each head once, so the sum
  after wo counts every head once), the KV heads those read, and the
  matching wo rows. Where a rank's heads are not its stored chunk of wq
  (H % tp != 0, phi4-mini's 24 heads at tp 16 are 1.5 a chunk) or of
  wk / wv (fewer KV heads than ranks), the weight is gathered over the
  model axis for the layer only and cut to the rank's columns (`take`).
  With fewer heads than ranks (recurrentgemma-2b's 10 at tp 16) some
  ranks hold no head: their spans are empty, they add zeros to the sum
  after wo and make every collective the others make;
- `DenseMLP`: w1 / w3 column-parallel, w2 row-parallel;
- `MoE`: JAX's moe_gecf pin, the expert ffn dim over the model axis; the
  router and the routing replicated (the same on every rank), the sum
  over the model axis before the gates weigh the expert outputs;
- `RGLRUBlock` (models/rglru.py): w_in, w_gate and conv_w by channels;
  w_a / w_x by output channels on the whole conv output (all-gathered),
  lam replicated and cut to the rank's channels, the scan on those
  channels, w_out row-parallel;
- `RWKVBlock` (models/rwkv6.py), two units. The time mix by whole heads
  (`head_span` over d / rwkv_head_dim heads, `take` where they are not
  the rank's chunk): wr / wk / wv / wg column-parallel, wo row-parallel;
  the decay LoRA's tanh(xw @ wa) on the rank's wa columns all-gathered,
  (b, S, 64), and multiplied by wb's columns for the rank's channels (wb
  gathered whole, 64 x d); the mu_* vectors, w0, u and ln_x's scale
  replicated and cut to the rank's channels; ln_x's sum of squares over
  the whole width summed over the axis; the scan on the rank's heads.
  The channel mix: ck column-parallel over d_ff, cv row-parallel, its
  partial sums reduce-scattered to the rank's chunk of d, there
  multiplied by the sigmoid of cr's columns (column-parallel over d),
  and the product all-gathered into the residual stream;
- whisper's `CrossAttention` (models/whisper.py) as `Attention`: the
  rank's query heads, the KV heads they read computed from the encoder
  output, wo row-parallel;
- `LM`, `RG`, `RWKV` and `Whisper`: the vocab-parallel embedding lookup
  (`embedding`) and the vocab-sharded f32 logits, which go to the
  vocab-parallel loss (`cross_entropy`).

A module computes with its shard only when every weight it cuts is
sharded under the TP-only spec (JAX's divisibility guard may leave a dim
replicated); otherwise it computes replicated, on whole weights, as off
the model axis.

Collectives (each rank calls them in the same order; every one goes
through torch.distributed's c10d ops, which launch/op_analysis.py counts):
`copy_to_model` is identity forward and an all-reduce of the gradient
backward (before a column-parallel input, and on a replicated weight used
on a rank's part of the channels: the qk norms, lam, mu_*);
`reduce_from_model` an all-reduce forward and identity backward (after a
row-parallel output; torch.distributed.nn.functional.all_reduce would
all-reduce the gradient too); `sum_over_model` an all-reduce both ways
(a statistic that every rank reads whole: ln_x's sum of squares);
`gather_from_model` an all-gather forward and a reduce-scatter backward
(right where the gathered tensor feeds a column-parallel product, so
each rank's gradient is a partial sum); `scatter_from_model` a
reduce-scatter forward and an all-gather backward; `gather_to_stream` an
all-gather forward whose backward is this rank's chunk of the gradient
(the gathered tensor joins the replicated residual stream, whose
gradient every rank holds whole). Outside the context every module runs
as it did.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (P, _reduce_scatter,
                                              local_shape, param_pspecs)
from repro_torch.launch.mesh import MeshAxis, mesh_axis_sizes, tp_axis

# The model axis while tensor-parallel compute is on. A process global, not
# a thread-local: remat's recompute and the backward run on the autograd
# engine's threads.
_AXIS: Optional[MeshAxis] = None


def active() -> Optional[MeshAxis]:
    """The model axis inside `tensor_parallel`, else None."""
    return _AXIS


@contextlib.contextmanager
def tensor_parallel(axis: Optional[MeshAxis]):
    """Turn tensor-parallel compute on over `axis` (a no-op for None or an
    axis of size 1)."""
    global _AXIS
    prev = _AXIS
    _AXIS = axis if axis is not None and axis.size > 1 else None
    try:
        yield
    finally:
        _AXIS = prev


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=axis.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverModel(_ReduceFromModel):
    backward = staticmethod(_CopyToModel.backward)


def _scatter(x: torch.Tensor, dim: int, axis: MeshAxis) -> torch.Tensor:
    """x summed over the axis and cut to this rank's chunk along dim."""
    front = x.movedim(dim, 0).contiguous()
    out = torch.empty((front.shape[0] // axis.size,) + front.shape[1:],
                      dtype=x.dtype, device=x.device)
    _reduce_scatter(out, front, group=axis.group)
    return out.movedim(0, dim).contiguous()


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return axis.all_gather_cat(w, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.axis), None, None


class _ScatterFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _scatter(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_gather_cat(g, ctx.dim), None, None


class _GatherToStream(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis, ctx.n = dim, axis, x.shape[dim]
        return axis.all_gather_cat(x, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n), None, None


def copy_to_model(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """x forward; its gradient summed over the model axis backward."""
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """x summed over the model axis forward; the gradient as it is
    backward (it is the same on every rank)."""
    return _ReduceFromModel.apply(x, axis)


def gather_from_model(w: torch.Tensor, dim: int,
                      axis: MeshAxis) -> torch.Tensor:
    """The ranks' chunks of w concatenated along dim; backward, the
    gradient's sum over the axis cut to this rank's chunk."""
    return _GatherFromModel.apply(w, dim, axis)


def sum_over_model(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """x summed over the model axis forward, and its gradient summed
    backward (each rank's loss reads the whole sum)."""
    return _SumOverModel.apply(x, axis)


def scatter_from_model(x: torch.Tensor, dim: int,
                       axis: MeshAxis) -> torch.Tensor:
    """The ranks' partial sums x summed and cut to this rank's chunk along
    dim; backward, the ranks' gradient chunks concatenated."""
    return _ScatterFromModel.apply(x, dim, axis)


def gather_to_stream(x: torch.Tensor, dim: int,
                     axis: MeshAxis) -> torch.Tensor:
    """The ranks' chunks of x concatenated along dim, for a replicated
    consumer; backward, this rank's chunk of the gradient, which every
    rank holds whole."""
    return _GatherToStream.apply(x, dim, axis)


Span = Tuple[int, int]


def take(w: torch.Tensor, dim: int, spans: Callable[[int], Span],
         axis: MeshAxis) -> torch.Tensor:
    """[a, b) along `dim` of the whole weight whose even chunk along dim
    this rank holds as `w`, with spans(r) = (a, b) rank r's range: `w`
    itself where every rank's range is its own chunk (no collective),
    else the weight gathered over the model axis and cut to the range, a
    copy, so the gathered weight does not outlive the call."""
    if not needs_gather(w.shape[dim], spans, axis.size):
        return w
    a, b = spans(axis.index)
    whole = gather_from_model(w, dim, axis)
    return whole.narrow(dim, a, b - a).clone(
        memory_format=torch.contiguous_format)


def needs_gather(chunk: int, spans: Callable[[int], Span], tp: int) -> bool:
    """Whether some rank's range is not its own chunk of `chunk` rows."""
    return any(spans(r) != (r * chunk, (r + 1) * chunk) for r in range(tp))


def head_span(n_heads: int, tp: int, r: int) -> Span:
    """Rank r's query heads: [ceil(r H / tp), ceil((r + 1) H / tp))."""
    return -(-r * n_heads // tp), -(-(r + 1) * n_heads // tp)


def kv_span(n_heads: int, q_per_kv: int, tp: int, r: int) -> Span:
    """The KV heads that rank r's query heads read (none where it holds
    no query head)."""
    h0, h1 = head_span(n_heads, tp, r)
    if h0 == h1:
        return h0 // q_per_kv, h0 // q_per_kv
    return h0 // q_per_kv, (h1 - 1) // q_per_kv + 1


def head_channels(n_heads: int, head_dim: int,
                  tp: int) -> Callable[[int], Span]:
    """spans(r): the channels [h0 hd, h1 hd) of rank r's heads."""
    def spans(r):
        h0, h1 = head_span(n_heads, tp, r)
        return h0 * head_dim, h1 * head_dim
    return spans


def attention_spans(cfg, tp: int) -> Dict[str, Callable[[int], Span]]:
    """Per attention weight, rank r's range along the dim the rules shard
    (wq / wk / wv columns, wo rows)."""
    hd, H, g = cfg.head_dim, cfg.n_heads, cfg.q_per_kv
    heads = head_channels(H, hd, tp)

    def kvs(r):
        k0, k1 = kv_span(H, g, tp, r)
        return k0 * hd, k1 * hd

    return {"wq": heads, "wk": kvs, "wv": kvs, "wo": heads}


def embedding(table: torch.Tensor, tokens: torch.Tensor,
              axis: MeshAxis) -> torch.Tensor:
    """The vocab-parallel lookup: this rank's rows of the table (its
    vocabulary chunk) looked up where the token falls in them, zeros
    elsewhere, summed over the model axis. One rank adds a non-zero, so
    the rows keep their bits."""
    n = table.shape[0]
    local = tokens.long() - axis.index * n
    inside = (local >= 0) & (local < n)
    x = table[local.clamp(0, n - 1)].masked_fill(~inside[..., None], 0)
    return reduce_from_model(x, axis)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  count: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """train/steps.py's masked mean CE on vocab-sharded f32 logits (this
    rank's chunk of the padded vocabulary): the logsumexp over the whole
    padded vocabulary from the max and the sum of exp each reduced over
    the model axis, the gold logit from the rank that holds it; every
    rank returns the same loss."""
    n = logits.shape[-1]
    mask = labels >= 0
    local = labels.long() - axis.index * n
    inside = (local >= 0) & (local < n)
    with torch.no_grad():
        top = logits.amax(-1)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=axis.group)
    sumexp = torch.exp(logits - top[..., None]).sum(-1)
    logz = top + torch.log(reduce_from_model(sumexp, axis))
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = reduce_from_model(gold.masked_fill(~inside, 0), axis)
    nll = (logz - gold) * mask
    return nll.sum() / count.clamp_min(1)


def compute_specs(model, mesh, shapes=None) -> Dict[str, P]:
    """{parameter name: the layout it is computed in}: JAX's TP-only spec
    for the weights of the modules that compute tensor-parallel (module
    docstring; every model of models/registry.py), replicated for every
    other parameter. `shapes`: the whole
    parameters' shapes when the model holds shards. Works on a
    sharding.MeshShape (no world)."""
    from repro_torch.models import layers as L
    from repro_torch.models.rglru import RGLRUBlock
    from repro_torch.models.rwkv6 import RWKVBlock
    from repro_torch.models.whisper import CrossAttention
    tp_only = param_pspecs(model, mesh, use_fsdp=False, shapes=shapes)
    out = {name: P(*(None,) * len(spec)) for name, spec in tp_only.items()}
    if mesh_axis_sizes(mesh).get(tp_axis(mesh), 1) == 1:
        return out
    whole = {name: tuple(shapes[name] if shapes is not None else p.shape)
             for name, p in model.named_parameters()}
    units = [["embed"], ["unembed"]]        # the weights a module cuts
    for prefix, mod in model.named_modules():
        if isinstance(mod, (L.Attention, CrossAttention)):
            names = [("wq", "wk", "wv", "wo")]
        elif isinstance(mod, RGLRUBlock):     # lam (1-D) stays replicated
            names = [("w_in", "w_gate", "conv_w", "w_a", "w_x", "w_out")]
        elif isinstance(mod, RWKVBlock):      # mu_*, w0, u: replicated
            names = [RWKVBlock.TIME_MIX, RWKVBlock.CHANNEL_MIX]
        elif isinstance(mod, (L.DenseMLP, L.MoE)):
            names = [tuple(n for n in ("w1", "w2", "w3") if hasattr(mod, n))]
        else:
            continue
        units += [[f"{prefix}.{n}" for n in unit] for unit in names]
    for unit in units:
        if all(tuple(local_shape(whole[n], tp_only[n], mesh)) != whole[n]
               for n in unit):
            out.update((n, tp_only[n]) for n in unit)
    return out


def compute_bytes(model, mesh, shapes=None) -> int:
    """The bytes of parameters one rank holds while it computes (each
    parameter under compute_specs)."""
    spec = compute_specs(model, mesh, shapes)
    return sum(math.prod(local_shape(
        shapes[name] if shapes is not None else p.shape, spec[name], mesh))
        * p.element_size() for name, p in model.named_parameters())
