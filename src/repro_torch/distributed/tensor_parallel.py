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

Sequence parallelism (JAX's seq_shard_acts): inside sharding.
activation_sharding with seq_axis "model", a model's forward or prefill
cuts its residual stream of S positions to each rank's S / tp (`stream`:
the model axis active and S dividing by seq_div and tp; decode's S = 1
never does). Every module enters through
`block_in` and leaves through `block_out`, the one place that chooses
between the two pairs of collectives: with the stream whole,
copy_to_model in and reduce_from_model out (a replicated module: none);
with it cut, the input all-gathered over S (gather_from_model, a
reduce-scatter backward; gather_to_stream for a replicated module) and
the partial sums reduce-scattered over S (scatter_from_model, an
all-gather backward; a replicated module's output cut to the rank's rows,
cut_to_stream). So each norm that feeds a block runs on the rank's rows,
its weight's gradient summed over the axis (layers.RMSNorm with stream);
the vocab-parallel lookup reduce-scatters; the logits gather S first;
the MoE routes every position and reduce-scatters after the combine (its
router's gradient summed); the RWKV channel mix turns its gated chunk of
d into the stream's rows by one all-to-all (`channels_to_rows`); and
prefill's last position is gathered from the ranks' last rows (`last`).
Where the stream is not cut, every site runs the collectives above and
gives the same bits.

Serving (every family) splits the same units but holds its cut:
`shard_for_serving` cuts a whole model once to what model-axis rank r
computes, and the serving step (train/steps.py make_prefill_step /
make_decode_step with mesh=) then makes no weight collective. Each
attention's and cross-attention's wq / wk / wv columns and wo's rows are
held at the rank's `attention_spans` (its query heads and the KV heads
they read: phi4-mini's 24 heads over 16 ranks leave rank 0 two heads and
one KV head), not at the even chunk that `take` gathers from each step in
training. An RWKV time mix holds its heads' channels the same way (wr /
wk / wv / wg columns, wo rows, wb's columns, w0 and u), and computes the
decay LoRA's tanh(xw @ wa) on the whole wa, with no gather. An RG-LRU
block holds its chunk of the lru channels (w_in, w_gate, conv_w, w_a,
w_x columns, w_out rows) and lam narrowed to them. The MLP, expert,
channel-mix and vocabulary weights are held at JAX's TP-only chunk, the
rest whole (replicated over the data axes too: no data-axis gather a
step). A unit that JAX's divisibility guard leaves whole is held whole
and computes replicated. The cache (`serve_cache_shape`) holds the
rank's rows and: the KV heads its self-attention reads (not JAX's T over
the model axis, so attention stays local; where there are fewer KV heads
than ranks, ranks that read the same KV head each hold it), whisper's
cross K/V at its cross-attention's KV heads, the ssm's f32 state s at
its heads and the hybrid's f32 h and conv state at its lru channels; the
ssm's shift inputs tm and cm lie on the replicated stream and are held
whole (JAX's cache_pspecs cut their width). The collectives of one
serving step: the vocab-parallel lookup's all-reduce; the all-reduce
after each attention's (whisper's encoder's too) and cross-attention's
wo, each MLP's w2 (the MoE's at its (G, E, C, d) expert outputs), each
RG-LRU block's w_out and each time mix's wo; each RG-LRU block's
all-gather of u for w_a / w_x; each time mix's f32 sum of squares for
ln_x; each channel mix's reduce-scatter after cv and all-gather into the
stream; and the all-gather of the logits' vocab chunks over the model
axis (the step then all-gathers the rows over the data axes where it
split them). A rank with no query head makes each of them.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (P, _reduce_scatter,
                                              local_shape, param_pspecs,
                                              seq_div_for)
from repro_torch.launch.mesh import (MeshAxis, dp_axes, mesh_axis,
                                     mesh_axis_sizes, tp_axis)

# The model axis while tensor-parallel compute is on. A process global, not
# a thread-local: remat's recompute and the backward run on the autograd
# engine's threads.
_AXIS: Optional[MeshAxis] = None


# The model axis the residual stream is cut over (sequence parallelism)
# inside a model's `stream` region, else None. A process global too;
# layers.remat re-enters it around its recompute.
_STREAM: Optional[MeshAxis] = None


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


def stream_axis() -> Optional[MeshAxis]:
    """The axis the residual stream is cut over in this region, else
    None."""
    return _STREAM


@contextlib.contextmanager
def stream_as(axis: Optional[MeshAxis]):
    """A region whose residual stream is cut over `axis` (None: whole)."""
    global _STREAM
    prev = _STREAM
    _STREAM = axis
    try:
        yield axis
    finally:
        _STREAM = prev


def stream(length: int):
    """The region of a model's residual stream of `length` positions: cut
    over the active model axis to each rank's length / tp positions where
    sharding.activation_sharding's seq_axis names that axis and length
    divides by its seq_div and by tp (JAX's maybe_shard guard); else
    whole (off the axis, a world of one, S % tp != 0, a decode step's
    S = 1)."""
    axis, div = _AXIS, seq_div_for("model")
    cut = (axis is not None and div is not None and length % div == 0
           and length % axis.size == 0)
    return stream_as(axis if cut else None)


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


class _CutToStream(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        n = x.shape[dim] // axis.size
        return x.narrow(dim, axis.index * n, n).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_gather_cat(g, ctx.dim), None, None


def _all_to_all(front: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """front (tp, ...): front[j] to rank j; returns what rank i sent here
    at [i]."""
    out = torch.empty_like(front)
    dist.all_to_all_single(out, front, group=axis.group)
    return out


def _rows_of(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """(b, S, c) of this rank's channels -> (b, S / tp, tp c): this rank's
    rows of every rank's channels, in rank order."""
    b, S, c = x.shape
    tp = axis.size
    front = x.reshape(b, tp, S // tp, c).permute(1, 2, 0, 3).contiguous()
    return _all_to_all(front, axis).permute(2, 1, 0, 3).reshape(
        b, S // tp, tp * c)


def _channels_of(g: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """_rows_of's inverse: (b, s, tp c) -> (b, tp s, c)."""
    b, s, C = g.shape
    tp = axis.size
    front = g.reshape(b, s, tp, C // tp).permute(2, 1, 0, 3).contiguous()
    return _all_to_all(front, axis).permute(2, 0, 1, 3).reshape(
        b, tp * s, C // tp)


class _ChannelsToRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _rows_of(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _channels_of(g, ctx.axis), None


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


def cut_to_stream(x: torch.Tensor, dim: int,
                  axis: MeshAxis) -> torch.Tensor:
    """This rank's chunk along dim of x, which every rank holds whole;
    backward, the ranks' gradient chunks concatenated (every rank's
    whole gradient)."""
    return _CutToStream.apply(x, dim, axis)


def channels_to_rows(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """(b, S, d / tp) on this rank's chunk of d -> (b, S / tp, d) on its
    chunk of S: one all-to-all each way."""
    return _ChannelsToRows.apply(x, axis)


def block_in(x: torch.Tensor, sharded: bool = True) -> torch.Tensor:
    """The input a module computes on, from the residual stream x (b, S,
    d), for a module that computes tensor-parallel (`sharded`) or
    replicated over the model axis. Off the axis, x. On it, with the
    stream whole: copy_to_model for a sharded module (each rank's
    gradient a partial sum), x for a replicated one. With the stream cut
    (`stream`): x all-gathered over S, by gather_from_model for a sharded
    module (a reduce-scatter backward) and gather_to_stream for a
    replicated one (backward, this rank's rows of the whole gradient)."""
    axis = _AXIS
    if axis is None:
        return x
    if _STREAM is not None:
        return (gather_from_model if sharded else gather_to_stream)(
            x, 1, _STREAM)
    return copy_to_model(x, axis) if sharded else x


def block_out(y: torch.Tensor, sharded: bool = True) -> torch.Tensor:
    """block_in's pair, a module's output (b, S, d) back to the stream.
    Off the axis, y. With the stream whole: reduce_from_model of a sharded
    module's partial sums, y of a replicated one. With it cut: the partial
    sums reduce-scattered over S (scatter_from_model), or a replicated
    output cut to this rank's rows (cut_to_stream: an all-gather
    backward)."""
    axis = _AXIS
    if axis is None:
        return y
    if _STREAM is not None:
        return (scatter_from_model if sharded else cut_to_stream)(
            y, 1, _STREAM)
    return reduce_from_model(y, axis) if sharded else y


def cut(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """A tensor every rank holds whole, at the stream's positions along
    dim: this rank's chunk where the stream is cut (cut_to_stream), else
    x."""
    return x if _STREAM is None else cut_to_stream(x, dim, _STREAM)


def last(x: torch.Tensor) -> torch.Tensor:
    """The stream's last position, (b, d), on every rank: x[:, -1], or
    where the stream is cut (the last position is the last rank's) the
    ranks' last rows all-gathered, (b, tp, d), and the last taken."""
    if _STREAM is None:
        return x[:, -1]
    return _STREAM.all_gather_cat(x[:, -1:], 1)[:, -1]


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
    elsewhere, summed over the model axis (reduce-scattered over S to
    this rank's rows where the stream is cut). One rank adds a
    non-zero, so the rows keep their bits."""
    n = table.shape[0]
    local = tokens.long() - axis.index * n
    inside = (local >= 0) & (local < n)
    x = table[local.clamp(0, n - 1)].masked_fill(~inside[..., None], 0)
    if _STREAM is not None:
        return scatter_from_model(x, 1, _STREAM)
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


class ServeLayout(NamedTuple):
    """How shard_for_serving cut a model: the mesh, the model-axis index
    the cut was taken at and its serve_cuts."""
    mesh: object
    index: int
    cuts: Dict[str, Tuple[int, int, int]]


def _model_size(mesh) -> int:
    return mesh_axis_sizes(mesh).get(tp_axis(mesh), 1)


def serve_cuts(model, mesh, index: int) -> Dict[str, Tuple[int, int, int]]:
    """{parameter name: (dim, a, b)}: the range [a, b) along `dim` that
    model-axis rank `index` holds for serving (module docstring); a
    parameter not named is held whole. Every family's units, as
    compute_specs names them. Works on a sharding.MeshShape (no world)."""
    from repro_torch.models import layers as L
    from repro_torch.models.rglru import RGLRUBlock
    from repro_torch.models.rwkv6 import RWKVBlock
    from repro_torch.models.whisper import CrossAttention
    cfg = model.cfg
    tp = _model_size(mesh)
    if tp == 1:
        return {}
    axis = tp_axis(mesh)
    spec = compute_specs(model, mesh)
    out = {}
    for name, p in model.named_parameters():
        dims = [d for d in range(len(spec[name]))
                if axis in spec[name].names(d)]
        if dims:
            n = p.shape[dims[0]] // tp
            out[name] = (dims[0], index * n, (index + 1) * n)
    spans = attention_spans(cfg, tp)
    for prefix, mod in model.named_modules():
        if isinstance(mod, (L.Attention, CrossAttention)) and \
                f"{prefix}.wq" in out:
            for n in ("wq", "wk", "wv", "wo"):
                out[f"{prefix}.{n}"] = (1 if n != "wo" else 0,
                                        *spans[n](index))
        elif isinstance(mod, RGLRUBlock) and f"{prefix}.w_in" in out:
            out[f"{prefix}.lam"] = (0, *out[f"{prefix}.w_in"][1:])
        elif isinstance(mod, RWKVBlock) and f"{prefix}.wr" in out:
            dh = cfg.rwkv_head_dim
            a, b = head_channels(cfg.d_model // dh, dh, tp)(index)
            for n in ("wr", "wk", "wv", "wg", "wb", "wo", "w0", "u"):
                rows = n in ("wo", "w0", "u")
                out[f"{prefix}.{n}"] = (0 if rows else 1, a, b)
            del out[f"{prefix}.wa"]         # the LoRA's tanh, whole
    return out


@torch.no_grad()
def shard_for_serving(model, mesh):
    """Cut a whole model of any family, in place, to what this rank
    computes when it serves on `mesh` (serve_cuts at its model-axis
    coordinate; each cut a copy, so the whole weight goes). Each cut
    module keeps the range it holds: an attention or cross-attention its
    heads as `serve_heads`, an RG-LRU block its lru channels as
    `serve_channels`, an RWKV block its time mix's head channels as
    `serve_heads` and its channel mix's chunk of d as `serve_chunk`. The
    model keeps the layout as `serve_layout`, which the mesh's serving
    steps check. Returns the model."""
    from repro_torch.models import layers as L
    from repro_torch.models.rglru import RGLRUBlock
    from repro_torch.models.rwkv6 import RWKVBlock
    from repro_torch.models.whisper import CrossAttention
    if getattr(model, "serve_layout", None) is not None or \
            getattr(model, "shard_layout", None) is not None:
        raise ValueError("the model is already cut (shard_for_serving or "
                         "shard_train_state)")
    tp = _model_size(mesh)
    index = mesh_axis(mesh, tp_axis(mesh)).index if tp > 1 else 0
    cuts = serve_cuts(model, mesh, index)
    for name, p in model.named_parameters():
        if name in cuts:
            dim, a, b = cuts[name]
            p.data = p.data.narrow(dim, a, b - a).clone(
                memory_format=torch.contiguous_format)
    cfg = model.cfg
    for prefix, mod in model.named_modules():
        def span(n):
            return cuts[f"{prefix}.{n}"][1:] if f"{prefix}.{n}" in cuts \
                else None
        if isinstance(mod, (L.Attention, CrossAttention)) and span("wq"):
            mod.serve_heads = (
                head_span(cfg.n_heads, tp, index),
                kv_span(cfg.n_heads, cfg.q_per_kv, tp, index))
        elif isinstance(mod, RGLRUBlock):
            mod.serve_channels = span("w_in")
        elif isinstance(mod, RWKVBlock):
            mod.serve_heads, mod.serve_chunk = span("wr"), span("cr")
    model.serve_layout = ServeLayout(mesh, index, cuts)
    return model


def serve_rows(batch: int, mesh) -> int:
    """The rows a data rank serves of a global batch: batch / dp where it
    divides by the data axes' size dp, else all of them."""
    sizes = mesh_axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in dp_axes(mesh))
    return batch // dp if batch % dp == 0 else batch


# Per cache leaf: the weight whose serving cut it follows (by the end of
# its name), the dim of the leaf that cut narrows, and whether that dim
# counts heads of shape[-1] channels (else channels). A leaf not named
# (the ssm's tm and cm, on the replicated stream) is held whole.
_CACHE_CUTS = {"k": (".attn.wk", 3, True), "v": (".attn.wk", 3, True),
               "xk": (".xattn.wk", 3, True), "xv": (".xattn.wk", 3, True),
               "s": (".wr", 2, True), "h": (".w_in", 2, False),
               "conv": (".w_in", 3, False)}


def serve_cache_shape(cuts, shape, mesh, key: str = "k") -> Tuple[int, ...]:
    """The cache leaf `key` a rank holds under its serve_cuts `cuts`, from
    the family's whole leaf (dim 1 the batch): its rows (serve_rows) and
    the part of the dim its unit's cut holds (_CACHE_CUTS: k / v the KV
    heads of its self-attention's wk columns, whisper's xk / xv those of
    its cross-attention's, the ssm's s the heads of its time mix, the
    hybrid's h and conv state its lru channels); whole where the unit is
    held whole, and none of a rank with no query head."""
    out = list(shape)
    out[1] = serve_rows(shape[1], mesh)
    if key in _CACHE_CUTS:
        suffix, dim, heads = _CACHE_CUTS[key]
        held = [c for name, c in cuts.items() if name.endswith(suffix)]
        if held:
            n = held[0][2] - held[0][1]
            out[dim] = n // shape[-1] if heads else n
    return tuple(out)


def serve_cache(model, batch: int, max_seq: int,
                dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Zeros of the cache this rank holds, on the model's device, for a
    model cut by shard_for_serving and a global batch of `batch` rows:
    every leaf of the family's cache (each in the dtype its init_cache
    gives it: the hybrid's h and the ssm's s f32) at serve_cache_shape."""
    from repro_torch.models.registry import get_api
    cfg, lay = model.cfg, model.serve_layout
    whole = get_api(cfg).init_cache(cfg, batch, max_seq, dtype, "meta")
    out = {key: torch.zeros(serve_cache_shape(lay.cuts, tuple(t.shape),
                                              lay.mesh, key),
                            dtype=t.dtype, device=model.device)
           for key, t in whole.items() if isinstance(t, torch.Tensor)}
    out["pos"] = 0
    return out
