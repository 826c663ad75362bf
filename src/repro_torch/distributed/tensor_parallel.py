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
- `LM` and `RG`: the vocab-parallel embedding lookup (`embedding`) and
  the vocab-sharded f32 logits, which go to the vocab-parallel loss
  (`cross_entropy`).

A module computes with its shard only when every weight it cuts is
sharded under the TP-only spec (JAX's divisibility guard may leave a dim
replicated); otherwise it computes replicated, on whole weights, as off
the model axis. The ssm and encdec families compute replicated.

Collectives (each rank calls them in the same order; every one goes
through torch.distributed's c10d ops, which launch/op_analysis.py counts):
`copy_to_model` is identity forward and an all-reduce of the gradient
backward (before a column-parallel input, and on a replicated weight used
on a rank's part of the heads: the qk norms); `reduce_from_model` an
all-reduce forward and identity backward (after a row-parallel output;
torch.distributed.nn.functional.all_reduce would all-reduce the gradient
too); `gather_from_model` an all-gather forward and a reduce-scatter
backward. Outside the context every module runs as it did.
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
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=axis.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return axis.all_gather_cat(w, dim)

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        front = g.movedim(ctx.dim, 0).contiguous()
        out = torch.empty((front.shape[0] // axis.size,) + front.shape[1:],
                          dtype=g.dtype, device=g.device)
        _reduce_scatter(out, front, group=axis.group)
        return out.movedim(0, ctx.dim).contiguous(), None, None


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


def attention_spans(cfg, tp: int) -> Dict[str, Callable[[int], Span]]:
    """Per attention weight, rank r's range along the dim the rules shard
    (wq / wk / wv columns, wo rows)."""
    hd, H, g = cfg.head_dim, cfg.n_heads, cfg.q_per_kv

    def heads(r):
        h0, h1 = head_span(H, tp, r)
        return h0 * hd, h1 * hd

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
    docstring), replicated for every other parameter. `shapes`: the whole
    parameters' shapes when the model holds shards. Works on a
    sharding.MeshShape (no world)."""
    from repro_torch.models import layers as L
    from repro_torch.models.lm import LM
    from repro_torch.models.rglru import RG, RGLRUBlock
    tp_only = param_pspecs(model, mesh, use_fsdp=False, shapes=shapes)
    out = {name: P(*(None,) * len(spec)) for name, spec in tp_only.items()}
    tp = mesh_axis_sizes(mesh).get(tp_axis(mesh), 1)
    if tp == 1 or not isinstance(model, (LM, RG)):
        return out
    whole = {name: tuple(shapes[name] if shapes is not None else p.shape)
             for name, p in model.named_parameters()}
    units = [["embed"], ["unembed"]]        # the weights a module cuts
    for prefix, mod in model.named_modules():
        if isinstance(mod, L.Attention):
            names = ("wq", "wk", "wv", "wo")
        elif isinstance(mod, RGLRUBlock):     # lam (1-D) stays replicated
            names = ("w_in", "w_gate", "conv_w", "w_a", "w_x", "w_out")
        elif isinstance(mod, (L.DenseMLP, L.MoE)):
            names = tuple(n for n in ("w1", "w2", "w3") if hasattr(mod, n))
        else:
            continue
        units.append([f"{prefix}.{n}" for n in names])
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
