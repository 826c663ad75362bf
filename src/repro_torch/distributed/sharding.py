"""Sharding rules: 2D (FSDP x TP) parameter placements, batch and cache
specs, and the moves of one tensor between layouts on a mesh (the port of
repro/distributed/sharding.py).

The rules are JAX's, letter for letter (`_param_rule`):
- every 2D projection W (d_in, d_out): P(fsdp, tp), the input dim over the
  data (+ pod) axes ZeRO-3 style, the output dim over "model"; the
  projections back to the residual stream (wo, w2, cv, w_out, wb) P(tp,
  fsdp);
- embeddings: vocab over "model", d_model over fsdp; the router's d over
  fsdp;
- MoE experts (E, x, y): experts replicated, the rest as a projection;
- KV caches: batch over dp, the sequence over "model"; recurrent states:
  batch over dp, width over "model";
- a dim that does not divide by its axes' sizes stays replicated.

A spec is a `PartitionSpec`: one entry per tensor dim, each an axis name,
a tuple of names or None. The rules take a `MeshShape` (names and sizes,
JAX's AbstractMesh: no world needed) or a live DeviceMesh
(launch/mesh.py). They key off JAX's leaf name and whether the leaf is
stacked over the layers, both from `models.convert.jax_leaves`; a stacked
leaf's lead None is dropped, since the port holds one tensor per layer.
`placements(spec, mesh)` turns a spec into DTensor placements.

Moving a tensor between layouts (collective over the mesh dims involved;
every rank calls them in the same order): `local_shard` cuts this rank's
chunk of a whole tensor (a view where the chunk is the whole), `gather`
rebuilds the whole tensor from the chunks (or a less sharded layout's
chunk), `reduce_shard` sums a tensor over some mesh dims into a layout's
chunk (a reduce-scatter where the layout shards the dim, an all-reduce
where it does not). A mesh dim of size 1 costs neither a collective nor
a copy.

The sharded train step (train/steps.py) stores the state under these
rules, gathers each parameter over the data axes only, to the layout it
is computed in (distributed/tensor_parallel.py's compute_specs: the
TP-only spec for every family's projections, embeddings, experts,
RG-LRU and RWKV weights, which compute tensor-parallel over "model";
replicated for the rest),
and reduces each gradient over the data axes into the moments' chunk.
By default it gathers each parameter at its use (JAX's step without a
pregather_spec, where GSPMD gathers each weight where the layer body
uses it): inside `gather_at_use`, `call_gathered` runs a unit on its
parameters all-gathered from their stored shards. A block (the unit
models/layers.py's `remat` passes it) gathers through `_GatherAtUse`, an
autograd Function whose backward hands the gathered layout's gradient to
the step's fold and none to the shard; its copies go when autograd no
longer holds them. The parameters outside the blocks are gathered once
a microbatch: the token embedding so too (its lookup keeps no copy and
its gradient comes last), the others, used after the blocks, as leaves
of their own (`_gathered_leaf`), held to the end of the microbatch's
backward, each folding its gradient as soon as autograd has it. The
shards stay in place. `compute_shape` gives a stored parameter's shape
in its computed layout, for code that reads a shape outside its unit.
Serving on a mesh (the decoder-only LMs) holds the cut of
tensor_parallel.shard_for_serving, not these rules: the rank's heads and
TP-only chunks, whole over the data axes, and a KV cache of the rank's
KV heads rather than cache_pspecs' T over "model"; the dry run still
reports these rules' bytes (rules_mb).

`activation_sharding(dp, seq_axis, seq_div, tp)` keeps JAX's signature
and is the switch of sequence parallelism (JAX's seq_shard_acts): its
one reader, `seq_div_for(axis)`, gives seq_div inside it where seq_axis
names `axis`, and distributed/tensor_parallel.py's `stream` holds the
whole guard (JAX's maybe_shard: the stream's length divides by seq_div)
and cuts the residual stream to each model rank's length / tp positions
while tensor-parallel compute is on over a model axis > 1. The state is a
process global, as tensor_parallel's axis is: a thread-local would be
lost on the autograd threads that run remat's recompute and the
backward, and so is `gather_at_use`'s. `maybe_shard` returns its input:
JAX's constraint changes no value, and eager PyTorch has no propagation
for it to steer; the port's modules place their collectives themselves.
"""
from __future__ import annotations

import contextlib
import math
from typing import (Callable, Collection, Dict, Mapping, NamedTuple,
                    Optional, Tuple)

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.distributed.checkpoint import local_chunk
from repro_torch.launch.mesh import (dp_axes, mesh_axis, mesh_axis_sizes,
                                    tp_axis)
from repro_torch.models.convert import jax_leaves

# torch 2.13 renamed reduce_scatter_tensor (deprecated there) to
# reduce_scatter_single; the card's torch may have either.
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor

# Names whose 2D matrices contract their TP-sharded input back to the
# residual stream: shard as P(tp, fsdp) instead of P(fsdp, tp).
_REDUCE_BACK = {"wo", "w2", "cv", "w_out", "wb"}
# Stacked containers: arrays carry a leading layer/superblock dim.
_STACKED = {"layers", "supers", "enc_layers", "dec_layers"}


class PartitionSpec(tuple):
    """JAX's PartitionSpec: one entry per tensor dim, a mesh axis name, a
    tuple of names (sharded over their product, the first outermost) or
    None (replicated). A tuple of one name is that name, as in JAX."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"

    def names(self, dim: int) -> Tuple[str, ...]:
        """The axis names of entry `dim`, () when it is replicated."""
        entry = self[dim] if dim < len(self) else None
        if entry is None:
            return ()
        return (entry,) if isinstance(entry, str) else tuple(entry)


P = PartitionSpec


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes without devices or a world (JAX's
    AbstractMesh): what the rules read."""
    names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return tuple(self.names)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.sizes)


_KINDS = ("btd", "bd", "moe_gtd", "moe_gecd", "moe_gecf")


# activation_sharding's state: (seq_axis, seq_div) inside it, else None.
# A process global (module docstring).
_SEQ_SHARD: Optional[Tuple[Optional[str], int]] = None


@contextlib.contextmanager
def activation_sharding(dp: Tuple[str, ...], seq_axis: Optional[str] = None,
                        seq_div: int = 1, tp: Optional[str] = "model"):
    """JAX's context that turns on activation sharding: here the switch
    of sequence parallelism over `seq_axis` for streams whose length
    divides by `seq_div` (module docstring). `dp` and `tp` are JAX's
    layout hints; the port's tensor-parallel modules place their own
    collectives over them."""
    global _SEQ_SHARD
    prev = _SEQ_SHARD
    _SEQ_SHARD = (seq_axis, max(int(seq_div), 1))
    try:
        yield
    finally:
        _SEQ_SHARD = prev


def seq_div_for(axis: str) -> Optional[int]:
    """seq_div inside activation_sharding with seq_axis `axis`, else
    None."""
    if _SEQ_SHARD is None or _SEQ_SHARD[0] != axis:
        return None
    return _SEQ_SHARD[1]


def maybe_shard(x: torch.Tensor, kind: str = "btd") -> torch.Tensor:
    """x unchanged: JAX's with_sharding_constraint of an activation
    ('btd', 'bd' or an MoE pin) changes no value, and eager PyTorch has no
    propagation for it to steer. An unknown kind raises, as JAX's does."""
    if kind not in _KINDS:
        raise ValueError(kind)
    return x


def _axes_if_div(dim: int, axes, sizes: Dict[str, int]):
    """Return `axes` (str or tuple) if dim divides by their product."""
    if axes is None:
        return None
    tup = (axes,) if isinstance(axes, str) else tuple(axes)
    if not tup:
        return None
    if dim % math.prod(sizes[a] for a in tup) == 0:
        return axes if isinstance(axes, str) else tup
    return None


def _param_rule(name: str, shape: Tuple[int, ...], stacked: bool,
                fsdp, tp, sizes: Dict[str, int]) -> P:
    lead = (None,) if stacked else ()
    core = shape[1:] if stacked else shape
    nd = len(core)
    if nd <= 1:
        return P(*lead, *(None,) * nd)
    if name == "embed":                     # (V, d)
        return P(*lead, _axes_if_div(core[0], tp, sizes),
                 _axes_if_div(core[1], fsdp, sizes))
    if name == "unembed":                   # (d, V)
        return P(*lead, _axes_if_div(core[0], fsdp, sizes),
                 _axes_if_div(core[1], tp, sizes))
    if name == "router":                    # (d, E)
        return P(*lead, _axes_if_div(core[0], fsdp, sizes), None)
    if nd == 3:                             # MoE expert weights (E, x, y)
        if name in _REDUCE_BACK:            # (E, f, d)
            return P(*lead, None, _axes_if_div(core[1], tp, sizes),
                     _axes_if_div(core[2], fsdp, sizes))
        return P(*lead, None, _axes_if_div(core[1], fsdp, sizes),
                 _axes_if_div(core[2], tp, sizes))
    if nd == 2:
        if name == "conv_w":                # (4, dr)
            return P(*lead, None, _axes_if_div(core[1], tp, sizes))
        if name in _REDUCE_BACK:
            return P(*lead, _axes_if_div(core[0], tp, sizes),
                     _axes_if_div(core[1], fsdp, sizes))
        return P(*lead, _axes_if_div(core[0], fsdp, sizes),
                 _axes_if_div(core[1], tp, sizes))
    return P(*lead, *(None,) * nd)


def param_pspecs(model: nn.Module, mesh, use_fsdp: bool = True,
                 shapes: Optional[Mapping[str, torch.Size]] = None
                 ) -> Dict[str, P]:
    """{parameter name: PartitionSpec} for the port's model (on any
    device, "meta" included). `shapes`: the whole parameters' shapes when
    the model holds shards.

    use_fsdp=False drops the data-axis factor (TP-only): JAX's pre-gather
    target spec when cfg.pregather is on."""
    fsdp = dp_axes(mesh) if use_fsdp else ()
    tp = tp_axis(mesh)
    sizes = mesh_axis_sizes(mesh)
    where = jax_leaves(model)
    out = {}
    for name, p in model.named_parameters():
        keys, row = where[name]
        shape = tuple(shapes[name] if shapes is not None else p.shape)
        if row is None:
            out[name] = _param_rule(str(keys[-1]), shape, False, fsdp, tp,
                                    sizes)
            continue
        # JAX's leaf is stacked: a lead dim of the layers, never sharded.
        full = (1,) + shape
        spec = _param_rule(str(keys[-1]), full,
                           any(str(k) in _STACKED for k in keys[:-1])
                           and len(full) > 1, fsdp, tp, sizes)
        out[name] = P(*spec[1:])
    return out


def state_pspecs(state, mesh, zero1: bool = False,
                 shapes: Optional[Mapping[str, torch.Size]] = None):
    """TrainState(params, opt{m, v, step}) of specs for the port's train
    state (its model and AdamW moments, keyed by parameter name).

    Default (ZeRO-3-flavoured): params AND moments 2D-sharded (fsdp x tp).
    zero1=True: params TP-only while the f32 moments stay 2D-sharded."""
    from repro_torch.train.steps import TrainState
    model = state.params
    moments = param_pspecs(model, mesh, shapes=shapes)
    return TrainState(
        params=(param_pspecs(model, mesh, use_fsdp=False, shapes=shapes)
                if zero1 else moments),
        opt={"m": moments, "v": dict(moments), "step": P()})


def batch_pspecs(batch: Mapping[str, torch.Tensor], mesh) -> Dict[str, P]:
    """The batch's leading dim over the dp axes where it divides."""
    dp = dp_axes(mesh)
    sizes = mesh_axis_sizes(mesh)
    return {key: P(_axes_if_div(x.shape[0], dp, sizes),
                   *(None,) * (len(x.shape) - 1))
            for key, x in batch.items()}


def cache_pspecs(cache: Mapping[str, object], mesh) -> Dict[str, P]:
    """KV caches: (L, B, T, H, hd) -> P(None, dp, tp-on-T, None, None);
    recurrent states: batch over dp, width over tp; "pos" replicated."""
    dp = dp_axes(mesh)
    tp = tp_axis(mesh)
    sizes = mesh_axis_sizes(mesh)

    def rule(name, s):
        if name == "pos":
            return P()
        if name in ("k", "v", "xk", "xv", "s"):  # (L,B,T,H,hd) (L,B,H,dk,dv)
            return P(None, _axes_if_div(s[1], dp, sizes),
                     _axes_if_div(s[2], tp, sizes), None, None)
        if name in ("tm", "cm", "h"):            # (L,B,d)
            return P(None, _axes_if_div(s[1], dp, sizes),
                     _axes_if_div(s[2], tp, sizes))
        if name == "conv":                       # (L,B,3,d)
            return P(None, _axes_if_div(s[1], dp, sizes), None,
                     _axes_if_div(s[3], tp, sizes))
        return P(*(None,) * len(s))

    return {name: rule(name, tuple(getattr(leaf, "shape", ())))
            for name, leaf in cache.items()}


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of `spec`, one per mesh dim: Shard(d) on each
    mesh dim that entry d names (a tuple of names on each of its dims, in
    mesh order), Replicate() on the others."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d in range(len(spec)):
        for axis in spec.names(d):
            out[names.index(axis)] = Shard(d)
    return tuple(out)


def _sharded(spec: P, mesh):
    """(mesh dim index, axis name, tensor dim) for each mesh dim of size
    > 1 that `spec` shards, in mesh order."""
    names = tuple(mesh.mesh_dim_names)
    out = []
    for i, axis in enumerate(names):
        if mesh.shape[i] == 1:
            continue
        for d in range(len(spec)):
            if axis in spec.names(d):
                out.append((i, axis, d))
    return out


def local_shape(shape, spec: P, mesh) -> torch.Size:
    """The shape of one rank's chunk of a whole tensor of `shape`."""
    out = list(shape)
    for i, _, d in _sharded(spec, mesh):
        out[d] //= mesh.shape[i]
    return torch.Size(out)


def local_shard(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's chunk of the whole tensor `t` under `spec`: the chunk
    checkpoint.local_chunk cuts under placements(spec, mesh) (the rules
    shard only dims that divide, so an even split). `t` itself when no
    mesh dim of size > 1 shards it, else a contiguous copy: a chunk that
    local_chunk leaves as a view (one cut along the leading dim) is copied
    too, so that it does not keep the whole tensor's storage alive."""
    if not _sharded(spec, mesh):
        return t
    out = local_chunk(t, mesh, placements(spec, mesh))
    return out.clone() if out._base is not None else out


def gather(t: torch.Tensor, spec: P, mesh, to: Optional[P] = None
           ) -> torch.Tensor:
    """The whole tensor from each rank's chunk `t` under `spec`:
    all-gathers over the mesh dims that shard it, innermost first; `t`
    itself when none of size > 1 does. `to`: a layout that keeps some of
    spec's cuts (the same mesh dim on the same tensor dim); the chunk
    under `to` comes back, gathered over the other mesh dims only."""
    keep = set(_sharded(to, mesh)) if to is not None else set()
    for i, axis, d in reversed(_sharded(spec, mesh)):
        if (i, axis, d) not in keep:
            t = mesh_axis(mesh, axis).all_gather_cat(t, dim=d)
    return t


def reduce_shard(t: torch.Tensor, spec: P, mesh,
                 over: Tuple[str, ...], held: Optional[P] = None
                 ) -> torch.Tensor:
    """Sum the whole tensor `t` over the mesh dims `over` and return this
    rank's chunk of the sum under `spec`: a reduce-scatter along the dim
    where `spec` shards it over that mesh dim, an all-reduce where it does
    not; a mesh dim outside `over` that `spec` shards only cuts the local
    chunk (every rank there holds the same sum). `t` itself when no mesh
    dim of size > 1 is involved. `held`: `t` is already this rank's chunk
    under `held` along the mesh dims outside `over` that it shards (a
    tensor-parallel gradient): kept where `spec` cuts the same tensor dim
    there, else gathered first."""
    names = tuple(mesh.mesh_dim_names)
    shard_dims = {axis: d for _, axis, d in _sharded(spec, mesh)}
    held_dims = ({axis: d for _, axis, d in _sharded(held, mesh)}
                 if held is not None else {})
    coord = None
    for i, axis in enumerate(names):
        size = mesh.shape[i]
        if size == 1:
            continue
        d = shard_dims.get(axis)
        h = held_dims.get(axis)
        if h is not None and axis not in over:
            if h == d:                      # already this rank's chunk
                continue
            t = mesh_axis(mesh, axis).all_gather_cat(t, dim=h)
        if axis in over:
            ax = mesh_axis(mesh, axis)
            ax.check("reduce_shard", t)
            if d is None:
                t = ax.all_reduce(t.contiguous())
                continue
            front = t.movedim(d, 0).contiguous()
            out = torch.empty((front.shape[0] // size,) + front.shape[1:],
                              dtype=t.dtype, device=t.device)
            _reduce_scatter(out, front, group=ax.group)
            t = out.movedim(0, d)
        elif d is not None:
            coord = mesh.get_coordinate() if coord is None else coord
            n = t.shape[d] // size
            t = t.narrow(d, coord[i] * n, n)
    return t.contiguous()


def owns(spec: P, mesh) -> bool:
    """Whether this rank is the one copy of its chunk that counts: its
    coordinate is 0 on every mesh dim that `spec` does not shard (a sum
    over the world then counts each element once)."""
    sharded = {i for i, _, _ in _sharded(spec, mesh)}
    coord = mesh.get_coordinate()
    return all(coord[i] == 0 for i in range(len(mesh.shape))
               if i not in sharded)


class AtUse(NamedTuple):
    """What the gather at each use reads (train/steps.py's sharded step):
    the mesh, each parameter's stored spec, the spec it is computed in,
    the whole shapes, {id(parameter): name} of the stored shards, and
    fold(name, grad), which takes each use's gradient in the computed
    layout."""
    mesh: object
    stored: Mapping[str, P]
    compute: Mapping[str, P]
    shapes: Mapping[str, torch.Size]
    names: Mapping[int, str]
    fold: Callable[[str, torch.Tensor], None]


# gather_at_use's state, else None. A process global (module docstring).
_AT_USE: Optional[AtUse] = None


@contextlib.contextmanager
def gather_at_use(state: AtUse):
    """The region in which `call_gathered` gathers each parameter of
    state.names from its shard at its use."""
    global _AT_USE
    prev = _AT_USE
    _AT_USE = state
    try:
        yield
    finally:
        _AT_USE = prev


def at_use() -> Optional[AtUse]:
    """gather_at_use's state inside it, else None."""
    return _AT_USE


class _GatherAtUse(torch.autograd.Function):
    """A stored shard all-gathered to its computed layout (no collective
    and no copy where no mesh dim of size > 1 separates the two); the
    backward hands the gradient to the state's fold and returns none to
    the shard."""

    @staticmethod
    def forward(ctx, shard, name, state):
        ctx.name, ctx.fold = name, state.fold
        return gather(shard, state.stored[name], state.mesh,
                      to=state.compute[name])

    @staticmethod
    def backward(ctx, grad):
        ctx.fold(ctx.name, grad)
        return None, None, None


class _Apply(nn.Module):
    """fn as the forward of a module that holds `unit`, so that
    torch.func.functional_call swaps the unit's tensors under their own
    names whether fn is the unit or takes it as an argument."""

    def __init__(self, unit: nn.Module, fn: Callable):
        super().__init__()
        self.unit = unit
        self.__dict__["fn"] = fn            # not a submodule

    def forward(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def _gathered_leaf(shard: torch.Tensor, name: str,
                   state: AtUse) -> torch.Tensor:
    """The shard gathered to its computed layout as a leaf of its own
    (the same storage where nothing is gathered), whose gradient the
    state's fold takes as soon as autograd has it: autograd runs a leaf's
    accumulation first, and its graph holds the copy to the end of the
    backward."""
    with torch.no_grad():
        leaf = gather(shard, state.stored[name], state.mesh,
                      to=state.compute[name]).detach().requires_grad_()

    def fold(t):
        state.fold(name, t.grad)
        t.grad = None
    leaf.register_post_accumulate_grad_hook(fold)
    return leaf


def call_gathered(unit: nn.Module, fn: Callable, args: tuple = (),
                  kwargs: Optional[dict] = None,
                  skip: Collection[str] = (), hold: Collection[str] = ()):
    """fn(*args, **kwargs) with every parameter of `unit` that
    gather_at_use holds as a shard (but those whose name in `unit` is in
    `skip`) replaced by its gathered copy, under its own name
    (torch.func.functional_call): the shards stay in p.data. Each copy
    lives as long as fn or autograd holds it, and autograd hands its
    gradient to the fold when it reaches the gather's node, which it runs
    after every node made later: right after a block's backward. Those
    named in `hold` are leaves instead (`_gathered_leaf`): for a weight
    gathered before the blocks and used after them (the unembedding),
    whose gradient would otherwise wait for every block's backward."""
    state = _AT_USE
    tensors = {f"unit.{n}": (_gathered_leaf if n in hold
                             else _GatherAtUse.apply)(
                                 p, state.names[id(p)], state)
               for n, p in unit.named_parameters()
               if n not in skip and id(p) in state.names}
    return torch.func.functional_call(_Apply(unit, fn), tensors, args,
                                      kwargs or {})


def compute_shape(t: torch.Tensor) -> torch.Size:
    """The shape `t` is computed at: inside gather_at_use, a stored
    shard's shape in its computed layout; else t's own."""
    state = _AT_USE
    name = state.names.get(id(t)) if state is not None else None
    if name is None:
        return t.shape
    return local_shape(state.shapes[name], state.compute[name], state.mesh)
