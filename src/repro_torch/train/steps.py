"""Train / prefill / decode step builders (the port of repro/train/steps.py).

make_train_step builds train_step(state, batch) -> (state, metrics):
  - microbatch gradient accumulation (cfg.microbatches), as JAX's lax.scan
    does it: contiguous rows per microbatch, each microbatch's gradient
    (in the parameter dtype) cast to f32 and summed, then divided by M;
  - the f32 loss with label masking (-1 = ignore);
  - the AdamW update (train/optimizer.py);
  - an optional grad_transform hook applied to the accumulated gradient
    before the optimizer (e.g. the sketched gradients of
    distributed/compression.py).

On a mesh (mesh=, after shard_train_state), JAX's sharded step with its
meanings, across the ranks of a torch DeviceMesh ("data", "model", and
"pod" where present; every rank calls the step with the same global
batch):
  - each parameter and both moments are stored as this rank's shard under
    distributed/sharding.py's state_pspecs, and stay so through the step;
    each parameter is all-gathered over the data axes to the layout it is
    computed in at its use, as JAX's step without a pregather_spec lets
    GSPMD gather each weight where the scanned layer body uses it: a
    block's (each unit models/layers.py's remat runs) when the block runs,
    inside remat's checkpoint when cfg.remat is set, so the backward's
    recompute gathers it again; the others (the embedding, unembedding,
    final norms) once a microbatch, those used after the blocks held to
    the end of its backward (sharding.gather_at_use and call_gathered). A block's gathered copies
    go when autograd lets them go: under remat when the block returns,
    without remat when the backward has passed the products that saved
    them. A mesh whose data
    axes have size 1 gathers without a copy. With JAX's pregather_spec,
    or with zero1 (the parameters stored TP-only), the step gathers every
    parameter once at entry instead, holds the gathered copies to the end
    of the backward and puts the shards back before the update;
  - over the model axis every family computes tensor-parallel
    (distributed/tensor_parallel.py: heads, MLP and expert ffn columns,
    the RG-LRU blocks' channels, the RWKV blocks' heads and channel-mix
    columns, whisper's cross-attention heads, the vocabulary of the
    embedding, the logits and the loss), each such weight kept as its
    model-axis chunk under JAX's TP-only spec; a module whose weights
    JAX's divisibility guard leaves whole gathers over the model axis
    too and computes replicated there. Whisper's frames are cut by data
    rank with the other batch keys;
  - rows: JAX runs microbatch m's rows [m B/M, (m+1) B/M) at groups = the
    data axes' size dp, as dp contiguous routing groups; here data rank r
    runs group r itself, rows [m B/M + r B/(M dp), + B/(M dp)), at
    groups / dp (capacity routing sees JAX's groups);
  - each rank's loss is normalized by the microbatch's global label count
    (read from the global batch), so the sum over ranks is JAX's loss;
  - each microbatch's gradient is reduced over the data axes as autograd
    produces it (once a microbatch: a block's gather's backward, not its
    replay, folds it), into grad_spec's layout (the moments' by default): a
    tensor-parallel weight's gradient is already its model-axis chunk,
    and a replicated parameter's is the same on every model rank, which
    keeps its chunk (no collective over "model"). A grad_transform
    instead gets each rank's whole, unreduced gradient (a
    tensor-parallel one gathered over "model"), reduces over the data
    axes itself (the sketched gradients average their r'-float sketch)
    and returns the global gradient, which JAX's hook sees;
  - AdamW runs on the local shards; the grad norm counts each element
    once (a chunk replicated over an axis counts on its coordinate 0).
Inside sharding.activation_sharding with seq_axis "model" (JAX's
seq_shard_acts; the dry run enters it, the launcher does not) the
models cut the residual stream over the model axis between blocks where
S divides (distributed/tensor_parallel.py's `stream`): the step itself
is unchanged, and every parameter's gradient is still whole or the
rank's chunk when the fold reads it (a stream norm's and the MoE
router's are summed over the axis where they are computed). A world
whose model axis has size 1 runs the same operations as before
tensor-parallel compute, the switch on or off, and a world of one rank
the same as the meshless step, bit for bit. Over a model axis > 1 the row-parallel sums and the
split logsumexp change the order of sums, so the numbers match JAX's to
f32 rounding, not bit for bit.

Differences from JAX's step, by design:
  - the state is updated in place and the same TrainState is returned (a
    second copy of a training state would not fit beside the first on
    one card). `TrainState.params` is the model (an nn.Module), as the
    rest of the port passes the model where JAX passes (params, cfg);
  - each parameter's gradient is folded into its f32 accumulator as soon
    as autograd has it (Tensor.register_post_accumulate_grad_hook; on a
    mesh gathering at each use, the gather's backward) and dropped, so a
    microbatch's gradients never live beside the sum: the
    same arithmetic as JAX's scan;
  - the unit of a gather at use is one block, where GSPMD may place each
    weight's gather anywhere in the scan body; the one pregather_spec
    taken is JAX's TP-only spec;
  - the batch (B / M) must divide by dp, where JAX would replicate.

No host sync runs inside the step: the metrics are tensors on the step's
device. `cfg` is kept for the JAX signature of the serving builders; the
model carries it.

make_prefill_step / make_decode_step take mesh= too: JAX's serving steps
under its dry run's shardings, on a model cut once by
distributed/tensor_parallel.py's shard_for_serving (its heads, KV heads,
MLP and expert columns and vocab chunk, held; no weight collective) and
the rank's cache of its rows and KV heads; each data rank serves its
rows of the global batch, and the logits come back whole.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import (AtUse, P, call_gathered,
                                              gather, gather_at_use,
                                              local_shape, local_shard,
                                              owns, param_pspecs,
                                              reduce_shard, state_pspecs)
from repro_torch.launch.mesh import dp_axes, mesh_axis, tp_axis
from repro_torch.models.config import ArchConfig
from repro_torch.models.convert import decayed_names
from repro_torch.models.layers import remat_units
from repro_torch.models.registry import ModelAPI
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update


class TrainState(NamedTuple):
    params: nn.Module
    opt: Dict


class ShardLayout(NamedTuple):
    """How a sharded train state is stored (shard_train_state): the mesh,
    the stored parameters' specs, the moments' specs, and the whole
    parameters' shapes."""
    mesh: object
    params: Dict[str, P]
    moments: Dict[str, P]
    shapes: Dict[str, torch.Size]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked mean CE. logits (B,S,V) f32, labels (B,S) int (-1 ignored);
    the logsumexp over the whole (padded) vocabulary, the mean over
    max(count, 1) labels. `count`: the labels to divide by when these rows
    are a part of the batch (default: this batch's own)."""
    mask = labels >= 0
    safe = labels.clamp_min(0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / (mask.sum() if count is None else count).clamp_min(1)


def init_train_state(cfg: ArchConfig, api: ModelAPI, tp: int = 16, *,
                     device=None,
                     generator: Optional[torch.Generator] = None
                     ) -> TrainState:
    """The model (drawn from `generator`, seed 0 when None) and zero AdamW
    moments in cfg.optimizer_dtype, on the card unless the caller names
    another device."""
    device = resolve_device(device)
    model = api.init(cfg, tp, device=device, generator=generator)
    opt_cfg = AdamWConfig(moment_dtype=cfg.optimizer_dtype)
    return TrainState(model, adamw_init(dict(model.named_parameters()),
                                        opt_cfg))


@torch.no_grad()
def shard_train_state(state: TrainState, mesh,
                      zero1: bool = False) -> TrainState:
    """Cut each parameter and both moments to this rank's shard under
    state_pspecs(state, mesh, zero1), in place (a mesh dim of size 1 cuts
    without a copy). The model keeps the layout as `shard_layout`, which
    the sharded step and the launcher's checkpoints read."""
    model = state.params
    if getattr(model, "shard_layout", None) is not None:
        raise ValueError("the train state is already sharded")
    shapes = {name: p.shape for name, p in model.named_parameters()}
    spec = state_pspecs(state, mesh, zero1)
    for name, p in model.named_parameters():
        p.data = local_shard(p.data, spec.params[name], mesh)
    opt = {key: {name: local_shard(t, spec.opt[key][name], mesh)
                 for name, t in state.opt[key].items()}
           for key in ("m", "v")}
    opt["step"] = state.opt["step"]
    model.shard_layout = ShardLayout(mesh, spec.params, spec.opt["m"],
                                     shapes)
    return TrainState(model, opt)


def _relayout(t: torch.Tensor, src: P, dst: P, mesh) -> torch.Tensor:
    """A chunk under `src` as this rank's chunk under `dst`."""
    if tuple(src) == tuple(dst):
        return t
    return local_shard(gather(t, src, mesh), dst, mesh)


def make_train_step(cfg: ArchConfig, api: ModelAPI, groups: int = 1,
                    grad_transform: Optional[Callable] = None,
                    opt_cfg: Optional[AdamWConfig] = None,
                    pregather_spec: Optional[Dict[str, P]] = None,
                    grad_spec: Optional[Dict[str, P]] = None, *,
                    mesh=None) -> Callable:
    """Returns train_step(state, batch) -> (state, {"loss", "grad_norm"}).

    batch: dict of (B, ...) tensors; B must divide by cfg.microbatches.
    grad_transform: optional ({name: grad} -> {name: grad}) hook on the
    accumulated gradients. With M = 1 the gradients stay in the parameter
    dtype, as JAX's do; with M > 1 they are the f32 mean.

    mesh: run the sharded step (module docstring) on a state from
    shard_train_state; groups must divide by the data axes' size dp.
    pregather_spec ({name: spec}): JAX's pre-gather target, which must be
    JAX's TP-only spec (param_pspecs(..., use_fsdp=False)): the step then
    gathers over the data axes once a step, not at each use (module
    docstring).
    grad_spec ({name: spec}): the layout each microbatch's gradient is
    reduce-scattered into and summed in (the moments' by default); a
    gradient in another layout is moved to the moments' before AdamW.
    On a mesh, grad_transform sees the gradient JAX's hook sees, the
    global one: it gets each rank's whole, unreduced gradient as a local
    mean (times dp, so the ranks' mean is the global gradient, JAX's pmean
    convention), reduces over the data axes itself (the sketched gradients
    with axis="data") and returns the global gradient, the same on every
    rank, which the step cuts to the moments' layout (grad_spec is then
    unused).
    """
    opt_cfg = opt_cfg or AdamWConfig(moment_dtype=cfg.optimizer_dtype)
    M = cfg.microbatches
    if mesh is not None:
        return _make_mesh_step(cfg, api, groups, grad_transform, opt_cfg,
                               pregather_spec, grad_spec, mesh)
    if pregather_spec is not None or grad_spec is not None:
        raise ValueError("pregather_spec and grad_spec need a mesh")

    def loss_fn(model, mb):
        return cross_entropy(api.forward(model, mb, groups), mb["labels"])

    def grads_of(model, params, batch):
        """(loss, {name: grad}): JAX's value_and_grad (M = 1), or its scan
        over M microbatches (the mean loss, the f32 mean gradient)."""
        if M == 1:
            loss = loss_fn(model, batch)
            loss.backward()
            grads = {name: p.grad for name, p in params.items()}
            for p in params.values():
                p.grad = None
            return loss.detach(), grads
        acc = {name: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
               for name, p in params.items()}

        def fold(name):
            def hook(p):
                acc[name].add_(p.grad.float())
                p.grad = None
            return hook

        hooks = [p.register_post_accumulate_grad_hook(fold(name))
                 for name, p in params.items()]
        try:
            loss_sum = None
            for i in range(M):
                mb = {k: x.reshape(M, x.shape[0] // M, *x.shape[1:])[i]
                      for k, x in batch.items()}
                loss = loss_fn(model, mb)
                loss.backward()
                loss = loss.detach()
                loss_sum = loss if loss_sum is None else loss_sum + loss
        finally:
            for h in hooks:
                h.remove()
        return loss_sum / M, {name: a.div_(M) for name, a in acc.items()}

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState,
                                                           Dict]:  # hot-path
        model = state.params
        if getattr(model, "shard_layout", None) is not None:
            raise ValueError("a sharded train state needs the step's mesh")
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss, grads = grads_of(model, params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        gnorm = torch.sqrt(sum(
            torch.linalg.vector_norm(g, dtype=torch.float32).square()
            for g in grads.values()))
        adamw_update(params, grads, state.opt, opt_cfg,
                     decay=decayed_names(model))
        return state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def _data_rank(mesh) -> int:
    """This rank's index over the data axes (pod-major)."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    rank = 0
    for a in dp_axes(mesh):
        i = names.index(a)
        rank = rank * mesh.shape[i] + coord[i]
    return rank


def _make_mesh_step(cfg, api, groups, grad_transform, opt_cfg,
                    pregather_spec, grad_spec, mesh) -> Callable:
    M = cfg.microbatches
    whole_grads = grad_transform is not None   # it reduces them itself
    names = tuple(mesh.mesh_dim_names)
    dp = dp_axes(mesh)
    n_dp = math.prod(mesh.shape[names.index(a)] for a in dp)
    if groups % n_dp:
        raise ValueError(f"groups {groups} must divide by the data axes' "
                         f"size {n_dp}: each data rank runs whole groups")
    rank = _data_rank(mesh)
    world = math.prod(mesh.shape)
    dp_groups = [mesh_axis(mesh, a) for a in dp
                 if mesh.shape[names.index(a)] > 1]
    tp = tp_axis(mesh)
    model_axis = mesh_axis(mesh, tp) if tp is not None else None

    def layouts(model, lay):
        """{name: the layout it is computed in}; pregather_spec checked
        against JAX's TP-only spec."""
        if pregather_spec is not None:
            want = param_pspecs(model, mesh, use_fsdp=False,
                                shapes=lay.shapes)
            bad = [n for n in want
                   if tuple(pregather_spec.get(n, ())) != tuple(want[n])]
            if bad:
                raise ValueError(
                    f"pregather_spec must be JAX's TP-only spec "
                    f"(param_pspecs(..., use_fsdp=False)); {bad[0]} is "
                    f"{pregather_spec.get(bad[0])}, not {want[bad[0]]}")
        return TP.compute_specs(model, mesh, lay.shapes)

    def grads_of(model, params, batch, lay, gspec, cspec, at_use):
        """(loss, {name: grad}): this rank's rows of each microbatch, the
        gradients reduced as autograd produces them (whole and unreduced
        for a grad_transform), then the f32 mean for M > 1. at_use: the
        parameters are gathered at each use (sharding.gather_at_use),
        else they were gathered at entry."""
        B = next(iter(batch.values())).shape[0]
        b = B // M // n_dp
        acc = {}
        if M > 1:
            acc = {name: torch.zeros(
                lay.shapes[name] if whole_grads else local_shape(
                    lay.shapes[name], gspec[name], mesh),
                dtype=torch.float32, device=p.device)
                for name, p in params.items()}
        axis = TP.active()
        vocab_cut = (axis is not None and "unembed" in cspec
                     and tp in cspec["unembed"].names(1))

        def fold(name, grad):
            """One use's gradient in the computed layout, reduced (or
            gathered whole for a grad_transform) and summed in."""
            g = (gather(grad, cspec[name], mesh) if whole_grads
                 else reduce_shard(grad, gspec[name], mesh, dp,
                                   held=cspec[name]))
            if M > 1:
                acc[name].add_(g.float())
            else:
                acc[name] = acc[name] + g if name in acc else g

        def hook(name):
            def fold_grad(p):
                fold(name, p.grad)
                p.grad = None
            return fold_grad

        hooks, region = [], contextlib.nullcontext()
        forward = api.forward
        if at_use:
            region = gather_at_use(AtUse(
                mesh, lay.params, cspec, lay.shapes,
                {id(p): name for name, p in params.items()}, fold))
            blocks = {f"{prefix}.{n}" for prefix, blk in
                      remat_units(model).items()
                      for n, _ in blk.named_parameters()}
            # The parameters outside the blocks, once a microbatch, those
            # used after the blocks held (call_gathered); the token
            # embedding's lookup keeps no copy, and its gradient comes
            # last.
            held = set(params) - blocks - {"embed"}

            def forward(model, mb, g):
                return call_gathered(model, api.forward, (model, mb, g),
                                     skip=blocks, hold=held)
        else:
            hooks = [p.register_post_accumulate_grad_hook(hook(name))
                     for name, p in params.items()]
        try:
            loss_sum = None
            with region:
                for i in range(M):
                    whole = {k: x.reshape(M, B // M, *x.shape[1:])[i]
                             for k, x in batch.items()}
                    count = (whole["labels"] >= 0).sum()
                    mb = {k: x[rank * b:(rank + 1) * b]
                          for k, x in whole.items()}
                    logits = forward(model, mb, groups // n_dp)
                    loss = (TP.cross_entropy(logits, mb["labels"], count,
                                             axis) if vocab_cut else
                            cross_entropy(logits, mb["labels"], count))
                    del logits          # autograd keeps what it needs
                    loss.backward()
                    loss = loss.detach()
                    loss_sum = loss if loss_sum is None else loss_sum + loss
        finally:
            for h in hooks:
                h.remove()
        for ax in dp_groups:
            ax.all_reduce(loss_sum)
        if M > 1:
            for a in acc.values():
                a.div_(M)
        # In the parameters' order (the hooks fire in the backward's).
        return loss_sum / M, {name: acc[name] for name in params}

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState,
                                                           Dict]:  # hot-path
        model = state.params
        lay = getattr(model, "shard_layout", None)
        if lay is None or lay.mesh is not mesh:
            raise ValueError("the train state is not sharded on this "
                             "step's mesh (shard_train_state)")
        B = next(iter(batch.values())).shape[0]
        if B % M or (B // M) % n_dp:
            raise ValueError(
                f"a batch of {B} rows in {M} microbatches does not split "
                f"over {n_dp} data ranks (JAX would replicate it)")
        gspec = grad_spec or lay.moments
        cspec = layouts(model, lay)
        params = dict(model.named_parameters())
        shards = {name: p.data for name, p in params.items()}
        # zero1 stores the parameters TP-only: nothing to gather over the
        # data axes at each use, so it keeps the entry gather.
        at_use = pregather_spec is None and all(
            tuple(lay.params[n]) == tuple(lay.moments[n]) for n in params)
        try:
            with torch.no_grad():
                for name, p in params.items():
                    p.grad = None
                    if not at_use:
                        p.data = gather(shards[name], lay.params[name],
                                        mesh, to=cspec[name])
            with TP.tensor_parallel(model_axis):
                loss, grads = grads_of(model, params, batch, lay, gspec,
                                       cspec, at_use)
        finally:
            if not at_use:
                for name, p in params.items():
                    p.data = shards[name]
        if whole_grads:
            if n_dp > 1:
                for g in grads.values():
                    g.mul_(n_dp)
            grads = {name: local_shard(g, lay.moments[name], mesh)
                     for name, g in grad_transform(grads).items()}
        else:
            grads = {name: _relayout(g, gspec[name], lay.moments[name],
                                     mesh) for name, g in grads.items()}
        zero = torch.zeros((), dtype=torch.float32, device=loss.device)
        total = sum((torch.linalg.vector_norm(g, dtype=torch.float32).square()
                     for name, g in grads.items()
                     if owns(lay.moments[name], mesh)), zero)
        if world > 1:
            dist.all_reduce(total)
        gnorm = torch.sqrt(total)
        at = {name: _relayout(shards[name], lay.params[name],
                              lay.moments[name], mesh) for name in params}
        adamw_update(at, grads, state.opt, opt_cfg,
                     decay=decayed_names(model))
        for name, p in params.items():
            if at[name] is not shards[name]:
                p.data = _relayout(at[name], lay.moments[name],
                                   lay.params[name], mesh)
        return state, {"loss": loss, "grad_norm": gnorm}

    return train_step


class _MeshServing(NamedTuple):
    """What a serving step needs of its mesh: this rank's data index,
    each data axis of size > 1 as a MeshAxis (innermost first) and the
    model axis."""
    mesh: object
    rank: int
    data_axes: Tuple
    model_axis: object

    def rows(self, model, B: int, groups: int) -> Tuple[slice, int, bool]:
        """(this rank's rows of a global batch of B, tensor_parallel's
        serve_rows, the groups it runs them at, whether the rows were
        split over the data axes)."""
        lay = getattr(model, "serve_layout", None)
        if lay is None or lay.mesh is not self.mesh:
            raise ValueError("the model is not cut for this step's mesh "
                             "(tensor_parallel.shard_for_serving)")
        b = TP.serve_rows(B, self.mesh)
        if b == B:
            return slice(None), groups, False
        if groups % (B // b):
            raise ValueError(f"groups {groups} must divide by the data "
                             f"axes' size {B // b}: each data rank runs "
                             f"whole routing groups")
        return (slice(self.rank * b, (self.rank + 1) * b),
                groups // (B // b), True)

    def gather(self, logits: torch.Tensor, split: bool) -> torch.Tensor:
        """The logits of every row: the data ranks' rows all-gathered,
        innermost axis first, where they were split."""
        for axis in self.data_axes if split else ():
            logits = axis.all_gather_cat(logits, 0)
        return logits


def _mesh_serving(mesh) -> _MeshServing:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    tp = tp_axis(mesh)
    return _MeshServing(
        mesh, _data_rank(mesh),
        tuple(mesh_axis(mesh, a) for a in reversed(dp_axes(mesh))
              if sizes[a] > 1),
        mesh_axis(mesh, tp) if tp is not None else None)


def _meshless(model) -> None:
    if getattr(model, "serve_layout", None) is not None:
        raise ValueError("a model cut by shard_for_serving needs the "
                         "step's mesh")


def make_prefill_step(cfg: ArchConfig, api: ModelAPI, groups: int = 1, *,
                      mesh=None) -> Callable:
    """prefill_step(model, batch, cache) -> (last-position logits (B,
    vocab_padded) f32, cache).

    mesh: JAX's prefill under its serving shardings (launch/dryrun.py's
    cells), on a model of any family cut by
    tensor_parallel.shard_for_serving for this mesh and the rank's cache
    (tensor_parallel.serve_cache). Every rank takes the global batch
    (whisper's carries its "frames" beside the tokens); where B divides
    by the data axes' size dp, data rank r runs rows [r B / dp, (r + 1) B
    / dp) of every entry of the batch as JAX's routing group r (groups
    must divide by dp), else every rank runs all rows at `groups`. The
    step computes tensor-parallel over the model axis and returns the
    logits of every row over the whole padded vocabulary (the rows
    all-gathered over the data axes where they were split: JAX's
    replicated out_shardings) and the rank's cache."""
    if mesh is not None:
        serving = _mesh_serving(mesh)

        def mesh_prefill_step(model, batch, cache):  # hot-path
            B = next(iter(batch.values())).shape[0]
            rows, g, split = serving.rows(model, B, groups)
            with TP.tensor_parallel(serving.model_axis):
                logits, cache = api.prefill(
                    model, {k: x[rows] for k, x in batch.items()}, cache, g)
            return serving.gather(logits, split), cache
        return mesh_prefill_step

    def prefill_step(model, batch, cache):  # hot-path
        _meshless(model)
        return api.prefill(model, batch, cache, groups)
    return prefill_step


def make_decode_step(cfg: ArchConfig, api: ModelAPI, groups: int = 1, *,
                     mesh=None) -> Callable:
    """decode_step(model, tokens, cache) -> (greedy next tokens as int32,
    logits, cache). mesh: as make_prefill_step's, on the global tokens
    (B,); the greedy tokens and logits of every row."""
    serving = _mesh_serving(mesh) if mesh is not None else None

    def decode_step(model, tokens, cache):  # hot-path
        if serving is None:
            _meshless(model)
            logits, cache = api.decode(model, tokens, cache, groups)
        else:
            rows, g, split = serving.rows(model, tokens.shape[0], groups)
            with TP.tensor_parallel(serving.model_axis):
                logits, cache = api.decode(model, tokens[rows], cache, g)
            logits = serving.gather(logits, split)
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tokens, logits, cache
    return decode_step
