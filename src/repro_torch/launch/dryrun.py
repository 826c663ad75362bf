"""Dry run: each (arch x shape x mesh) cell's step as rank 0 of the
production mesh runs it, on fake tensors (the port of
repro/launch/dryrun.py).

JAX lowers and compiles each cell's step with the production shardings
against ShapeDtypeStruct inputs and reads XLA's memory and cost analyses.
The port runs the step itself: rank 0 of a fake world of the production
size (launch/mesh.py `make_dryrun_mesh`: torch's fake backend, whose
collectives move nothing), every tensor a fake tensor (torch's
FakeTensorMode: shapes, dtypes and devices, no memory and no values), and
counts what the step does op by op (launch/op_analysis.py, which stands
for hlo_analysis.py). The dry run touches no card and allocates no device
memory, on a machine without one or with one: that is what it is, as in
JAX, and not a fallback. Nothing in it looks for a card or chooses a
device; its fake tensors and its mesh are on mesh.DRYRUN_DEVICE.

Cells, as JAX's (specs.SHAPES; specs.cell_supported decides the skips,
with JAX's status / reason file): groups = the data axes' size dp where
B divides by it, else 1; JAX's microbatch count (the config's, lowered
until B / M divides by dp).
  - train_4k: the model built on "meta", then fake; its AdamW state cut
    to rank 0's shards by shard_train_state(zero1=cfg.zero1); the step
    from make_train_step(mesh=) with JAX's pregather spec (TP-only, when
    cfg.pregather) and gradient spec (fsdp x tp); run on the global batch
    of specs.train_inputs(abstract=True), of which the step takes rank
    0's rows of each microbatch. The step computes tensor-parallel over
    the model axis as it does on a real mesh (every family;
    distributed/tensor_parallel.py), rank 0 taking the most heads. It
    gathers each parameter over the data axes at its use, JAX's default
    (each block's parameters when the block runs, and again in remat's
    replay; the others once a microbatch), or, with cfg.pregather or
    cfg.zero1, once a step; the record's "param_gather" says which
    ("at each use" or "once a step"). `train_plan` gives the collective
    bytes it must move;
  - prefill_32k: make_prefill_step; decode_32k and long_500k:
    make_decode_step. Every family serves tensor-parallel through the
    mesh's steps (mesh=): the model built on "meta", then fake, cut to
    rank 0's serving shards by tensor_parallel.shard_for_serving (its
    attention and cross-attention heads and the KV heads they read, its
    RG-LRU lru channels, its RWKV time-mix heads, its MLP, expert,
    channel-mix and vocab chunks; the rest whole), rank 0's cache of its
    rows and of those heads and channels (tensor_parallel.serve_cache),
    the global batch (whisper's with its frames) or tokens, of which the
    step takes rank 0's rows when groups == dp; `serve_plan` gives the
    collective bytes it must move. JAX's grid gives every arch
    prefill_32k and decode_32k (specs.cell_supported skips only
    long_500k, for all but LONG_OK).
Every cell's step runs inside sharding.activation_sharding(dp axes,
seq_axis="model" if cfg.seq_shard_acts else None, seq_div=tp), as JAX's
run_cell enters it: with the flag on (--overrides '{"seq_shard_acts":
true}'), each stream whose length divides by tp is cut over the model
axis between blocks (sequence parallelism, distributed/
tensor_parallel.py's `stream`), and the plans count its collectives.

The record has JAX's keys (dryrun.py:155-175) with JAX's meanings, but:
  - lower_s: the seconds of building the fake state and inputs, and
    compile_s: the seconds of running the fake step;
  - memory: op_analysis's argument / output / temp / peak of rank 0 (MiB);
  - cost: the same flops and bytes as hlo_flops / hlo_traffic_bytes (XLA's
    cost_analysis counts a loop body once; eager runs every trip, so there
    is no such count to tell apart);
and keys more: a train cell's param_gather (above), and rules_mb: rank
0's bytes of the parameters, the
optimizer state and the cache under the sharding rules (the sum of
local_shape x itemsize over state_pspecs, or over param_pspecs and
cache_pspecs for a serving cell; the cache's "pos" is a host int in the
port). rules_mb stays JAX's fsdp x tp layout; `held_bytes` gives what
rank 0 of the port holds (its serving shards, whole over the data axes,
and its cache of its rows, heads and channels).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch ARCH \\
        --shape {train_4k,prefill_32k,decode_32k,long_500k} [--multipod] \\
        [--out artifacts/dryrun_torch] [--overrides JSON]

One cell a process, as JAX's (benchmarks/dryrun_all.py fans them out).
The world is torn down when the cell ends; a failure raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.launch import specs
from repro_torch.launch.mesh import (DRYRUN_DEVICE, destroy_dryrun_mesh,
                                     dp_axes, make_dryrun_mesh,
                                     mesh_axis_sizes)
from repro_torch.launch.op_analysis import analyze
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import get_api
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.steps import (TrainState, make_decode_step,
                                     make_prefill_step, make_train_step,
                                     shard_train_state)

MIB = 2 ** 20


def _mb(nbytes: float) -> float:
    return round(nbytes / MIB, 1)


def _sizes(mesh) -> Tuple[int, int]:
    """(dp, tp): the data axes' size and the model axis's."""
    sizes = mesh_axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh)), sizes.get("model", 1)


def plan_cell(cfg: ArchConfig, B: int, mesh) -> Tuple[int, int]:
    """(groups, microbatches) as JAX's run_cell sets them (dryrun.py:70-72,
    :88-90)."""
    dp, _ = _sizes(mesh)
    groups = dp if B % dp == 0 else 1
    micro = min(cfg.microbatches, max(1, B // dp))
    while (B // micro) % dp and micro > 1:
        micro -= 1
    return groups, micro


def _fake(x):
    """A fake tensor on DRYRUN_DEVICE in place of each meta tensor of x (a
    tensor, a dict of them, or an nn.Module, whose parameters and buffers
    are replaced in place); must run under a FakeTensorMode."""
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device=DRYRUN_DEVICE)
    if isinstance(x, dict):
        return {k: _fake(v) for k, v in x.items()}
    if isinstance(x, nn.Module):
        for mod in x.modules():
            for name, p in mod._parameters.items():
                if p is not None:
                    mod._parameters[name] = nn.Parameter(
                        _fake(p), requires_grad=p.requires_grad)
            for name, b in mod._buffers.items():
                if b is not None:
                    mod._buffers[name] = _fake(b)
        return x
    return x


def _local_bytes(tensors: Dict[str, torch.Tensor], spec: Dict[str, object],
                 mesh) -> int:
    """Sum of local_shape x itemsize over the tensors (not "pos")."""
    return sum(math.prod(shd.local_shape(t.shape, spec[name], mesh))
               * t.element_size() for name, t in tensors.items()
               if isinstance(t, torch.Tensor))


def rules_bytes(cfg: ArchConfig, kind: str, B: int, S: int,
                mesh) -> Dict[str, int]:
    """Rank 0's bytes under the sharding rules, from a model on "meta"
    (no world needed: `mesh` may be a sharding.MeshShape): {"params",
    "opt", "cache"}. train: state_pspecs(zero1=cfg.zero1) over the
    parameters and the AdamW state (m, v and the int32 step); prefill and
    decode: param_pspecs over the parameters and cache_pspecs over the
    cache of the whole batch for max_seq S."""
    api = get_api(cfg)
    _, tp = _sizes(mesh)
    model = api.init(cfg, tp, device="meta")
    params = dict(model.named_parameters())
    if kind == "train":
        state = TrainState(model, adamw_init(
            params, AdamWConfig(moment_dtype=cfg.optimizer_dtype)))
        spec = shd.state_pspecs(state, mesh, zero1=cfg.zero1)
        opt = sum(_local_bytes(state.opt[k], spec.opt[k], mesh)
                  for k in ("m", "v")) + state.opt["step"].element_size()
        return {"params": _local_bytes(params, spec.params, mesh),
                "opt": opt, "cache": 0}
    cache = specs.cache_specs(cfg, api, B, S, abstract=True)
    return {"params": _local_bytes(params, shd.param_pspecs(model, mesh),
                                   mesh),
            "opt": 0,
            "cache": _local_bytes(cache, shd.cache_pspecs(cache, mesh),
                                  mesh)}


def train_plan(cfg: ArchConfig, micro: int, mesh, B: int,
               S: int) -> Dict[str, float]:
    """The collective bytes by kind that make_train_step's sharded step
    runs on rank 0 (train/steps.py) for a global batch of B rows of S
    positions, each sized by its result as op_analysis sizes it:
      - each parameter gathered over the mesh dims that shard its stored
        layout and not the layout it is computed in
        (tensor_parallel.compute_specs), an all-gather a dim, innermost
        first: by default at each use (JAX's step without a
        pregather_spec), a block's parameters (layers.remat_units) once a
        microbatch and once more where remat replays the block in the
        backward, the others once a microbatch; with cfg.pregather (JAX's
        TP-only pregather_spec) or cfg.zero1, once a step;
      - each microbatch's gradient, in the parameter's dtype and the
        computed layout, summed over the data axes into the moments'
        layout (a reduce-scatter over a dim that shards it, else an
        all-reduce); the f32 loss summed over each data axis of size > 1
        and the grad norm's f32 sum over the world; zero1 adds the moves
        of each parameter between its layouts;
      - over a model axis > 1, each microbatch's tensor-parallel
        collectives (distributed/tensor_parallel.py) on its b = B / (M dp)
        rows: per tensor-parallel attention, the all-gather of each of
        wq / wk / wv / wo whose rows a rank takes are not its chunk and
        its reduce-scatter backward, the all-reduce after wo and the
        gradient's all-reduce before the input, and with qk_norm the two
        norm scales' f32 gradients; per tensor-parallel MLP, the
        all-reduce after w2 (MoE: of the (G, E, C, d) expert outputs) and
        the gradient's before the input (MoE: of the (G, Tg, d) groups);
        per tensor-parallel RG-LRU block, the all-gather of u, (b, S, d)
        in the parameter dtype, and its reduce-scatter backward, the
        all-reduce after w_out, the gradient's all-reduce before its
        input and lam's f32 gradient all-reduce; per RWKV block's time
        mix, the gathers of wr / wk / wv / wg / wo where a rank's heads
        are not its chunk, wb's gather (64 x d) and the decay LoRA's
        (b, S, 64) in the parameter dtype, each with its reduce-scatter
        backward, the all-reduce after wo, ln_x's f32 (b, S, 1) sum of
        squares forward and backward, the input's gradient and eight f32
        (d,) gradients (mu_r, mu_k, mu_v, mu_w, mu_g, w0, u, ln_x's
        scale); per RWKV channel mix, cv's reduce-scatter to (b, S, d /
        tp) and its all-gather backward, the product's all-gather, the
        input's gradient and mu_ck / mu_cr's; whisper's encoder attention
        and MLP at b x n_audio_frames rows, its cross-attention as an
        attention (q and the all-reduces at b S rows; its K / V weights'
        gathers) and one all-reduce of the encoder output's gradient,
        (b, n_audio_frames, d), a microbatch; the vocab-parallel
        embedding's all-reduce, the gradient's before the unembedding,
        and the loss's three f32 all-reduces of (b, S) (the max, the sum
        of exp, the gold logit). Attention with fewer heads than ranks
        counts as any other: a rank with no head makes the same calls.
        With remat the backward replays a block's forward as far as the
        last tensor it saves (torch's checkpoint stops there): the
        attention's gathers and its all-reduce, the cross-attention's
        (and its K / V gathers), the RG-LRU block's gather of u and its
        all-reduce after w_out (the next norm saves the sum), the RWKV
        time mix's gathers and all-reduces and the channel mix's
        reduce-scatter (the gate saves its output), and the MoE's
        all-reduce, whose output the gates' product saves; not the dense
        MLP's, which ends the block, nor the channel mix's final
        all-gather (as measured on the dry run).
    With cfg.seq_shard_acts and S dividing by tp (whisper's encoder on its
    own guard, n_audio_frames), the stream is cut over the model axis
    (sequence parallelism): each module's entry all-gathers its input,
    (b, S, d), forward (and in remat's replay) and reduce-scatters its
    gradient backward, in place of the gradient's all-reduce; its exit
    reduce-scatters the partial sums forward (replayed where the
    all-reduce was) and all-gathers the gradient backward, in place of
    the all-reduce; a module that computes replicated all-gathers its
    input forward and its output's gradient backward. The MoE gathers
    every position, reduce-scatters after the combine (not replayed: it
    ends the block) and all-reduces its f32 router's gradient; the RWKV
    channel mix moves its product by an all-to-all, (b, S / tp, d), each
    way; each stream norm's f32 (d,) gradient is all-reduced; the lookup
    reduce-scatters forward and all-gathers backward (the vlm's lookup
    stays whole and its concatenation's cut all-gathers backward); the
    logits all-gather S forward and reduce-scatter backward; whisper's
    encoder output all-gathers over the frames where they were cut and
    reduce-scatters its gradient."""
    dp_n, tp = _sizes(mesh)
    model = get_api(cfg).init(cfg, tp, device="meta")
    spec = shd.state_pspecs(TrainState(model, {}), mesh, zero1=cfg.zero1)
    cspec = TP.compute_specs(model, mesh)
    names = tuple(mesh.mesh_dim_names)
    dp = dp_axes(mesh)
    out = {"all-gather": 0.0, "all-reduce": 0.0, "reduce-scatter": 0.0,
           "all-to-all": 0.0}
    at_use = not (cfg.pregather or cfg.zero1)
    blocks = {f"{prefix}.{n}" for prefix, blk in
              L.remat_units(model).items() for n, _ in blk.named_parameters()}

    def gathers(shape, pspec, itemsize, to=None, times=1):
        n = math.prod(shd.local_shape(shape, pspec, mesh)) * itemsize
        keep = set(shd._sharded(to, mesh)) if to is not None else set()
        for i, axis, d in reversed(shd._sharded(pspec, mesh)):
            if (i, axis, d) not in keep:
                n *= mesh.shape[i]
                out["all-gather"] += n * times

    for name, p in model.named_parameters():
        size = p.element_size()
        uses = (micro * (2 if cfg.remat and name in blocks else 1)
                if at_use else 1)
        gathers(p.shape, spec.params[name], size, to=cspec[name],
                times=uses)
        grad = spec.opt["m"][name]
        n = math.prod(shd.local_shape(p.shape, cspec[name], mesh)) * size
        dims = {axis: d for _, axis, d in shd._sharded(grad, mesh)}
        for i, axis in enumerate(names):
            if axis not in dp or mesh.shape[i] == 1:
                continue
            if axis in dims:
                n //= mesh.shape[i]
                out["reduce-scatter"] += micro * n
            else:
                out["all-reduce"] += micro * n
        if tuple(spec.params[name]) != tuple(grad):
            gathers(p.shape, spec.params[name], size)   # to the moments'
            gathers(p.shape, grad, size)                # and back
    out["all-reduce"] += 4 * sum(1 for a in dp
                                 if mesh.shape[names.index(a)] > 1)
    if math.prod(mesh.shape) > 1:
        out["all-reduce"] += 4
    if tp > 1:
        for kind, n in _tp_plan(cfg, model, cspec, B // micro // dp_n, S,
                                plan_cell(cfg, B, mesh)[0] // dp_n,
                                tp).items():
            out[kind] += micro * n
    return out


def _block(out: Dict[str, float], X: int, tp: int, sharded: bool,
           seq: bool, enter: int = 1, leave: int = 1,
           backward: bool = True) -> None:
    """Adds to `out` the collectives of tensor_parallel's block_in and
    block_out around one module on a stream of X bytes, each sized by its
    result: `enter` and `leave` the forward runs of each (remat's replay
    counted; 0, a side not run), with `backward` their gradients'
    collectives too. A sharded module: with the stream whole, the
    gradient's all-reduce in and the all-reduce out; with it cut, an
    all-gather in and a reduce-scatter of (b, S / tp, d) out, and the
    reverse backward. A replicated module: nothing with the stream whole;
    with it cut, the all-gather in and, backward, the output's gradient
    all-gathered."""
    if enter:
        if seq:
            out["all-gather"] += X * enter
            if sharded and backward:
                out["reduce-scatter"] += X // tp
        elif sharded and backward:
            out["all-reduce"] += X
    if leave:
        if seq:
            if sharded:
                out["reduce-scatter"] += X // tp * leave
            if backward:
                out["all-gather"] += X
        elif sharded:
            out["all-reduce"] += X * leave


def _tp_plan(cfg: ArchConfig, model, cspec, b: int, S: int, groups: int,
             tp: int) -> Dict[str, float]:
    """One microbatch's tensor-parallel collectives (train_plan)."""
    from repro_torch.models.rglru import RGLRUBlock
    from repro_torch.models.rwkv6 import RWKVBlock, _LORA
    from repro_torch.models.whisper import CrossAttention
    out = {"all-gather": 0.0, "all-reduce": 0.0, "reduce-scatter": 0.0,
           "all-to-all": 0.0}
    cut = {name for name, s in cspec.items() if any(s)}
    ai = L.dtype_of(cfg.param_dtype).itemsize       # the residual stream's
    d, replay = cfg.d_model, 2 if cfg.remat else 1
    F = cfg.n_audio_frames
    T_enc = b * F                                   # whisper's encoder
    sp = cfg.seq_shard_acts and S % tp == 0         # the streams cut
    sp_enc = cfg.seq_shard_acts and F % tp == 0
    spans = TP.attention_spans(cfg, tp)

    def weights(mod, names):
        """The all-gather of each weight whose rows a rank takes are not
        its chunk (each forward run) and its reduce-scatter backward."""
        for n, dim, span in names:
            w = getattr(mod, n)
            if TP.needs_gather(w.shape[dim] // tp, span, tp):
                whole = w.numel() * w.element_size()
                out["all-gather"] += whole * replay
                out["reduce-scatter"] += whole // tp

    attention = tuple((n, 1 if n != "wo" else 0, spans[n])
                      for n in ("wq", "wk", "wv", "wo"))
    for prefix, mod in model.named_modules():
        enc = prefix.startswith("enc_layers.") or prefix == "enc_ln"
        T, seq = (T_enc, sp_enc) if enc else (b * S, sp)
        X = T * d * ai
        if isinstance(mod, L.RMSNorm) and mod.stream and seq:
            out["all-reduce"] += d * 4      # its weight's gradient
        elif isinstance(mod, (L.Attention, CrossAttention)):
            sharded = f"{prefix}.wq" in cut
            # K / V at T_enc, q at b S; remat replays block_out where a
            # later tensor of the block saves its output.
            _block(out, X, tp, sharded, seq, replay, replay)
            if sharded:
                weights(mod, attention)
                if cfg.qk_norm and isinstance(mod, L.Attention):
                    out["all-reduce"] += 2 * cfg.head_dim * 4
        elif isinstance(mod, RGLRUBlock):
            sharded = f"{prefix}.w_in" in cut
            _block(out, X, tp, sharded, seq, replay, replay)
            if sharded:
                out["all-gather"] += X * replay     # u, on every position
                out["reduce-scatter"] += X // tp
                out["all-reduce"] += d * 4          # lam's gradient
        elif isinstance(mod, RWKVBlock):
            sharded = f"{prefix}.wr" in cut
            _block(out, X, tp, sharded, seq, replay, replay)  # time mix
            if sharded:
                dh = cfg.rwkv_head_dim
                chans = TP.head_channels(d // dh, dh, tp)
                weights(mod, tuple((n, 1 if n != "wo" else 0, chans)
                                   for n in ("wr", "wk", "wv", "wg", "wo")))
                whole = mod.wb.numel() * mod.wb.element_size()
                out["all-gather"] += (whole + T * _LORA * ai) * replay
                out["reduce-scatter"] += (whole + T * _LORA * ai) // tp
                # ln_x's f32 sum of squares both ways (replayed), the eight
                # vectors' f32 gradients.
                out["all-reduce"] += T * 4 * (replay + 1) + 8 * d * 4
            if f"{prefix}.ck" in cut:
                # x's entry; cv's reduce-scatter (replayed: the gate saves
                # it) and its all-gather backward; the product into the
                # stream: an all-gather over d (its backward a narrow), or
                # with the stream cut an all-to-all each way; mu_ck /
                # mu_cr's gradients.
                _block(out, X, tp, True, seq, replay, 0)
                out["reduce-scatter"] += X // tp * replay
                out["all-gather"] += X
                if seq:
                    out["all-to-all"] += 2 * X // tp
                else:
                    out["all-gather"] += X
                out["all-reduce"] += 2 * d * 4
            else:
                _block(out, X, tp, False, seq, replay, 1)
        elif isinstance(mod, L.DenseMLP):
            _block(out, X, tp, f"{prefix}.w1" in cut, seq, replay, 1)
        elif isinstance(mod, L.MoE):
            sharded = f"{prefix}.w1" in cut
            if seq:                 # reduce-scattered after the combine
                _block(out, X, tp, sharded, seq, replay, 1)
                if sharded:
                    out["all-reduce"] += d * cfg.n_experts * 4  # router
            elif sharded:           # the (G, E, C, d) expert outputs
                G = min(groups, T)
                C = max(1, int(cfg.top_k * (T // G) * 1.25 / cfg.n_experts))
                out["all-reduce"] += G * cfg.n_experts * C * d * ai * replay \
                    + X
    X = b * S * d * ai
    text = S - (min(cfg.n_patch_tokens, S // 2)
                if cfg.family == "vlm" else 0)
    if cfg.family == "vlm" or not sp:   # the lookup, whole
        if "embed" in cut:
            out["all-reduce"] += b * text * d * ai
        if sp:                          # the concatenation cut
            out["all-gather"] += X
    else:
        _block(out, X, tp, "embed" in cut, sp, enter=0)
    _block(out, X, tp, "unembed" in cut, sp, leave=0)
    if "unembed" in cut:                # the loss's max, sum of exp, gold
        out["all-reduce"] += b * S * 3 * 4
    if cfg.family == "encdec":          # the encoder output, once
        _block(out, T_enc * d * ai, tp,
               any(n.endswith(".xattn.wq") for n in cut), sp_enc, leave=0)
    return out


def serve_plan(cfg: ArchConfig, kind: str, mesh, B: int,
               S: int) -> Dict[str, float]:
    """The collective bytes by kind that one serving step ("prefill" of B
    prompts of S tokens, or "decode" of B tokens) moves on rank 0 of
    `mesh` (measure's serving cells), each sized by its result as
    op_analysis sizes it. The rank runs b = B / dp rows at groups / dp
    where B divides by the data axes' size dp, else all B at groups
    (plan_cell), each row S_q positions (S, less the vlm's patch prefix,
    which serving does not take; 1 to decode), T = b S_q tokens; d wide
    in the parameter dtype. Per unit that serve_cuts cuts:
      - each attention and cross-attention, the all-reduce after wo, (b,
        S_q, d); whisper's encoder attention runs at prefill only, on its
        b n_audio_frames frames;
      - each dense MLP, the all-reduce after w2 (the encoder's at its
        frames); each MoE, of the (G, E, C, d) expert outputs, G =
        min(groups, T), C = max(1, int(top_k (T / G) 1.25 / E));
      - each RG-LRU block, the all-gather of u, (b, S_q, d) (in the
        parameter dtype: measure's bf16 conv state promotes to it), and
        the all-reduce after w_out;
      - each RWKV time mix, the all-reduce after wo and ln_x's f32 sum of
        squares, (b, S_q, 1); each channel mix, the reduce-scatter after
        cv, (b, S_q, d / tp), and the all-gather into the stream, (b,
        S_q, d);
      - the vocab-parallel lookup's all-reduce, (b, S_q, d);
      - the last position's f32 logits all-gathered over the model axis,
        (b, V), where the vocabulary is cut, then over each data axis of
        size > 1, innermost first, where the rows were split, (B, V) at
        the last;
    and no weight's collective. With cfg.seq_shard_acts and S_q dividing
    by tp (whisper's encoder on its n_audio_frames), each unit's
    all-reduce becomes an all-gather of its input, (b, S_q, d), and a
    reduce-scatter of its output, (b, S_q / tp, d) (a replicated unit:
    the all-gather alone; the MoE's at the tokens, not its expert
    outputs); the channel mix's all-gather into the stream an all-to-all,
    (b, S_q / tp, d); the lookup's a reduce-scatter; the last position
    all-gathered from the ranks' last rows, (b, tp, d); and whisper's
    encoder output all-gathered over its frames where they were cut."""
    from repro_torch.models.rglru import RGLRUBlock
    from repro_torch.models.rwkv6 import RWKVBlock
    from repro_torch.models.whisper import CrossAttention
    out = {"all-gather": 0.0, "all-reduce": 0.0, "reduce-scatter": 0.0,
           "all-to-all": 0.0}
    dp_n, tp = _sizes(mesh)
    groups, _ = plan_cell(cfg, B, mesh)
    split = dp_n > 1 and B % dp_n == 0
    b, groups = (B // dp_n, groups // dp_n) if split else (B, groups)
    model = get_api(cfg).init(cfg, tp, device="meta")
    cuts = TP.serve_cuts(model, mesh, 0)
    if kind == "prefill":
        S_q = S - (min(cfg.n_patch_tokens, S // 2)
                   if cfg.family == "vlm" else 0)
    else:
        S_q = 1
    T, d = b * S_q, cfg.d_model
    T_enc = b * cfg.n_audio_frames if kind == "prefill" else 0
    ai = L.dtype_of(cfg.param_dtype).itemsize
    sp = tp > 1 and cfg.seq_shard_acts and S_q % tp == 0
    sp_enc = tp > 1 and cfg.seq_shard_acts and cfg.n_audio_frames % tp == 0

    def unit(X, sharded, seq):
        _block(out, X, tp, sharded, seq, backward=False)

    for prefix, mod in model.named_modules():
        n, seq = ((T_enc, sp_enc) if prefix.startswith("enc_layers.")
                  else (T, sp))
        X = n * d * ai
        if isinstance(mod, (L.Attention, CrossAttention)):
            unit(X, f"{prefix}.wq" in cuts, seq)
        elif isinstance(mod, L.DenseMLP):
            unit(X, f"{prefix}.w1" in cuts, seq)
        elif isinstance(mod, L.MoE):
            if f"{prefix}.w1" in cuts and not seq:
                G = min(groups, T)
                C = max(1, int(cfg.top_k * (T // G) * 1.25 / cfg.n_experts))
                out["all-reduce"] += G * cfg.n_experts * C * d * ai
            else:
                unit(X, f"{prefix}.w1" in cuts, seq)
        elif isinstance(mod, RGLRUBlock):
            unit(X, f"{prefix}.w_in" in cuts, seq)
            if f"{prefix}.w_in" in cuts:
                out["all-gather"] += X
        elif isinstance(mod, RWKVBlock):
            unit(X, f"{prefix}.wr" in cuts, seq)
            if f"{prefix}.wr" in cuts:
                out["all-reduce"] += T * 4
            if f"{prefix}.ck" in cuts:
                out["reduce-scatter"] += T * (d // tp) * ai
                if seq:
                    out["all-gather"] += X
                    out["all-to-all"] += X // tp
                else:
                    out["all-gather"] += X
            else:
                unit(X, False, seq)
    _block(out, T * d * ai, tp, "embed" in cuts, sp, enter=0,
           backward=False)
    if sp:
        out["all-gather"] += b * tp * d * ai        # the last position
    if cfg.family == "encdec":                      # the encoder output
        _block(out, T_enc * d * ai, tp, True, sp_enc, leave=0,
               backward=False)
    V = model.vocab
    if "unembed" in cuts:
        out["all-gather"] += b * V * 4
    if split:
        sizes, rows = mesh_axis_sizes(mesh), b
        for a in reversed(dp_axes(mesh)):
            if sizes[a] > 1:
                rows *= sizes[a]
                out["all-gather"] += rows * V * 4
    return out


def held_bytes(cfg: ArchConfig, kind: str, B: int, S: int,
               mesh) -> Dict[str, int]:
    """What rank 0 of the port holds in a serving cell (no world needed:
    `mesh` may be a sharding.MeshShape): {"params", "cache"}: its serving
    shards (tensor_parallel.serve_cuts) and every leaf of its bf16 cache
    (the hybrid's h and the ssm's s f32) at serve_cache_shape, as
    measure runs them."""
    api = get_api(cfg)
    _, tp = _sizes(mesh)
    model = api.init(cfg, tp, device="meta")
    cuts = TP.serve_cuts(model, mesh, 0)
    params = 0
    for name, p in model.named_parameters():
        n = p.numel()
        if name in cuts:
            dim, a, b = cuts[name]
            n = n // p.shape[dim] * (b - a)
        params += n * p.element_size()
    whole = specs.cache_specs(cfg, api, B, S, abstract=True)
    cache = sum(math.prod(TP.serve_cache_shape(cuts, tuple(t.shape), mesh,
                                               key)) * t.element_size()
                for key, t in whole.items() if isinstance(t, torch.Tensor))
    return {"params": params, "cache": cache}


def block_bytes(cfg: ArchConfig, mesh) -> Dict[str, int]:
    """{prefix: bytes} of each block's parameters (layers.remat_units) in
    the layout a rank computes them in (tensor_parallel.compute_specs):
    what the gather at each use brings in for the block (no world
    needed: `mesh` may be a sharding.MeshShape)."""
    _, tp = _sizes(mesh)
    model = get_api(cfg).init(cfg, tp, device="meta")
    spec = TP.compute_specs(model, mesh)
    return {prefix: sum(
        math.prod(shd.local_shape(p.shape, spec[f"{prefix}.{n}"], mesh))
        * p.element_size() for n, p in blk.named_parameters())
        for prefix, blk in L.remat_units(model).items()}


def measure(cfg: ArchConfig, kind: str, B: int, S: int, mesh) -> dict:
    """Build rank 0's fake state and inputs for one cell on `mesh` (a
    make_dryrun_mesh world), run its step under op_analysis and return
    the cell's record (module docstring; a train cell's param_gather is
    "at each use" unless cfg.pregather or cfg.zero1 make it "once a
    step") and, under "analysis", the analysis in bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    api = get_api(cfg)
    _, tp = _sizes(mesh)
    groups, micro = plan_cell(cfg, B, mesh)
    t0 = time.perf_counter()
    with FakeTensorMode():
        model = _fake(api.init(cfg, tp, device="meta"))
        if kind == "train":
            cfg_run = dataclasses.replace(cfg, microbatches=micro)
            state = TrainState(model, adamw_init(
                dict(model.named_parameters()),
                AdamWConfig(moment_dtype=cfg.optimizer_dtype)))
            pregather = (shd.param_pspecs(model, mesh, use_fsdp=False)
                         if cfg.pregather else None)
            grad_spec = shd.param_pspecs(model, mesh, use_fsdp=True)
            state = shard_train_state(state, mesh, zero1=cfg.zero1)
            batch = _fake(specs.train_inputs(cfg, S, B, abstract=True))
            step = make_train_step(cfg_run, api, groups,
                                   pregather_spec=pregather,
                                   grad_spec=grad_spec, mesh=mesh)
            args = (state, batch)
        else:
            micro = 1
            TP.shard_for_serving(model, mesh)
            cache = TP.serve_cache(model, B, S)
            if kind == "prefill":
                inputs = _fake(specs.prefill_inputs(cfg, S, B,
                                                    abstract=True))
                step = make_prefill_step(cfg, api, groups, mesh=mesh)
            else:
                inputs = _fake(specs.decode_tokens(cfg, B, abstract=True))
                step = make_decode_step(cfg, api, groups, mesh=mesh)
            args = (model, inputs, cache)
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        with shd.activation_sharding(
                dp_axes(mesh), seq_div=tp,
                seq_axis="model" if cfg.seq_shard_acts else None):
            res = analyze(step, *args)
        t_run = time.perf_counter() - t0
        del res["result"], args
    mem = res["memory"]
    rules = rules_bytes(cfg, kind, B, S, mesh)
    gather = ({"param_gather": "once a step" if cfg.pregather or cfg.zero1
               else "at each use"} if kind == "train" else {})
    return {
        "status": "ok", **gather,
        "lower_s": round(t_build, 1), "compile_s": round(t_run, 1),
        "n_devices": int(math.prod(mesh.shape)),
        "memory": {"argument_mb": _mb(mem["argument"]),
                   "output_mb": _mb(mem["output"]),
                   "temp_mb": _mb(mem["temp"]),
                   "peak_mb": _mb(mem["argument"] + mem["temp"])},
        "cost": {"flops": res["flops"],
                 "bytes_accessed": res["traffic_bytes"]},
        "hlo_flops": res["flops"],
        "hlo_traffic_bytes": res["traffic_bytes"],
        "collectives": {"bytes": res["collective_bytes"],
                        "counts": res["collective_counts"],
                        "total_bytes": res["collective_total"]},
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "microbatches": micro,
        "groups": groups,
        "rules_mb": {**{k: _mb(v) for k, v in rules.items()},
                     "total": _mb(sum(rules.values()))},
        "analysis": {**res, "rules": rules, "build_s": t_build,
                     "run_s": t_run},
    }


def _write(res: dict, out_dir: str, name: str) -> None:
    path = pathlib.Path(out_dir)
    path.mkdir(parents=True, exist_ok=True)
    (path / name).write_text(json.dumps(res, indent=1))


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             overrides: Optional[dict] = None) -> dict:
    """One cell (module docstring); writes {arch}__{shape}__{sp|mp}.json
    under out_dir and returns its record."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    ok, why = specs.cell_supported(cfg, shape)
    res = {"arch": arch, "shape": shape,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    name = f"{arch}__{shape}__{'mp' if multi_pod else 'sp'}.json"
    if not ok:
        res.update(status="skipped", reason=why)
        _write(res, out_dir, name)
        return res
    sh = specs.SHAPES[shape]
    mesh = make_dryrun_mesh(multi_pod)
    try:
        rec = measure(cfg, sh["kind"], sh["batch"], sh["seq"], mesh)
    finally:
        destroy_dryrun_mesh(mesh)
    rec.pop("analysis")
    res.update(rec)
    _write(res, out_dir, name)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(specs.SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--overrides", default="",
                    help="JSON dict of ArchConfig overrides")
    args = ap.parse_args(argv)
    overrides = json.loads(args.overrides) if args.overrides else None
    res = run_cell(args.arch, args.shape, args.multipod, args.out,
                   overrides)
    print(json.dumps(res, indent=1))
    if res["status"] == "ok":
        gather = (f" params gathered {res['param_gather']}"
                  if "param_gather" in res else "")
        print(f"\nOK {args.arch} x {args.shape} [{res['mesh']}]{gather} "
              f"peak={res['memory']['peak_mb']} MiB/rank "
              f"rules={res['rules_mb']['total']} MiB "
              f"flops={res['hlo_flops']:.3e} "
              f"coll={res['collectives']['total_bytes']:.3e}B")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
