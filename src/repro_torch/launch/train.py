"""Training launcher: mesh + sharded state + sketched gradients +
checkpoint / restart (the port of repro/launch/train.py).

It does what the JAX launcher does: the config (the smoke config with
--smoke), a (--data, --model) mesh built always (make_debug_mesh; a world
of one rank without torchrun, NCCL on the card, gloo on the CPU), random
weights at tp = --model (drawn from --seed; JAX's PRNGKey(0)) sharded by
state_pspecs and computed tensor-parallel over --model > 1 for every
family (distributed/tensor_parallel.py), a fixed synthetic batch
(specs.train_inputs from a generator seeded 7, JAX's PRNGKey(7)) that
the model must drive the loss down on, the train step of
train/steps.py on the mesh (cfg.microbatches, cfg.remat, AdamW at --lr,
JAX's groups = --data), a CheckpointManager
under --ckpt-dir saving every --ckpt-every steps and restoring the newest
checkpoint first, the same printed lines and the assertion that the loss
fell. As JAX's launcher, it passes the step no pregather_spec: the step
gathers each parameter over "data" at its use. A line before them gives
the bytes of the parameters in the layouts they are computed in, which a
rank holds a block at a time. A further
line gives the warm step time (the steps after the
first), tokens/s, on the card the peak device memory, and with
--sketch-grads the transform's time a step.

--sketch-grads r': JAX's sketched gradients with error feedback
(distributed/compression.py), a round's draw seeded from a counter t that
starts at 0 in each run, the error feedback not checkpointed (JAX's
semantics). The gradients are not reduced over the data axis: each rank
compresses its own and the r'-float sketch is averaged over "data", which
by linearity is JAX's projection of the global gradient.

Checkpoints: rank 0 writes whole leaves, gathered one at a time (the
other ranks drop their gathered copies at once), in the layout a one-rank
save writes: {"params": {name: tensor}, "opt": {"m": {name: tensor},
"v": {name: tensor}, "step": tensor}}. A restore reads
them into host tensors on every rank and copies this rank's chunk of each
into the live state, which the step updates in place (a second copy of
phi4-mini's 44.5 GB training state would not fit beside the first on one
card); so a checkpoint written on one mesh restores on any other.

Differences from the JAX launcher: a world of --data x --model ranks is
started by torchrun (one process per rank), not by one controller; the
batch's rows per microbatch must divide by --data; --smoke is --smoke /
--no-smoke and defaults to off, as JAX's store_true does; the saves are
waited for before the launcher returns.

Runs on the card unless --device cpu is given; without a card it stops.
On the card TF32 is off and bf16 GEMMs reduce in f32, as XLA's do.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \
      --arch qwen3-14b --steps 20 --batch 4 --seq 64 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src torchrun --nproc_per_node 2 -m repro_torch.launch.train \
      --device cpu --smoke --data 2 --steps 20 --sketch-grads 4096
  PYTHONPATH=src python -m repro_torch.launch.train --no-smoke \
      --arch phi4-mini-3.8b --batch 4 --seq 512 --steps 8
"""
from __future__ import annotations

import argparse
import math
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.distributed.checkpoint import (CheckpointManager, _flatten,
                                                _unflatten,
                                                wait_for_async_saves)
from repro_torch.distributed.compression import (compression_ratio,
                                                 make_sketched_grad_transform)
from repro_torch.distributed.sharding import gather, local_shard
from repro_torch.distributed.tensor_parallel import compute_bytes
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_debug_mesh, open_world, run_process
from repro_torch.launch.serve import set_matmul_precision
from repro_torch.models.registry import get_api
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.steps import (TrainState, init_train_state,
                                     make_train_step, shard_train_state)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=False, help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--data", type=int, default=1, help="data-axis size")
    ap.add_argument("--model", type=int, default=1, help="model-axis size")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--sketch-grads", type=int, default=0,
                    help="r' for SRHT gradient compression (0 = off)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap


class _Slot:
    """One leaf of the checkpoint: the live tensor, its spec (None where
    the state is not sharded) and the whole leaf's shape."""
    __slots__ = ("t", "spec", "shape")

    def __init__(self, t, spec, shape):
        self.t, self.spec, self.shape = t, spec, shape


def _slots(state: TrainState) -> dict:
    """The checkpoint's tree, {"params", "opt"}, of _Slot leaves."""
    model = state.params
    lay = getattr(model, "shard_layout", None)

    def slots(named, specs):
        return {name: _Slot(t, None, t.shape) if lay is None
                else _Slot(t, specs[name], lay.shapes[name])
                for name, t in named.items()}

    step = state.opt["step"]
    return {"params": slots(dict(model.named_parameters()),
                            lay and lay.params),
            "opt": {"m": slots(state.opt["m"], lay and lay.moments),
                    "v": slots(state.opt["v"], lay and lay.moments),
                    "step": _Slot(step, None, step.shape)}}


def state_tree(state: TrainState, keep: bool = True) -> dict:
    """The state as the checkpoint holds it: {"params", "opt"}, each leaf
    whole. A sharded state's leaves are gathered one at a time (collective:
    every rank calls it), each gathered copy moved to the host at once; a
    leaf that no mesh dim of size > 1 shards is the live tensor itself.
    keep=False (a rank that does not write) drops each gathered copy as
    its collective returns: the leaf stands as None, so only the writing
    rank holds the whole state on the host."""
    tree = _slots(state)
    lay = getattr(state.params, "shard_layout", None)

    def whole(slot):
        if slot.spec is None:
            return slot.t
        t = gather(slot.t, slot.spec, lay.mesh)
        if t is slot.t:
            return t
        return t.cpu() if keep else None

    return _unflatten(tree, (whole(slot) for _, slot in _flatten(tree)))


def _host_like(slot: _Slot) -> torch.Tensor:
    """A CPU tensor of the whole leaf's shape and dtype holding no memory:
    restore reads each leaf into host memory, not beside the live state
    on the card."""
    return torch.empty((), dtype=slot.t.dtype).expand(slot.shape)


@torch.no_grad()
def restore_into(mgr: CheckpointManager, state: TrainState) -> int:
    """Copy the newest checkpoint into the live state, this rank's chunk
    of each leaf where the state is sharded; returns its step
    (FileNotFoundError when there is none)."""
    tree = _slots(state)
    lay = getattr(state.params, "shard_layout", None)
    slots = [slot for _, slot in _flatten(tree)]
    restored, step = mgr.restore_latest(_unflatten(
        tree, (_host_like(slot) for slot in slots)))
    for slot, (_, src) in zip(slots, _flatten(restored)):
        if slot.spec is not None:
            src = local_shard(src, slot.spec, lay.mesh)
        slot.t.copy_(src)
    return step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace) -> dict:
    """Train on the (--data, --model) mesh; print the JAX launcher's lines
    and the speed line (on rank 0); return the state (this rank's
    shards), config, mesh, losses, grad norms, the first step run
    (`start`), each step's seconds, the warm numbers and, with
    --sketch-grads, the compression ratio and each transform's ms. A
    process group that this call made ends before it returns
    (launch/mesh.py open_world)."""
    kind = torch.device(args.device).type
    with open_world(kind):
        return _train(args, make_debug_mesh(args.data, args.model,
                                            device=kind))


def _train(args: argparse.Namespace, mesh) -> dict:
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        set_matmul_precision()
        torch.cuda.reset_peak_memory_stats(device)
    rank0 = dist.get_rank() == 0
    cfg = get_config(args.arch, smoke=args.smoke)
    api = get_api(cfg)
    state = init_train_state(
        cfg, api, tp=args.model, device=device,
        generator=torch.Generator(device).manual_seed(args.seed))
    out = {}
    grad_transform = None
    if args.sketch_grads:
        # Built on the whole parameters, before they are cut to shards.
        transform, init_ef = make_sketched_grad_transform(
            state.params, r_prime=args.sketch_grads, axis="data", mesh=mesh)
        out["ratio"] = compression_ratio(state.params, args.sketch_grads)
        ef = {"ef": init_ef(), "t": 0}
        out["transform_ms"] = []

        def grad_transform(grads):
            _sync(device)
            t = time.perf_counter()
            g, ef["ef"] = transform(grads, ef["ef"], torch.Generator(
                device).manual_seed(ef["t"]))
            ef["t"] += 1
            _sync(device)
            out["transform_ms"].append((time.perf_counter() - t) * 1e3)
            return g

    state = shard_train_state(state, mesh)
    opt_cfg = AdamWConfig(lr=args.lr, moment_dtype=cfg.optimizer_dtype)
    # A fixed synthetic corpus: the model must drive loss down on it.
    batch = specs.train_inputs(cfg, args.seq, args.batch,
                               torch.Generator(device).manual_seed(7))
    mgr = (CheckpointManager(args.ckpt_dir, save_every=args.ckpt_every)
           if args.ckpt_dir else None)
    start = 0
    if mgr is not None:
        try:
            start = restore_into(mgr, state)
            if rank0:
                print(f"restored checkpoint at step {start}")
        except FileNotFoundError:
            pass

    step_fn = make_train_step(cfg, api, groups=args.data,
                              grad_transform=grad_transform,
                              opt_cfg=opt_cfg, mesh=mesh)
    shapes = state.params.shard_layout.shapes
    out["compute_param_bytes"] = compute_bytes(state.params, mesh, shapes)
    if rank0:
        whole = sum(math.prod(shapes[n]) * p.element_size()
                    for n, p in state.params.named_parameters())
        print(f"parameters held a rank while computing: "
              f"{out['compute_param_bytes']} bytes of {whole} "
              f"(--data {args.data} --model {args.model}; gathered at "
              f"each use, a block at a time)", flush=True)
    losses, gnorms, step_s = [], [], []
    t0 = time.time()
    for step in range(start, args.steps):
        _sync(device)
        t_step = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t_step)
        gnorms.append(float(metrics["grad_norm"]))
        if mgr is not None and (step + 1) % mgr.save_every == 0:
            tree = state_tree(state, keep=rank0)   # every rank gathers
            if rank0:
                mgr.maybe_save(step + 1, tree)
            del tree
        if rank0 and (step % 10 == 0 or step == args.steps - 1):
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {gnorms[-1]:.3f} "
                  f"({(time.time()-t0):.1f}s)", flush=True)
    wait_for_async_saves()
    if not losses:
        raise SystemExit(f"nothing to train: the checkpoint is at step "
                         f"{start} and --steps is {args.steps}")
    warm = step_s[1:] or step_s
    warm_s = sum(warm) / len(warm)
    out.update({"state": state, "cfg": cfg, "mesh": mesh, "losses": losses,
                "grad_norms": gnorms, "start": start, "step_s": step_s,
                "warm_ms": warm_s * 1e3,
                "tokens_per_s": args.batch * args.seq / warm_s})
    peak = "not measured"
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        peak = f"{out['peak_bytes'] / 1e9:.3f} GB"
    sketch = ""
    if args.sketch_grads:
        ms = out["transform_ms"][1:] or out["transform_ms"]
        sketch = (f"; sketched gradients r' {args.sketch_grads} (ratio "
                  f"{out['ratio']:.4f}), transform {sum(ms) / len(ms):.1f} "
                  f"ms a step")
    if rank0:
        print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
        print(f"device {device.type}: warm step {out['warm_ms']:.1f} ms "
              f"over {len(warm)} steps, {out['tokens_per_s']:.1f} tokens/s; "
              f"peak device memory {peak}{sketch}", flush=True)
    if not losses[-1] < losses[0]:
        raise AssertionError("loss did not decrease")
    return out


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.data < 1 or args.model < 1:
        ap.error("--data and --model must be at least 1")
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if args.data * args.model != world:
        ap.error(f"--data {args.data} x --model {args.model} is a mesh of "
                 f"{args.data * args.model} ranks and the world has {world}:"
                 f" start one process per rank (torchrun --nproc_per_node "
                 f"{args.data * args.model})")
    if args.sketch_grads < 0:
        ap.error("--sketch-grads is r', at least 0 (0 = off)")
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        ap.error("no CUDA device is available; pass --device cpu to train "
                 "on the CPU")
    run(args)
    return 0


if __name__ == "__main__":
    run_process(main)
