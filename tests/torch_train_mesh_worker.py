"""One rank of a gloo world for tests/test_torch_train_mesh.py.

    python tests/torch_train_mesh_worker.py RANK DATA MODEL WORKDIR [cases]

WORKDIR holds `store` (the FileStore), `cases.json` (each case's arch,
config cut and the worlds it runs on) and `inputs.npz` (each case's
weights by the port's parameter names and its batch). On the (DATA,
MODEL) mesh the rank trains each of its cases STEPS steps with the
sharded step (tensor-parallel over MODEL > 1 for every family) and, at
world (2, 1) and (1, 2), runs the launcher (`launch.train.run`) as the
test asks. Rank 0 writes the metrics and the
whole state gathered after every step to `out.npz`, and, over a model
axis, the shape each parameter has when its module runs in the first
step (a forward pre-hook). Where the step gathers each parameter at its
use (no zero1, no pregather_spec) on a data axis of size > 1, rank 0
also writes, for the first step, the shape of every other block's
parameters when a block first runs (a forward pre-hook on each block),
how many times each parameter's gather at use ran a collective, and
how many gradient reductions the step made. A case with "seq" true steps inside
sharding.activation_sharding(seq_axis="model", seq_div=MODEL), JAX's
seq_shard_acts switch. With the optional last argument `cases` the rank
runs the cases alone (no launcher, checkpoint or zero1 runs). No JAX
runs here and no check asserts here: the test compares.
"""
import contextlib
import dataclasses
import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.distributed import sharding
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.sharding import (activation_sharding,
                                              param_pspecs)
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import (dp_axes, make_debug_mesh, open_world,
                                     run_process)
from repro_torch.models import get_api
from repro_torch.models.layers import remat_units
from repro_torch.train import steps as train_steps
from repro_torch.train import (AdamWConfig, TrainState, adamw_init,
                               init_train_state, make_train_step,
                               shard_train_state)

STEPS, LR = 3, 3e-3
# The launcher's runs: the smoke phi4 at B 4 x S 32, M 1.
LAUNCH = ["--device", "cpu", "--smoke", "--arch", "phi4-mini-3.8b",
          "--batch", "4", "--seq", "32"]
SKETCH = ["--sketch-grads", "4096", "--steps", "4"]


def whole_state(state, res, key):
    """The state gathered whole (every rank gathers); rank 0 keeps it."""
    tree = launch_train.state_tree(state, keep=dist.get_rank() == 0)
    if dist.get_rank() != 0:
        return
    for name, t in tree["params"].items():
        res[f"{key}/params/{name}"] = t.detach().float().numpy().copy()
    for mom in ("m", "v"):
        for name, t in tree["opt"][mom].items():
            res[f"{key}/{mom}/{name}"] = t.detach().float().numpy().copy()
    res[f"{key}/step"] = np.asarray(int(tree["opt"]["step"]))


def record_shapes(model, res, key):
    """Forward pre-hooks that record each parameter's shape when its
    module runs (the first call); returns the hooks' handles."""
    def pre(mod, _args, prefix):
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{prefix}.{pname}" if prefix else pname
            res.setdefault(f"{key}/shape/{name}", np.asarray(p.shape))
    return [mod.register_forward_pre_hook(
        lambda m, a, prefix=prefix: pre(m, a, prefix))
        for prefix, mod in model.named_modules()]


def record_held(model, res, key):
    """Forward pre-hooks on each block (layers.remat_units) that record,
    when it first runs, the shape every other block's parameters have
    then; returns the hooks' handles."""
    units = remat_units(model)

    def pre(prefix):
        def hook(_mod, _args):
            for other, blk in units.items():
                if other == prefix:
                    continue
                for pname, p in blk.named_parameters():
                    res.setdefault(f"{key}/held/{prefix}/{other}.{pname}",
                                   np.asarray(p.shape))
        return hook
    return [blk.register_forward_pre_hook(pre(prefix))
            for prefix, blk in units.items()]


class CountUses:
    """Within it, per parameter, the gathers at use that ran a collective
    (sharding.gather called on the parameter itself returning another
    tensor), and the gradient reductions of the step (its reduce_shard)
    into res under key."""

    def __init__(self, model, res, key):
        self.names = {id(p): n for n, p in model.named_parameters()}
        self.res, self.key = res, key
        self.gathers = dict.fromkeys(self.names.values(), 0)
        self.reductions = 0

    def __enter__(self):
        gather, reduce = sharding.gather, train_steps.reduce_shard

        def counted_gather(t, *args, **kwargs):
            out = gather(t, *args, **kwargs)
            if id(t) in self.names and out is not t:
                self.gathers[self.names[id(t)]] += 1
            return out

        def counted_reduce(*args, **kwargs):
            self.reductions += 1
            return reduce(*args, **kwargs)

        self.saved = gather, reduce
        sharding.gather = counted_gather
        train_steps.reduce_shard = counted_reduce
        return self

    def __exit__(self, *exc):
        sharding.gather, train_steps.reduce_shard = self.saved
        for name, n in self.gathers.items():
            self.res[f"{self.key}/gathers/{name}"] = np.asarray(n)
        self.res[f"{self.key}/reductions"] = np.asarray(self.reductions)


def train_case(mesh, data, tp, inp, case, res, zero1=False,
               pregather=False):
    """STEPS sharded steps of `case`; with zero1, the parameters stored
    TP-only and the gradients reduce-scattered into that layout too
    (grad_spec), so both move to the moments' layout for AdamW; with
    pregather, JAX's TP-only pregather_spec."""
    cfg = dataclasses.replace(get_config(case["arch"], smoke=True),
                              **case["cut"])
    api = get_api(cfg)
    model = api.init(cfg, tp, device="meta").to_empty(device="cpu")
    name = case["case"]
    with torch.no_grad():
        for pname, p in model.named_parameters():
            p.copy_(torch.from_numpy(inp[f"{name}/w/{pname}"]))
    batch = {k[len(f"{name}/b/"):]: torch.from_numpy(v)
             for k, v in inp.items() if k.startswith(f"{name}/b/")}
    opt = AdamWConfig(lr=LR)
    tp_only = param_pspecs(model, mesh, use_fsdp=False)
    state = shard_train_state(TrainState(model, adamw_init(
        dict(model.named_parameters()), opt)), mesh, zero1=zero1)
    step = make_train_step(cfg, api, groups=data, opt_cfg=opt,
                           grad_spec=tp_only if zero1 else None,
                           pregather_spec=tp_only if pregather else None,
                           mesh=mesh)
    key = (f"{name}-zero1" if zero1 else
           f"{name}-pregather" if pregather else name)
    at_use = data > 1 and not (zero1 or pregather)
    hooks = (record_shapes(model, res, key)
             if tp > 1 and not (zero1 or pregather) else [])
    if at_use:
        hooks += record_held(model, res, key)
    seq = "model" if case.get("seq") else None
    for i in range(1, STEPS + 1):
        with activation_sharding(dp_axes(mesh), seq_axis=seq, seq_div=tp), \
                (CountUses(model, res, key) if at_use and i == 1
                 else contextlib.nullcontext()):
            _, m = step(state, batch)
        for h in hooks:
            h.remove()
        hooks = []
        res[f"{key}/{i}/loss"] = np.asarray(float(m["loss"]))
        res[f"{key}/{i}/grad_norm"] = np.asarray(float(m["grad_norm"]))
        whole_state(state, res, f"{key}/{i}")


def refused(mesh, case, inp, res):
    """A batch whose microbatch rows do not split over the data ranks is
    refused before any collective runs."""
    cfg = get_config(case["arch"], smoke=True)
    api = get_api(cfg)
    state = shard_train_state(init_train_state(
        cfg, api, tp=1, device="cpu"), mesh)
    step = make_train_step(cfg, api, groups=2, mesh=mesh)
    batch = {k[len(case["case"]) + 3:]: torch.from_numpy(v[:3])
             for k, v in inp.items() if k.startswith(f"{case['case']}/b/")}
    try:
        step(state, batch)
        res["refused"] = np.asarray("")
    except ValueError as exc:
        res["refused"] = np.asarray(str(exc))


def launch(data, tp, argv, res, key):
    out = launch_train.run(launch_train.build_parser().parse_args(
        LAUNCH + ["--data", str(data), "--model", str(tp)] + argv))
    res[f"{key}/losses"] = np.asarray(out["losses"])
    res[f"{key}/start"] = np.asarray(out["start"])
    if "ratio" in out:
        res[f"{key}/ratio"] = np.asarray(out["ratio"])
    whole_state(out["state"], res, key)


def restored(workdir, data, tp, res):
    """A fresh sharded launcher state with the (2, 1) checkpoint restored
    into it, gathered whole."""
    mesh = make_debug_mesh(data, tp, device="cpu")
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    state = shard_train_state(init_train_state(
        cfg, get_api(cfg), tp=tp, device="cpu",
        generator=torch.Generator().manual_seed(5)), mesh)
    at = launch_train.restore_into(
        CheckpointManager(os.path.join(workdir, "ckpt")), state)
    res["restored/at"] = np.asarray(at)
    whole_state(state, res, "restored")


def main():
    rank, data, tp, workdir = (int(sys.argv[1]), int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
    world = data * tp
    torch.set_num_threads(1)
    with open_world("cpu", datetime.timedelta(seconds=120),
                    store=dist.FileStore(os.path.join(workdir, "store"),
                                         world), rank=rank, size=world):
        run(rank, data, tp, workdir)


def run(rank, data, tp, workdir):
    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    with open(os.path.join(workdir, "cases.json")) as f:
        cases = json.load(f)
    mesh = make_debug_mesh(data, tp, device="cpu")
    res = {}
    for case in cases:
        if [data, tp] in case["worlds"]:
            train_case(mesh, data, tp, inp, case, res)
    ckpt = os.path.join(workdir, "ckpt")
    if sys.argv[5:] == ["cases"]:
        pass
    elif (data, tp) == (2, 1):
        refused(mesh, cases[0], inp, res)
        launch(data, tp, SKETCH, res, "sketch")
        launch(data, tp, ["--steps", "2", "--ckpt-dir", ckpt,
                          "--ckpt-every", "2"], res, "saved")
        launch(data, tp, ["--steps", "4"], res, "whole")
    elif (data, tp) == (2, 2):
        train_case(mesh, data, tp, inp, cases[0], res, zero1=True)
        train_case(mesh, data, tp, inp, cases[0], res, pregather=True)
    elif (data, tp) == (1, 2):
        restored(workdir, data, tp, res)
        launch(data, tp, ["--steps", "4", "--ckpt-dir", ckpt,
                          "--ckpt-every", "100"], res, "resumed")
    if rank == 0:
        np.savez(os.path.join(workdir, "out.npz"), **res)
    dist.barrier()


if __name__ == "__main__":
    run_process(main)
