"""The sharded train step, the mesh launcher and its checkpoints against
repro.train on the CPU, over gloo worlds.

Seven cases at the smoke configs (phi4-mini-3.8b at M 1, at M 2 with
remat, and with 6 query heads over 2 KV heads of width 16, "phi4-h6";
mixtral-8x7b, rwkv6-1.6b, recurrentgemma-2b, whisper-large-v3), JAX's
weights (seed 0) carried into the port and JAX's batch (PRNGKey(1), 4
rows a microbatch, tests/test_torch_train.py's batch, at which its
tolerances were set, x S 16), train 3 steps at the launcher's lr 3e-3 on
the gloo worlds (data, model) = (2, 1), (1, 2), (2, 2), (4, 1), (1, 4)
(`tests/torch_train_mesh_worker.py`, one process per rank, a FileStore in
the test's tmp dir, run one world after another while JAX computes its
references): the first six cases on the first four worlds, phi4-h6 on the
worlds with a model axis, and phi4, phi4-m2, mixtral, phi4-h6, rwkv6,
recurrentgemma and whisper on (1, 4). Over a model axis every case
computes tensor-parallel (distributed/tensor_parallel.py); at (1, 4)
phi4-h6's wq chunk is 1.5 heads and a KV head spans two ranks' chunks of
wk, as phi4-mini's at 16, recurrentgemma's 2 heads leave ranks 1 and 3
with no head, as recurrentgemma-2b's 10 heads leave six of 16 ranks, and
rwkv6's 4 heads and whisper's 4 are one a rank (whisper's encoder, its
cross K/V and its decoder's self-attention each by heads).
After every step the loss, the grad norm, and every parameter and both
moments gathered whole are held to JAX's jitted make_train_step at
groups = dp, the data axis's size, by tests/test_torch_train.py's f32
tolerances and its small-gradient rule (the elements whose gradient was
small come from the port's meshless step at the same groups). `groups`
reaches only the MoE layers, so JAX runs once per case at groups 1 and
again at 2 and 4 for mixtral, whose capacity routing sees the data ranks
as JAX's routing groups. Over a model axis, each parameter's shape when
its module runs (the worker's forward pre-hooks) is its local shape under
JAX's TP-only spec. The step gathers each parameter over the data axes
at its use (JAX's step without a pregather_spec): at (2, 1), (2, 2) and
(4, 1), while a block runs every other block's parameters are still the
rank's stored fsdp x tp shards, each parameter is all-gathered once a
microbatch and a block's once more under remat (phi4-m2), and each
parameter's gradient is reduced once a microbatch (the worker counts
both in the first step).

Also: at (2, 2) phi4 with zero1 and a TP-only grad_spec, and phi4 with
JAX's TP-only pregather_spec, against JAX (the latter's step with the
same spec, on a mesh of this process's one device); a world of one rank,
made in this process, steps bit for bit as the meshless step for every
case; a batch whose microbatch rows do not split over the data ranks is
refused. The launcher (`launch.train.run`, smoke phi4, B 4 x S 32):
--sketch-grads 4096 at (2, 1) against (1, 1) in this process, at
compression_ratio's n / r'; a checkpoint saved at (2, 1) after 2 steps
restores at (1, 2) and at (1, 1) bit for bit, and the runs resumed from
it to step 4 end as the uninterrupted (2, 1) run.
"""
import dataclasses
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_config
from repro.distributed import sharding as jshd
from repro.launch import specs as jspecs
from repro.models.registry import get_api as jax_api
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.compression import compression_ratio
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import (MeshShape, local_shape,
                                              param_pspecs)
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import get_api
from repro_torch.models.layers import remat_units
from repro_torch.train import (AdamWConfig, TrainState, adamw_init,
                               init_train_state, make_train_step,
                               shard_train_state)
from test_torch_train import F32, LR, _hold
from torch_lm_common import jax_and_port, params_of, port_of
import torch_worlds

S, STEPS = 16, 3
CASES = {"phi4": ("phi4-mini-3.8b", {}),
         "phi4-m2": ("phi4-mini-3.8b", {"microbatches": 2, "remat": True}),
         "mixtral": ("mixtral-8x7b", {}),
         "rwkv6": ("rwkv6-1.6b", {}),
         "recurrentgemma": ("recurrentgemma-2b", {}),
         "whisper": ("whisper-large-v3", {}),
         "phi4-h6": ("phi4-mini-3.8b", {"n_heads": 6, "n_kv_heads": 2,
                                        "head_dim": 16})}
MOE = {"mixtral"}
TP_FAMILIES = {"dense", "moe", "vlm", "hybrid", "ssm", "encdec"}
WORLDS = ((2, 1), (1, 2), (2, 2), (4, 1), (1, 4))
# (world, case) pairs that run (module docstring).
PAIRS = tuple((w, c) for w in WORLDS[:4] for c in tuple(CASES)[:6]) + (
    ((1, 2), "phi4-h6"), ((2, 2), "phi4-h6"),
    *(((1, 4), c) for c in ("phi4", "phi4-m2", "mixtral", "phi4-h6",
                            "rwkv6", "recurrentgemma", "whisper")))
TP_PAIRS = tuple((w, c) for w, c in PAIRS if w[1] > 1)
WORLD_DEADLINE = 240.0        # seconds for all four worlds, start to join
LAUNCH = ["--device", "cpu", "--smoke", "--arch", "phi4-mini-3.8b",
          "--batch", "4", "--seq", "32"]


def _configs(case):
    arch, cut = CASES[case]
    return (dataclasses.replace(jax_config(arch, True), **cut),
            dataclasses.replace(get_config(arch, True), **cut))


def _batch(jcfg):
    """JAX's batch of 4 rows a microbatch, and the same as tensors."""
    jb = jspecs.train_inputs(jcfg, S, 4 * jcfg.microbatches, concrete=True,
                             key=jax.random.PRNGKey(1))
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _run_world(work, data, tp, deadline):
    """One world, its ranks started together and joined; rank 0's
    out.npz."""
    wdir = work / f"world{data}x{tp}"
    torch_worlds.link(work, wdir, ("inputs.npz", "cases.json", "ckpt"))
    torch_worlds.run(wdir, "torch_train_mesh_worker.py",
                     [[r, data, tp, wdir] for r in range(data * tp)],
                     f"({data}, {tp})", deadline)
    return dict(np.load(wdir / "out.npz"))


def _jax_steps(jcfg, params, jb, groups, pregather_spec=None):
    """JAX's jitted step, STEPS times: (loss, grad norm, params, m, v)."""
    jo = jopt.AdamWConfig(lr=LR, moment_dtype=jcfg.optimizer_dtype)
    jstate = jsteps.TrainState(params, jopt.adamw_init(params, jo))
    jstep = jax.jit(jsteps.make_train_step(jcfg, jax_api(jcfg),
                                           groups=groups, opt_cfg=jo,
                                           pregather_spec=pregather_spec))
    out = []
    for _ in range(STEPS):
        jstate, jm = jstep(jstate, jb)
        out.append((float(jm["loss"]), float(jm["grad_norm"]),
                    jstate.params, jstate.opt["m"], jstate.opt["v"]))
    return out


def _small_masks(pcfg, params, pb, groups):
    """After each step, the elements whose gradient was below F32's
    `small` of its tensor's largest at some step so far (the port's
    meshless step at `groups`)."""
    model = port_of(pcfg, params)
    small, masks = {}, []

    def record(grads):
        for name, g in grads.items():
            s = g.abs() < F32["small"] * g.abs().max()
            small[name] = small[name] | s if name in small else s
        return grads

    opt = AdamWConfig(lr=LR)
    state = TrainState(model, adamw_init(dict(model.named_parameters()),
                                         opt))
    step = make_train_step(pcfg, get_api(pcfg), groups=groups,
                           grad_transform=record, opt_cfg=opt)
    for _ in range(STEPS):
        step(state, pb)
        masks.append(dict(small))
    return model, masks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four worlds (run in a thread, one after another) and, meanwhile,
    JAX's references and the small-gradient masks."""
    work = tmp_path_factory.mktemp("train_mesh")
    (work / "ckpt").mkdir()
    inputs, cases, jax_in = {}, [], {}
    for case in CASES:
        jcfg, pcfg = _configs(case)
        params, model = jax_and_port(jcfg, pcfg)
        jb, pb = _batch(jcfg)
        for name, p in model.named_parameters():
            inputs[f"{case}/w/{name}"] = p.detach().numpy()
        for k, v in pb.items():
            inputs[f"{case}/b/{k}"] = v.numpy()
        cases.append({"case": case, "arch": CASES[case][0],
                      "cut": CASES[case][1],
                      "worlds": [list(w) for w, c in PAIRS if c == case]})
        jax_in[case] = (jcfg, pcfg, params, jb, pb)
    np.savez(work / "inputs.npz", **inputs)
    (work / "cases.json").write_text(json.dumps(cases))
    worlds, failed = {}, []
    deadline = time.monotonic() + WORLD_DEADLINE

    def spawn_all():
        try:
            for data, tp in WORLDS:
                worlds[(data, tp)] = _run_world(work, data, tp, deadline)
        except AssertionError as exc:
            failed.append(exc)

    thread = threading.Thread(target=spawn_all, daemon=True)
    thread.start()
    refs = {}
    for case, (jcfg, pcfg, params, jb, pb) in jax_in.items():
        for groups in ((1, 2, 4) if case in MOE else (1,)):
            refs[(case, groups)] = (_jax_steps(jcfg, params, jb, groups),
                                    *_small_masks(pcfg, params, pb, groups))
    thread.join(timeout=max(1.0, deadline + 30 - time.monotonic()))
    if thread.is_alive() or failed:
        raise failed[0] if failed else AssertionError("the worlds hung")
    return {"work": work, "worlds": worlds, "refs": refs, "jax": jax_in}


@pytest.fixture(scope="module")
def world1():
    """A gloo world of one rank in this process, destroyed after the
    module if this fixture made it."""
    made = not dist.is_initialized()
    mesh = make_debug_mesh(1, 1, device="cpu")
    yield mesh
    if made and dist.is_initialized():
        dist.destroy_process_group()


def _named(out, key, what):
    """{name: tensor} of `what` ("params", "m", "v") under `key`."""
    head = f"{key}/{what}/"
    return {k[len(head):]: torch.from_numpy(v) for k, v in out.items()
            if k.startswith(head)}


def _hold_case(out, key, ref, model, masks):
    for i, (loss, gnorm, jparams, jm, jv) in enumerate(ref, start=1):
        np.testing.assert_allclose(float(out[f"{key}/{i}/loss"]), loss,
                                   rtol=F32["loss"], err_msg=f"step {i}")
        np.testing.assert_allclose(float(out[f"{key}/{i}/grad_norm"]),
                                   gnorm, rtol=F32["gnorm"],
                                   err_msg=f"step {i}")
        mask = params_of(model, masks[i - 1])
        for what, want in (("params", jparams), ("m", jm), ("v", jv)):
            _hold(what, params_of(model, _named(out, f"{key}/{i}", what)),
                  want, mask, F32, i)
        assert int(out[f"{key}/{i}/step"]) == i


def _ids(v):
    return f"{v[0]}x{v[1]}" if isinstance(v, tuple) else v


@pytest.mark.parametrize("world,case", PAIRS, ids=_ids)
def test_mesh_step_matches_jax(runs, world, case):
    groups = world[0] if case in MOE else 1
    _hold_case(runs["worlds"][world], case, *runs["refs"][(case, groups)])


@pytest.mark.parametrize("world,case", TP_PAIRS, ids=_ids)
def test_weights_have_their_compute_shape(runs, world, case):
    """Over a model axis no rank holds a whole tensor-parallel weight:
    each parameter, when its module runs, has its local shape under JAX's
    TP-only spec (every family in TP_FAMILIES; a family outside it would
    compute replicated, on whole weights)."""
    pcfg = _configs(case)[1]
    model = get_api(pcfg).init(pcfg, 1, device="meta")
    mesh = MeshShape(("data", "model"), world)
    spec = param_pspecs(model, mesh, use_fsdp=False)
    out = runs["worlds"][world]
    cut = 0
    for name, p in model.named_parameters():
        want = (local_shape(p.shape, spec[name], mesh)
                if pcfg.family in TP_FAMILIES else p.shape)
        assert tuple(out[f"{case}/shape/{name}"]) == tuple(want), name
        cut += tuple(want) != tuple(p.shape)
    assert cut if pcfg.family in TP_FAMILIES else not cut


AT_USE_PAIRS = tuple((w, c) for w, c in PAIRS
                     if w in ((2, 1), (2, 2), (4, 1)))


def _blocks(pcfg):
    """The whole model on "meta" and {name: block prefix} of the
    parameters of its blocks (layers.remat_units)."""
    model = get_api(pcfg).init(pcfg, 1, device="meta")
    return model, {f"{prefix}.{n}": prefix
                   for prefix, blk in remat_units(model).items()
                   for n, _ in blk.named_parameters()}


@pytest.mark.parametrize("world,case", AT_USE_PAIRS, ids=_ids)
def test_other_blocks_hold_their_shards(runs, world, case):
    """Gathered at its use: while a block runs, every other block's
    parameters are still this rank's stored fsdp x tp shards (the
    worker's pre-hook on each block), and the data axis cuts some."""
    pcfg = _configs(case)[1]
    model, blocks = _blocks(pcfg)
    mesh = MeshShape(("data", "model"), world)
    spec = param_pspecs(model, mesh)
    whole = dict(model.named_parameters())
    out = runs["worlds"][world]
    cut = 0
    for running in set(blocks.values()):
        for name, prefix in blocks.items():
            if prefix == running:
                continue
            want = local_shape(whole[name].shape, spec[name], mesh)
            got = out[f"{case}/held/{running}/{name}"]
            assert tuple(got) == tuple(want), (running, name)
            cut += tuple(want) != tuple(whole[name].shape)
    assert cut


@pytest.mark.parametrize("world,case", AT_USE_PAIRS, ids=_ids)
def test_each_use_gathers_and_each_microbatch_reduces_once(runs, world,
                                                           case):
    """In the first step, each parameter whose stored shard is not its
    computed layout was all-gathered once a microbatch, a block's once
    more in remat's replay (phi4-m2: M 2, remat, so 4 a step), and each
    parameter's gradient was reduced once a microbatch (the replay adds
    no reduction)."""
    pcfg = _configs(case)[1]
    model, blocks = _blocks(pcfg)
    mesh = MeshShape(("data", "model"), world)
    stored = param_pspecs(model, mesh)
    compute = TP.compute_specs(model, mesh)
    out = runs["worlds"][world]
    M = pcfg.microbatches
    for name, p in model.named_parameters():
        moves = (local_shape(p.shape, stored[name], mesh)
                 != local_shape(p.shape, compute[name], mesh))
        uses = M * (2 if pcfg.remat and name in blocks else 1)
        assert int(out[f"{case}/gathers/{name}"]) == uses * moves, name
    assert int(out[f"{case}/reductions"]) == M * len(dict(
        model.named_parameters()))


def test_zero1_with_a_grad_spec_matches_jax(runs):
    """(2, 2), phi4: the parameters stored TP-only (zero1) and each
    microbatch's gradient reduce-scattered into that layout (grad_spec),
    both moved to the moments' 2D layout for AdamW."""
    _hold_case(runs["worlds"][(2, 2)], "phi4-zero1", *runs["refs"][
        ("phi4", 1)])


@pytest.mark.parametrize("case", CASES)
def test_world_of_one_is_the_meshless_step(world1, case):
    """(1, 1): the same operations as the meshless step, bit for bit."""
    jcfg, pcfg = _configs(case)
    params = jax_and_port(jcfg, pcfg)[0]
    pb = _batch(jcfg)[1]
    api, opt = get_api(pcfg), AdamWConfig(lr=LR)
    states = [TrainState(m, adamw_init(dict(m.named_parameters()), opt))
              for m in (port_of(pcfg, params), port_of(pcfg, params))]
    states[1] = shard_train_state(states[1], world1)
    steps = [make_train_step(pcfg, api, opt_cfg=opt),
             make_train_step(pcfg, api, opt_cfg=opt, mesh=world1)]
    for i in range(STEPS):
        (_, a), (_, b) = (step(s, pb) for step, s in zip(steps, states))
        assert torch.equal(a["loss"], b["loss"]), i
        assert torch.equal(a["grad_norm"], b["grad_norm"]), i
    pa = dict(states[0].params.named_parameters())
    for name, p in states[1].params.named_parameters():
        assert torch.equal(p, pa[name]), name
        for key in ("m", "v"):
            assert torch.equal(states[1].opt[key][name],
                               states[0].opt[key][name]), (key, name)


def test_batch_that_does_not_split_is_refused(runs):
    assert "does not split over 2 data ranks" in str(
        runs["worlds"][(2, 1)]["refused"])


def test_tp_only_pregather_matches_jax(runs):
    """(2, 2), phi4 with JAX's TP-only pregather_spec against JAX's step
    with the same spec (param_pspecs(use_fsdp=False) on a mesh of this
    process's one device, where it moves nothing)."""
    jcfg, _, params, jb, _ = runs["jax"]["phi4"]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    with jax.set_mesh(mesh):
        ref = _jax_steps(jcfg, params, jb, 1,
                         jshd.param_pspecs(params, mesh, use_fsdp=False))
    _hold_case(runs["worlds"][(2, 2)], "phi4-pregather", ref,
               *runs["refs"][("phi4", 1)][1:])


def _launch(*argv):
    return launch_train.run(launch_train.build_parser().parse_args(
        LAUNCH + list(argv)))


def _hold_run(got, want, step):
    """Two launcher states (whole {name: tensor} per "params", "m", "v")
    by F32's rule, no element excepted."""
    model = get_api(get_config("phi4-mini-3.8b", True)).init(
        get_config("phi4-mini-3.8b", True), 1, device="meta")
    none = {n: torch.zeros(p.shape, dtype=torch.bool)
            for n, p in model.named_parameters()}
    for what in ("params", "m", "v"):
        _hold(what, params_of(model, got[what]),
              params_of(model, {k: t for k, t in want[what].items()}),
              params_of(model, none), F32, step)


def _whole(out, key):
    return {what: _named(out, key, what) for what in ("params", "m", "v")}


def _tree(state):
    tree = launch_train.state_tree(state)
    return {"params": {n: t.detach().float() for n, t in
                       tree["params"].items()},
            "m": {n: t.float() for n, t in tree["opt"]["m"].items()},
            "v": {n: t.float() for n, t in tree["opt"]["v"].items()}}


def test_sketched_mesh_run_equals_one_rank(runs, world1):
    two = runs["worlds"][(2, 1)]
    one = _launch("--sketch-grads", "4096", "--steps", "4")
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    ratio = compression_ratio(get_api(cfg).init(cfg, 1, device="meta"),
                              4096)
    assert float(two["sketch/ratio"]) == one["ratio"] == ratio
    np.testing.assert_allclose(two["sketch/losses"], one["losses"],
                               rtol=F32["loss"])
    _hold_run(_whole(two, "sketch"), _tree(one["state"]), 4)


def _checkpoint_leaves(work):
    """The (2, 1) run's checkpoint at step 2 as {"params", "m", "v"}."""
    path = work / "ckpt" / "step_2"
    manifest = json.loads((path / "manifest.json").read_text())
    out = {"params": {}, "m": {}, "v": {}}
    for i, key in enumerate(manifest["paths"]):
        parts = [p.strip("'") for p in key[1:-1].split("][")]
        arr = torch.from_numpy(np.load(path / f"leaf_{i}.npy"))
        if parts[0] == "params":
            out["params"][parts[1]] = arr
        elif parts[1] in ("m", "v"):
            out[parts[1]][parts[2]] = arr
    return out


def test_checkpoint_moves_between_meshes_bitwise(runs, world1):
    """Saved at (2, 1); restored at (1, 2) (a world) and at (1, 1) (this
    process), each equal to the saved leaves and to the saving run's
    state bit for bit."""
    leaves = _checkpoint_leaves(runs["work"])
    saved = _whole(runs["worlds"][(2, 1)], "saved")
    at12 = runs["worlds"][(1, 2)]
    assert int(at12["restored/at"]) == 2
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    state = shard_train_state(init_train_state(
        cfg, get_api(cfg), tp=1, device="cpu",
        generator=torch.Generator().manual_seed(5)), world1)
    assert launch_train.restore_into(
        CheckpointManager(str(runs["work"] / "ckpt")), state) == 2
    for got in (_whole(at12, "restored"), _tree(state)):
        for what in ("params", "m", "v"):
            assert got[what].keys() == leaves[what].keys()
            for name, t in got[what].items():
                assert torch.equal(t, leaves[what][name]), (what, name)
                assert torch.equal(t, saved[what][name]), (what, name)


@pytest.mark.parametrize("where", ("1x2", "1x1"))
def test_resumed_run_ends_as_the_whole_one(runs, world1, where):
    whole = runs["worlds"][(2, 1)]
    if where == "1x2":
        out = runs["worlds"][(1, 2)]
        got, losses, start = (_whole(out, "resumed"), out["resumed/losses"],
                              int(out["resumed/start"]))
    else:
        run = _launch("--steps", "4", "--ckpt-dir",
                      str(runs["work"] / "ckpt"), "--ckpt-every", "100")
        got, losses, start = _tree(run["state"]), run["losses"], run["start"]
    assert start == 2
    np.testing.assert_allclose(losses, whole["whole/losses"][2:],
                               rtol=F32["loss"])
    _hold_run(got, _whole(whole, "whole"), 4)
