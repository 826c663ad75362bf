"""launch/dryrun.py, the abstract half of launch/specs.py and the dry-run
world of launch/mesh.py, against the JAX package on the CPU.

- specs: for all ten configs at each of the four shapes, every abstract
  input (train, prefill, decode) and cache leaf has the shape and dtype of
  JAX's ShapeDtypeStruct (JAX's cache through jax.eval_shape); the cache's
  "pos", an int32 scalar in JAX, is a host int 0 in the port.
- rules_mb: for all ten configs on the 16 x 16 and 2 x 16 x 16 meshes,
  the port's per-rank parameter and optimizer bytes equal JAX's sum of
  local shape x itemsize over state_pspecs, on an AbstractMesh over
  eval_shape of its train state; no step runs.
- the dry run at smoke widths on the production mesh and on fake (2, 2)
  and (1, 4) meshes, tensor-parallel for every family: the argument
  bytes are rules_mb plus the global batch the step takes, and the
  collective bytes by kind are train_plan's, the parameters gathered at
  each use or, with pregather (or zero1), once a step; at (2, 2) with
  remat, the peak gathering at use lies below the pregather peak by at
  least all blocks but two (dryrun.block_bytes).
- the serving cells (phi4-mini-3.8b x prefill_32k and decode_32k,
  mixtral-8x7b x long_500k; recurrentgemma-2b x prefill_32k at 3
  layers, rwkv6-1.6b x decode_32k at 2, whisper-large-v3 x prefill_32k
  at 2 + 2) at published width on fake (2, 2) and (1, 4) meshes,
  tensor-parallel through the mesh's steps: the collective bytes by kind
  are serve_plan's, no weight's among them, and the argument bytes are
  held_bytes plus the global inputs.
- run_cell: phi4 x long_500k writes JAX's skip file byte for byte (JAX's
  dryrun.py run in a subprocess: importing it in process would set its
  512-device XLA_FLAGS for every later subprocess); an ok cell's JSON has
  the keys of JAX's record (read from JAX's dryrun.py source) plus
  rules_mb; no process group is left after a cell, one that fails
  included; a cell refuses to start under an existing group; make_mesh
  refuses the fake backend.
"""
import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_config
from repro.distributed import sharding as jshd
from repro.launch import specs as jspecs
from repro.models.registry import get_api as jax_api
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import MeshShape
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import (destroy_dryrun_mesh, make_dryrun_mesh,
                                     make_mesh, mesh_axis)
from repro_torch.models import get_api
from torch_lm_common import SERVED

REPO = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


@pytest.fixture(autouse=True)
def no_world_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _same_leaf(got, want, what):
    assert isinstance(got, torch.Tensor) and got.device.type == "meta", what
    assert tuple(got.shape) == tuple(want.shape), what
    assert str(got.dtype).removeprefix("torch.") == jnp.dtype(
        want.dtype).name, what


@pytest.mark.parametrize("shape", list(specs.SHAPES))
@pytest.mark.parametrize("arch", SERVED)
def test_abstract_specs_match_jax(arch, shape):
    jcfg, pcfg = jax_config(arch), get_config(arch)
    sh = specs.SHAPES[shape]
    S, B = sh["seq"], sh["batch"]
    for name, got, want in (
            ("train", specs.train_inputs(pcfg, S, B, abstract=True),
             jspecs.train_inputs(jcfg, S, B)),
            ("prefill", specs.prefill_inputs(pcfg, S, B, abstract=True),
             jspecs.prefill_inputs(jcfg, S, B))):
        assert got.keys() == want.keys(), name
        for k in got:
            _same_leaf(got[k], want[k], (name, k))
    _same_leaf(specs.decode_tokens(pcfg, B, abstract=True),
               jspecs.decode_tokens(jcfg, B), "decode")
    got = specs.cache_specs(pcfg, get_api(pcfg), B, S, abstract=True)
    want = jspecs.cache_specs(jcfg, jax_api(jcfg), B, S)
    assert got.keys() == want.keys()
    for k in got:
        if k == "pos":
            assert got[k] == 0 and want[k].shape == () \
                and want[k].dtype == jnp.int32
        else:
            _same_leaf(got[k], want[k], ("cache", k))


def _jax_local_bytes(tree, spec_tree, amesh):
    sizes = dict(zip(amesh.axis_names, amesh.axis_sizes))
    total = 0
    for leaf, spec in zip(jax.tree.leaves(tree), jax.tree.leaves(
            spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.
                                                    PartitionSpec))):
        shape = list(leaf.shape)
        for d, entry in enumerate(spec):
            for axis in ((entry,) if isinstance(entry, str)
                         else entry or ()):
                shape[d] //= sizes[axis]
        total += int(np.prod(shape)) * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", SERVED)
def test_rules_bytes_match_jax_state_pspecs(arch, mesh):
    names, sizes = MESHES[mesh]
    jcfg, pcfg = jax_config(arch), get_config(arch)
    amesh = AbstractMesh(sizes, names)
    state = jax.eval_shape(lambda: jsteps.init_train_state(
        jax.random.PRNGKey(0), jcfg, jax_api(jcfg), tp=16))
    spec = jshd.state_pspecs(state, amesh, zero1=jcfg.zero1)
    got = dryrun.rules_bytes(pcfg, "train", 256, 4096,
                             MeshShape(names, sizes))
    assert got["params"] == _jax_local_bytes(state.params, spec.params,
                                             amesh)
    assert got["opt"] == _jax_local_bytes(state.opt, spec.opt, amesh)
    assert got["cache"] == 0


@pytest.mark.parametrize("arch,zero1", (
    ("phi4-mini-3.8b", False), ("phi4-mini-3.8b", True),
    ("mixtral-8x7b", False), ("recurrentgemma-2b", False),
    ("rwkv6-1.6b", False), ("whisper-large-v3", False),
    ("pixtral-12b", False)))
def test_smoke_cell_argument_and_collectives(arch, zero1):
    """train_4k's batch of 256 (groups 16, each rank 16 rows) at sequence
    64 on the 16 x 16 dry-run mesh, one config per family, and phi4 with
    zero1 (the parameters TP-only, moved to the moments' layout and back
    each step). Every cell computes tensor-parallel, its 2 or 4 heads
    over 16 ranks (rank 0 holds one, 12 or 14 ranks none), and moves
    activation-sized all-reduces."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), zero1=zero1)
    B, S = specs.SHAPES["train_4k"]["batch"], 64
    mesh = make_dryrun_mesh()
    try:
        rec = dryrun.measure(cfg, "train", B, S, mesh)
        plan = dryrun.train_plan(cfg, rec["microbatches"], mesh, B, S)
    finally:
        destroy_dryrun_mesh(mesh)
    res = rec["analysis"]
    batch = specs.train_inputs(cfg, S, B, abstract=True)
    batch_bytes = sum(t.numel() * t.element_size() for t in batch.values())
    rules = dryrun.rules_bytes(cfg, "train", B, S,
                               MeshShape(("data", "model"), (16, 16)))
    assert res["rules"] == rules
    assert res["memory"]["argument"] == sum(rules.values()) + batch_bytes
    assert res["memory"]["peak"] == res["memory"]["argument"] \
        + res["memory"]["temp"]
    assert rec["groups"] == 16
    assert {k: v for k, v in res["collective_bytes"].items() if v} == {
        k: float(v) for k, v in plan.items() if v}
    assert plan["all-gather"] > 0 and plan["reduce-scatter"] > 0
    assert res["collective_bytes"]["all-reduce"] > 0
    tokens = B // 16 // rec["microbatches"] * S
    assert plan["all-reduce"] > tokens * cfg.d_model * 4


@pytest.mark.parametrize("arch,cut,shape", (
    ("phi4-mini-3.8b", {}, (2, 2)),
    ("phi4-mini-3.8b", {"pregather": True, "remat": True,
                        "microbatches": 2}, (2, 2)),
    ("phi4-mini-3.8b", {"n_heads": 6, "n_kv_heads": 2, "head_dim": 16},
     (1, 4)),
    ("qwen3-14b", {"remat": True}, (2, 2)),
    ("mixtral-8x7b", {"remat": True, "microbatches": 2}, (2, 2)),
    ("pixtral-12b", {}, (2, 2)),
    ("recurrentgemma-2b", {}, (2, 2)),
    ("recurrentgemma-2b", {"remat": True, "microbatches": 2}, (1, 4)),
    ("rwkv6-1.6b", {}, (2, 2)),
    ("rwkv6-1.6b", {"remat": True, "microbatches": 2}, (1, 4)),
    ("whisper-large-v3", {}, (2, 2))),
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else
    "-".join(f"{k}{v}" for k, v in v.items()) if isinstance(v, dict) else v)
def test_tensor_parallel_cell_follows_the_plan(arch, cut, shape):
    """train_4k's batch of 256 at sequence 64 on a fake (2, 2) or (1, 4)
    dry-run mesh, tensor-parallel over the model axis: the collective
    bytes by kind are train_plan's (the data-axis gathers, the attention's
    weight gathers where a rank's heads are not its chunk of wq or wk,
    the row-parallel all-reduces and remat's replay of them, the MoE's,
    the RG-LRU blocks' gather of u and its reduce-scatter, lam's
    gradient, the RWKV blocks' (wb's and the decay LoRA's gathers, ln_x's
    sums, the channel mix's reduce-scatter and gathers, the vectors'
    gradients), whisper's encoder attention and MLP at its 16 frames a
    row, its cross-attention and the encoder output's gradient, the
    vocab-parallel embedding and loss; JAX's TP-only pregather spec
    taken; recurrentgemma's 2 heads at (1, 4) leave two ranks with
    none), the argument bytes rules_mb plus the batch; every cell moves
    activation-sized all-reduces over the model axis."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), **cut)
    B, S = specs.SHAPES["train_4k"]["batch"], 64
    mesh = make_dryrun_mesh(shape=shape)
    try:
        rec = dryrun.measure(cfg, "train", B, S, mesh)
        plan = dryrun.train_plan(cfg, rec["microbatches"], mesh, B, S)
    finally:
        destroy_dryrun_mesh(mesh)
    res = rec["analysis"]
    batch = specs.train_inputs(cfg, S, B, abstract=True)
    rules = dryrun.rules_bytes(cfg, "train", B, S,
                               MeshShape(("data", "model"), shape))
    assert res["memory"]["argument"] == sum(rules.values()) + sum(
        t.numel() * t.element_size() for t in batch.values())
    assert {k: v for k, v in res["collective_bytes"].items() if v} == {
        k: float(v) for k, v in plan.items() if v}
    tokens = B // shape[0] // rec["microbatches"] * S
    assert plan["all-reduce"] > tokens * cfg.d_model * 4
    if shape[0] == 1:       # no data axis: the attention's gathers alone
        assert plan["all-gather"] and plan["reduce-scatter"]


@pytest.mark.parametrize("layers", (4, 8), ids=("L4", "L8"))
def test_gather_at_use_lowers_the_peak(layers):
    """phi4's smoke config with remat at M 2 and L = 4 or 2L = 8 layers,
    train_4k's batch of 256 at sequence 64 on a fake (2, 2) mesh, run
    twice: gathering each parameter at its use (the default) and with
    JAX's TP-only pregather_spec (every parameter gathered once a step
    and held to the end of the backward). The bound: rank 0's peak
    gathering at use sits below the pregather peak by at least the bytes
    of all blocks but the two largest in their computed layout
    (dryrun.block_bytes; L - 2 blocks here): pregather holds every block
    at once, the gather at use one block's copies at a time and, in the
    backward, the next block's beside them. Both cells move their plans'
    collective bytes, and the record says how each gathered."""
    base = dataclasses.replace(get_config("phi4-mini-3.8b", smoke=True),
                               n_layers=layers, remat=True, microbatches=2)
    B, S = specs.SHAPES["train_4k"]["batch"], 64
    peaks = {}
    mesh = make_dryrun_mesh(shape=(2, 2))
    try:
        for pregather in (False, True):
            cfg = dataclasses.replace(base, pregather=pregather)
            rec = dryrun.measure(cfg, "train", B, S, mesh)
            plan = dryrun.train_plan(cfg, rec["microbatches"], mesh, B, S)
            assert {k: v for k, v in rec["analysis"]["collective_bytes"]
                    .items() if v} == {k: float(v) for k, v in plan.items()
                                       if v}
            assert rec["param_gather"] == ("once a step" if pregather
                                           else "at each use")
            peaks[pregather] = rec["analysis"]["memory"]["peak"]
    finally:
        destroy_dryrun_mesh(mesh)
    blocks = sorted(dryrun.block_bytes(
        base, MeshShape(("data", "model"), (2, 2))).values())
    assert len(blocks) == layers
    assert peaks[True] - peaks[False] >= sum(blocks[:-2]) > 0


@pytest.mark.parametrize("shape", ((2, 2), (1, 4)), ids=("2x2", "1x4"))
@pytest.mark.parametrize("arch,cell", (
    ("phi4-mini-3.8b", "prefill_32k"), ("phi4-mini-3.8b", "decode_32k"),
    ("mixtral-8x7b", "long_500k")))
def test_serving_cell_follows_the_plan(arch, cell, shape):
    """A serving cell at published width, 2 layers, on a fake (2, 2) or
    (1, 4) dry-run mesh, tensor-parallel over the model axis through the
    mesh's steps: the collective bytes by kind are serve_plan's (the
    all-reduces after wo, after w2 or of the MoE's expert outputs, the
    lookup's; the logits' all-gathers over the model axis and, where the
    rows split, the data axis), none of them a weight's (no
    reduce-scatter, and the all-gathers are the f32 logits alone); the
    argument bytes are the held parameters and cache (held_bytes) plus
    the global inputs."""
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    sh = specs.SHAPES[cell]
    B, S = sh["batch"], sh["seq"]
    mesh = make_dryrun_mesh(shape=shape)
    try:
        rec = dryrun.measure(cfg, sh["kind"], B, S, mesh)
        plan = dryrun.serve_plan(cfg, sh["kind"], mesh, B, S)
    finally:
        destroy_dryrun_mesh(mesh)
    res = rec["analysis"]
    assert {k: v for k, v in res["collective_bytes"].items() if v} == {
        k: float(v) for k, v in plan.items() if v}
    V = cfg.vocab_padded(shape[1])
    split = B % shape[0] == 0 and shape[0] > 1
    b = B // shape[0] if split else B
    assert plan["reduce-scatter"] == 0
    assert plan["all-gather"] == b * V * 4 + (B * V * 4 if split else 0)
    assert res["collective_counts"]["all-gather"] == 1 + split
    assert res["collective_counts"]["all-reduce"] == 2 * cfg.n_layers + 1
    inputs = (specs.prefill_inputs(cfg, S, B, abstract=True)
              if sh["kind"] == "prefill" else
              {"t": specs.decode_tokens(cfg, B, abstract=True)})
    held = dryrun.held_bytes(cfg, sh["kind"], B, S,
                             MeshShape(("data", "model"), shape))
    assert res["memory"]["argument"] == sum(held.values()) + sum(
        t.numel() * t.element_size() for t in inputs.values())


@pytest.mark.parametrize("shape", ((2, 2), (1, 4)), ids=("2x2", "1x4"))
@pytest.mark.parametrize("arch,cell,depth", (
    ("recurrentgemma-2b", "prefill_32k", {"n_layers": 3}),
    ("rwkv6-1.6b", "decode_32k", {"n_layers": 2}),
    ("whisper-large-v3", "prefill_32k", {"n_layers": 2,
                                         "n_encoder_layers": 2})),
    ids=("hybrid", "ssm", "encdec"))
def test_family_serving_cell_follows_the_plan(arch, cell, depth, shape):
    """One serving cell of the hybrid (R R A: its prompt of 32,768 runs
    the ring branch of the window's cache), the ssm and the encdec at
    published width on a fake (2, 2) or (1, 4) dry-run mesh,
    tensor-parallel through the mesh's steps: the collective bytes by
    kind are serve_plan's (besides the attention's, MLP's and lookup's
    all-reduces, the RG-LRU blocks' all-gather of u and their all-reduce
    after w_out, the time mix's all-reduce after wo and ln_x's sum, the
    channel mix's reduce-scatter and all-gather into the stream, whisper's
    encoder and cross-attention all-reduces), none of them a weight's;
    the argument bytes are the held parameters and every cache leaf
    (held_bytes) plus the global inputs."""
    cfg = dataclasses.replace(get_config(arch), **depth)
    sh = specs.SHAPES[cell]
    B, S = sh["batch"], sh["seq"]
    mesh = make_dryrun_mesh(shape=shape)
    try:
        rec = dryrun.measure(cfg, sh["kind"], B, S, mesh)
        plan = dryrun.serve_plan(cfg, sh["kind"], mesh, B, S)
    finally:
        destroy_dryrun_mesh(mesh)
    res = rec["analysis"]
    assert {k: v for k, v in res["collective_bytes"].items() if v} == {
        k: float(v) for k, v in plan.items() if v}
    split = B % shape[0] == 0 and shape[0] > 1
    counts = res["collective_counts"]
    if cfg.family == "hybrid":      # u's gathers (R R), then the logits'
        assert counts["all-gather"] == 2 + 1 + split
        assert counts["all-reduce"] == 2 * 3 + 1     # 2 a layer, lookup
    elif cfg.family == "ssm":       # each channel mix's, then the logits'
        assert counts["all-gather"] == cfg.n_layers + 1 + split
        assert counts["reduce-scatter"] == cfg.n_layers
        assert counts["all-reduce"] == 2 * cfg.n_layers + 1  # wo, ln_x
    else:           # encoder 2 + 2, decoder 3 a layer, the lookup
        assert counts["all-gather"] == 1 + split
        assert counts["all-reduce"] == 4 + 3 * cfg.n_layers + 1
    inputs = (specs.prefill_inputs(cfg, S, B, abstract=True)
              if sh["kind"] == "prefill" else
              {"t": specs.decode_tokens(cfg, B, abstract=True)})
    held = dryrun.held_bytes(cfg, sh["kind"], B, S,
                             MeshShape(("data", "model"), shape))
    assert res["memory"]["argument"] == sum(held.values()) + sum(
        t.numel() * t.element_size() for t in inputs.values())


def test_skip_cell_writes_jax_skip_file(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, "-m", "repro.launch.dryrun", "--arch",
                    "phi4-mini-3.8b", "--shape", "long_500k", "--out",
                    str(tmp_path / "jax")], check=True, env=env,
                   capture_output=True, timeout=300)
    assert dryrun.main(["--arch", "phi4-mini-3.8b", "--shape", "long_500k",
                        "--out", str(tmp_path / "port")]) == 0
    name = "phi4-mini-3.8b__long_500k__sp.json"
    want = (tmp_path / "jax" / name).read_text()
    assert (tmp_path / "port" / name).read_text() == want
    assert json.loads(want)["status"] == "skipped"


def _jax_record_keys():
    """The keys of JAX's ok record: run_cell's res dict, its res.update(...)
    and the dicts inside it (src/repro/launch/dryrun.py)."""
    tree = ast.parse((REPO / "src/repro/launch/dryrun.py").read_text())
    keys = {"arch", "shape", "mesh"}
    nested, names = {}, {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            names[node.targets[0].id] = {k.value for k in node.value.keys}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "update" and any(
                kw.arg == "lower_s" for kw in node.keywords):
            for kw in node.keywords:
                keys.add(kw.arg)
                value = kw.value
                if isinstance(value, ast.Call) and getattr(
                        value.func, "id", None) == "dict":
                    nested[kw.arg] = {k.arg for k in value.keywords}
                elif isinstance(value, ast.Name) and value.id in names:
                    nested[kw.arg] = names[value.id]
    return keys, nested


def test_ok_cell_has_jax_keys(tmp_path):
    keys, nested = _jax_record_keys()
    assert {"memory", "cost", "collectives", "hlo_flops"} <= keys
    assert nested["collectives"] == {"bytes", "counts", "total_bytes"}
    res = dryrun.run_cell("rwkv6-1.6b", "long_500k", False, str(tmp_path),
                          {"n_layers": 2})
    on_disk = json.loads((tmp_path / "rwkv6-1.6b__long_500k__sp.json")
                         .read_text())
    assert on_disk == res
    assert set(res) == keys | {"rules_mb"}
    for key, inner in nested.items():
        assert set(res[key]) == inner, key
    assert set(res["collectives"]["bytes"]) >= {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert set(res["rules_mb"]) == {"params", "opt", "cache", "total"}
    assert res["status"] == "ok" and res["n_devices"] == 256
    assert res["groups"] == 1 and res["microbatches"] == 1


def test_failing_cell_raises_and_leaves_no_group(tmp_path):
    # top_k above the expert count: the router's top-k fails in the step.
    with pytest.raises(RuntimeError, match="k not in range"):
        dryrun.run_cell("phi4-mini-3.8b", "train_4k", False, str(tmp_path),
                        {"n_layers": 1, "n_experts": 2, "top_k": 4})
    assert not dist.is_initialized()
    assert not list(tmp_path.iterdir())


def test_cell_refuses_an_existing_group(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="no process group"):
            dryrun.run_cell("rwkv6-1.6b", "long_500k", False,
                            str(tmp_path), {"n_layers": 2})
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


def test_fake_backend_only_on_a_dryrun_mesh():
    mesh = make_dryrun_mesh(multi_pod=True)
    try:
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.shape) == (2, 16, 16)
        assert tuple(mesh.get_coordinate()) == (0, 0, 0)
        assert mesh_axis(mesh, "model").size == 16
        with pytest.raises(ValueError, match="backend"):
            make_mesh((2, 16, 16), ("pod", "data", "model"), device="cpu")
    finally:
        destroy_dryrun_mesh(mesh)
    with pytest.raises(ValueError):
        destroy_dryrun_mesh(mesh)


def test_plan_cell_follows_jax():
    mesh = MeshShape(("data", "model"), (16, 16))
    cfg = get_config("nemotron-4-340b")
    assert dryrun.plan_cell(cfg, 256, mesh) == (16, cfg.microbatches)
    assert dryrun.plan_cell(cfg, 1, mesh) == (1, 1)
    assert dryrun.plan_cell(dataclasses.replace(cfg, microbatches=3), 256,
                            mesh) == (16, 2)


SEQ_FAMILIES = ("phi4-mini-3.8b", "mixtral-8x7b", "pixtral-12b",
                "recurrentgemma-2b", "rwkv6-1.6b", "whisper-large-v3")


@pytest.mark.parametrize("seq", (True, False), ids=("seq", "whole"))
@pytest.mark.parametrize("arch", SEQ_FAMILIES)
def test_sequence_parallel_train_cell_follows_the_plan(arch, seq):
    """train_4k's batch of 256 at sequence 64 on the 16 x 16 dry-run mesh
    at the smoke config of each family, with seq_shard_acts on (the dry
    run enters activation_sharding(seq_axis="model", seq_div=16) as
    JAX's run_cell does) and off: the collective bytes by kind are
    train_plan's. On, the stream between blocks is cut over S: the
    row-parallel all-reduces become reduce-scatters and all-gathers
    (rwkv6's channel mix an all-to-all each way), and only the small
    all-reduces (norm weights, the loss) stay."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              seq_shard_acts=seq)
    B, S = specs.SHAPES["train_4k"]["batch"], 64
    mesh = make_dryrun_mesh()
    try:
        rec = dryrun.measure(cfg, "train", B, S, mesh)
        plan = dryrun.train_plan(cfg, rec["microbatches"], mesh, B, S)
    finally:
        destroy_dryrun_mesh(mesh)
    got = rec["analysis"]["collective_bytes"]
    assert {k: v for k, v in got.items() if v} == {
        k: float(v) for k, v in plan.items() if v}
    whole = dryrun.train_plan(dataclasses.replace(cfg, seq_shard_acts=False),
                              rec["microbatches"], mesh, B, S)
    tokens = B // 16 // rec["microbatches"] * S
    if seq:
        assert plan["all-reduce"] < whole["all-reduce"]
        assert plan["reduce-scatter"] > whole["reduce-scatter"]
        assert bool(plan["all-to-all"]) == (cfg.family == "ssm")
    else:
        assert plan == whole and not plan["all-to-all"]
        assert plan["all-reduce"] > tokens * cfg.d_model * 4


@pytest.mark.parametrize("seq", (True, False), ids=("seq", "whole"))
@pytest.mark.parametrize("arch", SEQ_FAMILIES)
def test_sequence_parallel_prefill_cell_follows_the_plan(arch, seq):
    """prefill_32k at published width, 2 layers (whisper 2 + 2), on the
    16 x 16 dry-run mesh with seq_shard_acts on and off: the collective
    bytes by kind are serve_plan's. On, each block gathers S at its entry
    and reduce-scatters at its exit, the lookup reduce-scatters and the
    last position is gathered for the logits; whisper's 1,500 frames do
    not divide by 16, so its encoder keeps its all-reduces, and rwkv6's
    ln_x keeps its f32 sums of squares."""
    depth = {"n_layers": 2}
    if arch == "whisper-large-v3":
        depth["n_encoder_layers"] = 2
    cfg = dataclasses.replace(get_config(arch), seq_shard_acts=seq, **depth)
    sh = specs.SHAPES["prefill_32k"]
    B, S = sh["batch"], sh["seq"]
    mesh = make_dryrun_mesh()
    try:
        rec = dryrun.measure(cfg, "prefill", B, S, mesh)
        plan = dryrun.serve_plan(cfg, "prefill", mesh, B, S)
    finally:
        destroy_dryrun_mesh(mesh)
    got = rec["analysis"]["collective_bytes"]
    assert {k: v for k, v in got.items() if v} == {
        k: float(v) for k, v in plan.items() if v}
    whole = dryrun.serve_plan(dataclasses.replace(cfg, seq_shard_acts=False),
                              "prefill", mesh, B, S)
    if seq:
        assert plan["reduce-scatter"] > whole["reduce-scatter"]
        assert plan["all-reduce"] < whole["all-reduce"]
        b, ai = B // 16, 2                   # the rank's rows, bf16
        encoder = 2 * 2 * b * 1500 * cfg.d_model * ai  # 2 layers, 2 sums
        ln_x = 2 * b * S * 4                 # rwkv6's f32 sums of squares
        assert plan["all-reduce"] == {"encdec": encoder,
                                      "ssm": ln_x}.get(cfg.family, 0)
    else:
        assert plan == whole and not plan["all-to-all"]
