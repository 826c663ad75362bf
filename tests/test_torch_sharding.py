"""The port's sharding rules against repro.distributed.sharding.

All ten configs at their published widths, on the meshes (data, model) =
(1, 1), (4, 1), (2, 4), (16, 16) and (pod, data, model) = (2, 16, 16):
JAX's specs come from its rules on `jax.sharding.AbstractMesh` over
`jax.eval_shape` of its init at tp = the model axis's size; the port's
from its rules on a `MeshShape` over the same model built on the "meta"
device. Every parameter's spec, and the moments' with zero1 off and on,
equals its JAX leaf's (a stacked leaf's lead None dropped: the port holds
one tensor per layer); the batch's specs (B 12: sharded where 12 divides
by the dp axes, replicated elsewhere) and every cache leaf's equal JAX's.
Also: placements() on a spec, PartitionSpec's one-name tuples, and the
activation hints returning their input.
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_config
from repro.distributed import sharding as jshd
from repro.launch import specs as jspecs
from repro.models.registry import get_api as jax_api
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.models import get_api
from repro_torch.models.convert import jax_leaves
from repro_torch.train import AdamWConfig, TrainState, adamw_init
from torch_lm_common import SERVED

MESHES = {"1x1": (("data", "model"), (1, 1)),
          "4x1": (("data", "model"), (4, 1)),
          "2x4": (("data", "model"), (2, 4)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
B, S, MAX_SEQ = 12, 16, 64


def _meshes(key):
    names, sizes = MESHES[key]
    return AbstractMesh(sizes, names), shd.MeshShape(names, sizes)


@functools.lru_cache(maxsize=None)
def _jax_state(arch, tp):
    cfg = jax_config(arch)
    return jax.eval_shape(lambda: jsteps.init_train_state(
        jax.random.PRNGKey(0), cfg, jax_api(cfg), tp=tp))


@functools.lru_cache(maxsize=None)
def _port_state(arch, tp):
    cfg = get_config(arch)
    model = get_api(cfg).init(cfg, tp, device="meta")
    return TrainState(model, adamw_init(
        dict(model.named_parameters()),
        AdamWConfig(moment_dtype=cfg.optimizer_dtype)))


def _leaf(tree, keys):
    for key in keys:
        tree = tree[key]
    return tree


def _same(port_specs, jax_specs, model, what):
    where = jax_leaves(model)
    assert port_specs.keys() == where.keys()
    for name, spec in port_specs.items():
        keys, row = where[name]
        want = tuple(_leaf(jax_specs, keys))
        if row is not None:
            want = want[1:]
        assert isinstance(spec, shd.PartitionSpec)
        assert tuple(spec) == want, (what, name, spec, want)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", SERVED)
def test_param_and_state_specs_match_jax(arch, mesh):
    jmesh, pmesh = _meshes(mesh)
    tp = dict(zip(*MESHES[mesh]))["model"]
    jstate, pstate = _jax_state(arch, tp), _port_state(arch, tp)
    model = pstate.params
    _same(shd.param_pspecs(model, pmesh), jshd.param_pspecs(
        jstate.params, jmesh), model, "params")
    for zero1 in (False, True):
        got = shd.state_pspecs(pstate, pmesh, zero1=zero1)
        want = jshd.state_pspecs(jstate, jmesh, zero1=zero1)
        _same(got.params, want.params, model, f"params zero1={zero1}")
        for key in ("m", "v"):
            _same(got.opt[key], want.opt[key], model, f"{key} {zero1}")
        assert tuple(got.opt["step"]) == tuple(want.opt["step"]) == ()


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", SERVED)
def test_batch_and_cache_specs_match_jax(arch, mesh):
    jmesh, pmesh = _meshes(mesh)
    jcfg, pcfg = jax_config(arch), get_config(arch)
    jbatch = jax.eval_shape(lambda: jspecs.train_inputs(jcfg, S, B))
    pbatch = {k: torch.empty(v.shape, device="meta")
              for k, v in jbatch.items()}
    want = jshd.batch_pspecs(jbatch, jmesh)
    got = shd.batch_pspecs(pbatch, pmesh)
    assert got.keys() == want.keys()
    for k in got:
        assert tuple(got[k]) == tuple(want[k]), k
    jcache = jspecs.cache_specs(jcfg, jax_api(jcfg), B, MAX_SEQ,
                                dtype=jnp.bfloat16)
    pcache = get_api(pcfg).init_cache(pcfg, B, MAX_SEQ, torch.bfloat16,
                                      "meta")
    assert {k: tuple(v.shape) for k, v in pcache.items() if k != "pos"} \
        == {k: tuple(v.shape) for k, v in jcache.items() if k != "pos"}
    want = jshd.cache_pspecs(jcache, jmesh)
    got = shd.cache_pspecs(pcache, pmesh)
    assert got.keys() == want.keys()
    for k in got:
        assert tuple(got[k]) == tuple(want[k]), (k, got[k], want[k])


def test_placements_and_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = shd.MeshShape(("pod", "data", "model"), (2, 4, 2))
    spec = shd.P(("pod", "data"), "model")
    assert shd.placements(spec, mesh) == (Shard(0), Shard(0), Shard(1))
    assert shd.placements(shd.P(None, None), mesh) == (Replicate(),) * 3
    assert shd.P(("data",), None) == ("data", None)
    assert repr(shd.P("data", None)) == "P('data', None)"
    assert shd.local_shape((16, 6), spec, mesh) == (2, 3)


def test_activation_hints_return_their_input():
    x = torch.randn(2, 3, 4)
    with shd.activation_sharding(("data",), seq_axis="model", seq_div=2):
        assert shd.maybe_shard(x) is x
        y = x[:, 0]
        assert shd.maybe_shard(y, "bd") is y
        for kind in ("moe_gtd", "moe_gecd", "moe_gecf"):
            assert shd.maybe_shard(x, kind) is x
    with pytest.raises(ValueError):
        shd.maybe_shard(x, "nope")
