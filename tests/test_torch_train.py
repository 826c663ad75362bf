"""The port's training loop against repro.train on the CPU.

Each case draws JAX's weights (init_lm / init_rg / init_rwkv /
init_whisper at seed 0, carried into the port by models.convert) and
JAX's batch (specs.train_inputs(concrete=True, key=PRNGKey(1)), batch 4,
sequence 16, handed to the port as numpy), then runs JAX's jitted
make_train_step and the port's for 3 steps at the launcher's lr 3e-3
with the same AdamWConfig. After every step the loss, the grad norm, and
every parameter and both moments (read back into JAX's layout by
torch_lm_common.params_of) must agree:

- f32 (the ten smoke configs; phi4 and recurrentgemma again at M 2 with
  remat): loss and grad norm within 1e-5 relative; m and v within 5e-4
  of their tensor's largest |value| (the two frameworks sum the
  gradients in different orders: ~1e-6 of the largest, up to 1.3e-4
  where mixtral's capacity routing sums a token's experts); parameters
  within 0.05 lr (a step moves an element by lr m_hat / (sqrt(v_hat) +
  eps); where the gradient is small that ratio carries its relative
  error: 0.0165 lr at most, whisper). An element may miss only if its
  gradient at some step was below 1e-6 of its tensor's largest (the
  first step's m_hat / sqrt(v_hat) is g / |g|, so f32 noise there turns
  into +-lr), and such elements must be under 0.1 % of each tensor.
- bf16 (phi4 at M 2, param_dtype = dtype = bfloat16): the JAX package's
  bf16 backward on the CPU is the less exact of the two (its unembedding
  gradient is 0.79 % from an f64 product of the same inputs in norm, the
  port's 0.20 %; the gradients of the two differ by up to 2 % of their
  tensor's largest), so an element's update sign is fixed only where its
  gradient stands above that noise. Loss within 2e-3 relative, grad norm
  within 1e-2 (measured 5e-4 and 1.9e-3) and m and v within 2^-3 of
  their largest (measured 3.5e-2) after each step; after the first step
  (m_hat / sqrt(v_hat) = g / |g|: the update is +-lr whatever the
  gradient's size) every parameter within one bf16 ulp of JAX's, except
  elements whose gradient was below 2^-5 of its tensor's largest, which
  must be under 2 % of each tensor (measured 0.46 % at most in the
  products, 2 of 128 in each stacked norm scale). From the second step
  m_hat / sqrt(v_hat) carries the gradients' 1-2 % disagreement into
  every element, and lr times that exceeds an ulp of the smaller
  weights, so the parameters are not held element by element there.

At 8 rows a microbatch recurrentgemma's f32 trajectories part (JAX's is
the further from an f64 run of the same steps): that case holds the port
to the f64 run and JAX to the port at its own stated tolerances
(test_train_step_eight_rows_against_f64).

Also: cross_entropy with a wholly masked row and with no label at all,
adamw_update on a tree of 1-, 2- and 3-D leaves with f32 and bf16
moments, the decay set against the leaves JAX's adamw_update decays (all
ten configs), remat on == off bit for bit (one config per family), and
the launcher (`repro_torch.launch.train` in process, --device cpu
--smoke): the loss falls, a run cut at step 2 and resumed to 6 equals an
uninterrupted 6-step run bit for bit, a mesh larger than the world and a
negative --sketch-grads are refused, and without a card and without
--device it fails. The mesh itself is tests/test_torch_train_mesh.py's.
"""
import argparse
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.configs import get_config as jax_config
from repro.launch import specs as jspecs
from repro.models.registry import get_api as jax_api
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import get_api
from repro_torch.models.convert import decayed_names
from repro_torch.train import (AdamWConfig, TrainState, adamw_init,
                               adamw_update, cross_entropy, make_train_step)
from torch_lm_common import SERVED, jax_and_port, params_of, port_of

B, S, STEPS, LR = 4, 16, 3, 3e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(loss=1e-5, gnorm=1e-5, moments=5e-4, lr_frac=0.05, ulps=None,
           small=1e-6, miss=1e-3)
BF16 = dict(loss=2e-3, gnorm=1e-2, moments=2.0 ** -3, lr_frac=None, ulps=1,
            small=2.0 ** -5, miss=2e-2, param_steps=1)


def _tensor(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(a)


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _hold(what, got, want, small, tol, step):
    """got, want, small: the same tree; see the module docstring."""
    for (path, g), (_, w), (_, s) in zip(_leaves(got), _leaves(want),
                                         _leaves(small)):
        w = w.astype(np.float32)
        if what == "params" and tol["ulps"] is not None:
            e = np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -133)))
            bad = np.abs(g - w) > tol["ulps"] * 2.0 ** (e - 7)
        elif what == "params":
            bad = np.abs(g - w) > tol["lr_frac"] * LR
        else:
            bad = np.abs(g - w) > tol["moments"] * np.abs(w).max()
        where = f"{what}{path} after step {step}"
        assert not (bad & ~s).any(), (
            f"{where}: {int((bad & ~s).sum())} elements off, the worst "
            f"{float(np.abs(g - w)[bad & ~s].max())}")
        assert (bad & s).sum() < tol["miss"] * g.size, (
            f"{where}: {int((bad & s).sum())} of {g.size} small-gradient "
            f"elements off")


def _as_f32(named):
    return {n: t.detach().float() for n, t in named.items()}


def _parity(arch, tol=F32, batch=B, **cut):
    """Three steps of JAX's and the port's, held after each (module
    docstring); returns (the port's losses, JAX's losses)."""
    jcfg, pcfg = jax_config(arch, True), get_config(arch, True)
    if cut:
        jcfg = dataclasses.replace(jcfg, **cut)
        pcfg = dataclasses.replace(pcfg, **cut)
    params, model = jax_and_port(jcfg, pcfg)
    jb = jspecs.train_inputs(jcfg, S, batch, concrete=True,
                             key=jax.random.PRNGKey(1))
    pb = {k: _tensor(v) for k, v in jb.items()}
    jo = jopt.AdamWConfig(lr=LR, moment_dtype=jcfg.optimizer_dtype)
    po = AdamWConfig(lr=LR, moment_dtype=pcfg.optimizer_dtype)
    jstate = jsteps.TrainState(params, jopt.adamw_init(params, jo))
    jstep = jax.jit(jsteps.make_train_step(jcfg, jax_api(jcfg), opt_cfg=jo))
    small, losses = {}, ([], [])

    def record(grads):
        for name, g in grads.items():
            s = g.abs() < tol["small"] * g.abs().max()
            small[name] = small[name] | s if name in small else s
        return grads

    state = TrainState(model, adamw_init(dict(model.named_parameters()),
                                         po))
    step = make_train_step(pcfg, get_api(pcfg), grad_transform=record,
                           opt_cfg=po)
    for i in range(1, STEPS + 1):
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, pb)
        losses[0].append(float(m["loss"]))
        losses[1].append(float(jm["loss"]))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=tol["loss"], err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   rtol=tol["gnorm"], err_msg=f"step {i}")
        mask = params_of(model, small)
        if i <= tol.get("param_steps", STEPS):
            _hold("params", params_of(model, _as_f32(dict(
                model.named_parameters()))), jstate.params, mask, tol, i)
        for key in ("m", "v"):
            _hold(key, params_of(model, _as_f32(state.opt[key])),
                  jstate.opt[key], mask, tol, i)
        assert int(state.opt["step"]) == int(jstate.opt["step"]) == i
    return losses


@pytest.mark.parametrize("arch", SERVED)
def test_train_step_matches_jax(arch):
    _parity(arch)


@pytest.mark.parametrize("arch", ("phi4-mini-3.8b", "recurrentgemma-2b"))
def test_train_step_microbatched_with_remat(arch):
    """M 2 with remat: the contiguous microbatches, the f32 sum of their
    gradients; recurrentgemma's 5 layers are one stacked superblock and
    two unstacked remainder layers (supers against rem)."""
    _parity(arch, microbatches=2, remat=True)


def test_train_step_bf16():
    _parity("phi4-mini-3.8b", BF16, param_dtype="bfloat16",
            dtype="bfloat16", microbatches=2)


class _F64(TorchFunctionMode):
    """The port's operations in f64: every f32 cast and every tensor made
    in f32 is made f64 instead (a model in f64 passes through the f32
    casts of its norms, gates and logits, and AdamW's f32 temporaries)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func is torch.Tensor.float:
            return args[0].double()
        if kwargs.get("dtype") is torch.float32:
            kwargs["dtype"] = torch.float64
        args = tuple(torch.float64 if a is torch.float32 else a
                     for a in args)
        return func(*args, **kwargs)


# recurrentgemma at 8 rows a microbatch (test_train_step_eight_rows_
# against_f64): JAX's loss and grad norm against the port's, relative, and
# the port's against its f64 run's.
EIGHT_ROWS = dict(loss=3e-5, gnorm=3e-4)
F64_REL = dict(loss=1e-6, gnorm=1e-5)


def test_train_step_eight_rows_against_f64():
    """recurrentgemma's smoke config at 8 rows a microbatch (B 8, M 1), 3
    steps: from the second step JAX's loss and grad norm leave the port's
    by more than the 1e-5 of the 4-row cases (loss 1.04e-5 relative at
    step 3; grad norm 1.85e-5 at step 2, 1.10e-4 at step 3). An f64 run
    of the port's own operations from the same weights and batch (_F64)
    shows JAX's f32 trajectory to be the further of the two: the step-1
    update moves each element by +-lr whatever its gradient's size, and
    JAX's f32 gradients get more noise-level elements' signs wrong. Against
    the f64 run, at steps 1-3, the port's loss is within 3.4e-7 and its
    grad norm within 3.9e-6, JAX's within 1.07e-5 and 1.14e-4; after step
    3 JAX's parameters are 22x further from the f64 run's than the port's
    (L1). So this case holds the port to the f64 run at F64_REL, JAX to
    the port at EIGHT_ROWS (about 3x the measured gaps), and JAX's step-3
    loss and grad-norm errors and parameter distance to be over 10x the
    port's. It holds no element against JAX (one w1 element of JAX's is
    2.2 x 0.05 lr from the port's after step 2)."""
    arch, batch = "recurrentgemma-2b", 8
    jcfg, pcfg = jax_config(arch, True), get_config(arch, True)
    params, model = jax_and_port(jcfg, pcfg)
    model64 = port_of(pcfg, params).double()
    jb = jspecs.train_inputs(jcfg, S, batch, concrete=True,
                             key=jax.random.PRNGKey(1))
    pb = {k: _tensor(v) for k, v in jb.items()}
    jo = jopt.AdamWConfig(lr=LR, moment_dtype=jcfg.optimizer_dtype)
    po = AdamWConfig(lr=LR, moment_dtype=pcfg.optimizer_dtype)
    jstate = jsteps.TrainState(params, jopt.adamw_init(params, jo))
    jstep = jax.jit(jsteps.make_train_step(jcfg, jax_api(jcfg), opt_cfg=jo))
    state = TrainState(model, adamw_init(dict(model.named_parameters()),
                                         po))
    step = make_train_step(pcfg, get_api(pcfg), opt_cfg=po)
    with _F64():
        state64 = TrainState(model64, adamw_init(
            dict(model64.named_parameters()), po))
    step64 = make_train_step(pcfg, get_api(pcfg), opt_cfg=po)

    def rel(a, b):
        return abs(float(a) - float(b)) / abs(float(b))

    def l1(tree, named64):
        want = params_of(model64, named64)
        return sum(float(np.abs(np.asarray(g, np.float64) - w).sum())
                   for g, w in zip(jax.tree.leaves(tree),
                                   jax.tree.leaves(want)))

    for i in range(1, STEPS + 1):
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, pb)
        with _F64():
            state64, m64 = step64(state64, pb)
        assert m64["loss"].dtype == torch.float64
        for key, tol in (("loss", "loss"), ("grad_norm", "gnorm")):
            assert rel(m[key], m64[key]) < F64_REL[tol], (i, key)
            assert rel(jm[key], m[key]) < EIGHT_ROWS[tol], (i, key)
    for key in ("loss", "grad_norm"):
        assert rel(jm[key], m64[key]) > 10 * rel(m[key], m64[key]), key
    named64 = {n: t.detach() for n, t in model64.named_parameters()}
    port = params_of(model, {n: t.detach().double()
                             for n, t in model.named_parameters()})
    assert l1(jstate.params, named64) > 10 * l1(port, named64)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    labels[1] = -1                                  # a wholly masked row
    labels[2, :2] = -1
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jsteps.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    none = np.full_like(labels, -1)                 # count 0: max(count, 1)
    assert float(cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(none))) == 0.0
    assert float(jsteps.cross_entropy(jnp.asarray(logits),
                                      jnp.asarray(none))) == 0.0


@pytest.mark.parametrize("moment_dtype", ("float32", "bfloat16"))
def test_adamw_update_matches_jax(moment_dtype):
    """Three steps on a tree of 1-, 2- and 3-D f32 leaves (and one bf16
    leaf); the port's decay set is JAX's rule on these shapes."""
    rng = np.random.default_rng(3)
    shapes = {"bias": (7,), "w": (5, 6), "stack": (3, 4, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jp["half"] = jnp.asarray(rng.standard_normal((4, 3)), jnp.bfloat16)
    pp = {k: _tensor(np.asarray(v)) for k, v in jp.items()}
    cfg = dict(lr=1e-2, moment_dtype=moment_dtype)
    jstate = jopt.adamw_init(jp, jopt.AdamWConfig(**cfg))
    pstate = adamw_init(pp, AdamWConfig(**cfg))
    decay = {k for k, v in pp.items() if v.dim() >= 2}
    for i in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in pp.items()}
        jg = {k: jnp.asarray(g, jp[k].dtype) for k, g in grads.items()}
        pg = {k: _tensor(np.asarray(g)) for k, g in jg.items()}
        jp, jstate = jopt.adamw_update(jp, jg, jstate,
                                       jopt.AdamWConfig(**cfg))
        pp, pstate = adamw_update(pp, pg, pstate, AdamWConfig(**cfg),
                                  decay=decay)
        for k in pp:
            for got, want in ((pp[k], jp[k]), (pstate["m"][k],
                                               jstate["m"][k]),
                              (pstate["v"][k], jstate["v"][k])):
                want = np.asarray(want.astype(jnp.float32))
                ulp = 2.0 ** -7 if got.dtype == torch.bfloat16 else 2e-6
                np.testing.assert_allclose(
                    got.float().numpy(), want, rtol=ulp, atol=1e-7,
                    err_msg=f"{k} step {i + 1}")
        assert int(pstate["step"]) == int(jstate["step"]) == i + 1


@pytest.mark.parametrize("arch", SERVED)
def test_decay_set_matches_jax(arch):
    """JAX's adamw_update itself says which leaves it decays: from all
    ones, a zero gradient, lr 1 and weight decay 1, a decayed element
    becomes 0 and any other stays 1. Carried into the port's names, the
    zeros are decayed_names."""
    jcfg, pcfg = jax_config(arch, True), get_config(arch, True)
    params, model = jax_and_port(jcfg, pcfg)
    ones = jax.tree.map(jnp.ones_like, params)
    zeros = jax.tree.map(jnp.zeros_like, params)
    cfg = jopt.AdamWConfig(lr=1.0, weight_decay=1.0)
    after, _ = jopt.adamw_update(ones, zeros, jopt.adamw_init(ones, cfg),
                                 cfg)
    want = {name for name, p in port_of(pcfg, after).named_parameters()
            if not p.any()}
    assert decayed_names(model) == want
    assert "ln_f.weight" not in want
    assert any(name.endswith(".ln1.weight") for name in want)


@pytest.mark.parametrize("arch", ("phi4-mini-3.8b", "recurrentgemma-2b",
                                  "rwkv6-1.6b", "whisper-large-v3"))
def test_remat_changes_no_bit(arch):
    """Two steps with remat on and off (the same draws): loss, grad norm,
    parameters and moments identical."""
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(get_config(arch, True), remat=remat,
                                  microbatches=2)
        api = get_api(cfg)
        model = api.init(cfg, 1, device="cpu",
                         generator=torch.Generator().manual_seed(0))
        from repro_torch.launch import specs
        batch = specs.train_inputs(cfg, S, B,
                                   torch.Generator().manual_seed(1))
        state = TrainState(model, adamw_init(dict(model.named_parameters()),
                                             AdamWConfig(lr=LR)))
        step = make_train_step(cfg, api, opt_cfg=AdamWConfig(lr=LR))
        metrics = [step(state, batch)[1] for _ in range(2)]
        out.append((metrics, dict(model.named_parameters()), state.opt))
    (m0, p0, o0), (m1, p1, o1) = out
    for a, b in zip(m0, m1):
        assert torch.equal(a["loss"], b["loss"])
        assert torch.equal(a["grad_norm"], b["grad_norm"])
    for name in p0:
        assert torch.equal(p0[name], p1[name]), name
        assert torch.equal(o0["m"][name], o1["m"][name]), name
        assert torch.equal(o0["v"][name], o1["v"][name]), name


# -- the launcher ------------------------------------------------------------

def _run(*argv):
    args = launch_train.build_parser().parse_args(
        ["--device", "cpu", "--smoke", "--arch", "phi4-mini-3.8b",
         "--batch", "4", "--seq", "32", *argv])
    return launch_train.run(args)


def test_launcher_loss_falls(capsys):
    out = _run("--steps", "5")
    assert len(out["losses"]) == 5
    assert out["losses"][-1] < out["losses"][0]
    lines = capsys.readouterr().out.splitlines()
    # The compute layout's bytes, then JAX's lines.
    assert lines[0].startswith("parameters held a rank while computing: ")
    assert lines[1].startswith("step     0 loss ")
    assert any(ln.startswith("final loss ") for ln in lines)
    assert any("tokens/s" in ln for ln in lines)


def test_launcher_resume_is_bitwise(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    _run("--steps", "2", "--ckpt-dir", ckpt, "--ckpt-every", "2")
    resumed = _run("--steps", "6", "--ckpt-dir", ckpt, "--ckpt-every", "2")
    assert "restored checkpoint at step 2" in capsys.readouterr().out
    assert resumed["start"] == 2 and len(resumed["losses"]) == 4
    whole = _run("--steps", "6")
    a, b = resumed["state"], whole["state"]
    for name, p in a.params.named_parameters():
        assert torch.equal(p, dict(b.params.named_parameters())[name]), name
        assert torch.equal(a.opt["m"][name], b.opt["m"][name]), name
        assert torch.equal(a.opt["v"][name], b.opt["v"][name]), name
    assert int(a.opt["step"]) == int(b.opt["step"]) == 6
    assert resumed["losses"] == whole["losses"][2:]


@pytest.mark.parametrize("flag", (["--data", "2"], ["--model", "2"],
                                  ["--sketch-grads", "-8"]))
def test_launcher_refuses_the_mesh_flags(flag, capsys):
    """A mesh larger than the world (this process is a world of one: a
    mesh of 2 needs torchrun), and a negative r'."""
    with pytest.raises(SystemExit) as exc:
        launch_train.main(["--device", "cpu", "--smoke", *flag])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert ("torchrun --nproc_per_node 2" in err if flag[0] != "--sketch-grads"
            else "at least 0" in err)


def test_launcher_needs_the_card_by_default(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--steps", "1"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env={**os.environ,
                          "PYTHONPATH": os.path.join(REPO, "src"),
                          "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr


def test_parser_defaults_are_jax_launchers():
    args = launch_train.build_parser().parse_args([])
    assert isinstance(args, argparse.Namespace)
    assert (args.arch, args.smoke, args.steps, args.batch, args.seq,
            args.data, args.model, args.ckpt_dir, args.ckpt_every,
            args.sketch_grads, args.lr, args.device, args.seed) == (
        "qwen3-14b", False, 100, 4, 64, 1, 1, "", 50, 0, 3e-3, "cuda", 0)
