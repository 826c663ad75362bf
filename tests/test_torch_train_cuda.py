"""The training loop on the card against its own CPU path.

Run on a machine with a CUDA device (it needs no JAX, which
tests/conftest.py imports):

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_train_cuda.py

The same weights (drawn on the CPU from torch seed 0, loaded into a model
on the card) and batch go through 3 train steps on both devices in f32
with TF32 off, at phi4-mini's smoke config at M 1 and at M 2 with remat,
and at recurrentgemma's at M 2 with remat: the loss and grad norm within
1e-5 relative, m and v within 5e-4 of their tensor's largest, every
parameter within 0.05 lr, except elements whose gradient at some step was
below 1e-5 of their tensor's largest (under 0.1 % of each tensor). These
are the tolerances tests/test_torch_train.py holds the port to against
JAX and chip_smoke phase 17b's, but for the exception's threshold: there
it is 1e-6, and here one element of recurrentgemma's (a w3 of its
remainder layers, its gradient 1.7e-6 of the tensor's largest) missed
0.05 lr by 2.6 % on the H100 (a step moves an element by lr m_hat /
(sqrt(v_hat) + eps), which carries the relative error of a small
gradient). The launcher trains on the card and its checkpoints restore
there.
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch import specs
from repro_torch.launch import train as launch_train
from repro_torch.models import get_api
from repro_torch.train import (AdamWConfig, TrainState, adamw_init,
                               make_train_step)

LR, STEPS = 3e-3, 3
TOL = {"loss": 1e-5, "gnorm": 1e-5, "moments": 5e-4, "lr_frac": 0.05,
       "small": 1e-5, "miss": 1e-3}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: this is the card's training path")
    serve.set_matmul_precision()


def _hold(what, got, want, ratio):
    """`ratio`: each element's smallest |gradient| / its tensor's largest
    over the steps so far."""
    for name, g in got.items():
        g, w = g.detach().float().cpu(), want[name].detach().float().cpu()
        unit = (TOL["lr_frac"] * LR if what == "params"
                else TOL["moments"] * float(w.abs().max()))
        err = (g - w).abs() / unit
        s = ratio[name] < TOL["small"]
        worst = int(torch.argmax(torch.where(s, 0.0, err)))
        assert not bool((err > 1)[~s].any()), (
            f"{what} {name}: {int((err > 1)[~s].sum())} elements off, the "
            f"worst {float(err.view(-1)[worst])} of the tolerance at a "
            f"gradient ratio {float(ratio[name].view(-1)[worst])}")
        assert int((err > 1)[s].sum()) < TOL["miss"] * g.numel(), (what,
                                                                   name)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,cut", [
    ("phi4-mini-3.8b", {}),
    ("phi4-mini-3.8b", {"microbatches": 2, "remat": True}),
    ("recurrentgemma-2b", {"microbatches": 2, "remat": True})])
def test_card_steps_equal_the_cpu(card, arch, cut):
    cfg = dataclasses.replace(get_config(arch, smoke=True), **cut)
    api = get_api(cfg)
    cpu = api.init(cfg, tp=1, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    gpu = api.init(cfg, tp=1, device="meta").to_empty(device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    batch = specs.train_inputs(cfg, 64, 4, torch.Generator().manual_seed(1))
    ratio = {}

    def record(grads):
        for name, g in grads.items():
            r = g.abs() / g.abs().max().clamp_min(1e-30)
            ratio[name] = torch.minimum(ratio[name], r) if name in ratio \
                else r
        return grads

    opt = AdamWConfig(lr=LR)
    states = [TrainState(m, adamw_init(dict(m.named_parameters()), opt))
              for m in (cpu, gpu)]
    steps = [make_train_step(cfg, api, grad_transform=record, opt_cfg=opt),
             make_train_step(cfg, api, opt_cfg=opt)]
    for _ in range(STEPS):
        _, want = steps[0](states[0], batch)
        _, got = steps[1](states[1], {k: v.cuda() for k, v in batch.items()})
        assert got["loss"].device.type == "cuda"
        for key, tol in (("loss", TOL["loss"]), ("grad_norm", TOL["gnorm"])):
            assert abs(float(got[key]) - float(want[key])) <= \
                tol * abs(float(want[key])), key
        _hold("params", dict(gpu.named_parameters()),
              dict(cpu.named_parameters()), ratio)
        for key in ("m", "v"):
            _hold(key, states[1].opt[key], states[0].opt[key], ratio)


@pytest.mark.cuda
def test_launcher_trains_and_restores_on_the_card(card, tmp_path, capsys):
    base = ["--smoke", "--arch", "phi4-mini-3.8b", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2"]
    first = launch_train.run(launch_train.build_parser().parse_args(
        base + ["--steps", "2"]))
    assert first["losses"][-1] < first["losses"][0]
    assert first["state"].opt["step"].device.type == "cuda"
    again = launch_train.run(launch_train.build_parser().parse_args(
        base + ["--steps", "4"]))
    assert "restored checkpoint at step 2" in capsys.readouterr().out
    assert again["start"] == 2 and len(again["losses"]) == 2


@pytest.fixture(scope="module")
def nccl_mesh(card):
    from repro_torch.launch.mesh import make_debug_mesh
    made = not dist.is_initialized()
    yield make_debug_mesh(1, 1)
    if made and dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,cut", [
    ("phi4-mini-3.8b", {"microbatches": 2, "remat": True}),
    ("mixtral-8x7b", {})])
def test_sharded_step_at_world_one_is_the_meshless_step(nccl_mesh, arch,
                                                        cut):
    from repro_torch.train import shard_train_state
    cfg = dataclasses.replace(get_config(arch, smoke=True), **cut)
    api = get_api(cfg)
    cpu = api.init(cfg, tp=1, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    opt = AdamWConfig(lr=LR)
    models = []
    for _ in range(2):
        m = api.init(cfg, tp=1, device="meta").to_empty(device="cuda")
        m.load_state_dict(cpu.state_dict())
        models.append(m)
    states = [TrainState(m, adamw_init(dict(m.named_parameters()), opt))
              for m in models]
    states[1] = shard_train_state(states[1], nccl_mesh)
    steps = [make_train_step(cfg, api, opt_cfg=opt),
             make_train_step(cfg, api, opt_cfg=opt, mesh=nccl_mesh)]
    batch = {k: v.cuda() for k, v in specs.train_inputs(
        cfg, 64, 4, torch.Generator().manual_seed(1)).items()}
    for i in range(STEPS):
        (_, a), (_, b) = (step(s, batch) for step, s in zip(steps, states))
        assert torch.equal(a["loss"], b["loss"]), i
        assert torch.equal(a["grad_norm"], b["grad_norm"]), i
    pa = dict(models[0].named_parameters())
    for name, p in models[1].named_parameters():
        assert torch.equal(p, pa[name]), name
        for key in ("m", "v"):
            assert torch.equal(states[1].opt[key][name],
                               states[0].opt[key][name]), (key, name)


@pytest.mark.cuda
def test_sketched_gradients_on_the_card_equal_the_plain_path(card):
    from repro_torch.distributed import compression as comp
    from repro_torch.kernels import fwht_op
    n, r_prime = 300_000, 4096
    gen = torch.Generator().manual_seed(3)
    signs, rows = comp.sketch_params(gen, n, r_prime)
    v = torch.randn((n,), generator=gen)
    before = fwht_op.launches
    s_card = comp.compress(v.cuda(), signs.cuda(), rows.cuda())
    s_cpu = comp.compress(v, signs, rows)
    assert float((s_card.cpu() - s_cpu).abs().max()) <= 2e-4
    g_card = comp.decompress(s_cpu.cuda(), signs.cuda(), rows.cuda(), n)
    g_cpu = comp.decompress(s_cpu, signs, rows, n)
    assert float((g_card.cpu() - g_cpu).abs().max()) <= 2e-4
    assert fwht_op.launches == before + 2
    params = {"a": torch.zeros(1000, 300), "b": torch.zeros(7)}
    t_cpu, init_cpu = comp.make_sketched_grad_transform(params, r_prime)
    t_card, init_card = comp.make_sketched_grad_transform(
        {k: p.cuda() for k, p in params.items()}, r_prime)
    ef_cpu, ef_card = init_cpu(), init_card()
    for t in range(2):
        grads = {k: torch.randn(p.shape, generator=gen)
                 for k, p in params.items()}
        draws = comp.sketch_params(torch.Generator().manual_seed(t),
                                   300_007, r_prime)
        out_cpu, ef_cpu = t_cpu(grads, ef_cpu, draws)
        out_card, ef_card = t_card({k: g.cuda() for k, g in grads.items()},
                                   ef_card, tuple(d.cuda() for d in draws))
        assert float((ef_card.cpu() - ef_cpu).abs().max()) <= 2e-4
        for k in params:
            assert float((out_card[k].cpu() - out_cpu[k]).abs().max()) \
                <= 2e-4, (t, k)
