"""The decoder-only LM serving path on the card against its own CPU path.

Run on a machine with a CUDA device (it needs no JAX, which
tests/conftest.py imports):

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_lm_cuda.py

The same weights (drawn on the CPU from torch seed 0, loaded into a model
on the card) and token ids go through both devices in f32 with TF32 off:
forward, prefill (logits and cache) and greedy decode agree within 1e-4
abs on logits (the CPU tests' bound against JAX; the two devices sum in
other orders) and the greedy tokens are identical. At the smoke configs
of the seven decoder-only archs, the hybrid (mixtral's and the hybrid's
prompt of 40 past their window of 32 too), the ssm (rwkv6: prompts of
12 and 64, one chunk; 128, two chunks) and the encoder-decoder (whisper:
the same frames on both devices, the cross cache xk and xv too) and at
phi4-mini's published width, depth cut to 2; the launcher's defaults,
the hybrid, the ssm and whisper through it serve on the card.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import get_api

ARCHS = ("phi4-mini-3.8b", "qwen3-14b", "nemotron-4-340b",
         "command-r-plus-104b", "mixtral-8x7b", "dbrx-132b", "pixtral-12b")
TOL = 1e-4


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the LM path runs on the card")
    serve.set_matmul_precision()


def _both(cfg):
    init = get_api(cfg).init
    cpu = init(cfg, tp=1, device="cpu",
               generator=torch.Generator().manual_seed(0))
    gpu = init(cfg, tp=1, device="meta").to_empty(device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def _serve(model, tokens, gen, max_seq, frames=None):
    """forward logits, then prefill + `gen` greedy steps: every step's
    logits and tokens, and the final cache. `frames`: an encoder-decoder's
    audio frames, handed to forward and prefill."""
    tokens = tokens.to(model.device)
    extra = () if frames is None else (frames.to(model.device),)
    with torch.no_grad():
        out = {"forward": model(tokens, *extra), "logits": [], "tokens": []}
        cache = model.init_cache(tokens.shape[0], max_seq, torch.float32)
        logits, cache = model.prefill(tokens, *extra, cache)
        for _ in range(gen):
            nxt = logits.argmax(-1).to(torch.int32)
            out["logits"].append(logits)
            out["tokens"].append(nxt)
            logits, cache = model.decode(nxt, cache)
    out["cache"] = cache
    return out


def _hold(cfg, B, S, gen, max_seq):
    cpu, gpu = _both(cfg)
    draws = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=draws,
                           dtype=torch.int32)
    frames = (torch.randn((B, cfg.n_audio_frames, cfg.d_model),
                          generator=draws).to(getattr(torch, cfg.dtype))
              if cfg.family == "encdec" else None)
    want, got = _serve(cpu, tokens, gen, max_seq, frames), \
        _serve(gpu, tokens, gen, max_seq, frames)
    torch.testing.assert_close(got["forward"].cpu(), want["forward"],
                               rtol=0, atol=TOL)
    for g, w in zip(got["logits"], want["logits"]):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=TOL)
    for g, w in zip(got["tokens"], want["tokens"]):
        assert torch.equal(g.cpu(), w)
    keys = {"hybrid": ("h", "conv", "k", "v"), "ssm": ("s", "tm", "cm"),
            "encdec": ("k", "v", "xk", "xv")}.get(cfg.family, ("k", "v"))
    for key in keys:
        torch.testing.assert_close(got["cache"][key].cpu(),
                                   want["cache"][key], rtol=0, atol=TOL)
    assert got["cache"]["pos"] == want["cache"]["pos"] == S + gen


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_card_equals_cpu(card, arch):
    _hold(get_config(arch, smoke=True), B=2, S=12, gen=8, max_seq=32)


@pytest.mark.cuda
def test_mixtral_ring_card_equals_cpu(card):
    _hold(get_config("mixtral-8x7b", smoke=True), B=2, S=40, gen=8,
          max_seq=64)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [12, 40])
def test_hybrid_smoke_card_equals_cpu(card, S):
    """recurrentgemma smoke (R R A R R, window 32); S = 40 takes the
    prefill's ring branch."""
    _hold(get_config("recurrentgemma-2b", smoke=True), B=2, S=S, gen=8,
          max_seq=64)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [12, 64, 128])
def test_ssm_smoke_card_equals_cpu(card, S):
    """rwkv6 smoke (2 layers, heads of 16): S = 128 runs two chunks of 64
    with the state carried between them."""
    _hold(get_config("rwkv6-1.6b", smoke=True), B=2, S=S, gen=8,
          max_seq=S + 8)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [12, 24])
def test_encdec_smoke_card_equals_cpu(card, S):
    """whisper smoke (2 + 2 layers, 16 audio frames): text shorter and
    longer than the frames."""
    _hold(get_config("whisper-large-v3", smoke=True), B=2, S=S, gen=8,
          max_seq=S + 8)


@pytest.mark.cuda
def test_phi4_width_depth2_f32_card_equals_cpu(card):
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b"), n_layers=2,
                              param_dtype="float32", dtype="float32")
    _hold(cfg, B=2, S=64, gen=4, max_seq=128)


@pytest.mark.cuda
def test_launcher_defaults_serve_on_the_card(card, capsys):
    assert serve.main([]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=phi4-smoke batch=4 prefill 16 tok")
    assert lines[2].startswith("device cuda: decode")
    assert lines[2].endswith(" GB")


@pytest.mark.cuda
def test_hybrid_launcher_serves_on_the_card(card, capsys):
    assert serve.main(["--arch", "recurrentgemma-2b"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=recurrentgemma-smoke batch=4 prefill")
    assert lines[2].startswith("device cuda: decode")


@pytest.mark.cuda
def test_ssm_launcher_serves_on_the_card(card, capsys):
    assert serve.main(["--arch", "rwkv6-1.6b"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=rwkv6-smoke batch=4 prefill")
    assert lines[2].startswith("device cuda: decode")


@pytest.mark.cuda
def test_encdec_launcher_serves_on_the_card(card, capsys):
    assert serve.main(["--arch", "whisper-large-v3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=whisper-smoke batch=4 prefill")
    assert lines[2].startswith("device cuda: decode")
