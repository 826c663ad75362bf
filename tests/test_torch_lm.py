"""The port's decoder-only LMs against repro.models on the CPU, per arch.

The seven decoder-only smoke configs (dense, moe, vlm), the hybrid's
(recurrentgemma, 5 layers R R A R R, window 32), the ssm's (rwkv6, 2
layers) and the encoder-decoder's (whisper, 2 + 2 layers, 16 audio
frames), f32, JAX's init_lm / init_rg / init_rwkv / init_whisper weights
carried across by repro_torch.models.convert (lm_from_jax / rg_from_jax
/ rwkv_from_jax / whisper_from_jax), token ids and whisper's frames drawn
with numpy. Each is driven through both packages' registry and step
functions: forward, prefill (logits and the f32 cache: k and v, the
hybrid's h and conv state, the ssm's s, tm and cm, whisper's xk and xv),
then 8 greedy decode steps. Tolerance: 1e-4 abs on logits (of
magnitude up to ~5; the two agree to ~1e-5 in f32) and 1e-5 abs on the
cache; the greedy tokens must be identical. Mixtral's and the hybrid's
smoke window is 32, so a prompt of 40 takes prefill's ring branch
(lm.py:99-102, rglru.py:241-253).

The slice as a whole: the port's launcher (`repro_torch.launch.serve
--device cpu`, phi4, recurrentgemma, rwkv6 and whisper smoke; whisper's
frames handed to JAX as the launcher drew them) prints the same
generated ids as the JAX launcher's logic (repro/launch/serve.py: jitted
prefill / decode steps, f32 cache, argmax) given the port's weights and
prompt.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.registry import get_api as jax_api
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import get_api
from repro_torch.train import make_decode_step, make_prefill_step
from torch_lm_common import SERVED, cache_keys, jax_and_port, np_of, params_of

LOGIT_TOL = dict(rtol=0, atol=1e-4)
CACHE_TOL = dict(rtol=0, atol=1e-5)
B, S, MAX_SEQ, GEN = 2, 12, 32, 8


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _batches(cfg, tok, seed=1):
    """The same batch for JAX's registry and the port's: the tokens, and
    for encdec audio frames (B, n_audio_frames, d) drawn with numpy."""
    jb, pb = {"tokens": jnp.asarray(tok)}, {"tokens": torch.from_numpy(tok)}
    if cfg.family == "encdec":
        frames = np.random.default_rng(seed).standard_normal(
            (tok.shape[0], cfg.n_audio_frames, cfg.d_model)).astype(
                cfg.dtype)
        jb["frames"], pb["frames"] = (jnp.asarray(frames),
                                      torch.from_numpy(frames))
    return jb, pb


def _setup(arch):
    jcfg, pcfg = jax_config(arch, True), get_config(arch, True)
    params, model = jax_and_port(jcfg, pcfg)
    return jcfg, pcfg, params, model


@pytest.mark.parametrize("arch", SERVED)
def test_forward(arch):
    jcfg, pcfg, params, model = _setup(arch)
    jb, pb = _batches(pcfg, _tokens(pcfg, (B, S)))
    want = jax_api(jcfg).forward(params, jcfg, jb, 1)
    with torch.no_grad():
        got = get_api(pcfg).forward(model, pb, 1)
    assert got.dtype == torch.float32
    assert got.shape == (B, S, pcfg.vocab_padded(1))
    np.testing.assert_allclose(np_of(got), np.asarray(want), **LOGIT_TOL)


def test_vlm_forward_with_patch_prefix():
    jcfg, pcfg, params, model = _setup("pixtral-12b")
    tok = _tokens(pcfg, (B, S))
    patches = np.random.default_rng(1).standard_normal(
        (B, pcfg.n_patch_tokens, pcfg.d_model)).astype(np.float32)
    want = jax_api(jcfg).forward(params, jcfg, {
        "tokens": jnp.asarray(tok), "patches": jnp.asarray(patches)}, 1)
    with torch.no_grad():
        got = get_api(pcfg).forward(model, {
            "tokens": torch.from_numpy(tok),
            "patches": torch.from_numpy(patches)}, 1)
    assert got.shape == (B, pcfg.n_patch_tokens + S, pcfg.vocab_padded(1))
    np.testing.assert_allclose(np_of(got), np.asarray(want), **LOGIT_TOL)


def _serve_both(arch, prompt_len, max_seq):
    """Prefill then GEN greedy decode steps in both packages, held step by
    step; returns the port's cache."""
    jcfg, pcfg, params, model = _setup(arch)
    tok = _tokens(pcfg, (B, prompt_len))
    japi, papi = jax_api(jcfg), get_api(pcfg)
    jpre = jax.jit(jsteps.make_prefill_step(jcfg, japi))
    jdec = jax.jit(jsteps.make_decode_step(jcfg, japi))
    ppre, pdec = make_prefill_step(pcfg, papi), make_decode_step(pcfg, papi)
    jcache = japi.init_cache(jcfg, B, max_seq, jnp.float32)
    pcache = papi.init_cache(pcfg, B, max_seq, torch.float32, "cpu")
    jb, pb = _batches(pcfg, tok)
    jl, jcache = jpre(params, jb, jcache)
    pl, pcache = ppre(model, pb, pcache)
    np.testing.assert_allclose(np_of(pl), np.asarray(jl), **LOGIT_TOL)
    assert pcache["pos"] == int(jcache["pos"]) == prompt_len
    keys = cache_keys(pcfg)
    for key in keys:
        assert pcache[key].dtype == torch.float32
        np.testing.assert_allclose(np_of(pcache[key]),
                                   np.asarray(jcache[key]), **CACHE_TOL)
    jt = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    pt = torch.argmax(pl, dim=-1).to(torch.int32)
    for _ in range(GEN):
        np.testing.assert_array_equal(np_of(pt), np.asarray(jt))
        jt, jl, jcache = jdec(params, jt, jcache)
        pt, pl, pcache = pdec(model, pt, pcache)
        np.testing.assert_allclose(np_of(pl), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_array_equal(np_of(pt), np.asarray(jt))
    for key in keys:
        np.testing.assert_allclose(np_of(pcache[key]),
                                   np.asarray(jcache[key]), **CACHE_TOL)
    assert pcache["pos"] == int(jcache["pos"]) == prompt_len + GEN
    return pcache


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_and_greedy_decode(arch):
    """An attention cache holds MAX_SEQ slots; the ssm's state does not
    grow with the sequence."""
    cache = _serve_both(arch, S, MAX_SEQ)
    if "k" in cache:
        assert cache["k"].shape[2] == MAX_SEQ
    else:
        assert cache["s"].shape[1:] == (B, 4, 16, 16)


def test_mixtral_prefill_past_the_window():
    """S = 40 > window 32: the cache keeps the last 32 positions rolled
    into ring order, and decode wraps on from there."""
    assert get_config("mixtral-8x7b", True).window == 32
    assert _serve_both("mixtral-8x7b", 40, 64)["k"].shape[2] == 32


def test_hybrid_prefill_past_the_window():
    """The same for the hybrid's local attention layer (window 32): a
    prompt of 40 into a cache of 64 positions keeps 32 ring slots."""
    assert get_config("recurrentgemma-2b", True).window == 32
    assert _serve_both("recurrentgemma-2b", 40, 64)["k"].shape[2] == 32


def test_full_attention_prompt_longer_than_the_cache_refused():
    _, pcfg, _, model = _setup("phi4-mini-3.8b")
    cache = model.init_cache(1, 8, torch.float32)
    with pytest.raises(ValueError, match="does not fit"):
        model.prefill(torch.from_numpy(_tokens(pcfg, (1, 9))), cache)


def _launcher_against_jax(capsys, arch, smoke_name):
    """The port's launcher on `arch`'s smoke config at --device cpu
    against repro/launch/serve.py's logic on the same weights and
    prompt."""
    args = serve.build_parser().parse_args(["--device", "cpu", "--arch",
                                            arch])
    out = serve.run(args)
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith(f"arch={smoke_name} batch=4 prefill 16 tok")
    ids = [int(i) for i in printed[1].split("[")[1].rstrip("]").split(",")]

    cfg = jax_config(arch, smoke=True)
    api = jax_api(cfg)
    params = jax.tree.map(jnp.asarray, params_of(out["model"]))
    prefill = jax.jit(jsteps.make_prefill_step(cfg, api, groups=1))
    decode = jax.jit(jsteps.make_decode_step(cfg, api, groups=1))
    pb = {"tokens": jnp.asarray(np_of(out["prompt"]))}
    if out["frames"] is not None:
        pb["frames"] = jnp.asarray(np_of(out["frames"]))
    cache = api.init_cache(cfg, args.batch, args.max_seq, jnp.float32)
    logits, cache = prefill(params, pb, cache)
    tokens = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    generated = [np.asarray(tokens)]
    for _ in range(args.gen):
        tokens, logits, cache = decode(params, tokens, cache)
        generated.append(np.asarray(tokens))
    gen = np.stack(generated, axis=1)
    assert gen.shape == (args.batch, args.gen + 1)
    np.testing.assert_array_equal(out["generated"], gen)
    assert ids == gen[0].tolist()
    np.testing.assert_allclose(np_of(out["logits"]), np.asarray(logits),
                               **LOGIT_TOL)


def test_launcher_generates_jax_ids(capsys):
    _launcher_against_jax(capsys, "phi4-mini-3.8b", "phi4-smoke")


def test_hybrid_launcher_generates_jax_ids(capsys):
    _launcher_against_jax(capsys, "recurrentgemma-2b", "recurrentgemma-smoke")


def test_ssm_launcher_generates_jax_ids(capsys):
    _launcher_against_jax(capsys, "rwkv6-1.6b", "rwkv6-smoke")


def test_encdec_launcher_generates_jax_ids(capsys):
    _launcher_against_jax(capsys, "whisper-large-v3", "whisper-smoke")


def test_launcher_main_exits_zero(capsys):
    assert serve.main(["--device", "cpu", "--arch", "mixtral-8x7b",
                       "--prompt-len", "40", "--max-seq", "64"]) == 0
    assert "arch=mixtral-smoke" in capsys.readouterr().out
