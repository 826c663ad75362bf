"""The port's encoder-decoder family (repro_torch.models.whisper) against
repro.models.whisper on the CPU.

At whisper-smoke (2 encoder + 2 decoder layers, d 64, 4 heads, 16 audio
frames, f32): weights are JAX's init_* draws, carried across by
`models.convert.whisper_from_jax` (the model) or copied leaf by leaf (one
cross-attention); token ids and frames are drawn with numpy from a seed.
Tolerances: 1e-4 abs on logits (of magnitude up to ~5; the two agree to
~1e-5 in f32), 1e-5 abs on the encoder's output, the cross-attention and
the cache; the greedy tokens identical.

The sinusoid's angle pos x inv is formed from exp in f32, which XLA and
torch may round an ulp apart: the angle then differs by pos x 2^-23, so
a position pos is held within 2 (pos + 1) 2^-23 (at 1,500 frames ~4e-4).

bf16 with the f32 cache (the launchers' setting): the two packages round
bf16 at other places (XLA's CPU fusions keep excess precision), so the
model is held to the bf16 roundings of its layers (chip_smoke's
LM_ROUNDINGS, 7, an encoder layer; ENCDEC_ROUNDINGS, 11, a decoder
layer) in each of the two computations, adding up like a random walk:
sqrt(2 x roundings) x 2^-8 x max |logit|.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import whisper as JW
from repro_torch.configs import get_config
from repro_torch.models import Whisper, get_api, whisper
from repro_torch.models.convert import _tensor, whisper_from_jax

ARCH = "whisper-large-v3"
TOL = dict(rtol=0, atol=1e-4)
CACHE_TOL = dict(rtol=0, atol=1e-5)
BF16 = dict(param_dtype="bfloat16", dtype="bfloat16")
ENC_ROUNDINGS, DEC_ROUNDINGS = 7, 11
B, S, GEN = 2, 12, 8
KEYS = ("k", "v", "xk", "xv")


def _np(t):
    return t.detach().float().cpu().numpy()


def _rng(seed=0):
    return np.random.default_rng(seed)


def _configs(cfg_kw=None):
    jcfg, pcfg = jax_config(ARCH, True), get_config(ARCH, True)
    if cfg_kw:
        jcfg = dataclasses.replace(jcfg, **cfg_kw)
        pcfg = dataclasses.replace(pcfg, **cfg_kw)
    return jcfg, pcfg


def _model(cfg_kw=None):
    jcfg, pcfg = _configs(cfg_kw)
    params = JW.init_whisper(jax.random.PRNGKey(0), jcfg, tp=1)
    return jcfg, pcfg, params, whisper_from_jax(
        pcfg, jax.tree.map(np.asarray, params), "cpu")


def _tokens(cfg, shape, seed=0):
    return _rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _frames(cfg, batch=B, seed=1):
    """(batch, n_audio_frames, d) f32 draws; the caller casts them."""
    return _rng(seed).standard_normal(
        (batch, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)


def _both(frames, cfg):
    """frames in cfg.dtype for JAX and for the port."""
    j = jnp.asarray(frames).astype(jnp.dtype(cfg.dtype))
    return j, torch.from_numpy(frames).to(getattr(torch, cfg.dtype))


@pytest.mark.parametrize("S,d", [(16, 64), (24, 64), (1500, 1280)])
def test_sinusoid(S, d):
    got = whisper.sinusoid(S, d)
    want = np.asarray(JW._sinusoid(S, d))
    assert got.dtype == torch.float32 and got.shape == (S, d)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=2 * S * 2.0 ** -23)


@pytest.mark.parametrize("pos", [0, 5, 17, 519])
def test_sinusoid_at(pos):
    got = whisper.sinusoid_at(pos, 64)
    want = np.asarray(JW._sinusoid_at(jnp.asarray(pos, jnp.int32), 64))
    assert got.dtype == torch.float32 and got.shape == (64,)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=2 * (pos + 1) * 2.0 ** -23)
    # The row the forward's table holds at pos, bit for bit.
    assert torch.equal(got, whisper.sinusoid(pos + 1, 64)[pos])


def test_cross_attention():
    """apply_cross_attention and _cross_kv on one layer's weights: x of 7
    positions attends to all 16 encoder positions."""
    jcfg, pcfg = _configs()
    p = JW.init_cross_attention(jax.random.PRNGKey(3), jcfg, jnp.float32)
    xa = whisper.CrossAttention(pcfg, torch.float32, "cpu")
    with torch.no_grad():
        for name, param in xa.named_parameters():
            param.copy_(_tensor(np.asarray(p[name])))
    rng = _rng(4)
    x = rng.standard_normal((B, 7, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, 16, jcfg.d_model)).astype(np.float32)
    jk, jv = JW._cross_kv(p, jcfg, jnp.asarray(enc))
    want = JW.apply_cross_attention(p, jcfg, jnp.asarray(x), jk, jv)
    with torch.no_grad():
        pk, pv = xa.kv(torch.from_numpy(enc))
        got = xa(torch.from_numpy(x), pk, pv)
    assert pk.shape == jk.shape == (B, 16, jcfg.n_kv_heads, jcfg.head_dim)
    for g, w in ((pk, jk), (pv, jv), (got, want)):
        np.testing.assert_allclose(_np(g), np.asarray(w), **CACHE_TOL)


def test_encode():
    """encode: frames + sinusoid, 2 non-causal blocks (RoPE included, as
    JAX's _qkv applies it), enc_ln."""
    jcfg, pcfg, params, model = _model()
    jf, pf = _both(_frames(pcfg), pcfg)
    want = JW.encode(params, jcfg, jf)
    with torch.no_grad():
        got = model.encode(pf)
    assert got.shape == (B, pcfg.n_audio_frames, pcfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want), **CACHE_TOL)


@pytest.mark.parametrize("S", [1, 12, 24])
def test_forward(S):
    """forward_whisper's teacher-forced logits, with text shorter and
    longer than the 16 frames."""
    jcfg, pcfg, params, model = _model()
    tok = _tokens(pcfg, (B, S))
    jf, pf = _both(_frames(pcfg), pcfg)
    want = JW.forward_whisper(params, jcfg, jnp.asarray(tok), jf)
    with torch.no_grad():
        got = model(torch.from_numpy(tok), pf)
    assert got.dtype == torch.float32
    assert got.shape == (B, S, pcfg.vocab_padded(1))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_prefill_and_greedy_decode_against_jax():
    """prefill_whisper's logits and k, v, xk, xv, pos; then 8 greedy
    decode_whisper steps, each step's logits, tokens and cache."""
    jcfg, pcfg, params, model = _model()
    tok = _tokens(pcfg, (B, S))
    jf, pf = _both(_frames(pcfg), pcfg)
    jcache = JW.init_cache_whisper(jcfg, B, 32, jnp.float32)
    pcache = model.init_cache(B, 32, torch.float32)
    jl, jcache = JW.prefill_whisper(params, jcfg, jnp.asarray(tok), jf,
                                    jcache)
    pl, pcache = model.prefill(torch.from_numpy(tok), pf, pcache)
    for i in range(GEN + 1):
        np.testing.assert_allclose(_np(pl), np.asarray(jl), **TOL)
        assert pcache["pos"] == int(jcache["pos"]) == S + i
        for key in KEYS:
            assert pcache[key].dtype == torch.float32
            np.testing.assert_allclose(_np(pcache[key]),
                                       np.asarray(jcache[key]), **CACHE_TOL)
        jt = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        pt = pl.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(_np(pt), np.asarray(jt))
        if i < GEN:
            jl, jcache = JW.decode_whisper(params, jcfg, jt, jcache)
            pl, pcache = model.decode(pt, pcache)


def test_the_cross_cache_is_the_encoders_and_stays():
    """After prefill xk, xv hold each layer's _cross_kv of encode(frames),
    bit for bit; decode steps leave them as they are, bit for bit, and
    the self-attention slots past pos at zero."""
    _, pcfg, _, model = _model()
    tok = torch.from_numpy(_tokens(pcfg, (B, S + 4)))
    _, pf = _both(_frames(pcfg), pcfg)
    cache = model.init_cache(B, 32, torch.float32)
    with torch.no_grad():
        model.prefill(tok[:, :S], pf, cache)
        enc = model.encode(pf)
        want = [blk.xattn.kv(enc) for blk in model.dec_layers]
        kept = {key: cache[key].clone() for key in ("xk", "xv")}
        for i, (k, v) in enumerate(want):
            assert torch.equal(cache["xk"][i], k)
            assert torch.equal(cache["xv"][i], v)
        for i in range(4):
            model.decode(tok[:, S + i], cache)
    for key in ("xk", "xv"):
        assert torch.equal(cache[key], kept[key])
    assert cache["pos"] == S + 4
    assert not cache["k"][:, :, S + 4:].any()
    assert cache["k"][:, :, S + 3].abs().sum() > 0


def test_decode_equals_forward():
    """prefill(S) then 8 teacher-forced decode steps give forward(S + 8)'s
    logits at each position (the port against itself, f32)."""
    _, pcfg, _, model = _model()
    tok = torch.from_numpy(_tokens(pcfg, (B, S + GEN), seed=3))
    _, pf = _both(_frames(pcfg), pcfg)
    with torch.no_grad():
        full = model(tok, pf)
    cache = model.init_cache(B, S + GEN, torch.float32)
    logits, cache = model.prefill(tok[:, :S], pf, cache)
    np.testing.assert_allclose(_np(logits), _np(full[:, S - 1]), **TOL)
    for i in range(GEN):
        logits, cache = model.decode(tok[:, S + i], cache)
        np.testing.assert_allclose(_np(logits), _np(full[:, S + i]), **TOL)


def test_bf16_smoke_with_the_f32_cache():
    """The launchers' setting: bf16 weights and frames, an f32 cache.
    Prefill and 8 decode steps fed JAX's greedy tokens in both packages;
    logits within the bf16 tolerance of the module docstring, each greedy
    token equal or a near tie within it; the cache f32 and within the
    same relative tolerance of JAX's."""
    jcfg, pcfg, params, model = _model(BF16)
    tok = _tokens(pcfg, (B, S))
    jf, pf = _both(_frames(pcfg), pcfg)
    assert pf.dtype == torch.bfloat16
    jcache = JW.init_cache_whisper(jcfg, B, 32, jnp.float32)
    pcache = model.init_cache(B, 32, torch.float32)
    jl, jcache = jax.jit(JW.prefill_whisper, static_argnums=1)(
        params, jcfg, jnp.asarray(tok), jf, jcache)
    pl, pcache = model.prefill(torch.from_numpy(tok), pf, pcache)
    roundings = (ENC_ROUNDINGS * pcfg.n_encoder_layers
                 + DEC_ROUNDINGS * pcfg.n_layers)
    rel = math.sqrt(2 * roundings) * 2.0 ** -8
    jdec = jax.jit(JW.decode_whisper, static_argnums=1)
    jt = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    for _ in range(GEN):
        want = np.asarray(jl)
        tol = rel * np.abs(want).max()
        got = _np(pl)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        pick = got.argmax(-1)
        gap = want.max(-1) - want[np.arange(B), pick]
        assert (gap <= tol).all(), gap
        pl, pcache = model.decode(torch.from_numpy(np.array(jt)), pcache)
        jl, jcache = jdec(params, jcfg, jt, jcache)
        jt = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    for key in KEYS:
        assert pcache[key].dtype == torch.float32
        want = np.asarray(jcache[key])
        np.testing.assert_allclose(_np(pcache[key]), want, rtol=0,
                                   atol=rel * np.abs(want).max())


def test_prompt_longer_than_the_cache_refused():
    """9 tokens into 8 slots: JAX's dynamic_update_slice refuses it at
    trace time, the port's Attention.prefill with a ValueError."""
    jcfg, pcfg, params, model = _model()
    tok = _tokens(pcfg, (1, 9))
    jf, pf = _both(_frames(pcfg, 1), pcfg)
    with pytest.raises(TypeError, match="update shape must be smaller"):
        JW.prefill_whisper(params, jcfg, jnp.asarray(tok), jf,
                           JW.init_cache_whisper(jcfg, 1, 8, jnp.float32))
    with pytest.raises(ValueError, match="does not fit"):
        model.prefill(torch.from_numpy(tok), pf,
                      model.init_cache(1, 8, torch.float32))


@pytest.mark.parametrize("cfg_kw", [None, BF16], ids=["f32", "bf16"])
def test_whisper_from_jax_bit_for_bit(cfg_kw):
    """Every leaf of init_whisper's tree lands in one parameter, bit for
    bit (bf16 through its uint16 view), and no parameter is left over."""
    jcfg, pcfg, params, model = _model(cfg_kw)
    stacked = ("enc_layers", "dec_layers")
    leaves = jax.tree_util.tree_leaves_with_path(params)
    n_leaves = sum(a.shape[0] if path[0].key in stacked else 1
                   for path, a in leaves)
    named = dict(model.named_parameters())
    assert len(named) == n_leaves
    for path, a in leaves:
        keys = [p.key for p in path]
        rows = range(a.shape[0]) if keys[0] in stacked else [None]
        for i in rows:
            name = ".".join(keys if i is None else
                            [keys[0], str(i)] + keys[1:])
            if keys[-1].startswith("ln") or keys[-1] == "enc_ln":
                name += ".weight"
            want = np.asarray(a if i is None else a[i])
            got = named[name].detach()
            assert str(got.dtype).removeprefix("torch.") == want.dtype.name
            if want.dtype.name == "bfloat16":
                np.testing.assert_array_equal(
                    got.view(torch.int16).numpy(), want.view(np.int16))
            else:
                np.testing.assert_array_equal(got.numpy(), want)
    assert isinstance(model, Whisper)
    assert get_api(pcfg).init is Whisper


def test_cache_layout():
    jcfg, pcfg, _, model = _model()
    want = JW.init_cache_whisper(jcfg, 2, 64, jnp.float32)
    got = model.init_cache(2, 64, torch.float32)
    for key in KEYS:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).removeprefix("torch.") == \
            want[key].dtype.name, key
    assert got["k"].shape == (pcfg.n_layers, 2, 64, 4, 16)
    assert got["xk"].shape == (pcfg.n_layers, 2, pcfg.n_audio_frames, 4, 16)
    assert model.init_cache(2, 64)["xv"].dtype == torch.bfloat16
    assert got["pos"] == 0


def test_full_config_counts():
    """whisper-large-v3 as built (on "meta"): 32 + 32 layers, vocabulary
    51,866 padded to 51,968 at tp 1, 1,601,251,840 parameters."""
    cfg = get_config(ARCH)
    model = Whisper(cfg, tp=1, device="meta")
    assert (len(model.enc_layers), len(model.dec_layers)) == (32, 32)
    assert cfg.vocab_padded(1) == 51_968 and cfg.n_audio_frames == 1500
    assert sum(p.numel() for p in model.parameters()) == 1_601_251_840
    assert cfg.param_count() == jax_config(ARCH).param_count() == \
        1_600_989_440
