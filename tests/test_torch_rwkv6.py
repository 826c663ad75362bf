"""The port's ssm family (repro_torch.models.rwkv6) against
repro.models.rwkv6 on the CPU.

Inputs are drawn with numpy from a seed; weights are JAX's init_* draws,
carried across by `models.convert.rwkv_from_jax` (the model) or copied
leaf by leaf (one block). The WKV core is held to JAX's `_wkv_chunked`
and to the step-by-step recurrence (a torch copy of
tests/test_rwkv_wkv.py's `wkv_recurrent_ref`) within rtol and atol 2e-4,
that test's bound; the block, the model's logits and its cache (s, tm,
cm) within 1e-4 abs in f32 (they agree to ~1e-5: the port batches a
chunk's products over all chunks where JAX scans them one by one).

bf16 with the f32 cache (the launchers' setting): the two packages round
bf16 at other places (XLA's CPU fusions keep excess precision), so the
model is held to BF16_ROUNDINGS roundings a layer of 2^-8 relative
(chip_smoke.RWKV_ROUNDINGS) in each of the two computations, adding up
like a random walk: sqrt(2 x BF16_ROUNDINGS x layers) x 2^-8 x max
|logit|.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import rwkv6 as JW
from repro.models.registry import get_api as jax_api
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.models import RWKV, get_api, rwkv6
from repro_torch.models.convert import _tensor, rwkv_from_jax

ARCH = "rwkv6-1.6b"
WKV_TOL = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=0, atol=1e-4)
BF16 = dict(param_dtype="bfloat16", dtype="bfloat16")
BF16_ROUNDINGS = 41      # chip_smoke.RWKV_ROUNDINGS: one RWKV layer


def _np(t):
    return t.detach().float().cpu().numpy()


def _rng(seed=0):
    return np.random.default_rng(seed)


def wkv_recurrent_ref(r, k, v, logw, u, state0):
    """The recurrence step by step (tests/test_rwkv_wkv.py's reference)."""
    S = r.shape[1]
    state = state0
    outs = []
    for t in range(S):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], torch.exp(logw[:, t])
        kv = torch.einsum("bhd,bhe->bhde", kt, vt)
        outs.append(torch.einsum("bhd,bhde->bhe", rt,
                                 state + u[None, :, :, None] * kv))
        state = state * wt[..., None] + kv
    return torch.stack(outs, dim=1), state


def _wkv_inputs(S, chunk, seed, with_state, B=2, H=3, dh=8, logw=None):
    rng = _rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, dh)).astype(np.float32)
               for _ in range(3))
    if logw is None:
        logw = np.maximum(-np.exp(rng.standard_normal((B, S, H, dh))),
                          -60.0 / chunk).astype(np.float32)
    u = rng.standard_normal((H, dh)).astype(np.float32)
    state0 = (rng.standard_normal((B, H, dh, dh)) if with_state
              else np.zeros((B, H, dh, dh))).astype(np.float32)
    return r, k, v, logw, u, state0


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S,chunk", [(8, 4), (16, 16), (32, 8), (12, 4),
                                     (1, 64), (128, 64)])
def test_wkv_chunked(S, chunk, with_state):
    arrays = _wkv_inputs(S, chunk, S + chunk, with_state)
    got, gstate = rwkv6.wkv_chunked(*map(torch.from_numpy, arrays),
                                    chunk=chunk)
    want, wstate = JW._wkv_chunked(*map(jnp.asarray, arrays), chunk=chunk)
    ref, rstate = wkv_recurrent_ref(*map(torch.from_numpy, arrays))
    assert got.shape == arrays[0].shape and got.dtype == torch.float32
    for g, w in ((got, want), (gstate, wstate), (got, ref),
                 (gstate, rstate)):
        np.testing.assert_allclose(_np(g), np.asarray(w), **WKV_TOL)


def test_wkv_chunk_at_the_clamp_stays_finite():
    """Every step at the clamp, log w = -60 / 64: the last row of a chunk
    scales k by exp(-lp) = e^59, and the masked upper triangle of the
    scores holds products up to e^60 |r| |k| before the mask; in f32 both
    stay finite and the output matches the recurrence."""
    S, chunk = 128, 64
    logw = np.full((2, S, 3, 8), -60.0 / chunk, np.float32)
    arrays = _wkv_inputs(S, chunk, 5, True, logw=logw)
    got, gstate = rwkv6.wkv_chunked(*map(torch.from_numpy, arrays),
                                    chunk=chunk)
    ref, rstate = wkv_recurrent_ref(*map(torch.from_numpy, arrays))
    assert torch.isfinite(got).all() and torch.isfinite(gstate).all()
    np.testing.assert_allclose(_np(got), _np(ref), **WKV_TOL)
    np.testing.assert_allclose(_np(gstate), _np(rstate), **WKV_TOL)


def _block(cfg_kw=None, seed=0):
    jcfg, pcfg = jax_config(ARCH, True), get_config(ARCH, True)
    if cfg_kw:
        jcfg = dataclasses.replace(jcfg, **cfg_kw)
        pcfg = dataclasses.replace(pcfg, **cfg_kw)
    p = JW.init_rwkv_block(jax.random.PRNGKey(seed), jcfg,
                           jnp.dtype(jcfg.param_dtype))
    blk = rwkv6.RWKVBlock(pcfg, getattr(torch, pcfg.param_dtype), "cpu")
    with torch.no_grad():
        for name, param in blk.named_parameters():
            param.copy_(_tensor(np.asarray(p[name.split(".")[0]])))
    return jcfg, p, blk


@pytest.mark.parametrize("S,with_prev", [(11, False), (1, True), (16, True)])
def test_block(S, with_prev):
    """apply_rwkv_block's x, state, tm and cm (the normed inputs of the
    last token), from zeros or from a given state and shifts."""
    jcfg, p, blk = _block()
    rng = _rng(S)
    d, dh = jcfg.d_model, jcfg.rwkv_head_dim
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    prev = [rng.standard_normal(shape).astype(np.float32) for shape in
            ((2, d // dh, dh, dh), (2, d), (2, d))] if with_prev else []
    want = JW.apply_rwkv_block(p, jcfg, jnp.asarray(x),
                               *map(jnp.asarray, prev))
    with torch.no_grad():
        got = blk.step(torch.from_numpy(x), *map(torch.from_numpy, prev))
    xin = blk.ln1(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got[1][1]), _np(xin[:, -1]), rtol=0,
                               atol=0)
    for g, w in zip((got[0],) + got[1], (want[0],) + want[1]):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


def _model(cfg_kw=None):
    jcfg, pcfg = jax_config(ARCH, True), get_config(ARCH, True)
    if cfg_kw:
        jcfg = dataclasses.replace(jcfg, **cfg_kw)
        pcfg = dataclasses.replace(pcfg, **cfg_kw)
    params = JW.init_rwkv(jax.random.PRNGKey(0), jcfg, tp=1)
    return jcfg, pcfg, params, rwkv_from_jax(
        pcfg, jax.tree.map(np.asarray, params), "cpu")


def _tokens(cfg, shape, seed=0):
    return _rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def test_prefill_and_decode_against_jax():
    """prefill_rwkv and 4 decode_rwkv steps fed the same tokens: logits,
    s, tm, cm and pos, f32 at the smoke config."""
    jcfg, pcfg, params, model = _model()
    B, S = 2, 16
    tok = _tokens(pcfg, (B, S + 4))
    jcache = JW.init_cache_rwkv(jcfg, B, 32, jnp.float32)
    pcache = model.init_cache(B, 32, torch.float32)
    jl, jcache = JW.prefill_rwkv(params, jcfg, jnp.asarray(tok[:, :S]),
                                 jcache)
    pl, pcache = model.prefill(torch.from_numpy(tok[:, :S]), pcache)
    for i in range(5):
        np.testing.assert_allclose(_np(pl), np.asarray(jl), **TOL)
        assert pcache["pos"] == int(jcache["pos"]) == S + i
        for key in ("s", "tm", "cm"):
            assert pcache[key].dtype == torch.float32
            assert tuple(pcache[key].shape) == jcache[key].shape
            np.testing.assert_allclose(_np(pcache[key]),
                                       np.asarray(jcache[key]), **TOL)
        if i < 4:
            jl, jcache = JW.decode_rwkv(params, jcfg,
                                        jnp.asarray(tok[:, S + i]), jcache)
            pl, pcache = model.decode(torch.from_numpy(tok[:, S + i]),
                                      pcache)


def test_bf16_smoke_with_the_f32_cache():
    """The launchers' setting: bf16 weights, an f32 cache. Prefill and 8
    decode steps fed JAX's greedy tokens in both packages; logits within
    the bf16 tolerance of the module docstring, each greedy token equal
    or a near tie within it, tm and cm f32 and near JAX's, s within the
    same relative tolerance."""
    jcfg, pcfg, params, model = _model(BF16)
    B, S, max_seq = 2, 12, 32
    tok = _tokens(pcfg, (B, S))
    japi = jax_api(jcfg)
    jpre = jax.jit(jsteps.make_prefill_step(jcfg, japi))
    jdec = jax.jit(jsteps.make_decode_step(jcfg, japi))
    jcache = japi.init_cache(jcfg, B, max_seq, jnp.float32)
    pcache = model.init_cache(B, max_seq, torch.float32)
    jl, jcache = jpre(params, {"tokens": jnp.asarray(tok)}, jcache)
    pl, pcache = model.prefill(torch.from_numpy(tok), pcache)
    rel = math.sqrt(2 * BF16_ROUNDINGS * pcfg.n_layers) * 2.0 ** -8
    jt = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    for _ in range(8):
        want = np.asarray(jl)
        tol = rel * np.abs(want).max()
        got = _np(pl)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        pick = got.argmax(-1)
        gap = want.max(-1) - want[np.arange(B), pick]
        assert (gap <= tol).all(), gap
        pl, pcache = model.decode(torch.from_numpy(np.array(jt)), pcache)
        jt, jl, jcache = jdec(params, jt, jcache)
    for key in ("s", "tm", "cm"):
        assert pcache[key].dtype == torch.float32
        want = np.asarray(jcache[key])
        np.testing.assert_allclose(_np(pcache[key]), want, rtol=0,
                                   atol=rel * np.abs(want).max())


def test_prompt_not_a_multiple_of_the_chunk_refused():
    """65 tokens against chunks of 64: JAX's assertion, the port's
    ValueError; 64 and 128 pass in both."""
    jcfg, pcfg, params, model = _model()
    assert pcfg.rwkv_chunk == jcfg.rwkv_chunk == 64
    tok = _tokens(pcfg, (1, 65))
    with pytest.raises(AssertionError, match="not divisible"):
        JW.forward_rwkv(params, jcfg, jnp.asarray(tok))
    with pytest.raises(ValueError, match="seq 65 not divisible by chunk 64"):
        model(torch.from_numpy(tok))
    with pytest.raises(ValueError, match="not divisible"):
        model.prefill(torch.from_numpy(tok), model.init_cache(1, 128))
    with torch.no_grad():
        assert model(torch.from_numpy(_tokens(pcfg, (1, 128)))).shape[1] == 128


def test_state_handoff():
    """prefill(16) then 16 decode steps leaves the cache prefill(32)
    writes, and each step's logits are forward(32)'s at its position."""
    _, pcfg, _, model = _model()
    B, S, n = 2, 16, 16
    tok = torch.from_numpy(_tokens(pcfg, (B, S + n), seed=3))
    with torch.no_grad():
        full = model(tok)
    cache = model.init_cache(B, S + n, torch.float32)
    logits, cache = model.prefill(tok[:, :S], cache)
    np.testing.assert_allclose(_np(logits), _np(full[:, S - 1]), **TOL)
    for i in range(n):
        logits, cache = model.decode(tok[:, S + i], cache)
        np.testing.assert_allclose(_np(logits), _np(full[:, S + i]), **TOL)
    whole = model.init_cache(B, S + n, torch.float32)
    _, whole = model.prefill(tok, whole)
    assert cache["pos"] == whole["pos"] == S + n
    for key in ("s", "tm", "cm"):
        np.testing.assert_allclose(_np(cache[key]), _np(whole[key]),
                                   **WKV_TOL)


@pytest.mark.parametrize("cfg_kw", [None, BF16], ids=["f32", "bf16"])
def test_rwkv_from_jax_bit_for_bit(cfg_kw):
    """Every leaf of init_rwkv's tree lands in one parameter, bit for bit
    (bf16 through its uint16 view), and no parameter is left over."""
    jcfg, pcfg, params, model = _model(cfg_kw)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    n_leaves = sum(a.shape[0] if path[0].key == "layers" else 1
                   for path, a in leaves)
    named = dict(model.named_parameters())
    assert len(named) == n_leaves
    for path, a in leaves:
        keys = [p.key for p in path]
        rows = range(a.shape[0]) if keys[0] == "layers" else [None]
        for i in rows:
            name = ".".join(keys if i is None else
                            ["layers", str(i)] + keys[1:])
            if keys[-1].startswith("ln"):
                name += ".weight"
            want = np.asarray(a if i is None else a[i])
            got = named[name].detach()
            assert str(got.dtype).removeprefix("torch.") == want.dtype.name
            if want.dtype.name == "bfloat16":
                np.testing.assert_array_equal(
                    got.view(torch.int16).numpy(), want.view(np.int16))
            else:
                np.testing.assert_array_equal(got.numpy(), want)
    assert isinstance(model, RWKV)
    assert get_api(pcfg).init is RWKV


def test_cache_layout():
    jcfg, pcfg, _, model = _model()
    want = JW.init_cache_rwkv(jcfg, 2, 64, jnp.float32)
    got = model.init_cache(2, 64, torch.float32)
    for key in ("s", "tm", "cm"):
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).removeprefix("torch.") == \
            want[key].dtype.name, key
    assert model.init_cache(2, 64)["s"].dtype == torch.float32
    assert model.init_cache(2, 64)["tm"].dtype == torch.bfloat16
    assert got["pos"] == 0
