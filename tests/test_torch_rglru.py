"""The port's hybrid family (repro_torch.models.rglru) against
repro.models.rglru on the CPU.

Inputs are drawn with numpy from a seed; weights are JAX's init_* draws,
carried across by `models.convert.rg_from_jax` (the model) or copied leaf
by leaf (one block). In f32 the two agree to rounding: 1e-5 abs on the
scan, the conv, the block and the cache (the scan combines in another
order than JAX's associative_scan tree, so not to bits).

bf16 with the f32 cache (the launchers' setting): JAX's `decode_rg`
then promotes the conv's output and `u @ W_a` to f32, which the port
does by casting explicitly (torch.matmul refuses mixed dtypes). The two
packages round bf16 at other places (XLA's CPU fusions keep excess
precision), so the model is held to BF16_ROUNDINGS roundings a layer of
2^-8 relative (chip_smoke.HY_R_ROUNDINGS: 25 roundings, and the r gate's
counted 18.8 times for its gain through log a), in each of the two
computations, adding up like a random walk: sqrt(2 x BF16_ROUNDINGS x
layers) x 2^-8 x max |logit| (0.082 relative at the smoke depth of 5;
they differ by 0.027).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import rglru as JR
from repro.models.registry import get_api as jax_api
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.models import get_api, rglru
from repro_torch.models.convert import _tensor, rg_from_jax
from repro_torch.train import make_decode_step, make_prefill_step

TOL = dict(rtol=0, atol=1e-5)
ARCH = "recurrentgemma-2b"
BF16 = dict(param_dtype="bfloat16", dtype="bfloat16")
BF16_ROUNDINGS = 44      # chip_smoke.HY_R_ROUNDINGS: one R layer


def _np(t):
    return t.detach().float().cpu().numpy()


def _rng(seed=0):
    return np.random.default_rng(seed)


def _scan_inputs(S, seed=0, B=2, d=8):
    rng = _rng(seed)
    a_log = -8.0 * rng.random((B, S, d)).astype(np.float32)
    bx = rng.standard_normal((B, S, d)).astype(np.float32)
    h0 = rng.standard_normal((B, d)).astype(np.float32)
    return a_log, bx, h0


def _sequential(a_log, bx, h0):
    """The recurrence step by step in float64."""
    a, b = a_log.astype(np.float64), bx.astype(np.float64)
    h = np.zeros_like(b[:, 0]) if h0 is None else h0.astype(np.float64)
    out = np.empty_like(b)
    for t in range(b.shape[1]):
        h = np.exp(a[:, t]) * h + b[:, t]
        out[:, t] = h
    return out


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [1, 7, 64, 100])
def test_rglru_scan(S, with_h0):
    a_log, bx, h0 = _scan_inputs(S)
    h0 = h0 if with_h0 else None
    want = np.asarray(JR._rglru_scan(
        jnp.asarray(a_log), jnp.asarray(bx),
        None if h0 is None else jnp.asarray(h0)))
    got = rglru.rglru_scan(torch.from_numpy(a_log), torch.from_numpy(bx),
                           None if h0 is None else torch.from_numpy(h0))
    assert got.dtype == torch.float32 and got.shape == bx.shape
    np.testing.assert_allclose(_np(got), want, **TOL)
    np.testing.assert_allclose(_np(got), _sequential(a_log, bx, h0), **TOL)


def test_rglru_scan_deep_decay_stays_finite():
    """log a at -8 a step sums to -800 over 100 steps: exp(-A) of a
    cumulative sum would overflow f32; the combine never forms it."""
    a_log, bx, h0 = _scan_inputs(100)
    a_log = np.full_like(a_log, -8.0)
    got = _np(rglru.rglru_scan(torch.from_numpy(a_log),
                               torch.from_numpy(bx), torch.from_numpy(h0)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _sequential(a_log, bx, h0), **TOL)


@pytest.mark.parametrize("x_dtype,state_dtype", [
    ("float32", None), ("float32", "float32"), ("bfloat16", None),
    ("bfloat16", "bfloat16"), ("bfloat16", "float32")])
def test_causal_conv4(x_dtype, state_dtype):
    """y and the new state against JAX's, dtype included: a bf16 x with
    an f32 state gives f32 (jnp.concatenate's promotion)."""
    rng = _rng(3)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    state = rng.standard_normal((2, 3, 16)).astype(np.float32)
    jx = jnp.asarray(x, x_dtype)
    jw = jnp.asarray(w, x_dtype)
    jstate = None if state_dtype is None else jnp.asarray(state, state_dtype)
    want_y, want_s = JR._causal_conv4(jx, jw, jstate)
    tdt = getattr(torch, x_dtype)
    got_y, got_s = rglru.causal_conv4(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
        None if state_dtype is None
        else torch.from_numpy(state).to(getattr(torch, state_dtype)))
    for got, want in ((got_y, want_y), (got_s, want_s)):
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name
        want = np.asarray(want.astype(jnp.float32))
        # bf16 arithmetic: one rounding of the largest output (XLA's CPU
        # fusion may keep the products in f32 where torch rounds each).
        atol = (2.0 ** -8 * np.abs(want).max() if got.dtype == torch.bfloat16
                else 1e-6)
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=atol)


def _block(cfg_kw=None, seed=0):
    jcfg = jax_config(ARCH, True)
    pcfg = get_config(ARCH, True)
    if cfg_kw:
        jcfg = dataclasses.replace(jcfg, **cfg_kw)
        pcfg = dataclasses.replace(pcfg, **cfg_kw)
    dtype = jnp.dtype(jcfg.param_dtype)
    p = JR.init_rglru_block(jax.random.PRNGKey(seed), jcfg, dtype)
    blk = rglru.RGLRUBlock(pcfg, getattr(torch, pcfg.param_dtype), "cpu")
    with torch.no_grad():
        for name, param in blk.named_parameters():
            node = p
            for key in name.split("."):
                if key != "weight":
                    node = node[key]
            param.copy_(_tensor(np.asarray(node)))
    return jcfg, p, blk


def test_block_forward():
    jcfg, p, blk = _block()
    x = _rng(1).standard_normal((2, 11, jcfg.d_model)).astype(np.float32)
    want = JR.apply_rglru_block(p, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got = blk(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_block_decode():
    jcfg, p, blk = _block()
    rng = _rng(2)
    d = jcfg.d_model
    x = rng.standard_normal((2, 1, d)).astype(np.float32)
    h0 = rng.standard_normal((2, d)).astype(np.float32)
    conv0 = rng.standard_normal((2, 3, d)).astype(np.float32)
    want = JR.decode_rglru_block(p, jcfg, jnp.asarray(x), jnp.asarray(h0),
                                 jnp.asarray(conv0))
    with torch.no_grad():
        got = blk.step(torch.from_numpy(x), torch.from_numpy(h0),
                       torch.from_numpy(conv0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


def test_bf16_block_decode_with_f32_state():
    """A bf16 block decoding against an f32 h and conv state (the
    launchers' cache): x stays bf16, h and the conv state come out f32,
    as JAX's; the values within a layer's bf16 roundings of the output."""
    jcfg, p, blk = _block(BF16)
    rng = _rng(4)
    d = jcfg.d_model
    x = rng.standard_normal((2, 1, d)).astype(np.float32)
    h0 = rng.standard_normal((2, d)).astype(np.float32)
    conv0 = rng.standard_normal((2, 3, d)).astype(np.float32)
    want = JR.decode_rglru_block(p, jcfg, jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(h0), jnp.asarray(conv0))
    with torch.no_grad():
        got = blk.step(torch.from_numpy(x).bfloat16(), torch.from_numpy(h0),
                       torch.from_numpy(conv0))
    assert [str(g.dtype).removeprefix("torch.") for g in got] == \
        [w.dtype.name for w in want] == ["bfloat16", "float32", "float32"]
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        tol = math.sqrt(2 * BF16_ROUNDINGS) * 2.0 ** -8 * np.abs(w).max()
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=tol)


def _model(cfg_kw=None):
    jcfg, pcfg = jax_config(ARCH, True), get_config(ARCH, True)
    if cfg_kw:
        jcfg = dataclasses.replace(jcfg, **cfg_kw)
        pcfg = dataclasses.replace(pcfg, **cfg_kw)
    params = JR.init_rg(jax.random.PRNGKey(0), jcfg, tp=1)
    return jcfg, pcfg, params, rg_from_jax(
        pcfg, jax.tree.map(np.asarray, params), "cpu")


def test_layer_order_and_cache_layout():
    jcfg, pcfg, params, model = _model()
    assert [k for k, _ in JR._layer_list(params, jcfg)] == \
        list(model.kinds) == ["R", "R", "A", "R", "R"]
    want = JR.init_cache_rg(jcfg, 2, 64, jnp.float32)
    got = model.init_cache(2, 64, torch.float32)
    for key in ("h", "conv", "k", "v"):
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).removeprefix("torch.") == \
            want[key].dtype.name, key
    assert got["h"].dtype == torch.float32
    assert model.init_cache(2, 64)["h"].dtype == torch.float32
    assert got["k"].shape[2] == pcfg.window == 32


def test_decode_past_the_window():
    """JAX's test_sliding_window_ring_buffer: window + 3 decode steps from
    an empty cache of `window` slots, every step against JAX's."""
    jcfg, pcfg, params, model = _model()
    W = pcfg.window
    japi = jax_api(jcfg)
    jdec = jax.jit(jsteps.make_decode_step(jcfg, japi))
    pdec = make_decode_step(pcfg, get_api(pcfg))
    jcache = japi.init_cache(jcfg, 1, W, jnp.float32)
    pcache = model.init_cache(1, W, torch.float32)
    jt = jnp.zeros((1,), jnp.int32)
    pt = torch.zeros((1,), dtype=torch.int32)
    for _ in range(W + 3):
        jt, jl, jcache = jdec(params, jt, jcache)
        pt, pl, pcache = pdec(model, pt, pcache)
        np.testing.assert_allclose(_np(pl), np.asarray(jl), rtol=0,
                                   atol=1e-4)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    assert pcache["pos"] == int(jcache["pos"]) == W + 3
    assert np.isfinite(_np(pl)).all()
    for key in ("h", "conv", "k", "v"):
        np.testing.assert_allclose(_np(pcache[key]), np.asarray(jcache[key]),
                                   **TOL)


def test_bf16_smoke_with_the_f32_cache():
    """The launchers' setting: bf16 weights, an f32 cache. Prefill and 8
    decode steps fed JAX's greedy tokens in both packages; logits within
    the bf16 tolerance of the module docstring, each greedy token equal
    or a near tie within it, the cache f32 and near JAX's."""
    jcfg, pcfg, params, model = _model(BF16)
    B, S, max_seq = 2, 12, 32
    tok = _rng(0).integers(0, pcfg.vocab_size, (B, S)).astype(np.int32)
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
    for key in ("h", "conv", "k", "v"):
        assert pcache[key].dtype == torch.float32
        want = np.asarray(jcache[key])
        np.testing.assert_allclose(_np(pcache[key]), want, rtol=0,
                                   atol=rel * np.abs(want).max())
