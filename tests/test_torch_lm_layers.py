"""The port's LM building blocks against repro.models.layers on the CPU.

Inputs are drawn with numpy and handed to both packages; weights are
JAX's init_* draws carried across as numpy arrays. Everything is f32, so
the two agree to rounding: tolerance 1e-5 abs (rel 1e-5) unless stated.
The MoE routing is held where JAX's gate is positive: slots of gate 0
(an expert with fewer than C routed tokens) contribute 0 and which token
fills them depends on the top-k's tie order, which torch does not
promise. Also here: the configs against JAX's, the launcher's flags, the
registry's families and the input builders' shapes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as jax_config
from repro.launch import specs as jspecs
from repro.models import layers as JL
from repro.models.registry import get_api as jax_api
from repro_torch.configs import get_config
from repro_torch.launch import serve, specs
from repro_torch.models import get_api
from repro_torch.models import layers as L

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _load(module, params):
    """Copy a JAX params dict into a port module's parameters."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            node = params
            for key in name.split("."):
                if key != "weight":
                    node = node[key]
            p.copy_(_t(node))
    return module


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_rms_norm():
    x = _rng().standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = _rng(1).standard_normal(64).astype(np.float32)
    want = np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(_np(L.rms_norm(_t(x), _t(w))), want, **TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("offset", [0, 1000])
def test_apply_rope(theta, offset):
    x = _rng().standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = (np.arange(7) + offset)[None, :]
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = L.apply_rope(_t(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(_np(got), want, **TOL)


@pytest.mark.parametrize("window", [0, 1, 3, 40])
def test_causal_mask(window):
    want = np.asarray(JL.causal_mask(9, window))
    np.testing.assert_array_equal(_np(L.causal_mask(9, window)), want)


@pytest.mark.parametrize("scores_f32", [True, False])
def test_sdpa(scores_f32):
    rng = _rng()
    q = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    mask = rng.random((2, 1, 6, 9)) < 0.6
    mask[..., 0] = True                          # no row fully masked
    want = np.asarray(JL._sdpa(*map(jnp.asarray, (q, k, v, mask)), 2,
                               scores_f32))
    got = L.sdpa(_t(q), _t(k), _t(v), torch.from_numpy(mask), 2, scores_f32)
    np.testing.assert_allclose(_np(got), want, **TOL)


ACTS = ("swiglu", "geglu", "relu2", "gelu")


@pytest.mark.parametrize("activation", ACTS)
def test_act(activation):
    jcfg = dataclasses.replace(jax_config("phi4-mini-3.8b", True),
                               activation=activation)
    pcfg = dataclasses.replace(get_config("phi4-mini-3.8b", True),
                               activation=activation)
    a, b = (_rng(i).standard_normal((3, 50)).astype(np.float32) * 4
            for i in (0, 1))
    want = np.asarray(JL._act(jcfg, jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(_np(L.act(pcfg, _t(a), _t(b))), want, **TOL)


@pytest.mark.parametrize("activation", ACTS)
def test_dense_mlp(activation):
    jcfg = dataclasses.replace(jax_config("phi4-mini-3.8b", True),
                               activation=activation)
    pcfg = dataclasses.replace(get_config("phi4-mini-3.8b", True),
                               activation=activation)
    params = JL.init_mlp(jax.random.PRNGKey(0), jcfg, jnp.float32)
    mlp = _load(L.DenseMLP(pcfg, torch.float32, "cpu"), params)
    x = _rng().standard_normal((2, 5, 64)).astype(np.float32)
    want = np.asarray(JL.apply_dense_mlp(params, jcfg, jnp.asarray(x)))
    np.testing.assert_allclose(_np(mlp(_t(x))), want, **TOL)


def _jax_route(p, cfg, xg, capacity_factor=1.25):
    """layers.py:229-244 of apply_moe: (sel_vals, sel_idx) per group."""
    G, Tg, _ = xg.shape
    E, topk = cfg.n_experts, cfg.top_k
    logits = (xg @ p["router"].astype(xg.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    top_vals, top_idx = jax.lax.top_k(probs, topk)
    top_vals = top_vals / jnp.sum(top_vals, axis=-1, keepdims=True)
    gate = jnp.zeros((G, Tg, E), jnp.float32)
    gate = jax.vmap(lambda g, i, v: g.at[jnp.arange(Tg)[:, None], i].set(v)
                    )(gate, top_idx, top_vals)
    C = max(1, int(topk * Tg * capacity_factor / E))
    return jax.lax.top_k(gate.transpose(0, 2, 1), C)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "dbrx-132b"])
def test_moe(arch, groups):
    jcfg, pcfg = jax_config(arch, True), get_config(arch, True)
    params = JL.init_mlp(jax.random.PRNGKey(0), jcfg, jnp.float32)
    moe = _load(L.MoE(pcfg, torch.float32, "cpu"), params)
    x = _rng().standard_normal((2, 12, 64)).astype(np.float32)
    want = np.asarray(JL.apply_moe(params, jcfg, jnp.asarray(x), groups))
    np.testing.assert_allclose(_np(moe(_t(x), groups)), want, **TOL)
    xg = x.reshape(groups, -1, 64)
    jv, ji = map(np.asarray, _jax_route(params, jcfg, jnp.asarray(xg)))
    pv, pi = map(_np, moe.route(_t(xg)))
    routed = jv > 0
    assert routed.any() and not routed.all()     # both kinds of slot occur
    np.testing.assert_array_equal(pv > 0, routed)
    np.testing.assert_allclose(pv, jv, **TOL)
    np.testing.assert_array_equal(pi[routed], ji[routed])


def _attention(arch):
    jcfg, pcfg = jax_config(arch, True), get_config(arch, True)
    params = JL.init_attention(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return jcfg, params, _load(L.Attention(pcfg, torch.float32, "cpu"),
                               params)


@pytest.mark.parametrize("window,causal", [(0, True), (5, True),
                                           (0, False)])
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "qwen3-14b"])
def test_attention_forward(arch, window, causal):
    jcfg, params, attn = _attention(arch)
    x = _rng().standard_normal((2, 11, 64)).astype(np.float32)
    want = np.asarray(JL.apply_attention(params, jcfg, jnp.asarray(x),
                                         window=window, causal=causal))
    np.testing.assert_allclose(_np(attn(_t(x), window, causal)), want,
                               **TOL)


@pytest.mark.parametrize("window,T", [(0, 24), (8, 8)])
def test_decode_attention_across_the_ring(window, T):
    """20 one-token steps from an empty cache: the full cache fills
    slots 0..19 of 24; the ring of 8 wraps twice and a half."""
    jcfg, params, attn = _attention("mixtral-8x7b")
    xs = _rng().standard_normal((20, 2, 1, 64)).astype(np.float32)
    jk = jnp.zeros((2, T, 2, 16), jnp.float32)
    jv = jnp.zeros_like(jk)
    pk, pv = torch.zeros((2, T, 2, 16)), torch.zeros((2, T, 2, 16))
    step = jax.jit(lambda x, k, v, pos: JL.decode_attention(
        params, jcfg, x, k, v, pos, window))
    for pos, x in enumerate(xs):
        want, jk, jv = step(jnp.asarray(x), jk, jv, jnp.int32(pos))
        got = attn.decode(_t(x), pk, pv, pos, window)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        np.testing.assert_allclose(_np(pk), np.asarray(jk), **TOL)
        np.testing.assert_allclose(_np(pv), np.asarray(jv), **TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_and_counts_equal_jax(arch):
    for smoke in (False, True):
        jcfg, pcfg = jax_config(arch, smoke), get_config(arch, smoke)
        assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
        for tp in (1, 16):
            assert pcfg.vocab_padded(tp) == jcfg.vocab_padded(tp)
        assert pcfg.param_count() == jcfg.param_count()
        assert pcfg.active_param_count() == jcfg.active_param_count()
        assert pcfg._pattern() == jcfg._pattern()


def test_phi4_counts():
    cfg = get_config("phi4-mini-3.8b")
    assert cfg.vocab_padded(1) == 200_064
    assert round(cfg.param_count() / 1e9, 3) == 4.451


def test_smoke_flag():
    ap = serve.build_parser()
    default, full = ap.parse_args([]), ap.parse_args(["--no-smoke"])
    assert default.smoke and not full.smoke
    assert ap.parse_args(["--smoke"]).smoke
    assert get_config(full.arch, smoke=full.smoke) == \
        get_config("phi4-mini-3.8b")
    assert get_config(default.arch, smoke=default.smoke).name == "phi4-smoke"
    assert (default.batch, default.prompt_len, default.gen,
            default.max_seq, default.seed) == (4, 16, 8, 128, 0)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_registry_families(arch):
    cfg = get_config(arch, smoke=True)
    api = get_api(cfg)
    assert api.has_decode == jax_api(jax_config(arch, True)).has_decode
    if cfg.family == "ssm":
        assert api.init.__name__ == "RWKV"
    if cfg.family == "encdec":
        assert api.init.__name__ == "Whisper"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_builders_match_jax_shapes(arch):
    jcfg, pcfg = jax_config(arch, True), get_config(arch, True)
    want = jspecs.train_inputs(jcfg, 32, 4)               # ShapeDtypeStructs
    got = specs.train_inputs(pcfg, 32, 4,
                             torch.Generator().manual_seed(0))
    assert set(got) == set(want)
    for key, spec in want.items():
        assert tuple(got[key].shape) == spec.shape, key
        assert str(got[key].dtype).removeprefix("torch.") == \
            jnp.dtype(spec.dtype).name, key
    if "labels" in got and pcfg.family == "vlm":
        n_patch = got["patches"].shape[1]
        assert (got["labels"][:, :n_patch] == -1).all()
    assert (got["tokens"] >= 0).all()
    assert (got["tokens"] < pcfg.vocab_size).all()
    assert specs.SHAPES == jspecs.SHAPES and specs.LONG_OK == jspecs.LONG_OK
    for shape in specs.SHAPES:
        assert specs.cell_supported(get_config(arch), shape) == \
            jspecs.cell_supported(jax_config(arch), shape)
