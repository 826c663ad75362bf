"""The sketched gradients against repro.distributed.compression on the CPU.

JAX's PRNG is not reproduced, so the port's entry points take JAX's
draws: `jax_draws` runs JAX's sketch_params and hands its signs (f32 +-1)
and rows to the port. Given them, `compress` and `decompress` (on the
CPU through fwht_op's plain version), and three rounds of the
error-feedback transform on a smoke model's gradient tree (phi4, the
hybrid with its unstacked remainder layers, the encoder-decoder), agree
with JAX's within 2e-4 (fwht's tolerance in the kernel registry; values
of order 1). The port's compact int8 signs give the same bits as f32
signs. The flattened vector in `models.convert.jax_order` equals
`jax.tree.flatten`'s for all ten smoke configs, and compression_ratio
equals JAX's. The port's own draws: int8 +-1 signs over n_pad, distinct
rows in [0, n_pad) on both branches of the row draw, uniform over the
indices, the same for the same seed; r' beyond n_pad refused. On a draw
the projection's identities hold over the padded vectors: |g_hat| = |s|,
<g_hat, e'> ~ 0, and v = g_hat + e' up to e''s one rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.distributed import compression as jcomp
from repro_torch.configs import get_config
from repro_torch.distributed import compression as comp
from repro_torch.models.convert import jax_order
from torch_lm_common import SERVED, jax_and_port, params_of

TOL = 2e-4


def jax_draws(seed, n, r_prime):
    """JAX's (signs, rows) for a key, as numpy, and as the port's tensors."""
    signs, rows = jcomp.sketch_params(jax.random.PRNGKey(seed), n, r_prime)
    return (signs, rows), (torch.from_numpy(np.array(signs)),
                           torch.from_numpy(np.array(rows)).long())


@pytest.mark.parametrize("n,r_prime", [(1, 1), (5, 3), (1000, 64),
                                       (4096, 512), (70_000, 4096)])
def test_compress_and_decompress_match_jax(n, r_prime):
    vec = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    (js, jr), (ps, pr) = jax_draws(n, n, r_prime)
    want = np.asarray(jcomp.compress(jnp.asarray(vec), js, jr))
    got = comp.compress(torch.from_numpy(vec), ps, pr)
    assert got.shape == (r_prime,)
    assert np.abs(got.numpy() - want).max() <= TOL
    compact = comp.compress(torch.from_numpy(vec), ps.to(torch.int8), pr)
    assert torch.equal(compact, got)
    s = np.random.default_rng(n + 1).standard_normal(r_prime).astype(
        np.float32)
    want = np.asarray(jcomp.decompress(jnp.asarray(s), js, jr, n))
    got = comp.decompress(torch.from_numpy(s), ps.to(torch.int8), pr, n)
    assert got.shape == (n,)
    assert np.abs(got.numpy() - want).max() <= TOL


@pytest.mark.parametrize("arch", ("phi4-mini-3.8b", "recurrentgemma-2b",
                                  "whisper-large-v3"))
def test_transform_three_rounds_match_jax(arch):
    jcfg, pcfg = jax_config(arch, True), get_config(arch, True)
    params, model = jax_and_port(jcfg, pcfg)
    r_prime = 4096
    jt, jinit = jcomp.make_sketched_grad_transform(params, r_prime)
    pt, pinit = comp.make_sketched_grad_transform(model, r_prime)
    jef, pef = jinit(), pinit()
    n = int(pef.shape[0])
    assert jef.shape == (n,)
    rng = np.random.default_rng(7)
    for t in range(3):
        grads = {name: torch.from_numpy(rng.standard_normal(
            p.shape).astype(np.float32)) for name, p in
            model.named_parameters()}
        jgrads = jax.tree.map(jnp.asarray, params_of(model, grads))
        jhat, jef = jt(jgrads, jef, jax.random.PRNGKey(t))
        _, draws = jax_draws(t, n, r_prime)
        # JAX's transform draws from PRNGKey(t) as jax_draws(t, ...) does.
        phat, pef = pt(grads, pef, draws)
        assert np.abs(pef.numpy() - np.asarray(jef)).max() <= TOL, t
        for (path, g), w in zip(
                jax.tree_util.tree_flatten_with_path(params_of(
                    model, phat))[0], jax.tree.leaves(jhat)):
            assert np.abs(g - np.asarray(w)).max() <= TOL, (t, path)


@pytest.mark.parametrize("arch", SERVED)
def test_flatten_order_is_jax(arch):
    jcfg, pcfg = jax_config(arch, True), get_config(arch, True)
    params, model = jax_and_port(jcfg, pcfg)
    named = dict(model.named_parameters())
    got = torch.cat([named[n].detach().reshape(-1).float()
                     for n in jax_order(model)])
    want = np.asarray(jcomp._flatten(params)[0])
    np.testing.assert_array_equal(got.numpy(), want)
    assert comp.compression_ratio(model, 4096) == \
        jcomp.compression_ratio(params, 4096)


@pytest.mark.parametrize("n,r_prime", [(1000, 300), (100_000, 64)])
def test_sketch_params_draws(n, r_prime):
    """(1000, 300) takes the permutation branch, (100,000, 64) the draw
    with replacement and dedup."""
    signs, rows = comp.sketch_params(torch.Generator().manual_seed(1), n,
                                     r_prime)
    n_pad = 1 << (n - 1).bit_length()
    assert signs.dtype == torch.int8 and signs.shape == (n_pad,)
    assert set(signs.unique().tolist()) == {-1, 1}
    assert rows.dtype == torch.int64 and rows.shape == (r_prime,)
    assert rows.unique().numel() == r_prime
    assert 0 <= int(rows.min()) and int(rows.max()) < n_pad
    again = comp.sketch_params(torch.Generator().manual_seed(1), n,
                               r_prime)
    assert torch.equal(again[0], signs) and torch.equal(again[1], rows)


def test_row_draw_is_uniform():
    """3 of 16 (the dedup branch) 4,000 times: each index 750 times
    expected; a chi-square of 15 degrees of freedom stays under its
    0.999 quantile, 37.7."""
    gen = torch.Generator().manual_seed(2)
    counts = np.zeros(16)
    for _ in range(4000):
        rows = comp._choice(gen, 16, 3)
        assert rows.unique().numel() == 3
        counts[rows.numpy()] += 1
    expect = 4000 * 3 / 16
    assert ((counts - expect) ** 2 / expect).sum() < 37.7


def test_sketch_params_refuses_more_rows_than_n_pad():
    with pytest.raises(ValueError, match="n_pad"):
        comp.sketch_params(torch.Generator(), 5, 9)
    with pytest.raises(ValueError, match="mesh"):
        comp.make_sketched_grad_transform({"w": torch.zeros(3)}, 2,
                                          axis="data")


def test_projection_identities():
    """On the padded vectors (Omega's columns are orthonormal over all
    n_pad rows; the truncation to n drops g_hat's tail, which error
    feedback then never sees, as in JAX); then the transform at ef = 0
    with the same draw: its g_hat is decompress(s) bit for bit and its
    ef' is v - g_hat within one f32 rounding."""
    n, r_prime = 50_000, 2048
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(
        n).astype(np.float32))
    signs, rows = comp.sketch_params(torch.Generator().manual_seed(4), n,
                                     r_prime)
    n_pad = signs.shape[0]
    s = comp.compress(v, signs, rows)
    g_pad = comp.decompress(s, signs, rows, n_pad).double()
    e_pad = torch.nn.functional.pad(v, (0, n_pad - n)).double() - g_pad
    assert abs(float(g_pad.norm() / s.double().norm()) - 1) < 1e-6
    assert abs(float(g_pad @ e_pad)) < 1e-6 * float(g_pad.norm() *
                                                     e_pad.norm())
    transform, init_ef = comp.make_sketched_grad_transform(
        {"w": torch.zeros(n)}, r_prime)
    got, ef = transform({"w": v}, init_ef(), (signs, rows))
    assert torch.equal(got["w"], g_pad[:n].float())
    assert torch.equal(got["w"], comp.decompress(s, signs, rows, n))
    assert bool(((v.double() - got["w"].double() - ef.double()).abs()
                 <= 2.0 ** -24 * ef.double().abs()).all())
