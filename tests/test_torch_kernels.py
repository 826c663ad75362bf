"""The port's kernels against the JAX package, at every registry case.

Each case's inputs are made once with numpy and handed to both packages:
the port's plain version (what a wrapper runs for CPU tensors) must match
the JAX ref.py and the JAX op in Pallas interpret mode, within the
registry's tolerances (2e-3; 1e-4 for kmeans_assign, whose labels may
differ only on ties). The `cuda` cases hold each kernel against its plain
version on the card; this file imports JAX only inside the tests that
need it, so those run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import registry


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's registry, layout helper and ref.py per kernel."""
    jnp = pytest.importorskip("jax.numpy")
    import repro.kernels  # noqa: F401  -- populates the JAX registry
    from repro.kernels import registry as jax_registry
    from repro.kernels.extend_embed.ref import extend_embed_ref
    from repro.kernels.fit_sketch.ref import fit_sketch_ref
    from repro.kernels.gram.ref import gram_stripe_ref
    from repro.kernels.kmeans_assign.ref import assign_ref
    refs = {"gram_stripe": gram_stripe_ref, "kmeans_assign": assign_ref,
            "extend_embed": extend_embed_ref, "fit_sketch": fit_sketch_ref}

    def jax_args(name, args):
        """The JAX package's layout of the same inputs: fit_sketch takes
        its validity mask as row 0 of an (8, m) array."""
        if name == "fit_sketch":
            X, Omega, C, Ocr, V = args
            V8 = np.zeros((8, V.shape[0]), np.float32)
            V8[0] = V
            args = (X, Omega, C, Ocr, V8)
        return [jnp.asarray(a) for a in args]

    return jax_registry, refs, jax_args


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _cases():
    for entry in registry.kernel_entries():
        for i in range(len(entry.cases)):
            yield pytest.param(entry.name, i, id=f"{entry.name}-{i}")


def _inputs(name, i):
    entry = registry.get_kernel(name)
    args, kw = entry.build(np.random.default_rng(1000 + i), entry.cases[i])
    return entry, args, kw


def test_cases_and_tolerances_equal_the_jax_registry(jax_side):
    jax_registry = jax_side[0]
    for entry in registry.kernel_entries():
        ref = jax_registry.get_kernel(entry.name)
        assert entry.cases == ref.cases, entry.name
        assert (entry.rtol, entry.atol) == (ref.rtol, ref.atol), entry.name


@pytest.mark.parametrize("name,i", _cases())
def test_plain_matches_jax_ref(jax_side, name, i):
    _, refs, jax_args = jax_side
    entry, args, kw = _inputs(name, i)
    got = entry.ref(*[torch.from_numpy(a) for a in args], **kw)
    want = refs[name](*jax_args(name, args), **kw)
    registry.compare(entry, got, want)


@pytest.mark.kernels
@pytest.mark.parametrize("name,i", _cases())
def test_plain_matches_jax_op_interpret(jax_side, name, i):
    jax_registry, _, jax_args = jax_side
    entry, args, kw = _inputs(name, i)
    got = entry.op(*[torch.from_numpy(a) for a in args], **kw)
    want = jax_registry.get_kernel(name).op(*jax_args(name, args),
                                            interpret=True, **kw)
    registry.compare(entry, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name,i", _cases())
def test_kernel_matches_plain_on_card(name, i):
    dev = _card()
    entry, args, kw = _inputs(name, i)
    targs = [torch.from_numpy(a).to(dev) for a in args]
    launches = entry.op.launches
    got = entry.op(*targs, **kw)
    torch.cuda.synchronize()
    assert entry.op.launches == launches + 1
    registry.compare(entry, got, entry.ref(*targs, **kw))


@pytest.mark.cuda
def test_extend_embed_column_bits_do_not_depend_on_batch_width():
    """Bucketed == unbatched on the card: the split over n depends on n
    alone, so a query column gets the same bits in any batch width."""
    dev = _card()
    rng = np.random.default_rng(7)
    X, P, Xq = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                .to(dev) for s in ((19, 5000), (2, 5000), (19, 512)))
    op = registry.get_kernel("extend_embed").op
    wide = op(X, P, Xq)
    for a, b in ((0, 8), (100, 164), (300, 512)):
        assert torch.equal(op(X, P, Xq[:, a:b]), wide[:, a:b])


@pytest.mark.cuda
def test_fit_sketch_is_deterministic_on_card():
    """Fixed-order split reductions, no float atomics: the same inputs
    give the same bits (chunked ingest == one-shot rests on it)."""
    dev = _card()
    entry = registry.get_kernel("fit_sketch")
    args, kw = entry.build(np.random.default_rng(8),
                           {"p": 19, "m": 3000, "b": 512, "rp": 7})
    targs = [torch.from_numpy(a).to(dev) for a in args]
    first = entry.op(*targs, **kw)
    for _ in range(3):
        for g, w in zip(entry.op(*targs, **kw), first):
            assert torch.equal(g, w)
