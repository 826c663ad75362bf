"""The port's kernels against the JAX package, at every registry case.

Each case's inputs are made once with numpy and handed to both packages:
the port's plain version (what a wrapper runs for CPU tensors) must match
the JAX ref.py and the JAX op in Pallas interpret mode, within the
registry's tolerances (2e-3; 2e-4 for fwht and srht_t; 1e-4 for
kmeans_assign, whose labels may differ only on ties). srht_t, the SRHT
form of fwht, is held against the JAX package's srht_apply_t, with its
plain transform and with fwht_pallas in interpret mode; embed_assign, the
assignment folded into extend_embed's summing launch, against the JAX
package's assign on extend_embed's embedding, its ref.py files composed
and its Pallas kernels in interpret mode. The `cuda` cases
hold each kernel against its plain version on the card; this file
imports JAX only inside the tests that need it, so those run where JAX
is not installed:

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
    from repro.kernels.fwht.ref import fwht_ref
    from repro.kernels.gram.ref import gram_stripe_ref
    from repro.kernels.kmeans_assign.ref import assign_ref
    refs = {"gram_stripe": gram_stripe_ref, "kmeans_assign": assign_ref,
            "extend_embed": extend_embed_ref, "fit_sketch": fit_sketch_ref,
            "fwht": fwht_ref, "srht_t": _jax_srht_t(),
            "embed_assign": _jax_embed_assign(extend_embed_ref, assign_ref)}

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


def _jax_srht_t(fwht_fn=None):
    """The JAX package's Omega^T M (repro.core.sketch.srht_apply_t) for the
    srht_t registry signature (M, signs, rows, n_pad)."""
    from repro.core import sketch as jsk

    def srht_t(M, signs, rows, n_pad):
        srht = jsk.SRHT(signs=signs, rows=rows, n=M.shape[0], n_pad=n_pad)
        return jsk.srht_apply_t(srht, M, fwht_fn)
    return srht_t


def _jax_embed_assign(embed, assign):
    """The JAX package's assignment of a serving stripe, for the
    embed_assign registry signature: assign(embed(X, P, Xb).T, C)."""
    def embed_assign(X, P, Xb, C, **kw):
        interpret = kw.pop("interpret", None)
        extra = {} if interpret is None else {"interpret": interpret}
        return assign(embed(X, P, Xb, **kw, **extra).T, C, **extra)
    return embed_assign


def _jax_op(jax_registry, name):
    """The JAX op of an entry, called in Pallas interpret mode; srht_t runs
    srht_apply_t through fwht_pallas, embed_assign assign_pallas on
    extend_embed_pallas."""
    if name == "embed_assign":
        from repro.kernels.extend_embed.ops import extend_embed_pallas
        from repro.kernels.kmeans_assign.ops import assign_pallas
        return _jax_embed_assign(extend_embed_pallas, assign_pallas)
    if name == "srht_t":
        from repro.kernels.fwht.ops import fwht_pallas
        op = _jax_srht_t(lambda x: fwht_pallas(x, interpret=True))
        return lambda *args, interpret, **kw: op(*args, **kw)
    return jax_registry.get_kernel(name).op


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
    jax_names = {entry.name for entry in jax_registry.kernel_entries()}
    port_names = {entry.name for entry in registry.kernel_entries()}
    # The port's own entries.
    assert port_names - jax_names == {"srht_t", "embed_assign"}
    for entry in registry.kernel_entries():
        if entry.name == "embed_assign":
            # extend_embed's cases, each with a centroid set.
            embed = jax_registry.get_kernel("extend_embed")
            assert [{k: v for k, v in case.items() if k != "k"}
                    for case in entry.cases] == list(embed.cases)
            assert (entry.rtol, entry.atol) == (embed.rtol, embed.atol)
        if entry.name in ("srht_t", "embed_assign"):
            continue
        ref = jax_registry.get_kernel(entry.name)
        assert entry.cases == ref.cases, entry.name
        assert (entry.rtol, entry.atol) == (ref.rtol, ref.atol), entry.name


def test_registered_names_are_the_entries():
    """register_kernel / registered_kernels with JAX's semantics
    (repro/kernels/registry.py:65, :82): the names sorted, each entry's,
    an entry with no cases refused, a name registered again replaced."""
    names = registry.registered_kernels()
    assert names == sorted(names)
    assert names == [entry.name for entry in registry.kernel_entries()]
    assert set(names) == {entry.name for entry in registry.ENTRIES}
    fwht = registry.get_kernel("fwht")
    with pytest.raises(ValueError, match="no parity cases"):
        registry.register_kernel(fwht._replace(cases=()))
    assert registry.get_kernel("fwht") is fwht
    try:
        wider = registry.register_kernel(fwht._replace(rtol=1.0))
        assert registry.get_kernel("fwht") is wider
        assert registry.registered_kernels() == names
    finally:
        registry.register_kernel(fwht)
    assert registry.get_kernel("fwht") is fwht
    with pytest.raises(KeyError, match="unknown kernel"):
        registry.get_kernel("nope")


@pytest.mark.parametrize("name,i", _cases())
def test_plain_matches_jax_ref(jax_side, name, i):
    _, refs, jax_args = jax_side
    entry, args, kw = _inputs(name, i)
    targs = [torch.from_numpy(a) for a in args]
    got = entry.ref(*targs, **kw)
    want = refs[name](*jax_args(name, args), **kw)
    registry.compare(entry, got, want, (targs, kw))


@pytest.mark.kernels
@pytest.mark.parametrize("name,i", _cases())
def test_plain_matches_jax_op_interpret(jax_side, name, i):
    jax_registry, _, jax_args = jax_side
    entry, args, kw = _inputs(name, i)
    targs = [torch.from_numpy(a) for a in args]
    got = entry.op(*targs, **kw)
    want = _jax_op(jax_registry, name)(*jax_args(name, args),
                                       interpret=True, **kw)
    registry.compare(entry, got, want, (targs, kw))


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
    registry.compare(entry, got, entry.ref(*targs, **kw), (targs, kw))


@pytest.mark.cuda
def test_extend_embed_column_bits_do_not_depend_on_batch_width():
    """Bucketed == unbatched on the card: the split over n depends on n
    alone, so a query column gets the same bits in any batch width and at
    any offset (one query, offsets off the 16-query tile), in both kinds
    the tile computes differently."""
    dev = _card()
    rng = np.random.default_rng(7)
    X, P, Xq = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                .to(dev) for s in ((19, 5000), (2, 5000), (19, 512)))
    op = registry.get_kernel("extend_embed").op
    for kw in ({}, {"kind": "rbf", "gamma": 0.05}):
        wide = op(X, P, Xq, **kw)
        for a, b in ((0, 8), (100, 164), (300, 512), (3, 4), (17, 40),
                     (511, 512), (0, 200)):
            assert torch.equal(op(X, P, Xq[:, a:b], **kw), wide[:, a:b])


@pytest.mark.cuda
def test_extend_embed_is_deterministic_on_card():
    """Fixed-order partial sums, no float atomics: the same inputs give
    the same bits on every launch."""
    dev = _card()
    entry = registry.get_kernel("extend_embed")
    args, kw = entry.build(np.random.default_rng(9),
                           {"p": 19, "n": 20_000, "r": 2, "w": 512})
    targs = [torch.from_numpy(a).to(dev) for a in args]
    first = entry.op(*targs, **kw)
    for _ in range(3):
        assert torch.equal(entry.op(*targs, **kw), first)


# The extend_embed kernel's shapes beyond the registry: the main path's
# stripe with the rbf kind, one query to a wide batch (query tiles per warp
# 1, 2 and 4, two query groups), n off the 128-point unit, r in passes of
# 8 up to 200, and p in chunks of 24.
EXTEND_CARD_CASES = (
    {"p": 19, "n": 100_000, "r": 2, "w": 512, "kind": "rbf", "gamma": 0.5},
    *({"p": 19, "n": 20_000, "r": 2, "w": w} for w in (1, 8, 23, 64, 1024)),
    *({"p": 19, "n": n, "r": 2, "w": 200} for n in (97, 5001)),
    *({"p": 19, "n": 3000, "r": r, "w": 100} for r in (1, 9, 16, 200)),
    {"p": 50, "n": 3000, "r": 3, "w": 70, "kind": "rbf", "gamma": 0.1},
)


@pytest.mark.cuda
@pytest.mark.parametrize("case", EXTEND_CARD_CASES, ids=(
    "main-rbf", "w1", "w8", "w23", "w64", "w1024", "n97", "n5001", "r1",
    "r9", "r16", "r200", "p50-rbf"))
def test_extend_embed_matches_plain_on_card(case):
    """The tensor-core kernel (3xTF32) against its plain version, within
    the registry's 2e-3, on unit-norm points as serving sees them."""
    dev = _card()
    entry = registry.get_kernel("extend_embed")
    (X, P, Xb), kw = entry.build(np.random.default_rng(12), case)
    X /= np.linalg.norm(X, axis=0, keepdims=True)
    Xb /= np.linalg.norm(Xb, axis=0, keepdims=True)
    targs = [torch.from_numpy(a).to(dev) for a in (X, P, Xb)]
    got = entry.op(*targs, **kw)
    torch.cuda.synchronize()
    registry.compare(entry, got, entry.ref(*targs, **kw))


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


# The fit_sketch kernel's shapes beyond the registry: the main path's block
# with the rbf kind (the tile's cancellation), ragged and single-column
# blocks, m off the 16- and 64-row tiles, a V mask, r' in passes of 8, p in
# chunks of 24 and b in chunks of 512.
FIT_CARD_CASES = (
    {"p": 19, "m": 100_000, "b": 512, "rp": 7, "kind": "rbf", "gamma": 0.5},
    *({"p": 19, "m": 3001, "b": b, "rp": 7} for b in (1, 37, 160, 512)),
    {"p": 19, "m": 5000, "b": 160, "rp": 7, "valid": 4321},
    {"p": 19, "m": 2000, "b": 200, "rp": 140},
    {"p": 19, "m": 2000, "b": 200, "rp": 400},
    {"p": 50, "m": 1500, "b": 100, "rp": 9, "kind": "rbf", "gamma": 0.1},
    {"p": 19, "m": 1500, "b": 1100, "rp": 7, "valid": 1000},
)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FIT_CARD_CASES, ids=(
    "main-rbf", "b1", "b37", "b160", "b512", "v-mask", "rp140", "rp400",
    "p50-rbf", "b1100"))
def test_fit_sketch_matches_plain_on_card(case):
    """The tensor-core kernel (3xTF32) against its plain version, within
    the registry's 2e-3, on unit-norm columns as the fit feeds it."""
    dev = _card()
    entry = registry.get_kernel("fit_sketch")
    args, kw = entry.build(np.random.default_rng(11), case)
    X, Omega, C, Ocr, V = args
    X /= np.linalg.norm(X, axis=0, keepdims=True)
    C /= np.linalg.norm(C, axis=0, keepdims=True)
    targs = [torch.from_numpy(a).to(dev) for a in (X, Omega, C, Ocr, V)]
    got = entry.op(*targs, **kw)
    torch.cuda.synchronize()
    registry.compare(entry, got, entry.ref(*targs, **kw))


@pytest.mark.cuda
def test_fwht_is_deterministic_on_card():
    """No atomics and a fixed stage order: the same bits on every run, at
    the main path's two shapes (the SRHT block update and the
    eigensolve's Omega^T Q) and a strided case with a masked column tile."""
    dev = _card()
    op = registry.get_kernel("fwht").op
    rng = np.random.default_rng(9)
    for n, c in ((1 << 17, 512), (1 << 17, 7), (1 << 11, 37)):
        x = torch.from_numpy(rng.standard_normal((n, c)).astype(np.float32)
                             ).to(dev)
        first = op(x)
        for _ in range(3):
            assert torch.equal(op(x), first)
        registry.compare(registry.get_kernel("fwht"), first,
                         registry.get_kernel("fwht").ref(x))


@pytest.mark.cuda
@pytest.mark.parametrize("row_bits", [13, 12, 11])
def test_fwht_column_equals_plain_and_repeats_on_card(monkeypatch, row_bits):
    """One column (c = 1: the row pass, then the pass kernel over the
    (n / 2^L, 2^L) view) at n = 2^1 .. 2^26 for each L tried: fwht_ref's
    bits, normalized and not, and the same bits on two launches. A column
    that does not start 16-byte aligned takes the pass kernel alone, with
    the same bits."""
    from repro_torch.kernels.fwht import ops
    dev = _card()
    monkeypatch.setattr(ops, "ROW_BITS", row_bits)
    g = torch.Generator(device=dev).manual_seed(row_bits)
    for m in range(1, 27):
        buf = torch.randn(((1 << m) + 1,), generator=g, device=dev)
        x = buf[:1 << m].view(-1, 1)
        for normalize in (True, False):
            first = ops.fwht_op(x, normalize)
            again = ops.fwht_op(x, normalize)
            want = ops.fwht_ref(x, normalize)
            assert torch.equal(first.view(torch.int32),
                               again.view(torch.int32)), (m, normalize)
            assert torch.equal(first.view(torch.int32),
                               want.view(torch.int32)), (m, normalize)
        shifted = buf[1:].view(-1, 1)
        assert not ops.aligned(shifted)
        assert torch.equal(ops.fwht_op(shifted).view(torch.int32),
                           ops.fwht_ref(shifted).view(torch.int32)), m


@pytest.mark.cuda
@pytest.mark.parametrize("max_bits", [10, 6])
@pytest.mark.parametrize("c", [512, 7, 36])
def test_fwht_and_srht_t_equal_plain_and_repeat_on_card(monkeypatch,
                                                         max_bits, c):
    """The redesigned pass kernel: fwht equals fwht_ref bit for bit and
    srht_t equals srht_t_ref by value, at n = 2^17 in two passes (the main
    path's plan) and three (max_bits 6), for the main path's m = 100,000
    and for m = n; two launches give the same bits."""
    from repro_torch.kernels.fwht import ops
    dev = _card()
    monkeypatch.setattr(ops, "MAX_PASS_BITS", max_bits)
    n = 1 << 17
    g = torch.Generator(device=dev).manual_seed(c)
    x = torch.randn((n, c), generator=g, device=dev)
    first = ops.fwht_op(x)
    assert torch.equal(first.view(torch.int32),
                       ops.fwht_op(x).view(torch.int32))
    assert torch.equal(first.view(torch.int32),
                       registry.get_kernel("fwht").ref(x).view(torch.int32))
    signs = (torch.randint(0, 2, (n,), generator=g, device=dev) * 2 - 1
             ).float()
    rows = torch.randperm(n, generator=g, device=dev)[:7]
    for m in (100_000, n):
        M = x[:m]
        first = ops.srht_t_op(M, signs, rows, n)
        assert torch.equal(first.view(torch.int32),
                           ops.srht_t_op(M, signs, rows, n).view(torch.int32))
        assert torch.equal(first, ops.srht_t_ref(M, signs, rows, n))
