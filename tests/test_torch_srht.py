"""srht_t: Omega^T M with the signs, the zero tail and the row gather inside
the fwht kernel. Its plain version against the JAX package, its pass plan
(run here with torch ops, as the kernel runs it) against the plain
version and against brute force, the pass planning, and the routes of
the port that now call it. Inputs are made with numpy from a
seed; the JAX side runs on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sketch as jsk
from repro_torch.core import sketch as sk
from repro_torch.core.kernels_fn import make_kernel
from repro_torch.data import gaussian_blobs
from repro_torch.kernels.fwht import ops
from repro_torch.kernels.fwht.ref import fwht_ref, srht_t_ref
from repro_torch.stream.accumulate import SketchAccumulator

FWHT_TOL = 2e-4          # the fwht / srht_t registry tolerance
R_PRIME = 7


def _draws(n_pad, m, c, r=R_PRIME, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((m, c)).astype(np.float32)
    signs = (rng.integers(0, 2, n_pad) * 2 - 1).astype(np.float32)
    rows = rng.permutation(n_pad)[:r].astype(np.int64)
    return M, signs, rows


def _rows_for(n_pad, kind):
    return {"full": n_pad, "less_one": n_pad - 1,
            "ragged": n_pad // 2 + 3}[kind]


def _bits(t):
    """The float32 bit patterns, so that -0 and +0 differ."""
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("c", [1, 7, 33])
@pytest.mark.parametrize("kind", ["full", "ragged"])
@pytest.mark.parametrize("n_pad", [64, 1 << 11, 1 << 13])
def test_plain_is_the_composition_and_matches_jax(n_pad, kind, c):
    """srht_t_ref is the unfused pad / sign / transform / gather bit for
    bit, and JAX's srht_apply_t on the same draws within 2e-4."""
    M, signs, rows = _draws(n_pad, _rows_for(n_pad, kind), c)
    tM, ts, tr = map(torch.from_numpy, (M, signs, rows))
    got = srht_t_ref(tM, ts, tr, n_pad)
    Mp = torch.nn.functional.pad(tM, (0, 0, 0, n_pad - M.shape[0]))
    assert torch.equal(_bits(got),
                       _bits(fwht_ref((Mp * ts[:, None]).contiguous())[tr]))
    jsrht = jsk.SRHT(signs=jnp.asarray(signs), rows=jnp.asarray(rows),
                     n=M.shape[0], n_pad=n_pad)
    want = jsk.srht_apply_t(jsrht, jnp.asarray(M))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FWHT_TOL, atol=FWHT_TOL)


def _run_plan(M, signs, rows, n_pad, max_bits):
    """srht_plan's passes with torch ops, as csrc/fwht.cu runs them: each
    block gathers its 2^k rows, runs the k stages in the plain order and
    writes its listed rows; rows past m are +0 and read nothing."""
    m, c = M.shape
    src = torch.zeros((n_pad, c))
    src[:m] = M * signs[:m, None]
    plan = ops.srht_plan(rows.numpy(), n_pad, max_bits)
    for p in plan:
        idx = (torch.from_numpy(p.bases)[:, None]
               + torch.arange(1 << p.k)[None, :] * p.stride)
        tiles = fwht_ref(src[idx].transpose(0, 1).contiguous(),
                         normalize=False).transpose(0, 1)
        block = torch.repeat_interleave(
            torch.arange(len(p.bases)), torch.from_numpy(np.diff(p.wptr)))
        dst = torch.full((p.out_rows, c), float("nan"))
        dst[torch.from_numpy(p.wdst)] = tiles[block,
                                              torch.from_numpy(p.wj).long()]
        src = dst
    return src / torch.sqrt(torch.tensor(float(n_pad), dtype=torch.float32))


# (n_pad, max_bits) with one, two and three passes.
PLANS = [(1 << 10, 10), (1 << 11, 10), (1 << 11, 4), (1 << 12, 5)]


@pytest.mark.parametrize("kind", ["full", "less_one", "ragged"])
@pytest.mark.parametrize("n_pad,max_bits", PLANS)
def test_plan_gives_the_plain_values(n_pad, max_bits, kind):
    """The plan, run block by block, equals srht_t_ref by value (a zero
    may differ in sign): the rows it skips are never needed."""
    M, signs, rows = map(torch.from_numpy,
                         _draws(n_pad, _rows_for(n_pad, kind), 5, r=9))
    got = _run_plan(M, signs, rows, n_pad, max_bits)
    assert torch.equal(got, srht_t_ref(M, signs, rows, n_pad))


@pytest.mark.parametrize("r", [1, 7, 40])
@pytest.mark.parametrize("n_pad,max_bits", PLANS)
def test_plan_writes_the_rows_brute_force_needs(n_pad, max_bits, r):
    """Every pass but the last writes exactly the rows whose low done + k
    bits equal a sampled row's, each once, where the next pass reads it;
    the last writes each sampled row to its output row; a pass runs only
    the blocks that hold such rows."""
    rows = np.random.default_rng(r).permutation(n_pad)[:r]
    plan = ops.srht_plan(rows, n_pad, max_bits)
    assert [p.k for p in plan] == sorted(ops.pass_bits(n_pad, max_bits))
    prev = np.zeros(1, np.int64)
    where = None                # full row -> row of the previous destination
    for i, p in enumerate(plan):
        d, e = p.done, p.done + p.k
        assert p.stride == prev.size
        need_lo = set(int(x) for x in rows % (1 << d))
        assert len(p.bases) == (n_pad >> e) * len(need_lo)
        written = {}
        for b, base in enumerate(p.bases):
            t, hi = base % p.stride, base // (p.stride << p.k)
            assert int(prev[t]) in need_lo
            if where is not None:       # reads what the last pass wrote
                for j in range(1 << p.k):
                    full = int(hi * (1 << e) + j * (1 << d) + prev[t])
                    assert where[full] == base + j * p.stride
            for w in range(p.wptr[b], p.wptr[b + 1]):
                full = int(hi * (1 << e) + p.wj[w] * (1 << d) + prev[t])
                assert int(p.wdst[w]) not in written
                written[int(p.wdst[w])] = full
        if i == len(plan) - 1:
            assert written == {q: int(x) for q, x in enumerate(rows)}
        else:
            low = set(int(x) for x in rows % (1 << e))
            brute = [x for x in range(n_pad) if x % (1 << e) in low]
            assert sorted(written.values()) == brute     # each row once
            assert sorted(written) == list(range(p.out_rows))
        where = {full: dst for dst, full in written.items()}
        prev = p.residues


@pytest.mark.parametrize("n", [1 << m for m in (0, 1, 3, 9, 10, 11, 17, 20,
                                                21, 24)])
def test_pass_bits_and_reg_bits(n):
    """log2(n) stages in the fewest passes of <= MAX_PASS_BITS, as even as
    possible, low bits first; every pass's register rounds fit a block."""
    bits = ops.pass_bits(n)
    m = n.bit_length() - 1
    assert sum(bits) == m
    assert len(bits) == -(-m // ops.MAX_PASS_BITS)
    assert all(k <= ops.MAX_PASS_BITS for k in bits)
    assert not bits or max(bits) - min(bits) <= 1
    assert bits == sorted(bits, reverse=True)
    for k in bits or [0]:
        g = ops.reg_bits(k)
        assert g <= min(k, max(ops.MAX_REG_BITS, k - 7))
        assert ops.LANES << (k - g) <= ops.MAX_THREADS


def test_srht_t_op_checks_its_arguments():
    M, signs, rows = map(torch.from_numpy, _draws(64, 50, 3))
    with pytest.raises(ValueError, match="power of two"):
        ops.srht_t_op(M, signs, rows, 48)
    with pytest.raises(ValueError, match="rows"):
        ops.srht_t_op(M, signs[:32], rows, 32)
    with pytest.raises(TypeError, match="int64"):
        ops.srht_t_op(M, signs, rows.int(), 64)
    with pytest.raises(ValueError, match="contiguous"):
        ops.srht_t_op(M.T.contiguous().T, signs, rows, 64)


def _counting(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*args, **kw):
        calls.append(name)
        return real(*args, **kw)
    monkeypatch.setattr(module, name, counted)
    return calls


def test_srht_apply_routes_to_the_kernels_by_default(monkeypatch):
    """With fwht_fn unset, srht_apply_t calls srht_t_op and srht_apply
    fwht_op; an explicit fwht_fn keeps the unfused composition. On the
    CPU both give the same bits."""
    M, signs, rows = map(torch.from_numpy, _draws(256, 200, 7))
    srht = sk.SRHT(signs=signs, rows=rows, n=200, n_pad=256)
    fused = _counting(monkeypatch, sk, "srht_t_op")
    unfused = _counting(monkeypatch, sk, "fwht_op")
    got = sk.srht_apply_t(srht, M.T.contiguous().T)    # column-major, as Q
    assert fused == ["srht_t_op"] and unfused == []
    want = sk.srht_apply_t(srht, M, fwht_ref)
    assert fused == ["srht_t_op"]
    assert torch.equal(_bits(got), _bits(want))
    V = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (R_PRIME, 3)).astype(np.float32))
    out = sk.srht_apply(srht, V)
    assert unfused == ["fwht_op"]
    assert torch.equal(out, sk.srht_apply(srht, V, fwht_ref))


@pytest.mark.parametrize("kernel", [("polynomial", {"gamma": 0.0,
                                                    "degree": 2}),
                                    ("rbf", {"gamma": 0.5})])
def test_accumulator_default_route_is_the_old_composition(monkeypatch,
                                                          kernel):
    """The canonical SRHT update hands Kc (q + b rows, no zeroed
    capacity-row stripe) to srht_t_op: on the CPU its state and eig equal
    the unfused composition's (fwht_fn=fwht_ref) bit for bit, and
    chunked == one-shot holds on the new route."""
    X, _ = gaussian_blobs(np.random.default_rng(0), 300, 3, 2, spread=0.3,
                          center_scale=2.0)
    kern = make_kernel(kernel[0], **kernel[1])
    calls = _counting(monkeypatch, sk, "srht_t_op")

    def fit(fwht_fn, chunks):
        acc = SketchAccumulator(kern, 300, 2, oversampling=5, block=64,
                                generator=torch.Generator().manual_seed(4),
                                fwht_fn=fwht_fn)
        for a, b in chunks:
            acc.add(X[:, a:b])
        return acc, acc.eig()

    new, new_eig = fit(None, ((0, 300),))
    # Four blocks, the ragged tail and the eigensolve's Omega^T Q.
    assert len(calls) == 300 // 64 + 2
    old, old_eig = fit(fwht_ref, ((0, 300),))
    assert len(calls) == 6
    chunked, chunked_eig = fit(None, ((0, 70), (70, 131), (131, 300)))
    for other, eig in ((old, old_eig), (chunked, chunked_eig)):
        assert torch.equal(_bits(new.W), _bits(other.W))
        assert torch.equal(_bits(new.row_norms2), _bits(other.row_norms2))
        for name in ("Y", "U", "eigvals"):
            assert torch.equal(getattr(new_eig, name), getattr(eig, name))
