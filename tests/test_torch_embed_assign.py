"""The K-means assignment folded into the extend_embed kernel's summing
launch (`kernels.embed_assign_op`), against the JAX package.

Inputs are made with numpy from a seed and handed to both packages. On the
CPU the wrapper runs its plain version, `embed_assign_ref`; it is held
against the JAX package's assignment of extend_embed's embedding (both
ref.py files composed, and both Pallas kernels in interpret mode), and the
Extender's serving path on the kernel path against the JAX Extender, for
each kernel kind, with a ragged last stripe. Labels follow the near-tie
rule of the registry entry (`registry.near_tie_compare`). A routing test
shows which wrapper each policy reaches. The `cuda` cases hold the fold
against the two-launch sequence (extend_embed_op, transpose, assign_op)
bit for bit on the card, and hold extend_embed and the fold against their
plain versions at the landmark widths of a Nystrom model (n_ref = m of
10 to 64 training points, a part of one staging unit), where a Nystrom
fit on the card serves:

    python -m pytest --noconftest -m cuda tests/test_torch_embed_assign.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import KernelKMeans
from repro_torch.data import segmentation_proxy
from repro_torch.kernels import registry
from repro_torch.kernels.extend_embed.ops import extend_embed_op
from repro_torch.kernels.kmeans_assign.ops import assign_op, embed_assign_op
from repro_torch.kernels.kmeans_assign.ref import embed_assign_ref
from repro_torch.serve import ComputePolicy, MicroBatcher, from_reference
from repro_torch.serve import extend
from repro_torch.serve.extend import Extender

N, NQ, P, K, R, BLOCK = 300, 200, 19, 7, 2, 64     # 200 = 3 x 64 + 8
TOL = 2e-3
# The two-pass embedding with the kernel assignment (interpret applies to
# both fields, so on the CPU the kernel path is asked for alone).
TWO_PASS_KERNEL_ASSIGN = ComputePolicy(embed_fused=False, assign_fused=True)
KINDS = {
    "poly-g0-d2": ("polynomial", {"gamma": 0.0, "degree": 2}),
    "poly-g1-d3": ("polynomial", {"gamma": 1.0, "degree": 3}),
    "rbf": ("rbf", {"gamma": 0.5}),
    "linear": ("linear", {}),
}


def _statics(kind):
    name, params = KINDS[kind]
    return {"kind": name, **params}


def _stripe_inputs(seed, n=N, w=NQ, k=K, r=R, p=P):
    """X (p, n) and queries (p, w) of unit norm, P (r, n), C (k, r)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((p, n)).astype(np.float32)
    X /= np.linalg.norm(X, axis=0)
    Xb = rng.standard_normal((p, w)).astype(np.float32)
    Xb /= np.linalg.norm(Xb, axis=0)
    Pm = (rng.standard_normal((r, n)) / np.sqrt(n)).astype(np.float32)
    C = (0.3 * rng.standard_normal((k, r))).astype(np.float32)
    return X, Pm, Xb, C


def _distances(Y, C):
    """Squared distances (w, k) of the rows of Y (w, r) to C, float64."""
    Y, C = np.asarray(Y, np.float64), np.asarray(C, np.float64)
    return ((Y[:, None, :] - C[None]) ** 2).sum(-1)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plain_matches_jax_composition_interpret(kind):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.extend_embed.ops import extend_embed_pallas
    from repro.kernels.extend_embed.ref import extend_embed_ref
    from repro.kernels.kmeans_assign.ops import assign_pallas
    from repro.kernels.kmeans_assign.ref import assign_ref
    kw = _statics(kind)
    args = _stripe_inputs(3)
    targs = [torch.from_numpy(a) for a in args]
    got = embed_assign_ref(*targs, **kw)
    X, Pm, Xb, C = (jnp.asarray(a) for a in args)
    pallas = assign_pallas(
        extend_embed_pallas(X, Pm, Xb, interpret=True, **kw).T, C,
        interpret=True)
    refs = assign_ref(extend_embed_ref(X, Pm, Xb, **kw).T, C)
    dist = registry.embed_distances(*targs, **kw)
    for want in (pallas, refs):
        registry.near_tie_compare(got, want, TOL, TOL, dist)


@pytest.fixture(scope="module")
def fits():
    """One JAX fit per kind (segmentation shape, n = 300, block 64),
    carried into the port, and held-out queries."""
    from repro.api import KernelKMeans as JaxKernelKMeans
    X, _ = segmentation_proxy(np.random.default_rng(21), n=N + NQ, p=P, k=K)
    X = X.numpy()
    names = ("X_train", "U", "eigvals", "centroids", "sketch_signs",
             "sketch_rows", "stream_w", "stream_row_norms2", "stream_counts")
    out = {}
    for kind, (name, params) in KINDS.items():
        jest = JaxKernelKMeans(
            k=K, r=R, kernel=name, kernel_params=params,
            backend="onepass-srht", backend_params={"oversampling": 5},
            block=BLOCK).fit(X[:, :N], key=0)
        leaves = {n: None if getattr(jest.model_, n) is None
                  else np.asarray(getattr(jest.model_, n)) for n in names}
        out[kind] = (jest, from_reference(
            leaves, dataclasses.asdict(jest.model_.spec), device="cpu"))
    return out, X[:, N:].copy()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_extender_kernel_path_matches_jax(fits, kind):
    """b = 200 over blocks of 64: three full stripes and a ragged one."""
    from repro.serve import ComputePolicy as JaxPolicy
    from repro.serve.extend import Extender as JaxExtender
    models, Xq = fits
    jest, model = models[kind]
    ext = Extender(model, policy=ComputePolicy(interpret=True))
    assert ext.fused and ext.assign_fused and ext.block == BLOCK
    ref = JaxExtender(jest.model_, policy=JaxPolicy(interpret=True))
    got = ext.assign(Xq)
    want = ref.assign(Xq)
    dist = _distances(np.asarray(ref.embed(Xq)).T,
                      np.asarray(jest.model_.centroids))
    registry.near_tie_compare(got, want, TOL, TOL, dist)
    # The same request through the two-pass embedding and the standalone
    # kernel's plain version (assign_fused=True on the CPU warns).
    with pytest.warns(UserWarning, match="plain version"):
        two_pass = Extender(model, policy=TWO_PASS_KERNEL_ASSIGN)
    registry.near_tie_compare(got, two_pass.assign(Xq), TOL, TOL, dist)


@pytest.fixture
def routes(monkeypatch):
    """Calls of the two kernel-path wrappers from the Extender."""
    calls = {"embed_assign": [], "kmeans_assign": []}

    def counted(name, op, width):
        def wrapped(*args, **kwargs):
            calls[name].append(width(*args))
            return op(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(extend, "embed_assign_op", counted(
        "embed_assign", extend.embed_assign_op, lambda X, P, Xb, C: Xb.shape[1]))
    monkeypatch.setattr(extend, "assign_op", counted(
        "kmeans_assign", extend.assign_op, lambda Yq, C: Yq.shape[0]))
    return calls


def test_routing_follows_the_policy(fits, routes):
    models, Xq = fits
    model = models["poly-g0-d2"][1]
    # Both on the kernel path: one embed_assign_op per stripe, no assign_op.
    Extender(model, policy=ComputePolicy(interpret=True)).assign(Xq)
    assert routes == {"embed_assign": [64, 64, 64, 8], "kmeans_assign": []}
    Extender(model, policy=ComputePolicy(interpret=True)).assign(
        Xq, block=128)
    assert routes["embed_assign"][4:] == [128, 72]
    # The two-pass embedding with the kernel assignment: assign_op once.
    routes["embed_assign"].clear()
    with pytest.warns(UserWarning, match="plain version"):
        two_pass = Extender(model, policy=TWO_PASS_KERNEL_ASSIGN)
    two_pass.assign(Xq)
    assert routes == {"embed_assign": [], "kmeans_assign": [NQ]}
    # fused=False for one call: the plain argmin, neither wrapper.
    Extender(model, policy=ComputePolicy(interpret=True)).assign(
        Xq, fused=False)
    assert routes == {"embed_assign": [], "kmeans_assign": [NQ]}


def test_outputs_are_written_in_place_and_checked():
    X, Pm, Xb, C = (torch.from_numpy(a) for a in _stripe_inputs(5))
    labels = torch.full((NQ + 10,), -1, dtype=torch.int32)
    d2 = torch.full((NQ + 10,), -1.0)
    got = embed_assign_op(X, Pm, Xb, C, labels=labels[10:], d2=d2[10:])
    assert got[0].data_ptr() == labels[10:].data_ptr()
    want = embed_assign_ref(X, Pm, Xb, C)
    assert torch.equal(labels[10:], want[0]) and torch.equal(d2[10:], want[1])
    assert (labels[:10] == -1).all() and (d2[:10] == -1).all()
    assert embed_assign_op.launches == 0            # no kernel on the CPU
    with pytest.raises(ValueError, match="labels must be"):
        embed_assign_op(X, Pm, Xb, C, labels=torch.empty(NQ))
    with pytest.raises(ValueError, match="d2 must be"):
        embed_assign_op(X, Pm, Xb, C, d2=torch.empty(NQ - 1))


def test_near_tie_rule_tells_a_flip_from_a_fault():
    dist = np.array([[1.0, 1.0005, 9.0], [4.0, 1.0, 2.0]])
    want = (np.array([0, 1]), np.array([1.0, 1.0], np.float32))
    registry.near_tie_compare((np.array([1, 1]), want[1]), want, TOL, TOL,
                              dist)
    with pytest.raises(AssertionError, match="near-tie"):
        registry.near_tie_compare((np.array([0, 2]), want[1]), want, TOL,
                                  TOL, dist)


# -- on the card ---------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _on_card(seed, n, w, k, r):
    dev = _card()
    return [torch.from_numpy(a).to(dev)
            for a in _stripe_inputs(seed, n=n, w=w, k=k, r=r)]


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("k,r", [(7, 2), (100, 2), (7, 16), (100, 16)],
                         ids=["k7-r2", "k100-r2", "k7-r16", "k100-r16"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_fold_equals_two_launches_on_card(kind, k, r):
    """At w 8, 64, 256, 512 and the ragged 23: labels and d2 of the fold
    are the bits of assign_op on extend_embed_op's embedding, and within
    the near-tie rule of the plain version."""
    kw = _statics(kind)
    X, Pm, Xq, C = _on_card(11, 5000, 512, k, r)
    entry = registry.get_kernel("embed_assign")
    for w in (8, 64, 256, 512, 23):
        Xb = Xq[:, :w]
        launches = embed_assign_op.launches
        got = embed_assign_op(X, Pm, Xb, C, **kw)
        torch.cuda.synchronize()
        assert embed_assign_op.launches == launches + 1
        want = assign_op(extend_embed_op(X, Pm, Xb, **kw).T.contiguous(), C)
        assert torch.equal(got[0], want[0]), w
        assert _same_bits(got[1], want[1]), w
        registry.compare(entry, got, entry.ref(X, Pm, Xb, C, **kw),
                         ((X, Pm, Xb, C), kw))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_fold_bits_do_not_depend_on_batch_width_on_card(kind):
    """A query's label and d2 are the same at any batch width and
    offset, in the request's outputs at any offset."""
    kw = _statics(kind)
    X, Pm, Xq, C = _on_card(13, 5000, 512, K, R)
    wide = embed_assign_op(X, Pm, Xq, C, **kw)
    for a, b in ((0, 8), (100, 164), (300, 512), (3, 4), (17, 40),
                 (511, 512), (0, 200)):
        labels = torch.empty((b - a + 5,), dtype=torch.int32,
                             device=X.device)
        d2 = torch.empty((b - a + 5,), device=X.device)
        embed_assign_op(X, Pm, Xq[:, a:b], C, labels=labels[5:],
                        d2=d2[5:], **kw)
        assert torch.equal(labels[5:], wide[0][a:b])
        assert _same_bits(d2[5:], wide[1][a:b])


@pytest.mark.cuda
def test_served_requests_go_through_the_fold_on_card():
    """The default policy on the card: one embed_assign launch per stripe
    and no standalone kmeans_assign launch; bucketed == unbatched."""
    X, Pm, Xq, C = (t.cpu().numpy() for t in _on_card(17, 3000, 300, K, R))
    dev = _card()
    spec = {"kernel": "polynomial", "kernel_params": {"gamma": 0.0,
                                                      "degree": 2},
            "k": K, "r": R, "block": 128, "n": 3000, "p": P}
    U, _ = np.linalg.qr(Pm.T)
    model = from_reference({"X_train": X, "U": U.astype(np.float32),
                            "eigvals": np.array([2.0, 1.0], np.float32),
                            "centroids": C}, spec, device=dev)
    ext = Extender(model)
    before = (embed_assign_op.launches, assign_op.launches)
    labels, d2 = ext.assign(Xq)
    assert embed_assign_op.launches - before[0] == 3       # 128, 128, 44
    assert assign_op.launches == before[1]
    batcher = MicroBatcher(model)
    for a, b in ((0, 1), (1, 8), (8, 72), (72, 300)):
        got = batcher.assign_batch(Xq[:, a:b])
        np.testing.assert_array_equal(got[0], labels[a:b].cpu().numpy())
        np.testing.assert_array_equal(got[1].view(np.int32),
                                      d2[a:b].cpu().numpy().view(np.int32))
    assert assign_op.launches == before[1]


@pytest.mark.cuda
@pytest.mark.parametrize("w", [8, 512])
@pytest.mark.parametrize("n", [10, 20, 50, 64])
@pytest.mark.parametrize("kind", ["poly-g0-d2", "rbf"])
def test_landmark_widths_on_card(kind, n, w):
    """extend_embed and the fold against n = m landmarks (p 19): within
    the registry tolerances of their plain versions, the same bits on two
    launches."""
    kw = _statics(kind)
    X, Pm, Xb, C = _on_card(19, n, w, K, R)
    for name in ("extend_embed", "embed_assign"):
        entry = registry.get_kernel(name)
        args = (X, Pm, Xb) + ((C,) if name == "embed_assign" else ())
        got = entry.op(*args, **kw)
        again = entry.op(*args, **kw)
        torch.cuda.synchronize()
        registry.compare(entry, got, entry.ref(*args, **kw), (args, kw))
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        again if isinstance(again, tuple) else (again,)):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_nystrom_fit_and_predict_on_card():
    """A Nystrom KernelKMeans on the card serves through embed_assign
    against its 64 landmarks, with no standalone kmeans_assign launch; its
    training round trip and labels hold against the two-pass plain
    extension."""
    dev = _card()
    X, _ = segmentation_proxy(np.random.default_rng(23), n=3000 + NQ, p=P,
                              k=K)
    Xq = X[:, 3000:].to(dev)
    est = KernelKMeans(k=K, r=R, kernel="polynomial",
                       kernel_params={"gamma": 0.0, "degree": 2},
                       backend="nystrom", backend_params={"m": 64},
                       block=128, device=dev).fit(X[:, :3000], seed=0)
    assert est.model_.n_ref == 64 and est.model_.landmarks.is_cuda
    before = (embed_assign_op.launches, assign_op.launches)
    labels = est.predict(Xq)
    assert embed_assign_op.launches - before[0] == 2       # 128 + 72
    assert assign_op.launches == before[1]
    Y = est.embedding_
    rel = float(torch.linalg.norm(est.embed(X[:, :3000].to(dev)) - Y)
                / torch.linalg.norm(Y))
    assert rel <= TOL, rel
    plain = Extender(est.model_, policy=ComputePolicy(embed_fused=False,
                                                      assign_fused=False))
    emb = plain.embed(Xq).T.double()
    dist = ((emb[:, None, :] - est.centroids_.double()[None]) ** 2).sum(
        -1).cpu().numpy()
    got = est.extender().assign(Xq)
    assert torch.equal(got[0], labels)
    registry.near_tie_compare(got, plain.assign(Xq), TOL, TOL, dist)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["nystrom", "exact"])
def test_backend_fits_predicts_scores_and_reloads_on_card(backend, tmp_path):
    """The Nystrom and exact estimators on the card: fit, predict, score,
    save and load; the loaded model serves the same labels and score."""
    dev = _card()
    X, _ = segmentation_proxy(np.random.default_rng(29), n=2000 + NQ, p=P,
                              k=K)
    Xq = X[:, 2000:]
    est = KernelKMeans(k=K, r=R, kernel="polynomial",
                       kernel_params={"gamma": 0.0, "degree": 2},
                       backend=backend,
                       backend_params={"m": 64} if backend == "nystrom"
                       else {}, block=128, device=dev).fit(X[:, :2000],
                                                           seed=0)
    labels = est.predict(Xq)
    assert labels.device.type == dev.type and est.model_.n_ref == (
        64 if backend == "nystrom" else 2000)
    score = est.score(Xq)
    assert np.isfinite(score) and score <= 0.0 and est.score() <= 0.0
    loaded = KernelKMeans.load(est.save(str(tmp_path / backend)),
                               device=dev)
    assert loaded.model_.device.type == dev.type
    assert torch.equal(loaded.predict(Xq), labels)
    assert loaded.score(Xq) == score
