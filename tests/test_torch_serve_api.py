"""The serving entry points' arguments against the JAX package's:
`KernelKMeans.extender(**kwargs)`, `MicroBatcher.reset_stats(
preserve_buckets=)` and the per-call `Extender.assign(..., fused=)`.

A small model is fitted once by the JAX package (segmentation shape,
n = 300, block 64) and carried into the port; queries are made with numpy
from a seed. Labels and distances are compared by the kmeans_assign rule
(distances within 2e-3, labels differ on < 1% of rows).
"""
import dataclasses
import types
import warnings

import numpy as np
import pytest
import torch

from repro.api import KernelKMeans as JaxKernelKMeans
from repro.serve import ComputePolicy as JaxPolicy
from repro.serve import MicroBatcher as JaxMicroBatcher
from repro.serve.extend import Extender as JaxExtender
from repro_torch.api import KernelKMeans
from repro_torch.data import segmentation_proxy
from repro_torch.kernels.registry import assign_compare
from repro_torch.serve import ComputePolicy, MicroBatcher, from_reference
from repro_torch.serve import extend
from repro_torch.serve.extend import Extender

N, NQ, P, K, R, BLOCK = 300, 200, 19, 7, 2, 64
TOL = 2e-3
WIDTHS = (1, 7, 64, 9, 100, 1)      # request widths: buckets 8, 64, 16, 128


@pytest.fixture(scope="module")
def models():
    X, _ = segmentation_proxy(np.random.default_rng(21), n=N + NQ, p=P, k=K)
    X = X.numpy()
    jest = JaxKernelKMeans(
        k=K, r=R, kernel="polynomial",
        kernel_params={"gamma": 0.0, "degree": 2}, backend="onepass-srht",
        backend_params={"oversampling": 5}, block=BLOCK).fit(X[:, :N], key=0)
    names = ("X_train", "U", "eigvals", "centroids", "sketch_signs",
             "sketch_rows", "stream_w", "stream_row_norms2", "stream_counts")
    leaves = {n: None if getattr(jest.model_, n) is None
              else np.asarray(getattr(jest.model_, n)) for n in names}
    model = from_reference(leaves, dataclasses.asdict(jest.model_.spec),
                           device="cpu")
    return jest, model, X[:, N:].copy()


def test_extender_kwargs_build_a_fresh_extender(models):
    jest, model, _ = models
    policy = ComputePolicy(embed_fused=False, assign_fused=False)
    est = KernelKMeans.from_model(model, policy=policy)
    cached = est.extender()
    fresh = est.extender(block=32)
    want = jest.extender(block=32)
    assert fresh.block == want.block == 32
    assert fresh is not cached and fresh.policy is est.policy
    assert est.extender() is cached and cached.block == BLOCK
    # A policy given with the kwargs wins over the estimator's.
    other = ComputePolicy(interpret=True)
    assert est.extender(policy=other).policy is other
    assert jest.extender() is jest.extender()
    assert jest.extender().block == BLOCK


def _serve(batcher, Xq):
    off = 0
    for w in WIDTHS:
        batcher.assign_batch(Xq[:, off:off + w])
        off += w


@pytest.mark.parametrize("preserve", [True, False],
                         ids=["preserve-buckets", "drop-buckets"])
def test_reset_stats_matches_jax(models, preserve):
    jest, model, Xq = models
    port = MicroBatcher(model, policy=ComputePolicy(embed_fused=False,
                                                    assign_fused=False))
    ref = JaxMicroBatcher(jest.model_, policy=JaxPolicy(embed_fused=False,
                                                        assign_fused=False))
    _serve(port, Xq)
    _serve(ref, Xq)
    assert port.stats == ref.stats
    assert port.executables == ref.executables == [8, 16, 64, 128]
    port.reset_stats(preserve_buckets=preserve)
    ref.reset_stats(preserve_buckets=preserve)
    assert port.stats == ref.stats
    assert port.executables == ref.executables
    hits = port.stats["bucket_hits"]
    if preserve:
        assert hits == {8: 0, 16: 0, 64: 0, 128: 0}
    else:
        assert hits == {} and port.executables == []
    # The counters count again from zero, on the kept keys.
    _serve(port, Xq)
    _serve(ref, Xq)
    assert port.stats == ref.stats


@pytest.fixture
def counted_assign(monkeypatch):
    """The queries each Extender.assign call sent down the kmeans_assign
    kernel path, in either form: assign_op after the embedding, or
    embed_assign_op in each fused stripe. Calls that took the plain argmin
    add nothing."""
    calls = []
    assign = Extender.assign

    def counted_call(self, *args, **kwargs):
        calls.append(0)
        try:
            return assign(self, *args, **kwargs)
        finally:
            if not calls[-1]:
                calls.pop()

    def counted(op, queries):
        def wrapped(*args, **kwargs):
            calls[-1] += queries(*args)
            return op(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(Extender, "assign", counted_call)
    monkeypatch.setattr(extend, "assign_op", counted(
        extend.assign_op, lambda Yq, C: Yq.shape[0]))
    monkeypatch.setattr(extend, "embed_assign_op", counted(
        extend.embed_assign_op, lambda X, P, Xb, C: Xb.shape[1]))
    return calls


def test_assign_fused_false_per_call_matches_jax(models, counted_assign):
    jest, model, Xq = models
    # Both extenders take the kernel path by default (interpret=True opts
    # in on the CPU); fused=False per call takes the plain argmin.
    ext = Extender(model, policy=ComputePolicy(interpret=True))
    ref = JaxExtender(jest.model_, policy=JaxPolicy(interpret=True))
    assert ext.assign_fused
    got = ext.assign(Xq, fused=False)
    assert counted_assign == []
    want = ref.assign(Xq, fused=False)
    assign_compare(got, want, TOL, TOL)
    ext.assign(Xq)
    assert counted_assign == [NQ]
    ext.assign(Xq, block=16, fused=True)
    assert counted_assign == [NQ, NQ]


def test_assign_fused_true_per_call_follows_the_jax_rules(models,
                                                          counted_assign):
    jest, model, Xq = models
    plain = ComputePolicy(embed_fused=False, assign_fused=False)
    ext = Extender(model, policy=plain)
    ref = JaxExtender(jest.model_, policy=JaxPolicy(embed_fused=False,
                                                    assign_fused=False))
    assert not ext.assign_fused
    want = ext.assign(Xq)
    assert counted_assign == []
    # fused=True on the CPU with no interpret flag: honoured through the
    # plain version, with a warning, in both packages.
    for e in (ext, ref):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = e.assign(Xq, fused=True)
        assert len(caught) == 1
        assign_compare(got, want, TOL, TOL)
    assert counted_assign == [NQ]
    # fused=True against an explicit interpret=False: both refuse.
    for e in (Extender(model, policy=ComputePolicy(interpret=False)),
              JaxExtender(jest.model_, policy=JaxPolicy(interpret=False))):
        with pytest.raises(ValueError, match="interpret=False"):
            e.assign(Xq, fused=True)
    assert torch.equal(ext.assign(Xq, fused=False)[0], want[0])


# -- names the reference exports (ROADMAP Queue C) ---------------------------

def test_model_spec_is_the_legacy_alias():
    from repro_torch.serve import ClusteringSpec, ModelSpec
    assert ModelSpec is ClusteringSpec


@pytest.mark.parametrize("changes", [
    {}, {"embed_fused": False}, {"assign_fused": True, "interpret": True},
    {"embed_fused": True, "assign_fused": False, "fit_fused": False,
     "interpret": None}])
def test_policy_replace_matches_jax(changes):
    base = {"embed_fused": True, "fit_fused": True}
    policy = ComputePolicy(**base)
    got = policy.replace(**changes)
    want = JaxPolicy(**base).replace(**changes)
    shared = [f.name for f in dataclasses.fields(ComputePolicy)]
    assert {n: getattr(got, n) for n in shared} == \
        {n: getattr(want, n) for n in shared}
    assert got is not policy and policy == ComputePolicy(**base)
    assert got == ComputePolicy(**{**base, **changes})
    with pytest.raises(dataclasses.FrozenInstanceError):
        got.embed_fused = None
    # The mesh fields: replace() carries them, and a mesh without the
    # data axis is refused, as in the JAX package.
    assert got.replace(mesh_axis="data") == got
    mesh = types.SimpleNamespace(mesh_dim_names=("model",))
    with pytest.raises(ValueError, match="no axis 'data'"):
        got.replace(mesh=mesh)
    assert got.replace(mesh=mesh, mesh_axis="model").mesh is mesh
