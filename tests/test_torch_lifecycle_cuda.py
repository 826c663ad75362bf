"""The serving lifecycle and the drift monitor on the card.

Run on a machine with a CUDA device (it needs no JAX, which
tests/conftest.py imports):

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_lifecycle_cuda.py

A model is fitted by the port on the card (segmentation proxy from a
numpy seed: n = 2,000, p = 19, K = 7, r = 2, block 64, the fused fit).
On the card the kernels' bits do not depend on the batch width or a
query's offset in it, so async flushes that coalesce differently from
one synchronous drain give its labels and distances bit for bit, and a
swap under a running pump serves the old model's bits before the flip.
The drift monitor's errors take kappa from the gram kernel and are held
against the same errors with the plain kappa at the gram registry
tolerance (2e-3).
"""
import numpy as np
import pytest
import torch

from repro_torch.api import KernelKMeans
from repro_torch.data import segmentation_proxy
from repro_torch.kernels import OPS, registry
from repro_torch.kernels.gram.ref import gram_stripe_ref
from repro_torch.serve import (AsyncBatcher, ComputePolicy, MicroBatcher,
                               ModelRegistry)
from repro_torch.stream import DriftMonitor

N, NQ, P, K, R, BLOCK = 2000, 600, 19, 7, 2, 64


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def card():
    """(model, its centroid rows reversed, held-out queries (P, NQ)) on
    the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    X, _ = segmentation_proxy(np.random.default_rng(31), n=N + NQ, p=P, k=K)
    X = X.numpy()[:, np.random.default_rng(32).permutation(N + NQ)]
    est = KernelKMeans(k=K, r=R, kernel="polynomial",
                       kernel_params={"gamma": 0.0, "degree": 2},
                       backend_params={"oversampling": 5}, block=BLOCK,
                       policy=ComputePolicy(), device="cuda").fit(
                           X[:, :N], seed=0)
    model = est.model_
    flipped = model._replace(centroids=model.centroids.flip(0).contiguous())
    return model, flipped, X[:, N:].copy()


def _requests(Xq, widths, seed):
    rng = np.random.RandomState(seed)
    out = []
    for w in widths:
        a = rng.randint(0, Xq.shape[1] - w + 1)
        out.append(np.ascontiguousarray(Xq[:, a:a + w]))
    return out


def _sync(model, reqs, **kw):
    mb = MicroBatcher(model, **kw)
    for r in reqs:
        mb.submit(r)
    return mb.drain()


def _same_bits(got, want):
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1].view(np.int32), want[1].view(np.int32))


@pytest.mark.cuda
def test_async_equals_sync_across_rounds_on_card(card):
    model, _, Xq = card
    reqs = _requests(Xq, [5, 17, 9, 2, 64, 1, 33, 120], seed=8)
    want = _sync(model, reqs, max_bucket=128)
    ab = AsyncBatcher(model, max_wait_ms=5.0, clock=FakeClock(),
                      max_bucket=128)
    futs = []
    for group in ((0, 1), (2,), (3, 4, 5), (6, 7)):
        futs += [ab.submit(reqs[i]) for i in group]
        ab.flush()
    for f, w in zip(futs, want):
        _same_bits(f.result(timeout=0), w)
    # One request at a time, each in its own (narrowest) bucket.
    for r, w in zip(reqs, want):
        fut = ab.submit(r)
        ab.flush()
        _same_bits(fut.result(timeout=0), w)


@pytest.mark.cuda
def test_swap_under_a_running_pump_on_card(card):
    model, flipped, Xq = card
    reqs = _requests(Xq, [3, 17, 40, 9, 26], seed=7)
    want = _sync(model, reqs, max_bucket=128)
    reg = ModelRegistry()
    reg.register("m", model, version=1)
    sched = reg.scheduler("m", max_wait_ms=1.0, max_bucket=128)
    sched.batcher.warm([r.shape[1] for r in reqs])
    sched.start()
    futs = [sched.submit(r) for r in reqs]
    served = list(sched.batcher.executables)   # the drain may add one
    report = reg.swap("m", flipped, version=2)
    sched2 = reg.scheduler("m")
    assert sched2.running and not sched.running
    new = [sched2.submit(r) for r in reqs]
    for f, w in zip(futs, want):
        _same_bits(f.result(timeout=30.0), w)
    for f, w in zip(new, want):
        assert np.array_equal(f.result(timeout=30.0)[0], K - 1 - w[0])
    assert set(served) <= set(report.buckets_warmed)
    reg.unregister("m")
    assert not sched2.running
    assert sched.pump_errors == sched2.pump_errors == 0


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 48, 512])
def test_drift_errors_through_the_gram_kernel_on_card(card, width):
    """The monitor's sampled errors launch the gram kernel once per call
    and match the errors with the plain kappa at its tolerance."""
    model, _, Xq = card
    mon = DriftMonitor(model)
    entry = registry.get_kernel("gram_stripe")
    Xb = torch.from_numpy(np.ascontiguousarray(Xq[:, :width])).cuda()
    before = OPS["gram_stripe"].launches
    got = mon._approx_errors(Xb)
    torch.cuda.synchronize()
    assert OPS["gram_stripe"].launches == before + 1
    z = gram_stripe_ref(model.extension_ref, Xb, "polynomial", 0.0, 2)
    resid = z - model.U @ (model.U.T @ z)
    want = torch.linalg.norm(resid, dim=0) / torch.clamp(
        torch.linalg.norm(z, dim=0), min=1e-12)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=entry.rtol, atol=entry.atol)
    mon.observe(Xq[:, :width])
    assert OPS["gram_stripe"].launches == before + 2
    rep = mon.report()
    assert rep.samples == width and np.isfinite(rep.approx_err_p95)
