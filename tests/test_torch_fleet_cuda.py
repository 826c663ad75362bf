"""The fleet tier on the card, with live pump threads.

Run on a machine with a CUDA device (it needs no JAX, which
tests/conftest.py imports):

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_fleet_cuda.py

A model is fitted by the port on the card (segmentation proxy from a
numpy seed: n = 2,000, p = 19, K = 7, r = 2, block 64, the fused fit) and
published to a VersionStore. Two replicas share the card, each pump
thread launching the kernels on its own; on the card a query's bits do
not depend on its batch, so every routed request equals an unbatched
Extender.assign of its queries bit for bit, and stopping the fleet
releases every pin and strands no future.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import KernelKMeans
from repro_torch.data import segmentation_proxy
from repro_torch.fleet import Fleet
from repro_torch.serve import ComputePolicy, Extender, VersionStore

N, NQ, P, K, R, BLOCK = 2000, 600, 19, 7, 2, 64
BUCKETS = (8, 16, 32, 64, 128)


@pytest.fixture(scope="module")
def card():
    """(model, its centroid rows reversed, held-out queries (P, NQ)) on
    the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    X, _ = segmentation_proxy(np.random.default_rng(41), n=N + NQ, p=P, k=K)
    X = X.numpy()[:, np.random.default_rng(42).permutation(N + NQ)]
    est = KernelKMeans(k=K, r=R, kernel="polynomial",
                       kernel_params={"gamma": 0.0, "degree": 2},
                       backend_params={"oversampling": 5}, block=BLOCK,
                       policy=ComputePolicy(), device="cuda").fit(
                           X[:, :N], seed=0)
    model = est.model_
    flipped = model._replace(centroids=model.centroids.flip(0).contiguous())
    return model, flipped, X[:, N:].copy()


def _requests(Xq, n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for w in rng.randint(1, 65, size=n):
        a = rng.randint(0, Xq.shape[1] - w + 1)
        out.append(np.ascontiguousarray(Xq[:, a:a + w]))
    return out


def _unbatched(model, reqs):
    ext = Extender(model, policy=ComputePolicy())
    return [tuple(x.cpu().numpy() for x in ext.assign(
        torch.from_numpy(r).cuda())) for r in reqs]


def _same_bits(got, want):
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1].view(np.int32), want[1].view(np.int32))


def _live_fleet(root):
    fleet = Fleet(root, n_workers=2, max_wait_ms=1.0, max_bucket=128,
                  device="cuda")
    for w in fleet.workers:               # first launches off the pumps
        w.scheduler().batcher.warm(BUCKETS)
    for w in fleet.workers:
        w.scheduler().start()
    return fleet


@pytest.mark.cuda
def test_live_pumps_on_two_replicas_equal_unbatched_assign(card, tmp_path):
    model, _, Xq = card
    store = VersionStore(str(tmp_path / "versions"))
    v1 = store.publish(model)
    reqs = _requests(Xq, 96, seed=3)
    want = _unbatched(model, reqs)
    fleet = _live_fleet(store.root)
    futs = [fleet.submit(r) for r in reqs]
    for f, w in zip(futs, want):
        _same_bits(f.result(timeout=60.0), w)
    assert all(w.latency.requests > 0 for w in fleet.workers)
    assert all(w.scheduler().pump_errors == 0 for w in fleet.workers)
    assert store.pins(v1) == ["w0", "w1"]
    fleet.stop()
    assert not any(w.scheduler().running for w in fleet.workers)
    assert store.pins(v1) == []
    with pytest.raises(RuntimeError):
        fleet.submit(reqs[0])


@pytest.mark.cuda
def test_rollout_under_live_pumps_then_stop_releases_every_pin(card,
                                                              tmp_path):
    model, flipped, Xq = card
    store = VersionStore(str(tmp_path / "versions"))
    store.publish(model)
    reqs = _requests(Xq, 48, seed=4)
    want = _unbatched(model, reqs)
    fleet = _live_fleet(store.root)
    before = [fleet.submit(r) for r in reqs[:24]]
    v2 = store.publish(flipped)
    report = fleet.rollout(v2)
    assert report.promoted and report.state == "done"
    assert all(w.version == v2 and w.scheduler().running
               for w in fleet.workers)
    for f, w in zip(before, want):
        _same_bits(f.result(timeout=60.0), w)
    after = [fleet.submit(r) for r in reqs[24:]]
    in_flight = [fleet.submit(r) for r in reqs[:8]]
    fleet.stop()                          # drains what is in flight
    assert all(f.done() for f in after + in_flight)
    for f, w in zip(after, want[24:]):
        assert np.array_equal(f.result(timeout=0)[0], K - 1 - w[0])
    assert all(w.scheduler().pump_errors == 0 for w in fleet.workers)
    assert all(store.pins(v) == [] for v in store.versions())
