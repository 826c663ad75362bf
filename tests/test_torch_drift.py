"""The streaming loop of the port against the JAX package: DriftMonitor,
DriftReport, RetrainWorker, and drift -> refit -> publish -> swap under
async traffic.

Models: a polynomial fit on the segmentation proxy (n = 300, p = 19,
K = 7, r = 2) and an rbf fit on two 1-d blobs (k = 2, r = 4, gamma 0.5),
each fitted by the JAX package and carried into the port; the loop's own
estimator is fitted by the port. Data and traffic are made with numpy
from seeds. Timing runs on a fake clock, except the background worker's
test, bounded by its own timeout.

Tolerances against JAX's DriftMonitor on the same model, reference
labels and traffic: live and reference fractions and chi2 within 1e-6;
approximation-error p50 / p95 within 2e-3 (the gram registry tolerance:
the port takes kappa from the gram wrapper, JAX from plain jnp). The
monitor's errors through the gram kernel itself are held against the
plain kappa on the card, in tests/test_torch_lifecycle_cuda.py.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro.api import KernelKMeans as JaxKernelKMeans
from repro.serve.extend import assign as jax_assign
from repro.stream import DriftMonitor as JaxDriftMonitor
from repro_torch.api import KernelKMeans
from repro_torch.core.metrics import clustering_accuracy
from repro_torch.data import segmentation_proxy
from repro_torch.kernels import OPS
from repro_torch.serve import (MicroBatcher, ModelRegistry, VersionStore,
                               from_reference)
from repro_torch.stream import (DriftMonitor, DriftReport, RetrainReport,
                                RetrainWorker)

N, NQ, P, K, R, BLOCK = 300, 400, 19, 7, 2, 64
TOL = 2e-3
FRAC_TOL = 1e-6


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def _carry(jax_model, device="cpu"):
    leaves = {name: None if val is None else np.asarray(val)
              for name, val in jax_model._asdict().items() if name != "spec"}
    return from_reference(leaves, dataclasses.asdict(jax_model.spec),
                          device=device)


def _blobs_1d(rng, xs, n_per, sigma=0.25):
    """1-d-separable 2-row blobs at the given x centers -> (X, labels)."""
    cols, labels = [], []
    for i, x0 in enumerate(xs):
        c = np.zeros((2, n_per), np.float32)
        c[0] = x0 + sigma * rng.standard_normal(n_per)
        c[1] = sigma * rng.standard_normal(n_per)
        cols.append(c)
        labels.append(np.full(n_per, i))
    return np.concatenate(cols, axis=1), np.concatenate(labels)


@pytest.fixture(scope="module")
def fits():
    """{kind: (JAX model, port model, reference labels, reference
    traffic, shifted traffic)}. The reference labels are JAX's assignment
    of the training points: at rank r the extension of a training point
    need not give its K-means label, so held-out traffic is compared with
    what serving gives the training set."""
    out = {}
    X, _ = segmentation_proxy(np.random.default_rng(21), n=N + NQ, p=P, k=K)
    X = X.numpy()[:, np.random.default_rng(22).permutation(N + NQ)]
    jest = JaxKernelKMeans(
        k=K, r=R, kernel="polynomial",
        kernel_params={"gamma": 0.0, "degree": 2}, backend="onepass-srht",
        backend_params={"oversampling": 5}, block=BLOCK).fit(X[:, :N], key=0)
    # The proxy lays its classes out in blocks: its first 200 points
    # (before the shuffle) are one class, a shifted population.
    shifted, _ = segmentation_proxy(np.random.default_rng(21), n=N + NQ,
                                    p=P, k=K)
    out["polynomial"] = (jest.model_, _carry(jest.model_),
                         np.asarray(jax_assign(jest.model_, X[:, :N])[0]),
                         X[:, N:].copy(), shifted.numpy()[:, :200].copy())
    rng = np.random.default_rng(1)
    X0, _ = _blobs_1d(rng, (-2.0, 2.0), 100, sigma=0.3)
    jest = JaxKernelKMeans(k=2, r=4, kernel="rbf",
                           kernel_params={"gamma": 0.5},
                           backend="onepass-srht", block=BLOCK).fit(X0, key=2)
    Xon, _ = _blobs_1d(rng, (-2.0, 2.0), 64, sigma=0.3)
    Xfar = np.stack([rng.normal(0.0, 0.3, 128),
                     rng.normal(6.0, 0.3, 128)]).astype(np.float32)
    out["rbf"] = (jest.model_, _carry(jest.model_),
                  np.asarray(jax_assign(jest.model_, X0)[0]), Xon, Xfar)
    return out


def _observe_both(port, ref, X, jax_model, width, labels):
    for lo in range(0, X.shape[1], width):
        chunk = X[:, lo:lo + width]
        served = (np.asarray(jax_assign(jax_model, chunk)[0])
                  if labels == "served" else None)
        port.observe(chunk, served)
        ref.observe(chunk, served)


def _reports_agree(got: DriftReport, want) -> None:
    assert (got.queries, got.samples) == (want.queries, want.samples)
    np.testing.assert_allclose(got.live_fracs, want.live_fracs,
                               rtol=0, atol=FRAC_TOL)
    np.testing.assert_allclose(got.ref_fracs, want.ref_fracs,
                               rtol=0, atol=FRAC_TOL)
    assert got.chi2 == pytest.approx(want.chi2, rel=FRAC_TOL, abs=FRAC_TOL)
    assert got.max_frac_delta == pytest.approx(want.max_frac_delta,
                                               abs=FRAC_TOL)
    for name in ("approx_err_p50", "approx_err_p95", "approx_err_mean"):
        assert getattr(got, name) == pytest.approx(
            getattr(want, name), rel=TOL, abs=TOL), name
    assert (got.approx_fired, got.assign_fired, got.fired) == \
        (want.approx_fired, want.assign_fired, want.fired)


@pytest.mark.parametrize("labels", ["served", "recomputed"])
@pytest.mark.parametrize("traffic", ["reference", "shifted"])
@pytest.mark.parametrize("kind", ["polynomial", "rbf"])
def test_drift_report_matches_jax(fits, kind, traffic, labels):
    """Same model, reference labels and traffic: the port's report is
    JAX's. `served` hands both monitors JAX's served labels; with
    `recomputed` each monitor assigns the traffic through its own model."""
    jm, model, ref_labels, Xon, Xoff = fits[kind]
    X = Xon if traffic == "reference" else Xoff
    kw = dict(min_queries=50, sample_every=2,
              approx_err_threshold=0.5 if kind == "rbf" else None)
    port = DriftMonitor(model, ref_labels=torch.from_numpy(ref_labels), **kw)
    ref = JaxDriftMonitor(jm, ref_labels=ref_labels, **kw)
    _observe_both(port, ref, X, jm, 32, labels)
    got, want = port.report(), ref.report()
    _reports_agree(got, want)
    assert got.fired == (traffic == "shifted")
    assert got.to_dict()["reason"] == got.reason


@pytest.mark.parametrize("kind", ["polynomial", "rbf"])
def test_derived_reference_labels_match_jax(fits, kind):
    """ref_labels=None assigns X_train through the model, as JAX does."""
    jm, model, _, _, _ = fits[kind]
    port, ref = DriftMonitor(model), JaxDriftMonitor(jm)
    np.testing.assert_allclose(port.ref_fracs, ref.ref_fracs, rtol=0,
                               atol=FRAC_TOL)
    assert abs(port.ref_fracs.sum() - 1.0) < 1e-9


# ---------------------------------------------------------------------------
# the port's monitor on its own fit (tests/test_stream.py's cases)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lin_est():
    rng = np.random.default_rng(0)
    X0, y0 = _blobs_1d(rng, (-2.0, 2.0), 100)
    est = KernelKMeans(k=2, r=2, kernel="linear", backend="onepass-srht",
                       block=BLOCK, device="cpu")
    est.partial_fit(X0, seed=3, capacity=400)
    return est, X0, y0


def test_drift_monitor_quiet_on_reference_traffic(lin_est):
    est, X0, _ = lin_est
    mon = DriftMonitor(est.model_, ref_labels=est.labels_, min_queries=50)
    for lo in range(0, 200, 40):
        mon.observe(X0[:, lo:lo + 40])
    rep = mon.report()
    assert rep.queries == 200 and rep.samples == 200
    assert not rep.fired and rep.reason == "no drift"
    assert rep.chi2 < 10.0 and rep.max_frac_delta < 0.1


def test_drift_monitor_fires_on_assignment_shift(lin_est):
    est, X0, _ = lin_est
    mon = DriftMonitor(est.model_, ref_labels=est.labels_, min_queries=50)
    for lo in range(0, 200, 40):
        mon.observe(X0[:, lo:lo + 40], labels=np.zeros(40, np.int32))
    rep = mon.report()
    assert rep.assign_fired and rep.fired
    assert "assignment shift" in rep.reason
    assert rep.chi2 > mon.chi2_threshold
    assert rep.live_fracs == [1.0, 0.0]
    mon.reset_window()                    # below min_queries: quiet
    mon.observe(X0[:, :40], labels=np.zeros(40, np.int32))
    assert not mon.report().fired


def test_drift_monitor_sample_every(lin_est):
    est, X0, _ = lin_est
    mon = DriftMonitor(est.model_, min_queries=50, sample_every=2)
    np.testing.assert_allclose(mon.ref_fracs, [0.5, 0.5], atol=0.05)
    before = OPS["gram_stripe"].launches
    for lo in range(0, 160, 40):                  # 4 calls, 2 sampled
        mon.observe(X0[:, lo:lo + 40])
    rep = mon.report()
    assert rep.queries == 160 and rep.samples == 80
    assert OPS["gram_stripe"].launches == before  # CPU: the plain version


def test_drift_monitor_approx_error_trigger():
    """RBF model: on-support queries keep the kernel-column residual
    small; off-support queries land outside the rank-r eigenbasis and
    push p95 over the threshold."""
    rng = np.random.default_rng(1)
    X0, _ = _blobs_1d(rng, (-2.0, 2.0), 100, sigma=0.3)
    est = KernelKMeans(k=2, r=4, kernel="rbf", kernel_params={"gamma": 0.5},
                       backend="onepass-srht", block=BLOCK, device="cpu")
    est.fit(X0, seed=2)
    mon = DriftMonitor(est.model_, ref_labels=est.labels_,
                       approx_err_threshold=0.5, min_queries=10 ** 9)
    Xq, _ = _blobs_1d(rng, (-2.0, 2.0), 64, sigma=0.3)
    mon.observe(Xq)
    quiet = mon.report()
    assert not quiet.fired and quiet.approx_err_p95 < 0.5
    mon.reset_window()
    Xfar = np.stack([rng.normal(0.0, 0.3, 64),
                     rng.normal(6.0, 0.3, 64)]).astype(np.float32)
    mon.observe(Xfar)
    rep = mon.report()
    assert rep.approx_fired and rep.fired and "approx-err" in rep.reason
    assert rep.approx_err_p95 > quiet.approx_err_p95


def test_sample_serving_stats_preserves_buckets(lin_est):
    est, X0, _ = lin_est
    mb = MicroBatcher(est.model_, min_bucket=8)
    mb.assign_batch(X0[:, :10])
    mon = DriftMonitor(est.model_, ref_labels=est.labels_)
    snap = mon.sample_serving_stats(mb)
    assert snap["queries"] == 10 and snap["bucket_hits"] == {16: 1}
    assert mb.stats["queries"] == 0 and mb.stats["bucket_hits"] == {16: 0}
    assert mb.executables == [16]
    mb.reset_stats()
    assert mb.executables == []


# ---------------------------------------------------------------------------
# RetrainWorker
# ---------------------------------------------------------------------------

def _skew(mon, X, n=80):
    mon.observe(X[:, :n], labels=np.zeros(n, np.int32))


def test_retrain_worker_step_and_cooldown(lin_est, tmp_path):
    est, X0, _ = lin_est
    model = est.model_
    flipped = model._replace(centroids=model.centroids.flip(0))
    store = VersionStore(str(tmp_path / "store"))
    reg = ModelRegistry()
    reg.register("m", model, version=store.publish(model))
    clock = FakeClock()
    mon = DriftMonitor(model, ref_labels=est.labels_, min_queries=50)
    refits = []

    def refit(report):
        refits.append(report)
        return flipped if len(refits) % 2 else model

    worker = RetrainWorker("m", reg, store, mon, refit, cooldown_s=10.0,
                           clock=clock)
    assert worker.step() is None and worker.checks == 1   # quiet window
    _skew(mon, X0)
    out = worker.step()
    assert isinstance(out, RetrainReport) and worker.retrains == 1
    assert out.version == 2 and reg.version("m") == 2
    assert reg.get("m") is flipped and mon.model is flipped
    assert out.drift.assign_fired and out.swap.new_version == 2
    assert min(out.refit_s, out.publish_s, out.swap_s) >= 0.0
    assert out.to_dict()["drift"]["fired"]
    _skew(mon, X0)                            # fires again at once...
    clock.advance(5.0)
    assert worker.step() is None              # ...but inside the cooldown
    assert mon.report().fired and worker.retrains == 1
    clock.advance(6.0)
    again = worker.step()
    assert again is not None and again.version == 3
    assert worker.retrains == 2 and reg.get("m") is model
    assert store.versions() == [1, 2, 3] and worker.checks == 4


def test_retrain_worker_background_loop_records_errors(lin_est, tmp_path):
    """A refit that raises does not kill the poll thread: errors and
    last_error record it, and stop() ends the thread."""
    est, X0, _ = lin_est
    store = VersionStore(str(tmp_path / "store"))
    reg = ModelRegistry()
    reg.register("m", est.model_)
    mon = DriftMonitor(est.model_, ref_labels=est.labels_, min_queries=50)
    _skew(mon, X0)
    called = threading.Event()

    def refit(report):
        called.set()
        raise RuntimeError("refit failed")

    worker = RetrainWorker("m", reg, store, mon, refit)
    worker.start(poll_s=0.001)
    try:
        with pytest.raises(RuntimeError, match="already running"):
            worker.start()
        assert called.wait(timeout=30.0)
    finally:
        worker.stop()
    assert not worker.running
    assert worker.errors >= 1 and worker.retrains == 0
    assert isinstance(worker.last_error, RuntimeError)
    assert store.versions() == []


# ---------------------------------------------------------------------------
# end to end: drift -> refit -> publish -> swap under async traffic
# ---------------------------------------------------------------------------

def test_e2e_stream_drift_refit_swap(tmp_path):
    rng = np.random.default_rng(42)
    X0, _ = _blobs_1d(rng, (-2.0, 2.0), 100)      # initial distribution
    Xd, yd = _blobs_1d(rng, (3.0, 8.0), 100)      # drifted distribution

    est = KernelKMeans(k=2, r=2, kernel="linear", backend="onepass-srht",
                       block=BLOCK, device="cpu")
    est.partial_fit(X0, seed=3, capacity=400)
    stale_acc = clustering_accuracy(yd, est.predict(Xd), 2)
    assert stale_acc <= 0.75           # the drifted blobs share a centroid

    store = VersionStore(str(tmp_path / "store"), keep=4)
    reg = ModelRegistry()
    reg.register("stream-demo", est.model_, version=store.publish(est.model_))
    clock = FakeClock()
    sched_kwargs = dict(max_wait_ms=5.0, clock=clock)
    sched = reg.scheduler("stream-demo", **sched_kwargs)
    mon = DriftMonitor(est.model_, ref_labels=est.labels_,
                       min_queries=50, chi2_threshold=30.0)

    def refit(report):
        assert report.fired
        est.partial_fit(Xd)                       # fold the drifted window
        return est.model_

    worker = RetrainWorker("stream-demo", reg, store, mon, refit)

    Xh = X0[:, rng.permutation(X0.shape[1])]
    healthy = [Xh[:, lo:lo + 20] for lo in range(0, 100, 20)]
    futs = [sched.submit(ch) for ch in healthy]
    sched.flush()
    for ch, f in zip(healthy, futs):
        mon.observe(ch, f.result(timeout=5)[0])
    assert worker.step() is None and worker.checks == 1

    drifted = [Xd[:, lo:lo + 20] for lo in range(0, 200, 20)]
    futs = [sched.submit(ch) for ch in drifted]
    sched.flush()
    for ch, f in zip(drifted, futs):
        mon.observe(ch, f.result(timeout=5)[0])
    pending = sched.submit(Xd[:, :8])     # drained by the swap, not lost

    out = worker.step()
    assert out is not None and worker.retrains == 1
    assert out.version == 2 and out.drift.assign_fired
    assert out.swap.old_version == 1 and out.swap.new_version == 2
    assert out.swap.drained_requests == 1
    assert out.detect_to_swap_s >= 0.0
    assert pending.done() and pending.result()[0].shape == (8,)
    assert [f for f in futs + [pending] if not f.done()] == []
    assert sched.stopped
    with pytest.raises(RuntimeError, match="stopped"):
        sched.submit(Xd[:, :4])
    assert worker.step() is None          # the window was rebound

    assert reg.version("stream-demo") == 2 and store.latest() == 2
    new_sched = reg.scheduler("stream-demo", **sched_kwargs)
    assert new_sched is not sched
    f = new_sched.submit(Xd[:, :16])
    new_sched.flush()
    assert f.result(timeout=5)[0].shape == (16,)
    new_acc = clustering_accuracy(yd, KernelKMeans.from_model(
        reg.get("stream-demo")).predict(Xd), 2)
    assert new_acc >= 0.95 and new_acc > stale_acc + 0.2
    d = out.to_dict()
    assert d["swap"]["drained_requests"] == 1 and d["drift"]["fired"]
    reg.unregister("stream-demo")
