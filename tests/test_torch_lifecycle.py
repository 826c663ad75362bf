"""The serving lifecycle of the port against the JAX package: the latency
histogram, AsyncBatcher, VersionStore and ModelRegistry (warm swap).

A small model is fitted once by the JAX package (segmentation shape,
n = 300, p = 19, K = 7, r = 2, block 64) and carried into the port;
requests are slices of held-out proxy points, their widths drawn with
numpy from a seed. Timing runs on a fake clock (no sleeps) except in the
pump-thread tests, each bounded by its own timeout.

Tolerances: the histogram and LatencyStats equal JAX's exactly on the
same samples; served labels and distances by the kmeans_assign rule
(distances within 2e-3, labels differ on < 1% of rows). Inside the port,
async results equal a synchronous drain bit for bit where the two
coalesce the same batches. On the CPU the plain path is a torch matmul
whose bits may depend on the batch width, so across differently
coalesced rounds the labels are held equal and the distances within
2e-3; the bitwise cross-round gate is a card test
(tests/test_torch_lifecycle_cuda.py), where the kernels' bits do not
depend on the batch width.
"""
import dataclasses
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.analysis import locks
from repro.api import KernelKMeans as JaxKernelKMeans
from repro.serve import AsyncBatcher as JaxAsyncBatcher
from repro.serve import MicroBatcher as JaxMicroBatcher
from repro.serve import ModelRegistry as JaxRegistry
from repro.serve import VersionStore as JaxVersionStore
from repro.serve import latency as jax_latency
from repro_torch.data import segmentation_proxy
from repro_torch.kernels.registry import assign_compare
from repro_torch.serve import (AsyncBatcher, LatencyStats, MicroBatcher,
                               ModelRegistry, VersionStore, from_reference,
                               latest_version, load_version,
                               publish_version)
from repro_torch.serve import latency as lat
from repro_torch.serve import registry as port_registry

N, NQ, P, K, R, BLOCK = 300, 400, 19, 7, 2, 64
TOL = 2e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance_ms(self, ms):
        self.t += ms / 1e3


def _carry(jax_model, device="cpu"):
    leaves = {name: None if val is None else np.asarray(val)
              for name, val in jax_model._asdict().items() if name != "spec"}
    return from_reference(leaves, dataclasses.asdict(jax_model.spec),
                          device=device)


@pytest.fixture(scope="module")
def models():
    """(JAX model, its centroid rows reversed, the same two in the port,
    held-out queries (P, NQ))."""
    X, _ = segmentation_proxy(np.random.default_rng(21), n=N + NQ, p=P, k=K)
    X = X.numpy()
    perm = np.random.default_rng(22).permutation(N + NQ)
    X = X[:, perm]
    jm = JaxKernelKMeans(
        k=K, r=R, kernel="polynomial",
        kernel_params={"gamma": 0.0, "degree": 2}, backend="onepass-srht",
        backend_params={"oversampling": 5}, block=BLOCK).fit(
            X[:, :N], key=0).model_
    jm_b = jm._replace(centroids=jm.centroids[::-1])
    return jm, jm_b, _carry(jm), _carry(jm_b), X[:, N:].copy()


def _requests(Xq, widths, seed=0):
    """Requests of the given widths at random offsets into Xq."""
    rng = np.random.RandomState(seed)
    out = []
    for w in widths:
        a = rng.randint(0, Xq.shape[1] - w + 1)
        out.append(np.ascontiguousarray(Xq[:, a:a + w]))
    return out


def _jax_sync(model, reqs, **kw):
    mb = JaxMicroBatcher(model, **kw)
    for r in reqs:
        mb.submit(r)
    return mb.drain()


def _port_sync(model, reqs, **kw):
    mb = MicroBatcher(model, **kw)
    for r in reqs:
        mb.submit(r)
    return mb.drain()


def _same_bits(got, want):
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(np.asarray(got[1]).view(np.int32),
                          np.asarray(want[1]).view(np.int32))


def _against_jax(got, want):
    for g, w in zip(got, want):
        assign_compare(g, (np.asarray(w[0]), np.asarray(w[1])), TOL, TOL)


# ---------------------------------------------------------------------------
# latency histogram and LatencyStats: equal to JAX's on the same samples
# ---------------------------------------------------------------------------

def test_histogram_bucket_layout_equals_jax():
    assert lat._N_BUCKETS == jax_latency._N_BUCKETS == 8 * lat._PER_DECADE
    for i in range(lat._N_BUCKETS):
        assert lat._bucket_edges(i) == jax_latency._bucket_edges(i)
        edge = lat._bucket_edges(i)[0]
        assert lat._bucket_index(edge) == jax_latency._bucket_index(edge) == i


_SAMPLES = {
    "linspace": np.linspace(1.0, 100.0, 1000),
    "lognormal": np.random.default_rng(3).lognormal(0.0, 2.0, 777),
    "edges": np.array([lat._LO_MS * 10.0 ** (i / lat._PER_DECADE)
                       for i in range(0, lat._N_BUCKETS, 7)]),
    "clamped": np.array([0.0, 1e-9, 5e-4, 1e9, 3e7]),
    "one": np.array([12.5]),
    "empty": np.array([]),
}


@pytest.mark.parametrize("name", sorted(_SAMPLES))
def test_histogram_equals_jax(name):
    port, ref = lat.Histogram(), jax_latency.Histogram()
    for v in _SAMPLES[name]:
        port.record(v)
        ref.record(v)
    assert port.counts == ref.counts
    assert (port.n, port.total, port.min, port.max, port.mean) == \
        (ref.n, ref.total, ref.min, ref.max, ref.mean)
    for q in (0.0, 1.0, 25.0, 50.0, 90.0, 95.0, 99.0, 99.9, 100.0):
        assert port.percentile(q) == ref.percentile(q), q


def _record_both(port, ref, rows):
    for enq, flush, done, queries, bucket in rows:
        port.record(enq, flush, done, queries=queries, bucket=bucket)
        ref.record(enq, flush, done, queries=queries, bucket=bucket)


def _latency_rows(seed, n=300):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        enq = float(rng.uniform(0.0, 10.0))
        flush = enq + float(rng.exponential(2e-3))
        done = flush + float(rng.exponential(5e-3))
        rows.append((enq, flush, done, int(rng.integers(1, 65)),
                     [None, 8, 64, 1024][int(rng.integers(0, 4))]))
    return rows


@pytest.mark.parametrize("slo_ms", [None, 6.0])
def test_latency_stats_summary_equals_jax(slo_ms):
    port, ref = LatencyStats(slo_ms=slo_ms), jax_latency.LatencyStats(
        slo_ms=slo_ms)
    _record_both(port, ref, _latency_rows(5))
    assert port.summary() == ref.summary()
    assert port.format_table() == ref.format_table()
    assert port.slo_violation_rate == ref.slo_violation_rate
    # merge / merged: exact, and the same as JAX's on the same parts.
    parts = [_latency_rows(s, n=50) for s in (6, 7, 8)]
    pp, rp = [], []
    for rows in parts:
        a, b = LatencyStats(slo_ms=slo_ms), jax_latency.LatencyStats(
            slo_ms=slo_ms)
        _record_both(a, b, rows)
        pp.append(a)
        rp.append(b)
    merged = LatencyStats.merged(pp)
    assert merged.summary() == jax_latency.LatencyStats.merged(rp).summary()
    # Against one stream of all the samples: the same counts, so the same
    # percentiles; the summed totals may differ in the last bit.
    one = LatencyStats(slo_ms=slo_ms)
    for rows in parts:
        for enq, flush, done, queries, bucket in rows:
            one.record(enq, flush, done, queries=queries, bucket=bucket)
    for h, g in [(merged.total, one.total),
                 (merged.queue_wait, one.queue_wait)] + [
                     (merged.by_bucket[b], one.by_bucket[b])
                     for b in one.by_bucket]:
        assert h.counts == g.counts and h.n == g.n
        assert [h.percentile(q) for q in (50.0, 95.0, 99.0)] == \
            [g.percentile(q) for q in (50.0, 95.0, 99.0)]
        assert h.mean == pytest.approx(g.mean, rel=1e-12)
    assert (merged.requests, merged.queries, merged.slo_violations) == \
        (one.requests, one.queries, one.slo_violations)


def test_latency_merge_refuses_mixed_slos():
    a, b = LatencyStats(slo_ms=5.0), LatencyStats(slo_ms=9.0)
    a.record(0.0, 0.0, 0.002)
    b.record(0.0, 0.0, 0.001)
    with pytest.raises(ValueError, match="different SLOs"):
        a.merge(b)
    fresh = LatencyStats()
    fresh.merge(b)                       # adopts 9.0: nothing recorded yet
    assert fresh.slo_ms == 9.0 and fresh.requests == 1


# ---------------------------------------------------------------------------
# AsyncBatcher: deadline, full bucket, order, cancel, foreign, stop, waits
# ---------------------------------------------------------------------------

def test_deadline_flush_fires_on_oldest_request(models):
    _, _, model, _, Xq = models
    clock = FakeClock()
    ab = AsyncBatcher(model, max_wait_ms=5.0, clock=clock, max_bucket=128)
    ab.submit(_requests(Xq, [3])[0])
    clock.advance_ms(3.0)
    ab.submit(_requests(Xq, [4], seed=1)[0])   # younger request, 3 ms later
    assert not ab.due()
    assert ab.poll() == 0                 # nothing due yet
    clock.advance_ms(2.0)                 # oldest hits 5 ms; youngest at 2
    assert ab.due()
    assert ab.poll() == 2                 # deadline of the OLDEST flushes all
    assert ab.pending_requests == 0
    assert not ab.due()                   # empty queue is never due


def test_full_bucket_flushes_inline_without_deadline(models):
    _, _, model, _, Xq = models
    clock = FakeClock()
    ab = AsyncBatcher(model, max_wait_ms=1e6, clock=clock, max_bucket=64)
    futs = [ab.submit(r) for r in _requests(Xq, [30, 30])]
    assert ab.pending_requests == 2 and ab.pending_width == 60
    assert not futs[0].done()
    futs.append(ab.submit(_requests(Xq, [10], seed=1)[0]))  # 70 >= 64
    assert ab.pending_requests == 0
    assert all(f.done() for f in futs)


def test_flush_resolves_in_order_and_matches_jax(models):
    """Futures resolve to their own slices in submission order; the
    same requests through JAX's AsyncBatcher serve the same labels."""
    jm, _, model, _, Xq = models
    reqs = _requests(Xq, [7, 33, 1, 49, 11], seed=3)
    clocks = FakeClock(), FakeClock()
    ab = AsyncBatcher(model, max_wait_ms=5.0, clock=clocks[0],
                      max_bucket=512)
    jab = JaxAsyncBatcher(jm, max_wait_ms=5.0, clock=clocks[1],
                          max_bucket=512)
    futs = [ab.submit(r) for r in reqs]
    jfuts = [jab.submit(r) for r in reqs]
    assert ab.flush() == 5 and jab.flush() == 5
    got = [f.result(timeout=0) for f in futs]
    for r, (labels, d2) in zip(reqs, got):
        assert labels.shape == d2.shape == (r.shape[1],)
        assert isinstance(labels, np.ndarray) and isinstance(d2, np.ndarray)
    _against_jax(got, [f.result(timeout=0) for f in jfuts])


def test_async_equals_sync_drain_bit_for_bit(models):
    """One flush hands the inner batcher exactly what drain() sees."""
    _, _, model, _, Xq = models
    reqs = _requests(Xq, [7, 33, 1, 23], seed=4)
    ab = AsyncBatcher(model, max_wait_ms=5.0, clock=FakeClock(),
                      max_bucket=64)
    futs = [ab.submit(r) for r in reqs[:3]]    # 41 < 64: stays pending
    assert not any(f.done() for f in futs)
    futs.append(ab.submit(reqs[3]))            # 64: flushes inline
    assert all(f.done() for f in futs)
    for f, want in zip(futs, _port_sync(model, reqs, max_bucket=64)):
        _same_bits(f.result(timeout=0), want)


def test_async_across_rounds_matches_sync(models):
    """Requests flushed in separate rounds resolve to exactly their own
    slices whatever order the futures are read in. On the CPU the
    rounds' widths may change the plain matmul's bits: labels equal,
    distances within 2e-3 (bitwise on the card, test below)."""
    jm, _, model, _, Xq = models
    reqs = _requests(Xq, [5, 17, 9, 2], seed=5)
    ab = AsyncBatcher(model, max_wait_ms=5.0, clock=FakeClock(),
                      max_bucket=512)
    f0, f1 = ab.submit(reqs[0]), ab.submit(reqs[1])
    ab.flush()                            # round 1: reqs 0, 1
    f2, f3 = ab.submit(reqs[2]), ab.submit(reqs[3])
    ab.flush()                            # round 2: reqs 2, 3
    want = _port_sync(model, reqs, max_bucket=512)
    got = [f.result(timeout=0) for f in (f3, f2, f1, f0)][::-1]
    for g, w in zip(got, want):
        assert np.array_equal(g[0], w[0])
        np.testing.assert_allclose(g[1], w[1], rtol=TOL, atol=TOL)
    _against_jax(got, _jax_sync(jm, reqs, max_bucket=512))


def test_cancelled_future_does_not_strand_the_batch(models):
    _, _, model, _, Xq = models
    ab = AsyncBatcher(model, max_wait_ms=1e9, clock=FakeClock())
    reqs = _requests(Xq, [3, 4, 5])
    futs = [ab.submit(r) for r in reqs]
    assert futs[1].cancel()              # pending -> cancellable
    assert ab.flush() == 3
    for i in (0, 2):
        labels, _ = futs[i].result(timeout=5)
        assert labels.shape == (reqs[i].shape[1],)
    assert futs[1].cancelled()


def test_flush_rejects_foreign_inner_requests(models):
    """Requests enqueued directly on the inner MicroBatcher must not be
    silently zipped onto the async futures."""
    _, _, model, _, Xq = models
    ab = AsyncBatcher(model, clock=FakeClock(), max_bucket=512)
    ab.batcher.submit(_requests(Xq, [3])[0])   # foreign: bypasses futures
    fut = ab.submit(_requests(Xq, [5])[0])
    with pytest.raises(RuntimeError, match="foreign"):
        ab.flush()
    with pytest.raises(RuntimeError, match="foreign"):
        fut.result(timeout=0)                  # the future carries it


def test_submit_validates_shape(models):
    _, _, model, _, _ = models
    ab = AsyncBatcher(model, clock=FakeClock())
    with pytest.raises(ValueError):
        ab.submit(np.zeros((P, 0), np.float32))
    with pytest.raises(ValueError):
        ab.submit(np.zeros((P + 1, 4), np.float32))


def test_submit_after_stop_rejected_not_stranded(models):
    _, _, model, _, Xq = models
    ab = AsyncBatcher(model, clock=FakeClock(), max_bucket=128)
    fut = ab.submit(_requests(Xq, [4])[0])
    assert ab.stop() == 1                      # stop flushes pending
    assert fut.done() and ab.stopped and not ab.running
    with pytest.raises(RuntimeError, match="stopped"):
        ab.submit(_requests(Xq, [4])[0])       # would never flush
    assert ab.stop() == 0                      # idempotent
    with pytest.raises(RuntimeError, match="stopped"):
        ab.start()                             # a stopped batcher is dead


def test_per_bucket_wait_follows_the_window_as_jax_does(models):
    """The deadline that applies is the one of the bucket the pending
    window would coalesce into; the port's due() sequence equals JAX's
    on the same clock and requests."""
    jm, _, model, _, Xq = models
    clock = FakeClock()
    ab = AsyncBatcher(model, max_wait_ms=10.0, clock=clock,
                      min_bucket=8, max_bucket=128)
    jab = JaxAsyncBatcher(jm, max_wait_ms=10.0, clock=clock,
                          min_bucket=8, max_bucket=128)
    for b in (ab, jab):
        b.set_bucket_wait(8, 2.0)
        b.set_bucket_wait(64, 6.0)
        with pytest.raises(ValueError, match="positive"):
            b.set_bucket_wait(16, 0.0)
    assert [ab.bucket_wait(b) for b in (8, 16, 64)] == [2.0, 10.0, 6.0]
    assert ab._pump_period() == jab._pump_period() == 2.0 / 4e3
    # (width submitted at this time or None, check time ms, due?)
    script = [(3, 0.0, False), (None, 1.9, False), (None, 2.1, True),
              (40, 2.1, False),            # 43 wide: bucket 64, 6 ms
              (None, 5.9, False), (None, 6.1, True),
              (30, 6.1, False),            # 73 wide: bucket 128, 10 ms
              (None, 9.9, False), (None, 10.1, True)]
    for width, at_ms, due in script:
        clock.t = at_ms / 1e3
        if width is not None:
            for b in (ab, jab):
                b.submit(_requests(Xq, [width], seed=width)[0])
        assert ab.due() == jab.due() == due, (width, at_ms)
    assert ab.flush() == jab.flush() == 3


def test_slo_and_per_bucket_latency_equal_jax(models):
    """The same requests on the same fake clock give the same latency
    summary in both packages, per-bucket breakdown and SLO counter
    included."""
    jm, _, model, _, Xq = models
    summaries = []
    for cls, m in ((AsyncBatcher, model), (JaxAsyncBatcher, jm)):
        clock = FakeClock()
        ab = cls(m, max_wait_ms=100.0, slo_ms=5.0, clock=clock,
                 min_bucket=8, max_bucket=128)
        for widths, wait in (((3, 4), 0.0), ((40, 30), 10.0),
                             ((2,), 4.0), ((60, 50), 7.0)):
            for req in _requests(Xq, widths, seed=sum(widths)):
                ab.submit(req)
            clock.advance_ms(wait)
            ab.flush()
        for req in _requests(Xq, (100, 100), seed=9):
            ab.submit(req)               # 200 >= 128: flushes inline
        assert ab.pending_requests == 0
        summaries.append(ab.latency.summary())
    assert summaries[0] == summaries[1]
    s = summaries[0]
    # 10 and 7 ms waits break the 5 ms SLO: two requests each.
    assert s["slo_violations"] == 4 and s["requests"] == 9
    assert {k: v["requests"] for k, v in s["per_bucket"].items()} == {
        "8": 3, "128": 6}


def test_pump_thread_flushes_on_deadline(models):
    """Real-clock smoke of the background pump: a submitted request
    resolves without any explicit poll/flush."""
    _, _, model, _, Xq = models
    with AsyncBatcher(model, max_wait_ms=1.0, max_bucket=512) as ab:
        assert ab.running
        with pytest.raises(RuntimeError, match="already running"):
            ab.start()
        fut = ab.submit(_requests(Xq, [4])[0])
        labels, _ = fut.result(timeout=30.0)
    assert labels.shape == (4,)
    assert ab.latency.requests == 1 and ab.stopped and not ab.running


def test_pump_thread_survives_flush_errors(models):
    """A poisoned batch must not kill the pump thread: its futures carry
    the exception and later requests still get served."""
    _, _, model, _, Xq = models
    ab = AsyncBatcher(model, max_wait_ms=1.0, max_bucket=512)
    with ab:
        ab.batcher.submit(_requests(Xq, [3])[0])   # poison: foreign req
        bad = ab.submit(_requests(Xq, [5])[0])
        with pytest.raises(RuntimeError):
            bad.result(timeout=30.0)
        good = ab.submit(_requests(Xq, [4])[0])    # pump must still run
        labels, _ = good.result(timeout=30.0)
    assert labels.shape == (4,)
    assert ab.pump_errors >= 1
    assert isinstance(ab.last_pump_error, RuntimeError)


def test_concurrent_submitters_with_a_live_pump(models):
    """More submitting threads than cores against a running pump, with a
    short switch interval: every future resolves to its own request's
    labels (the sync drain's) and every request is counted once."""
    _, _, model, _, Xq = models
    n_threads, per_thread = 2 * (os.cpu_count() or 1) + 2, 6
    reqs = _requests(Xq, [1 + (i % 9) for i in range(n_threads * per_thread)],
                     seed=11)
    want = [MicroBatcher(model).assign_batch(r)[0] for r in reqs]
    ab = AsyncBatcher(model, max_wait_ms=0.5, max_bucket=64)
    futs = [None] * len(reqs)

    def client(t):
        for i in range(t, len(reqs), n_threads):
            futs[i] = ab.submit(reqs[i])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ab.start()
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
        got = [f.result(timeout=60.0)[0] for f in futs]
    finally:
        sys.setswitchinterval(old)
        ab.stop()
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert ab.latency.requests == len(reqs)
    assert ab.latency.queries == sum(r.shape[1] for r in reqs)
    assert ab.pump_errors == 0


# ---------------------------------------------------------------------------
# VersionStore
# ---------------------------------------------------------------------------

def test_version_store_publish_latest_pinned(models, tmp_path):
    _, _, model, model_b, _ = models
    store = VersionStore(str(tmp_path / "store"))
    assert store.versions() == [] and store.latest() is None
    with pytest.raises(FileNotFoundError):
        store.path()
    assert (store.publish(model), store.publish(model_b)) == (1, 2)
    assert store.versions() == [1, 2] and store.latest() == 2
    assert torch.equal(store.load(1, device="cpu").centroids,
                       model.centroids)
    assert torch.equal(store.load(device="cpu").centroids,
                       model_b.centroids)


def test_version_store_gc_keeps_last_k(models, tmp_path):
    _, _, model, _, _ = models
    store = VersionStore(str(tmp_path / "store"))
    for _ in range(5):
        store.publish(model)
    assert store.gc(keep=2) == [1, 2, 3]
    assert store.versions() == [4, 5]
    store.load(4, device="cpu")                # survivors still load
    with pytest.raises(FileNotFoundError):
        store.load(2, device="cpu")            # GC'ed pin fails loudly
    assert store.publish(model) == 6           # numbers never reused
    with pytest.raises(ValueError):
        store.gc(keep=0)
    inline = VersionStore(str(tmp_path / "inline"), keep=2)
    for _ in range(4):
        inline.publish(model)                  # constructor keep applies
    assert inline.versions() == [3, 4]


def test_version_store_pins_survive_gc(models, tmp_path):
    _, _, model, _, _ = models
    store = VersionStore(str(tmp_path / "store"))
    for _ in range(3):
        store.publish(model)
    assert store.pin(1, "worker-a") == 1
    store.pin(1, "worker-b")
    store.pin(1, "worker-a")                   # idempotent per owner
    assert store.pins(1) == ["worker-a", "worker-b"]
    with pytest.raises(FileNotFoundError):
        store.pin(9, "worker-a")
    assert store.gc(keep=1) == [2]             # v1 pinned, v2 removed
    assert store.versions() == [1, 3]
    store.unpin(1, "worker-a")
    store.unpin(1, "worker-b")
    store.unpin(1, "worker-b")                 # idempotent
    assert store.gc(keep=1) == [1]
    assert store.versions() == [3]
    assert not (tmp_path / "store" / "v_1.pins").exists()


def test_version_store_ignores_inflight_and_junk(models, tmp_path):
    _, _, model, _, _ = models
    root = tmp_path / "store"
    store = VersionStore(str(root))
    store.publish(model)
    (root / "v_9.tmp").mkdir()                 # crashed publish (stale)
    old = time.time() - 7200
    os.utime(root / "v_9.tmp", (old, old))
    (root / "v_8.tmp").mkdir()                 # in-flight publish (fresh)
    (root / "not_a_version").mkdir()
    (root / "v_7").mkdir()                     # no spec.json: incomplete
    assert store.versions() == [1] and store.latest() == 1
    store.gc(keep=1)
    assert not (root / "v_9.tmp").exists()     # stale crash swept
    assert (root / "v_8.tmp").exists()         # live writer left alone


def test_version_store_publish_never_clobbers_existing_dir(models, tmp_path):
    _, _, model, _, _ = models
    root = tmp_path / "store"
    store = VersionStore(str(root))
    store.publish(model)                       # v_1
    blocker = root / "v_2"
    blocker.mkdir()
    (blocker / "marker").write_text("keep me")
    assert store.publish(model) == 3           # bumped past the blocker
    assert (blocker / "marker").read_text() == "keep me"
    assert store.versions() == [1, 3]
    store.load(3, device="cpu")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_one_store_both_packages(models, tmp_path, writer):
    """A store written by one package loads in the other and serves the
    same labels; a pin written by one keeps its version through the
    other's gc."""
    jm, jm_b, model, model_b, Xq = models
    root = str(tmp_path / "store")
    port, ref = VersionStore(root), JaxVersionStore(root)
    if writer == "jax":
        assert [ref.publish(m) for m in (jm, jm_b, jm)] == [1, 2, 3]
        ref.pin(1, "jax-worker")
        assert port.gc(keep=1) == [2]
        assert port.versions() == [1, 3] and port.pins(1) == ["jax-worker"]
        loaded = port.load(1, device="cpu")
        assert torch.equal(loaded.centroids, model.centroids)
        reqs = _requests(Xq, [9, 40], seed=2)
        _against_jax(_port_sync(loaded, reqs), _jax_sync(jm, reqs))
        for g, w in zip(_port_sync(loaded, reqs), _port_sync(model, reqs)):
            _same_bits(g, w)
        port.unpin(1, "jax-worker")
        assert ref.gc(keep=1) == [1] and ref.versions() == [3]
    else:
        assert [port.publish(m) for m in (model, model_b, model)] == [1, 2, 3]
        port.pin(1, "port-worker")
        assert ref.gc(keep=1) == [2]
        assert ref.versions() == [1, 3] and ref.pins(1) == ["port-worker"]
        loaded = ref.load(1)
        np.testing.assert_array_equal(np.asarray(loaded.centroids),
                                      np.asarray(jm.centroids))
        reqs = _requests(Xq, [9, 40], seed=2)
        _against_jax(_port_sync(model, reqs), _jax_sync(loaded, reqs))
        ref.unpin(1, "port-worker")
        assert port.gc(keep=1) == [1] and port.versions() == [3]


# ---------------------------------------------------------------------------
# ModelRegistry: kwargs conflicts, warm swap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["batcher", "scheduler"])
def test_registry_kwargs_conflict_raises(models, kind):
    _, _, model, _, _ = models
    reg = ModelRegistry()
    reg.register("m", model)
    clock = FakeClock()
    kw = {"max_bucket": 64} if kind == "batcher" else {
        "max_wait_ms": 2.0, "clock": clock}
    get = getattr(reg, kind)
    first = get("m", **kw)
    assert get("m") is first                          # bare hit: fine
    assert get("m", **kw) is first                    # same kwargs: fine
    with pytest.raises(ValueError, match="conflicting override"):
        get("m", max_bucket=128) if kind == "batcher" else get(
            "m", max_wait_ms=999.0)
    with pytest.raises(ValueError, match="conflicting override"):
        get("m", min_bucket=16)                       # not recorded
    with pytest.raises(ValueError, match="already registered"):
        reg.register("m", model)
    with pytest.raises(KeyError):
        reg.latency_summary("other")
    reg.unregister("m")


def test_swap_under_load_resolves_every_future(models):
    """Async traffic on a fake clock while swap() flips versions: every
    future resolves, labels match the version that served them (and the
    JAX registry's on the same requests), and the warmed buckets cover
    every bucket the old row served."""
    jm, jm_b, model, model_b, Xq = models
    reg, jreg = ModelRegistry(), JaxRegistry()
    reg.register("m", model, version=1)
    jreg.register("m", jm, version=1)
    clock, jclock = FakeClock(), FakeClock()
    sched = reg.scheduler("m", max_wait_ms=5.0, clock=clock, max_bucket=128)
    jsched = jreg.scheduler("m", max_wait_ms=5.0, clock=jclock,
                            max_bucket=128)
    reqs = _requests(Xq, [3, 17, 40, 9, 26], seed=7)

    def traffic(s, c):
        done = [s.submit(r) for r in reqs[:2]]
        c.advance_ms(6.0)
        assert s.poll() == 2
        done += [s.submit(r) for r in reqs[2:]]
        c.advance_ms(6.0)
        assert s.poll() == 3
        return done + [s.submit(r) for r in reqs[:2]]   # pending at flip

    futs, jfuts = traffic(sched, clock), traffic(jsched, jclock)
    assert sched.batcher.executables == [32, 128]
    report = reg.swap("m", model_b, version=2)
    jreport = jreg.swap("m", jm_b, version=2)
    assert report.drained_requests == jreport.drained_requests == 2
    assert report.buckets_warmed == jreport.buckets_warmed == [32, 128]
    assert all(f.done() for f in futs)
    _against_jax([f.result(timeout=0) for f in futs],
                 [f.result(timeout=0) for f in jfuts])
    old = _port_sync(model, reqs, max_bucket=128)
    for f, w in zip(futs, old + old[:2]):
        assert np.array_equal(f.result(timeout=0)[0], w[0])
    with pytest.raises(RuntimeError, match="stopped"):
        sched.submit(reqs[0])             # the retired handle rejects

    sched2 = reg.scheduler("m")
    assert sched2 is not sched and sched2.latency is sched.latency
    assert sched2.latency.requests == 7
    assert sched2.batcher.executables == report.buckets_warmed
    new = [sched2.submit(r) for r in reqs]
    clock.advance_ms(6.0)
    assert sched2.poll() == 5
    for f, w in zip(new, old):
        # The reversed centroid rows: label k - 1 - old.
        assert np.array_equal(f.result(timeout=0)[0], K - 1 - w[0])
    assert sched2.batcher.executables == report.buckets_warmed
    assert reg.version("m") == 2 and report.old_version == 1
    assert report.flip_ms >= 0.0 and report.p95_before_ms >= 0.0
    reg.unregister("m")
    jreg.unregister("m")


def test_swap_warms_sync_batcher_and_keeps_kwargs(models):
    _, _, model, model_b, Xq = models
    reg = ModelRegistry()
    reg.register("m", model)
    b1 = reg.batcher("m", max_bucket=64, min_bucket=8)
    for w in (3, 30, 64):
        b1.assign_batch(_requests(Xq, [w])[0])
    assert b1.executables == [8, 32, 64]
    report = reg.swap("m", model_b)
    b2 = reg.batcher("m")
    assert b2 is not b1 and b2.model is model_b
    assert b2.max_bucket == 64 and b2.min_bucket == 8
    assert b2.executables == [8, 32, 64] == report.buckets_warmed
    labels, _ = b2.assign_batch(_requests(Xq, [30])[0])
    assert labels.shape == (30,) and b2.executables == [8, 32, 64]
    with pytest.raises(ValueError, match="conflicting override"):
        reg.batcher("m", max_bucket=128)
    with pytest.raises(KeyError):
        ModelRegistry().swap("ghost", model)


def test_swap_restarts_running_pump(models):
    _, _, model, model_b, Xq = models
    reg = ModelRegistry()
    reg.register("m", model)
    sched = reg.scheduler("m", max_wait_ms=1.0, max_bucket=128)
    sched.start()
    sched.submit(_requests(Xq, [4])[0]).result(timeout=30.0)
    reg.swap("m", model_b)
    assert not sched.running and sched.stopped
    sched2 = reg.scheduler("m")
    assert sched2.running                      # pump carried over
    labels, _ = sched2.submit(_requests(Xq, [6])[0]).result(timeout=30.0)
    assert labels.shape == (6,)
    reg.unregister("m")
    assert not sched2.running


def test_swap_refuses_a_row_changed_concurrently(models, monkeypatch):
    """A register that lands during the swap's (unlocked) warm phase
    makes the flip raise instead of silently discarding it."""
    _, _, model, model_b, Xq = models
    reg = ModelRegistry()
    reg.register("m", model)
    reg.batcher("m").assign_batch(_requests(Xq, [5])[0])

    class RacingBatcher(MicroBatcher):
        def warm(self, buckets):
            out = super().warm(buckets)
            reg.register("m", model, overwrite=True)     # the race
            return out

    monkeypatch.setattr(port_registry, "MicroBatcher", RacingBatcher)
    with pytest.raises(RuntimeError, match="changed concurrently"):
        reg.swap("m", model_b)
    assert reg.get("m") is model


def test_registry_publish_and_load_version(models, tmp_path):
    _, _, model, model_b, _ = models
    root = str(tmp_path / "store")
    reg = ModelRegistry()
    reg.register("m", model)
    assert reg.version("m") is None
    assert reg.publish("m", root) == 1 and reg.version("m") == 1
    reg.register("m", model_b, overwrite=True)
    assert reg.publish("m", root, keep=2) == 2
    assert latest_version(root) == 2
    assert torch.equal(load_version(root, 1, device="cpu").centroids,
                       model.centroids)
    reg2 = ModelRegistry()
    reg2.load_version("m", root, device="cpu")
    assert reg2.version("m") == 2
    reg2.load_version("pinned", root, version=1, device="cpu")
    assert torch.equal(reg2.get("pinned").centroids, model.centroids)
    assert reg2.names() == ["m", "pinned"]
    assert publish_version(root, model) == 3


# ---------------------------------------------------------------------------
# the lock contract, checked by the JAX package's analysis pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["scheduler", "registry"])
def test_port_declares_and_passes_lock_contract(name):
    rel = f"src/repro_torch/serve/{name}.py"
    src = open(os.path.join(REPO, rel)).read()
    assert "# guarded-by: _lock" in src
    if name == "scheduler":
        assert "# lock-order: _flush_lock -> _lock" in src
    assert locks.check_file(os.path.join(REPO, rel), rel) == []


def test_port_scheduler_inverted_lock_order_is_flagged():
    src = open(os.path.join(
        REPO, "src/repro_torch/serve/scheduler.py")).read()
    inverted = """
    def _inverted(self):
        with self._lock:
            with self._flush_lock:
                return len(self._queue)
"""
    findings = locks.check_source(src + inverted, "scheduler_inverted.py")
    assert [f.rule for f in findings] == ["L002"]


# ---------------------------------------------------------------------------
# the benches: the JAX package's schema, the port's own file
# ---------------------------------------------------------------------------

def test_benches_keep_the_jax_schema_and_write_the_port_file(
        models, tmp_path, monkeypatch):
    """benchmark_assign / async / swap / stream run on the CPU model and
    return JAX's keys (less the mesh's `sharded`); median_benches and
    format_bench read them; write_bench defaults to
    BENCH_serve_torch.json, never the JAX package's BENCH_serve.json."""
    from repro.serve import bench as jax_bench
    from repro_torch.serve import bench

    jm, _, model, _, _ = models
    got = bench.benchmark_assign(model, batch_sizes=(8, 64), repeats=2)
    want = jax_bench.benchmark_assign(jm, batch_sizes=(8, 64), repeats=2)
    assert set(got) == set(want) - {"sharded"} | {"device"}
    assert got["backend"] == "cpu" and got["device"] == "cpu"
    assert [r["bucket"] for r in got["results"]] == [8, 64]
    kw = dict(n_requests=24, width_range=(1, 16))
    for name in ("benchmark_async", "benchmark_swap"):
        g = getattr(bench, name)(model, **kw)
        w = getattr(jax_bench, name)(jm, **kw)
        assert set(g) == set(w) - {"sharded"}, name
    assert set(g["buckets_warmed"]) == set(w["buckets_warmed"])
    got["async"] = bench.benchmark_async(model, **kw)
    assert set(got["async"]["latency"]) == set(
        jax_bench.benchmark_async(jm, **kw)["latency"])
    got["swap"] = bench.benchmark_swap(model, **kw)
    assert got["async"]["latency"]["requests"] == 24
    assert got["swap"]["stranded_futures"] == 0
    assert got["swap"]["drained_requests"] == 4
    got["stream"] = bench.benchmark_stream(model, n_chunks=3, chunk_cols=64,
                                           repeats=1)
    ro = got["stream"]["rollout"]
    assert ro["retrains"] == 1 and ro["stranded_futures"] == 0
    assert ro["drained_requests"] == 1
    lines = bench.format_bench(got).splitlines()
    assert lines[0].startswith("batch      8") and len(lines) == 6
    med = bench.median_benches([got, got])
    assert med["results"] == got["results"]
    monkeypatch.chdir(tmp_path)
    path = bench.write_bench(None, got)
    assert path == bench.BENCH_PATH == "BENCH_serve_torch.json"
    assert (tmp_path / path).is_file()
    assert not (tmp_path / "BENCH_serve.json").exists()
