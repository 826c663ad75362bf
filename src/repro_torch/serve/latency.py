"""Streaming latency accounting for the async serving path.

A serving process answers millions of requests; keeping every latency
sample to compute percentiles is out of the question. `LatencyStats` keeps
a *streaming histogram* instead: fixed log-spaced bucket edges spanning
1 microsecond .. ~100 s, O(1) per sample, O(buckets) memory, and
percentiles recovered by walking the cumulative counts with geometric
interpolation inside the winning bucket (error bounded by the bucket
ratio, ~9% with 16 buckets/decade — far below the run-to-run noise of any
real latency distribution).

Three timestamps bound every request's life (recorded by
`serve.scheduler.AsyncBatcher`):

    enqueue   submit() accepted the request
    flush     the deadline/full-bucket trigger moved it into a batch
    complete  results were scattered back and its future resolved

from which two spans are tracked per request: queue wait
(enqueue->flush) and total latency (enqueue->complete). An optional SLO
threshold (`slo_ms`) turns the total-latency stream into a violation
counter.

The bucket edges, percentiles and summary schema are the JAX package's
(repro.serve.latency), so a summary taken here compares key for key and
number for number with one taken there on the same samples.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

# Bucket edges: 16 buckets per decade from 1e-3 ms (1 us) to 1e5 ms (100 s),
# i.e. ratio 10^(1/16) ~ 1.15 between edges. Samples outside the range clamp
# to the first/last bucket.
_LO_MS = 1e-3
_HI_MS = 1e5
_PER_DECADE = 16
# round(), not int(): the decade count is an exact integer mathematically
# (the range is a power-of-10 ratio), but float log10 may land at
# 7.999999... on some libms and int() would silently drop a whole decade
# of buckets.
_N_BUCKETS = round(math.log10(_HI_MS / _LO_MS)) * _PER_DECADE


def _bucket_index(ms: float) -> int:
    if ms <= _LO_MS:
        return 0
    # int() truncation mis-buckets samples sitting exactly on a bucket
    # edge (log10 of an edge value can land just below the integer).
    # round() is within one bucket of the true floor; the compare against
    # the recomputed edges — the same float expressions that define the
    # buckets — settles it exactly, edges included.
    idx = int(round(math.log10(ms / _LO_MS) * _PER_DECADE))
    idx = min(max(idx, 0), _N_BUCKETS - 1)
    lo, hi = _bucket_edges(idx)
    if ms < lo:
        idx -= 1
    elif ms >= hi:
        idx += 1
    return min(max(idx, 0), _N_BUCKETS - 1)


def _bucket_edges(idx: int) -> tuple:
    lo = _LO_MS * 10.0 ** (idx / _PER_DECADE)
    hi = _LO_MS * 10.0 ** ((idx + 1) / _PER_DECADE)
    return lo, hi


class Histogram:
    """Fixed-edge log-spaced streaming histogram over milliseconds."""

    def __init__(self):
        self.counts: List[int] = [0] * _N_BUCKETS
        self.n = 0
        self.total = 0.0
        self.min = math.inf
        self.max = 0.0

    def record(self, ms: float) -> None:
        ms = max(float(ms), 0.0)
        self.counts[_bucket_index(ms)] += 1
        self.n += 1
        self.total += ms
        self.min = min(self.min, ms)
        self.max = max(self.max, ms)

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold `other`'s samples into this histogram, in place.

        Exact, not approximate: both histograms share the same fixed
        bucket edges, so summing counts yields bit-for-bit the histogram
        a single stream of the union of samples would have built — the
        property a per-worker -> tier-level aggregation relies on."""
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.n += other.n
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def percentile(self, q: float) -> float:
        """q in [0, 100]. Geometric interpolation inside the bucket; the
        observed min/max clamp the first/last occupied bucket so tiny
        sample counts do not report a bucket edge nobody hit."""
        if self.n == 0:
            return 0.0
        rank = q / 100.0 * self.n
        seen = 0
        for idx, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo, hi = _bucket_edges(idx)
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if hi <= lo:
                    return lo
                frac = (rank - seen) / c
                return lo * (hi / lo) ** frac
            seen += c
        return self.max

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0


class LatencyStats:
    """Per-request latency accounting: queue-wait + total histograms, an
    SLO-violation counter, and a per-bucket total-latency breakdown.

    slo_ms=None disables SLO accounting (violations stay 0).

    The per-bucket breakdown keys a separate total-latency Histogram by
    the pow-2 bucket the request's flush batch ran through
    (serve/batcher.py bucketing policy) — the knob-tuning read-out the
    aggregate percentiles hide: a fat p99 can be one under-coalesced
    bucket, not the whole pipeline. Callers that do not batch (or do not
    know the bucket) simply omit `bucket` and only the aggregate
    histograms move."""

    def __init__(self, slo_ms: Optional[float] = None):
        self.slo_ms = slo_ms
        self.queue_wait = Histogram()
        self.total = Histogram()
        self.by_bucket: Dict[int, Histogram] = {}
        self.requests = 0
        self.queries = 0
        self.slo_violations = 0

    def record(self, enqueue_ts: float, flush_ts: float, complete_ts: float,
               queries: int = 1, bucket: Optional[int] = None) -> None:
        """Record one request's life from its three timestamps (seconds).

        `bucket` (optional) is the pow-2 execution bucket of the flush
        that completed the request; it lands the total latency in the
        per-bucket breakdown."""
        wait_ms = (flush_ts - enqueue_ts) * 1e3
        total_ms = (complete_ts - enqueue_ts) * 1e3
        self.queue_wait.record(wait_ms)
        self.total.record(total_ms)
        if bucket is not None:
            self.by_bucket.setdefault(int(bucket), Histogram()) \
                .record(total_ms)
        self.requests += 1
        self.queries += int(queries)
        if self.slo_ms is not None and total_ms > self.slo_ms:
            self.slo_violations += 1

    def merge(self, other: "LatencyStats") -> "LatencyStats":
        """Fold another LatencyStats into this one, in place.

        The aggregation path of a serving tier: each worker keeps its own
        per-process LatencyStats; the tier-level p50/p95/p99 summary is
        the merge of all of them. Because every histogram shares the same
        fixed bucket edges, merging is exact — the merged summary equals
        the summary a single stream observing all samples (in any
        interleaving) would report. Both sides must account the same SLO
        (otherwise the summed violation counters would silently mix
        thresholds); merging into a stats whose slo_ms is None adopts the
        other's threshold only when no samples were recorded against None
        yet."""
        if other.slo_ms != self.slo_ms:
            if self.slo_ms is None and self.requests == 0:
                self.slo_ms = other.slo_ms
            else:
                raise ValueError(
                    f"cannot merge LatencyStats with different SLOs "
                    f"({self.slo_ms!r} vs {other.slo_ms!r}): the summed "
                    f"violation counters would mix thresholds")
        self.queue_wait.merge(other.queue_wait)
        self.total.merge(other.total)
        # A snapshot: a fleet merges while live pumps record, and a first
        # flush into a new bucket would change the dict mid-iteration.
        for b, h in list(other.by_bucket.items()):
            self.by_bucket.setdefault(int(b), Histogram()).merge(h)
        self.requests += other.requests
        self.queries += other.queries
        self.slo_violations += other.slo_violations
        return self

    @classmethod
    def merged(cls, stats: "List[LatencyStats]",
               slo_ms: Optional[float] = None) -> "LatencyStats":
        """Fresh tier-level aggregate of per-worker stats (non-mutating)."""
        out = cls(slo_ms=slo_ms if slo_ms is not None
                  else (stats[0].slo_ms if stats else None))
        for s in stats:
            out.merge(s)
        return out

    @property
    def slo_violation_rate(self) -> float:
        return self.slo_violations / self.requests if self.requests else 0.0

    def summary(self) -> Dict:
        """JSON-ready summary — the schema the async bench embeds
        (serve/bench.py)."""
        t, w = self.total, self.queue_wait
        return {
            "requests": self.requests,
            "queries": self.queries,
            "latency_ms": {
                "p50": t.percentile(50.0),
                "p95": t.percentile(95.0),
                "p99": t.percentile(99.0),
                "mean": t.mean,
                "max": t.max if t.n else 0.0,
            },
            "queue_wait_ms": {
                "p50": w.percentile(50.0),
                "p95": w.percentile(95.0),
                "p99": w.percentile(99.0),
            },
            # Per-execution-bucket total latency (string keys: this dict
            # is JSON-serialized verbatim into the bench file).
            "per_bucket": {
                str(b): {
                    "requests": h.n,
                    "p50": h.percentile(50.0),
                    "p95": h.percentile(95.0),
                    "p99": h.percentile(99.0),
                    "mean": h.mean,
                }
                for b, h in sorted(self.by_bucket.items())
            },
            "slo_ms": self.slo_ms,
            "slo_violations": self.slo_violations,
            "slo_violation_rate": self.slo_violation_rate,
        }

    def format_table(self) -> str:
        """Human-readable latency table."""
        s = self.summary()
        lines = [
            f"{'requests':>14s}: {s['requests']}",
            f"{'queries':>14s}: {s['queries']}",
            f"{'p50':>14s}: {s['latency_ms']['p50']:10.3f} ms",
            f"{'p95':>14s}: {s['latency_ms']['p95']:10.3f} ms",
            f"{'p99':>14s}: {s['latency_ms']['p99']:10.3f} ms",
            f"{'mean':>14s}: {s['latency_ms']['mean']:10.3f} ms",
            f"{'max':>14s}: {s['latency_ms']['max']:10.3f} ms",
            f"{'queue-wait p95':>14s}: {s['queue_wait_ms']['p95']:10.3f} ms",
        ]
        if self.slo_ms is not None:
            lines.append(f"{'SLO':>14s}: {self.slo_ms:g} ms, "
                         f"{self.slo_violations} violations "
                         f"({100.0 * self.slo_violation_rate:.2f}%)")
        for b, h in sorted(self.by_bucket.items()):
            lines.append(f"{f'bucket {b}':>14s}: "
                         f"p50 {h.percentile(50.0):8.3f} ms  "
                         f"p95 {h.percentile(95.0):8.3f} ms  "
                         f"({h.n} requests)")
        return "\n".join(lines)
