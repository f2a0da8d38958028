"""Minimal Prometheus-style metrics: counters, gauges, summaries,
histograms.

Reference: the per-binary prometheus registries (pkg/apiserver/metrics,
plugin/pkg/scheduler/metrics/metrics.go:30-80, pkg/kubelet/metrics) exposed
on /metrics. We keep the same metric names so dashboards line up.

Summaries hold a sliding sample window and answer quantiles for ONE
process's ONE label set; they cannot be merged (a p99 of p99s is not a
p99). Histograms hold counts in pinned buckets, so two histograms with
the same boundaries merge by adding counts — across label sets, across
processes, across scrape rounds. That is why the fleet scraper
(obs/metricsplane.py) aggregates histograms, and why the bucket
boundaries are pinned HERE per metric name (HISTOGRAM_BUCKETS): two
registries that disagreed on boundaries would be unmergeable.
"""

from __future__ import annotations

import bisect
import threading
from collections import defaultdict, deque
from typing import Dict, List, Optional, Tuple


def _key(labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((labels or {}).items()))


def escape_label_value(val: str) -> str:
    """Prometheus text-format label-value escaping: backslash first
    (the escape character itself), then quote and newline — the three
    characters the exposition format reserves."""
    return (str(val).replace("\\", "\\\\")
                    .replace('"', '\\"')
                    .replace("\n", "\\n"))


def _fmt_labels(k: Tuple[Tuple[str, str], ...]) -> str:
    if not k:
        return ""
    inner = ",".join(f'{name}="{escape_label_value(val)}"'
                     for name, val in k)
    return "{" + inner + "}"


def _fmt_le(bound: float) -> str:
    """Bucket upper-bound label value: '+Inf' for the overflow bucket,
    otherwise Python's shortest round-trip float repr (byte-stable
    across runs, exact through the scrape parser)."""
    if bound == float("inf"):
        return "+Inf"
    return repr(float(bound))


class _Summary:
    """Sliding-window summary: count, sum, and quantiles over the last N
    observations (enough for the 50th/90th/99th the SLO checks read)."""

    def __init__(self, max_samples: int = 10_000):
        self.count = 0
        self.total = 0.0
        self._samples: List[float] = []   # kept sorted for quantiles
        self._order: deque = deque()      # insertion order for eviction
        self._max = max_samples

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if len(self._order) >= self._max:
            oldest = self._order.popleft()
            idx = bisect.bisect_left(self._samples, oldest)
            del self._samples[idx]
        self._order.append(v)
        bisect.insort(self._samples, v)

    def quantile(self, q: float) -> float:
        if not self._samples:
            return 0.0
        idx = min(len(self._samples) - 1, int(q * len(self._samples)))
        return self._samples[idx]


class Histogram:
    """Cumulative-bucket histogram over pinned boundaries.

    Buckets are per-observation counts keyed by upper bound; the +Inf
    overflow bucket is implicit (counts[-1]). Unlike _Summary this is
    a pure monoid: merge() of two histograms with identical bounds is
    exact, associative, and commutative — the property the fleet
    scraper leans on to fold per-process /metrics into one view.
    """

    __slots__ = ("bounds", "counts", "total", "count")

    def __init__(self, bounds: Tuple[float, ...]):
        if tuple(bounds) != tuple(sorted(bounds)) or not bounds:
            raise ValueError(f"bucket bounds must be sorted, non-empty: "
                             f"{bounds!r}")
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in bounds)
        self.counts: List[int] = [0] * (len(self.bounds) + 1)  # +Inf last
        self.total = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        # le is inclusive: v lands in the first bucket whose bound >= v
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.total += v
        self.count += 1

    def merge(self, other: "Histogram") -> "Histogram":
        """-> new Histogram = self + other (bounds must match)."""
        if self.bounds != other.bounds:
            raise ValueError(
                f"unmergeable histograms: bounds {self.bounds} != "
                f"{other.bounds}")
        out = Histogram(self.bounds)
        out.counts = [a + b for a, b in zip(self.counts, other.counts)]
        out.total = self.total + other.total
        out.count = self.count + other.count
        return out

    def cumulative(self) -> List[int]:
        """Per-bucket counts folded into the cumulative counts the
        _bucket{le=} exposition lines carry (last == count)."""
        out, run = [], 0
        for c in self.counts:
            run += c
            out.append(run)
        return out

    def quantile_le(self, le: float) -> int:
        """Observations <= le, for any le that is a pinned bound —
        what a latency SLO reads as its 'good events' counter."""
        idx = bisect.bisect_left(self.bounds, le)
        if idx >= len(self.bounds) or self.bounds[idx] != le:
            raise ValueError(f"le={le} is not a pinned bound of "
                             f"{self.bounds}")
        return sum(self.counts[:idx + 1])

    def to_dict(self) -> dict:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "sum": self.total, "count": self.count}

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        h = cls(tuple(d["bounds"]))
        h.counts = [int(c) for c in d["counts"]]
        h.total = float(d["sum"])
        h.count = int(d["count"])
        return h


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Dict[tuple, float]] = defaultdict(dict)
        self._gauges: Dict[str, Dict[tuple, float]] = defaultdict(dict)
        self._summaries: Dict[str, Dict[tuple, _Summary]] = defaultdict(dict)
        self._histograms: Dict[str, Dict[tuple, Histogram]] = \
            defaultdict(dict)

    def inc(self, name: str, labels: Optional[Dict[str, str]] = None,
            by: float = 1.0) -> None:
        k = _key(labels)
        with self._lock:
            self._counters[name][k] = self._counters[name].get(k, 0.0) + by

    def set_gauge(self, name: str, value: float,
                  labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._gauges[name][_key(labels)] = value

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, str]] = None) -> None:
        k = _key(labels)
        with self._lock:
            s = self._summaries[name].get(k)
            if s is None:
                s = self._summaries[name][k] = _Summary()
            s.observe(value)
            # dual-landing: any metric with pinned boundaries also
            # feeds a histogram, so the hot-path call sites (tracer
            # stage ends, apiserver service time, watch publish lag)
            # grow a mergeable cross-process view without touching
            # any call site
            bounds = HISTOGRAM_BUCKETS.get(name)
            if bounds is not None:
                h = self._histograms[name].get(k)
                if h is None:
                    h = self._histograms[name][k] = Histogram(bounds)
                h.observe(value)

    def observe_histogram(self, name: str, value: float,
                          labels: Optional[Dict[str, str]] = None) -> None:
        """Histogram-only observation (no summary window). The bucket
        boundaries MUST be pinned in HISTOGRAM_BUCKETS — an unpinned
        name would mint boundaries nobody else can merge with."""
        bounds = HISTOGRAM_BUCKETS.get(name)
        if bounds is None:
            raise ValueError(
                f"histogram {name!r} has no pinned boundaries in "
                f"utils.metrics.HISTOGRAM_BUCKETS")
        k = _key(labels)
        with self._lock:
            h = self._histograms[name].get(k)
            if h is None:
                h = self._histograms[name][k] = Histogram(bounds)
            h.observe(value)

    def summary_samples(self, name: str) -> Dict[tuple, List[float]]:
        """-> {labels_key: sorted sample window} — lets a reader merge
        windows across label sets for an all-traffic percentile (label
        summaries cannot be merged from quantiles alone)."""
        with self._lock:
            return {k: list(s._samples)
                    for k, s in self._summaries.get(name, {}).items()}

    def summary_stats(self, name: str
                      ) -> Dict[Tuple[Tuple[str, str], ...],
                                Dict[str, float]]:
        """-> {labels_key_tuple: {count, sum, p50, p90, p99}} for
        one summary metric — the server-side read the SLO suite gates
        on (the reference gates on apiserver metrics, not client
        probes: test/e2e/metrics_util.go:194-200)."""
        out = {}
        with self._lock:
            for k, s in self._summaries.get(name, {}).items():
                out[k] = {"count": s.count, "sum": s.total,
                          "p50": s.quantile(0.50),
                          "p90": s.quantile(0.90),
                          "p99": s.quantile(0.99)}
        return out

    # ---------------------------------------------------------------- read

    def counter(self, name: str, labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._counters.get(name, {}).get(_key(labels), 0.0)

    def gauge(self, name: str,
              labels: Optional[Dict[str, str]] = None) -> Optional[float]:
        """Last value set_gauge recorded for one label set (None if the
        gauge was never set) — what a bench reads back for a depth
        gauge like watch_fanout_queue_depth."""
        with self._lock:
            return self._gauges.get(name, {}).get(_key(labels))

    def counter_sum(self, name: str) -> float:
        """Total across every label set of one counter — what a gate
        asserts when it cares that the thing happened, not which label
        it happened under (the crash soak's durability counters)."""
        with self._lock:
            return sum(self._counters.get(name, {}).values())

    def summary(self, name: str,
                labels: Optional[Dict[str, str]] = None) -> Optional[_Summary]:
        with self._lock:
            return self._summaries.get(name, {}).get(_key(labels))

    def histogram(self, name: str,
                  labels: Optional[Dict[str, str]] = None
                  ) -> Optional[Histogram]:
        """Snapshot copy of one histogram (safe to merge/read outside
        the registry lock)."""
        with self._lock:
            h = self._histograms.get(name, {}).get(_key(labels))
            return Histogram.from_dict(h.to_dict()) if h else None

    def histogram_merged(self, name: str) -> Optional[Histogram]:
        """One histogram folded across every label set — the exact
        merge summaries cannot do (an all-traffic latency view)."""
        with self._lock:
            hists = list(self._histograms.get(name, {}).values())
            if not hists:
                return None
            out = Histogram(hists[0].bounds)
            for h in hists:
                out = out.merge(h)
        return out

    def histogram_stats(self, name: str
                        ) -> Dict[Tuple[Tuple[str, str], ...], dict]:
        """-> {labels_key: Histogram.to_dict()} for one histogram."""
        with self._lock:
            return {k: h.to_dict()
                    for k, h in self._histograms.get(name, {}).items()}

    def render(self) -> str:
        """Prometheus text exposition format."""
        out: List[str] = []
        with self._lock:
            for name in sorted(self._counters):
                out.append(f"# TYPE {name} counter")
                for k, v in sorted(self._counters[name].items()):
                    out.append(f"{name}{_fmt_labels(k)} {v}")
            for name in sorted(self._gauges):
                out.append(f"# TYPE {name} gauge")
                for k, v in sorted(self._gauges[name].items()):
                    out.append(f"{name}{_fmt_labels(k)} {v}")
            for name in sorted(self._summaries):
                out.append(f"# TYPE {name} summary")
                for k, s in sorted(self._summaries[name].items()):
                    for q in (0.5, 0.9, 0.99):
                        lbl = dict(k); lbl["quantile"] = str(q)
                        out.append(f"{name}{_fmt_labels(_key(lbl))} {s.quantile(q)}")
                    out.append(f"{name}_sum{_fmt_labels(k)} {s.total}")
                    out.append(f"{name}_count{_fmt_labels(k)} {s.count}")
            for name in sorted(self._histograms):
                out.append(f"# TYPE {name} histogram")
                for k, h in sorted(self._histograms[name].items()):
                    cum = h.cumulative()
                    for bound, c in zip(h.bounds + (float("inf"),), cum):
                        lbl = dict(k); lbl["le"] = _fmt_le(bound)
                        out.append(
                            f"{name}_bucket{_fmt_labels(_key(lbl))} {c}")
                    out.append(f"{name}_sum{_fmt_labels(k)} {h.total}")
                    out.append(f"{name}_count{_fmt_labels(k)} {h.count}")
        return "\n".join(out) + "\n"


#: shared default registry (each binary may still make its own)
global_metrics = MetricsRegistry()

#: Durability / HA counters: wal_* incremented by core/wal.py and the
#: store recovery paths, leader/lease ones by utils/leaderelection.py.
#: The crash-soak gates (tests/test_chaos.py) assert these move; the
#: names are pinned here so dashboards and gates cannot drift.
DURABILITY_COUNTERS = (
    "wal_records_total",        # ledger records appended to the WAL
    "wal_snapshots_total",      # snapshot compactions written
    "wal_recoveries_total",     # Store/NativeStore.recover completions
    "leader_transitions_total", # elector acquisitions (label: name)
    "lease_renew_failures_total",  # failed renew attempts (label: name)
)

#: Shard-failure counters (sched/device/shardfail.py): the shard-kill
#: soak (kubemark/shard_soak.py) gates on these moving, so the names
#: are pinned with the same no-drift contract as DURABILITY_COUNTERS.
SHARD_COUNTERS = (
    "shard_lease_transitions_total",  # dead-shard fencing takeovers
                                      # (label: lease) — the CAS that
                                      # advances lease_transitions
    "shard_reshards_total",           # survivor re-shards applied
    "shard_replay_rows_total",        # journaled rows replayed onto
                                      # survivors across all reshards
)

#: Pod-lifecycle stage model (the obs tracing layer): every span that
#: carries a stage tag lands one observation in this summary, so
#: render() exposes the spans-derived decomposition under ONE stable
#: metric name — {stage=...} label values are pinned below (no-drift,
#: like DURABILITY_COUNTERS; bench.py's obs section and the stage
#: glossary in README both read these names).
OBS_STAGE_SUMMARY = "pod_e2e_stage_seconds"

#: where a pod's wall-clock goes, create -> kubelet confirm:
OBS_STAGES = (
    "create",    # apiserver/registry create commit (server-side)
    "queue",     # pending FIFO wait: informer delivery -> tile drain
    "schedule",  # tile snapshot/encode up to device dispatch
    "device",    # device execute: dispatch -> assignments materialized
    "bind",      # bind txn: CAS commit of a tile's bindings
    "publish",   # store publish fan-out to watchers
    "confirm",   # kubelet confirm: fleet status batch -> committed
)

#: Workload-replay counters: incremented by the controllers the
#: trace-replay soak shakes out; pinned here for the same no-drift
#: reason as DURABILITY_COUNTERS (the workload gates assert these).
WORKLOAD_COUNTERS = (
    "job_backoff_requeues_total",  # Job syncs held back by failure
                                   # backoff (label: job)
)

#: Per-(verb, resource) apiserver service time in MICROSECONDS —
#: observed in ApiServer.handle's finally block; the density SLO suite
#: and the burn-rate evaluator both read this name (was a stray
#: literal in kubemark/slo.py before the no-drift contract landed).
APISERVER_LATENCY_SUMMARY = "apiserver_request_latencies_microseconds"

#: Watch publish -> deliver lag in SECONDS: stamped when a commit's
#: events enter the store publish ring, observed when a consumer's
#: drain hands them to watcher fan-out (core/store.py). The default
#: committer-drained shard observes unlabeled; worker fan-out shards
#: observe with {shard=...} (burn-rate evaluation sums label sets).
WATCH_LAG_HISTOGRAM = "watch_publish_deliver_lag_seconds"

#: Publish-ring backlog per fan-out shard (pub_seq head minus the
#: shard's delivery cursor), set by FanoutShard.drain with
#: {shard=...}. A shard stuck behind a slow fan-out shows here before
#: its watchers overrun and take the 410 path.
FANOUT_QUEUE_DEPTH_GAUGE = "watch_fanout_queue_depth"

#: Requests served per apiserver worker (label: worker). The serving
#: bench and fanout soak read this to show spread across the pool.
APISERVER_WORKER_REQUESTS = "apiserver_worker_requests"

#: Flash-crowd progress counters the workload soak's burn-rate SLO
#: reads: created is incremented synchronously at crowd injection,
#: bound when the tracker sees the crowd pod bind. error ratio =
#: 1 - d(bound)/d(created) over a sample window.
CROWD_COUNTERS = (
    "crowd_pods_created_total",
    "crowd_pods_bound_total",
)

#: Scraper-side bookkeeping (obs/metricsplane.py): counter resets seen
#: while folding per-target samples (a crashed+restarted process's
#: counters restart at 0; the scraper rebases so rates never go
#: negative) and scrape errors (target unreachable that round).
SCRAPE_COUNTERS = (
    "scrape_counter_resets_total",
    "scrape_errors_total",
)

#: Priority-preemption counters (sched/batch.py _try_preempt + the
#: flash-drain soak's post-hoc oracle audit): attempts counts victim
#: searches run, victims counts uid-preconditioned evictions issued,
#: wrongful counts audit violations — the soak gates on wrongful == 0.
PREEMPTION_COUNTERS = (
    "preemption_attempts_total",
    "preemption_victims_total",
    "preemption_wrongful_total",
)

#: Surge progress counters the flash-drain soak's burn-rate SLO reads
#: (same shape as CROWD_COUNTERS): created is incremented synchronously
#: at surge injection, bound_fast when the tracker sees the surge pod
#: bind within the fast-bind limit.
SURGE_COUNTERS = (
    "surge_pods_created_total",
    "surge_pods_bound_fast_total",
)

#: Surge bind latency (injection -> observed binding), seconds.
SURGE_BIND_HISTOGRAM = "preemption_surge_bind_seconds"

#: Pinned per-metric histogram bucket boundaries. observe() dual-lands
#: any of these names into a Histogram next to its summary; boundaries
#: live HERE (not at call sites) because merging across processes
#: requires every registry to agree on them. Units follow the metric
#: name suffix.
HISTOGRAM_BUCKETS: Dict[str, Tuple[float, ...]] = {
    # stage seconds: sub-ms ledger commits up to multi-second confirms
    OBS_STAGE_SUMMARY: (
        0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
        0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
    # apiserver service time, microseconds (ref gate: p99 < 1s = 1e6us)
    APISERVER_LATENCY_SUMMARY: (
        100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
        25000.0, 50000.0, 100000.0, 250000.0, 500000.0,
        1000000.0, 2500000.0),
    # watch publish lag, seconds: fan-out normally drains sub-ms; the
    # 5/10s tail buckets exist for the 10k-watcher fan-out storm
    # (a GIL-bound worker pump behind 10k sends can stall whole
    # seconds — the SLO needs to see that tail, not clip it)
    WATCH_LAG_HISTOGRAM: (
        0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
        0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
    # surge bind latency, seconds: the 5s bucket edge is the soak's
    # fast-bind limit (a preempted-then-bound surge pod pays victim
    # grace + one requeue round trip, normally well under it)
    SURGE_BIND_HISTOGRAM: (
        0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0),
}
