"""Fleet metrics plane: deterministic scrape -> merge -> time-series
-> SLO burn rates.

The reference posture is an external Prometheus scraping every
component's /metrics on a wall-clock cadence and an Alertmanager
evaluating burn-rate rules over the TSDB. This port keeps the exact
same pipeline shape — exposition text is really parsed, histograms are
really merged, alerts really trip — but runs it in-process on the
injectable `utils/clock.Clock` with seeded jitter, so a same-seed
`FakeClock` run exports a byte-identical series artifact and alert
trip/clear ticks are part of the replayable contract (DIVERGENCES
#30). Soaks gate on alerts, not just end-of-run values.

Pipeline:
  Target.scrape()      -> Prometheus exposition text (HTTP or in-proc)
  parse_exposition()   -> {family: kind + per-labelset points}
  FleetScraper.sample():
      per-target counter-reset rebase (a crash-restarted process's
      counters restart at 0; rates must never go negative), then
      sum counters / merge histograms across targets into ONE fleet
      sample appended to a bounded ring
  FleetScraper.export_json() -> sorted, byte-stable JSON series
  BurnRateEvaluator.observe(sample) -> deterministic TRIP/CLEAR events

Histograms merge because utils/metrics.py pins per-metric bucket
boundaries; summaries expose only _sum/_count here (a p99 of p99s is
not a p99 — the merged percentile story belongs to histograms).
"""

from __future__ import annotations

import json
import random
import threading
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.clock import REAL, Clock
from ..utils.metrics import (HISTOGRAM_BUCKETS, Histogram, MetricsRegistry,
                             _fmt_labels, _key)

# ------------------------------------------------------------ parsing


def _unescape(val: str) -> str:
    out, i = [], 0
    while i < len(val):
        c = val[i]
        if c == "\\" and i + 1 < len(val):
            nxt = val[i + 1]
            out.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt, c + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_labels(body: str) -> Dict[str, str]:
    """`a="x",b="y"` -> dict, honoring \\\\ \\" \\n escapes."""
    labels: Dict[str, str] = {}
    i = 0
    while i < len(body):
        eq = body.index("=", i)
        name = body[i:eq].strip().lstrip(",").strip()
        if body[eq + 1] != '"':
            raise ValueError(f"unquoted label value at {body[eq:]!r}")
        j = eq + 2
        while j < len(body):
            if body[j] == "\\":
                j += 2
                continue
            if body[j] == '"':
                break
            j += 1
        labels[name] = _unescape(body[eq + 2:j])
        i = j + 1
    return labels


def _parse_sample_line(line: str) -> Tuple[str, Dict[str, str], float]:
    if "{" in line:
        name, rest = line.split("{", 1)
        body, valpart = rest.rsplit("}", 1)
        return name, _parse_labels(body), float(valpart.strip())
    name, valpart = line.split(None, 1)
    return name, {}, float(valpart)


@dataclass
class Family:
    """One metric family from one exposition: kind + points keyed by
    the sorted-labels tuple. Histogram points are de-cumulated back
    into Histogram objects (mergeable); summaries keep only the
    mergeable _sum/_count pair."""

    name: str
    kind: str  # counter | gauge | histogram | summary | untyped
    points: Dict[tuple, float] = field(default_factory=dict)
    hists: Dict[tuple, Histogram] = field(default_factory=dict)
    sums: Dict[tuple, Tuple[float, float]] = field(default_factory=dict)


def parse_exposition(text: str) -> Dict[str, Family]:
    """Parse Prometheus text exposition into families. Round-trips
    MetricsRegistry.render() exactly (the golden test), and accepts
    the subset any of this repo's components serve."""
    kinds: Dict[str, str] = {}
    flat: Dict[str, Dict[tuple, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                kinds[parts[2]] = parts[3]
            continue
        name, labels, value = _parse_sample_line(line)
        flat.setdefault(name, {})[_key(labels)] = value

    out: Dict[str, Family] = {}
    for fam_name, kind in kinds.items():
        fam = Family(fam_name, kind)
        if kind == "histogram":
            # regroup _bucket/_sum/_count by base labels, rebuild the
            # per-bucket counts from the cumulative exposition
            buckets: Dict[tuple, List[Tuple[float, float]]] = {}
            for k, v in flat.get(fam_name + "_bucket", {}).items():
                le = dict(k)["le"]
                base = _key({n: x for n, x in k if n != "le"})
                bound = float("inf") if le == "+Inf" else float(le)
                buckets.setdefault(base, []).append((bound, v))
            for base, pairs in buckets.items():
                pairs.sort()
                bounds = tuple(b for b, _ in pairs if b != float("inf"))
                h = Histogram(bounds)
                prev = 0.0
                cum = [c for _, c in pairs]
                for i, c in enumerate(cum):
                    h.counts[i] = int(round(c - prev))
                    prev = c
                h.total = flat.get(fam_name + "_sum", {}).get(base, 0.0)
                h.count = int(flat.get(fam_name + "_count",
                                       {}).get(base, prev))
                fam.hists[base] = h
        elif kind == "summary":
            for k, v in flat.get(fam_name + "_sum", {}).items():
                cnt = flat.get(fam_name + "_count", {}).get(k, 0.0)
                fam.sums[k] = (v, cnt)
        else:
            fam.points = dict(flat.get(fam_name, {}))
        out[fam_name] = fam
    return out


# ------------------------------------------------------------- targets


class RegistryTarget:
    """In-proc component registry (scheduler, controllers, fleet, the
    soak harness itself) — scraped through render(), not object
    access, so the parser path is exercised for every target."""

    def __init__(self, name: str, registry: MetricsRegistry):
        self.name = name
        self._registry = registry

    def scrape(self) -> str:
        return self._registry.render()


class HttpTarget:
    """A /metrics endpoint over the wire (apiserver, kubelet). The
    endpoint is shed-exempt on the apiserver (like /healthz) so this
    keeps reading during a 429/503 storm."""

    def __init__(self, name: str, url: str, timeout_s: float = 5.0):
        self.name = name
        self.url = url
        self.timeout_s = timeout_s

    def scrape(self) -> str:
        with urllib.request.urlopen(self.url,
                                    timeout=self.timeout_s) as resp:
            return resp.read().decode()


class CallableTarget:
    """Escape hatch: any () -> exposition-text callable."""

    def __init__(self, name: str, fn: Callable[[], str]):
        self.name = name
        self._fn = fn

    def scrape(self) -> str:
        return self._fn()


# ------------------------------------------------- reset-aware folding


class _CounterState:
    """Per-(target, metric, labelset) monotone rebase: when a raw
    cumulative value goes DOWN the process behind it restarted, so the
    pre-crash total is banked into `base` and the adjusted value
    (base + raw) stays monotone — a rate over it never goes negative.
    """

    __slots__ = ("last", "base")

    def __init__(self) -> None:
        self.last = 0.0
        self.base = 0.0

    def adjust(self, raw: float) -> Tuple[float, bool]:
        reset = raw < self.last
        if reset:
            self.base += self.last
        self.last = raw
        return self.base + raw, reset


class _HistState:
    """Reset rebase for a histogram point: a restart zeroes counts,
    so bank the pre-crash histogram and merge it under the fresh one.
    Reset signal: the cumulative observation count went down."""

    __slots__ = ("last_count", "banked")

    def __init__(self) -> None:
        self.last_count = 0
        self.banked: Optional[Histogram] = None

    def adjust(self, raw: Histogram,
               prev_raw: Optional[Histogram]) -> Tuple[Histogram, bool]:
        reset = raw.count < self.last_count
        if reset and prev_raw is not None:
            self.banked = (prev_raw if self.banked is None
                           else self.banked.merge(prev_raw))
        self.last_count = raw.count
        return (raw if self.banked is None
                else self.banked.merge(raw)), reset


# ------------------------------------------------------------- scraper


def _lstr(k: tuple) -> str:
    """Canonical label-set key for JSON: the exposition label string
    ('' for the empty set) — already sorted, already escaped."""
    return _fmt_labels(k)


class FleetScraper:
    """Clocked scrape -> fold -> ring. One sample() pulls every
    target, rebases counter resets per target, then folds into one
    fleet view: counters and gauges sum across targets and label
    sets stay separate; histograms with pinned boundaries merge
    exactly. Samples land in a bounded ring; export_json() is sorted
    and byte-stable (same-seed FakeClock runs are byte-identical —
    tier-1 gated, like the tracer's span export).
    """

    def __init__(self, targets: List, clock: Optional[Clock] = None,
                 cadence_s: float = 1.0, jitter_s: float = 0.0,
                 seed: int = 0, capacity: int = 4096):
        self.targets = list(targets)
        self.clock = clock or REAL
        self.cadence_s = cadence_s
        self.jitter_s = jitter_s
        self.seed = seed
        # seeded per-(seed, stream) jitter draw — the scrape analogue
        # of the chaos plans' fixed-draw contract
        self._rng = random.Random(f"{seed}:metricsplane")
        self._ring: List[dict] = []
        self._capacity = capacity
        self._lock = threading.Lock()
        # (target, metric, lstr) -> rebase state
        self._cstate: Dict[tuple, _CounterState] = {}
        self._hstate: Dict[tuple, _HistState] = {}
        self._praw: Dict[tuple, Histogram] = {}
        self.resets_total = 0
        self.errors_total = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._n = 0

    # ------------------------------------------------------ one round

    def sample(self, t: Optional[float] = None) -> dict:
        """Scrape every target once and append the folded fleet
        sample. `t` defaults to the clock's monotonic read; soaks
        pass their tick index so the time axis is replayable."""
        if t is None:
            t = self.clock.monotonic()
        counters: Dict[str, Dict[str, float]] = {}
        gauges: Dict[str, Dict[str, float]] = {}
        hists: Dict[str, Dict[str, Histogram]] = {}
        resets = 0
        errors = 0
        for target in self.targets:
            try:
                fams = parse_exposition(target.scrape())
            except Exception:
                errors += 1
                continue
            for fam in fams.values():
                if fam.kind == "histogram":
                    for k, h in fam.hists.items():
                        key = (target.name, fam.name, k)
                        st = self._hstate.get(key)
                        if st is None:
                            st = self._hstate[key] = _HistState()
                        adj, was_reset = st.adjust(h, self._praw.get(key))
                        self._praw[key] = h
                        resets += was_reset
                        cur = hists.setdefault(fam.name,
                                               {}).get(_lstr(k))
                        hists[fam.name][_lstr(k)] = \
                            adj if cur is None else cur.merge(adj)
                    continue
                if fam.kind == "summary":
                    # only the mergeable pair survives aggregation
                    for k, (s, c) in fam.sums.items():
                        for suffix, raw in (("_sum", s), ("_count", c)):
                            name = fam.name + suffix
                            key = (target.name, name, k)
                            st = self._cstate.get(key)
                            if st is None:
                                st = self._cstate[key] = _CounterState()
                            adj, was_reset = st.adjust(raw)
                            resets += was_reset
                            d = counters.setdefault(name, {})
                            d[_lstr(k)] = d.get(_lstr(k), 0.0) + adj
                    continue
                sink = gauges if fam.kind == "gauge" else counters
                for k, v in fam.points.items():
                    if fam.kind == "gauge":
                        d = sink.setdefault(fam.name, {})
                        d[_lstr(k)] = d.get(_lstr(k), 0.0) + v
                        continue
                    key = (target.name, fam.name, k)
                    st = self._cstate.get(key)
                    if st is None:
                        st = self._cstate[key] = _CounterState()
                    adj, was_reset = st.adjust(v)
                    resets += was_reset
                    d = counters.setdefault(fam.name, {})
                    d[_lstr(k)] = d.get(_lstr(k), 0.0) + adj
        self.resets_total += resets
        self.errors_total += errors
        smp = {
            "t": t,
            "counters": counters,
            "gauges": gauges,
            "histograms": {
                name: {ls: h.to_dict() for ls, h in by_label.items()}
                for name, by_label in hists.items()},
            "resets": resets,
            "errors": errors,
        }
        with self._lock:
            self._ring.append(smp)
            if len(self._ring) > self._capacity:
                del self._ring[0]
            self._n += 1
        return smp

    # ------------------------------------------------------ the series

    def series(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def tail(self, n: int) -> List[dict]:
        with self._lock:
            return list(self._ring[-n:])

    def export_json(self) -> str:
        """Sorted, compact, byte-stable series artifact — the
        metrics-plane twin of Tracer.export_json()."""
        with self._lock:
            doc = {
                "cadence_s": self.cadence_s,
                "jitter_s": self.jitter_s,
                "seed": self.seed,
                "targets": sorted(t.name for t in self.targets),
                "resets_total": self.resets_total,
                "errors_total": self.errors_total,
                "samples": list(self._ring),
            }
        return json.dumps(doc, sort_keys=True, separators=(",", ":"))

    # --------------------------------------------------- clocked loop

    def start(self) -> "FleetScraper":
        """Background sampler at the fixed cadence plus a seeded
        jitter draw per round (Prometheus jitters scrapes so targets
        don't see a thundering herd; ours is replayable)."""
        def loop() -> None:
            while not self._stop.is_set():
                self.clock.sleep(self.cadence_s
                                 + self._rng.uniform(0.0, self.jitter_s))
                if self._stop.is_set():
                    return
                self.sample()
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fleet-scraper")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# ----------------------------------------------------- SLO burn rates


@dataclass(frozen=True)
class SLODef:
    """One pinned SLO over the fleet series.

    kind "ratio": good/total are two cumulative counters (summed
    across label sets); error ratio over a window of W samples is
    1 - d(good)/d(total).  kind "histogram_le": good events are the
    observations <= threshold_le of a pinned histogram (the bound
    must be a pinned bucket boundary — exact, no interpolation),
    total is its _count.

    Burn rate = error_ratio / error_budget, error_budget =
    1 - objective. Multi-window alerting per the SRE workbook: the
    alert TRIPs when both the fast and the slow window burn over
    their thresholds (fast alone is noise-prone, slow alone is
    laggy), and CLEARs as soon as the fast window calms.
    """

    name: str
    metric: str                 # total counter, or histogram name
    kind: str = "ratio"         # "ratio" | "histogram_le"
    good_metric: str = ""       # ratio: the good-events counter
    threshold_le: float = 0.0   # histogram_le: pinned bucket bound
    objective: float = 0.999
    fast_window: int = 2        # samples
    slow_window: int = 8
    fast_burn: float = 10.0
    slow_burn: float = 2.0

    @property
    def budget(self) -> float:
        return 1.0 - self.objective


@dataclass(frozen=True)
class AlertEvent:
    """A deterministic alert edge: sample index + both burn rates at
    the edge. Soaks gate on these (trip AND clear), not just final
    values — the alert timeline is part of the replayable contract."""

    sample: int
    t: float
    slo: str
    action: str   # "TRIP" | "CLEAR"
    fast_burn: float
    slow_burn: float

    def to_dict(self) -> dict:
        return {"sample": self.sample, "t": self.t, "slo": self.slo,
                "action": self.action,
                "fast_burn": round(self.fast_burn, 4),
                "slow_burn": round(self.slow_burn, 4)}


def _counter_total(sample: dict, name: str) -> float:
    return sum(sample.get("counters", {}).get(name, {}).values())


def _hist_good_total(sample: dict, name: str,
                     le: float) -> Tuple[float, float]:
    good = total = 0.0
    for d in sample.get("histograms", {}).get(name, {}).values():
        h = Histogram.from_dict(d)
        good += h.quantile_le(le)
        total += h.count
    return good, total


class BurnRateEvaluator:
    """Feed fleet samples in order; collect TRIP/CLEAR events. Pure
    function of the sample stream — two same-seed runs produce the
    same events at the same sample indices."""

    def __init__(self, slos: List[SLODef],
                 on_trip: Optional[Callable[[AlertEvent], None]] = None,
                 on_clear: Optional[Callable[[AlertEvent], None]] = None):
        self.slos = list(slos)
        self.events: List[AlertEvent] = []
        self._on_trip = on_trip
        self._on_clear = on_clear
        # per-slo: cumulative (good, total) per sample + active flag
        self._track: Dict[str, List[Tuple[float, float]]] = \
            {s.name: [] for s in self.slos}
        self._active: Dict[str, bool] = {s.name: False for s in self.slos}
        self._idx = -1

    @staticmethod
    def _good_total(slo: SLODef, sample: dict) -> Tuple[float, float]:
        if slo.kind == "histogram_le":
            return _hist_good_total(sample, slo.metric, slo.threshold_le)
        return (_counter_total(sample, slo.good_metric),
                _counter_total(sample, slo.metric))

    def _burn(self, slo: SLODef, window: int) -> float:
        track = self._track[slo.name]
        hi = track[-1]
        lo = track[max(0, len(track) - 1 - window)]
        d_total = hi[1] - lo[1]
        if d_total <= 0:
            return 0.0
        err = max(0.0, 1.0 - (hi[0] - lo[0]) / d_total)
        return err / slo.budget

    def observe(self, sample: dict) -> List[AlertEvent]:
        """Evaluate one appended sample; returns the events it fired."""
        self._idx += 1
        fired: List[AlertEvent] = []
        for slo in self.slos:
            self._track[slo.name].append(self._good_total(slo, sample))
            fast = self._burn(slo, slo.fast_window)
            slow = self._burn(slo, slo.slow_window)
            active = self._active[slo.name]
            if not active and fast >= slo.fast_burn \
                    and slow >= slo.slow_burn:
                ev = AlertEvent(self._idx, sample.get("t", 0.0),
                                slo.name, "TRIP", fast, slow)
            elif active and fast < slo.fast_burn:
                ev = AlertEvent(self._idx, sample.get("t", 0.0),
                                slo.name, "CLEAR", fast, slow)
            else:
                continue
            self._active[slo.name] = ev.action == "TRIP"
            self.events.append(ev)
            fired.append(ev)
            cb = self._on_trip if ev.action == "TRIP" else self._on_clear
            if cb is not None:
                cb(ev)
        return fired

    def active(self, slo_name: str) -> bool:
        return self._active.get(slo_name, False)

    def events_dict(self) -> List[dict]:
        return [e.to_dict() for e in self.events]


def evaluate_series(slos: List[SLODef],
                    series: List[dict]) -> List[AlertEvent]:
    """Offline replay of the evaluator over a recorded series — what
    tools/obs_report.py runs on an exported artifact."""
    ev = BurnRateEvaluator(slos)
    for sample in series:
        ev.observe(sample)
    return ev.events
