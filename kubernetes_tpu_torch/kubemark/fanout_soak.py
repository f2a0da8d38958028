"""The 10k-watcher fan-out soak: a create-storm against the N-worker
serving plane (Fleet serving, README), with delivery lag gated as a
burn-rate SLO.

What the reference's watch cache buys (pkg/storage/cacher.go): one
apiserver process absorbs list/watch fan-out so etcd never sees
per-client load. This harness measures our horizontally-scaled version
of that promise — N apiserver workers over ONE shared store, each
worker's fan-out shard draining the publish ring independently — under
the load shape that actually hurts: thousands of concurrent watchers
on one resource while a committer storms creates into it.

Measurement is server-side, like kubemark/slo.py:
`watch_publish_deliver_lag_seconds` is observed by the shard drains
themselves (enqueue stamp -> fan-out hand-off), per {shard=...} label,
so a GIL-starved client thread cannot shrink the sample set. The
BurnRateEvaluator runs the pinned FLEET_SLOS (incl. the watch-deliver
SLO) over per-step fleet samples — the exported series replays the
alert timeline.

Scaling readout honesty: on a 1-core box the GIL
serializes the shard pumps, so wall-clock delivery throughput may not
scale 1 -> N workers. The harness records the ratio AND the
multi-consumer overlap witness (Store.drain_overlap: how often two
consumers were genuinely inside fan-out at once); when the box can't
show wall-clock scaling, the overlap readout is the gate and the
caveat is recorded in the artifact instead of a flattering number.
"""

from __future__ import annotations

import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from ..api.client import HttpClient
from ..api.registry import Registry
from ..api.server import ApiServerPool
from ..core.store import Store
from ..obs.metricsplane import (BurnRateEvaluator, FleetScraper,
                                RegistryTarget)
from ..utils.metrics import (APISERVER_WORKER_REQUESTS,
                             FANOUT_QUEUE_DEPTH_GAUGE,
                             WATCH_LAG_HISTOGRAM, MetricsRegistry)
from .benchmark import _bench_pod
from .slo import FLEET_SLOS, WATCH_DELIVER_SLO

#: the scaling acceptance bar (1 -> N workers) when wall-clock can
#: show it; below this the overlap witness gates instead
SCALING_RATIO_BAR = 1.5


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


@dataclass
class FanoutArm:
    """One storm run at a fixed worker count."""
    workers: int
    n_watchers: int
    creates_total: int
    elapsed_s: float
    create_pods_per_sec: float
    #: ring events consumed by the shard drains (summed across shards,
    #: so it grows with workers — informational, NOT the scaling basis)
    deliver_events_total: int
    #: per-watcher event deliveries per second (drained / elapsed) —
    #: the same total work in every arm, so the 1 -> N ratio of THIS
    #: number is the fair wall-clock scaling readout
    deliver_events_per_sec: float
    #: events the client side actually drained (sanity: == expected)
    drained_events_total: int
    drained_expected: int
    #: per-shard delivery stats: shard -> {watchers, delivered,
    #: lag_p50_ms, lag_p99_ms, queue_depth_max, worker_requests}
    per_worker: Dict[str, dict] = field(default_factory=dict)
    lag_p50_ms: float = 0.0
    lag_p99_ms: float = 0.0
    #: Store.drain_overlap() snapshot (multi-consumer witness)
    overlap: Dict = field(default_factory=dict)
    #: burn-rate alert timeline over the storm samples
    alerts: List[Dict] = field(default_factory=list)
    scrape_samples: int = 0
    http_events: int = 0
    watchers_alive_end: int = 0
    #: per-worker HTTP list sizes at storm end (each must equal
    #: creates_total: any worker serves the whole shared store)
    cross_worker_lists: List[int] = field(default_factory=list)

    @property
    def cross_worker_ok(self) -> bool:
        return all(n == self.creates_total
                   for n in self.cross_worker_lists)

    @property
    def delivered_ok(self) -> bool:
        """Exactly-once accounting: every watcher drained exactly the
        storm's event count — no drops, no dups, no stuck shard."""
        return self.drained_events_total == self.drained_expected

    @property
    def watch_slo_ok(self) -> bool:
        """The watch-deliver burn-rate SLO never stayed tripped: every
        TRIP has a CLEAR (transient storm lag is the expected shape;
        a stuck shard never clears)."""
        trips = [a for a in self.alerts
                 if a["slo"] == WATCH_DELIVER_SLO.name
                 and a["action"] == "TRIP"]
        clears = [a for a in self.alerts
                  if a["slo"] == WATCH_DELIVER_SLO.name
                  and a["action"] == "CLEAR"]
        return len(clears) >= len(trips)


@dataclass
class FanoutSoakResult:
    n_watchers: int
    workers: int
    storm_steps: int
    creates_per_step: int
    seed: int
    arm: FanoutArm
    #: the 1-worker arm of the same storm (compare_single=True runs)
    baseline: Optional[FanoutArm] = None
    scaling_ratio: float = 0.0
    #: 'wallclock' when the ratio met the bar, 'overlap' when the
    #: 1-core caveat applied and the overlap witness gated instead
    scaling_gate: str = ""
    scaling_ok: bool = False
    caveat: str = ""

    @property
    def ok(self) -> bool:
        return bool(self.arm.delivered_ok and self.arm.watch_slo_ok
                    and self.arm.cross_worker_ok
                    and (self.baseline is None or self.scaling_ok))

    def as_dict(self) -> Dict:
        d = asdict(self)
        d["ok"] = self.ok
        for key, arm in (("arm", self.arm), ("baseline", self.baseline)):
            if arm is None:
                continue
            d[key]["delivered_ok"] = arm.delivered_ok
            d[key]["watch_slo_ok"] = arm.watch_slo_ok
            d[key]["cross_worker_ok"] = arm.cross_worker_ok
        return d


def _run_arm(n_watchers: int, workers: int, storm_steps: int,
             creates_per_step: int, batch: int, seed: int,
             http_watchers: int, settle_timeout_s: float,
             name_base: int) -> FanoutArm:
    """One complete storm at a fixed worker count: fresh store, fresh
    pool, fresh metrics (no cross-arm mixing)."""
    metrics = MetricsRegistry()
    store = Store(metrics=metrics)
    registry = Registry(store)
    pool = ApiServerPool(registry, n_workers=workers,
                         metrics=metrics).start()
    scraper = FleetScraper([RegistryTarget("fleet", metrics)],
                           seed=seed)
    evaluator = BurnRateEvaluator(list(FLEET_SLOS))

    prefix = registry.prefix("pods", "default")
    shards = pool.shards()

    # ---- in-proc watchers, round-robin across worker shards ("from
    # now": the storm is the signal, replay would just add noise)
    watchers: List[List] = [[] for _ in pool.workers]
    for i in range(n_watchers):
        wi = i % len(pool.workers)
        w = registry.watch("pods", "default",
                           shard=pool.workers[wi]._shard)
        watchers[wi].append(w)

    # ---- a few real HTTP watch streams for wire realism (chunked
    # encoding, serialization, the works) — small on purpose; the
    # 10k-scale load is the in-proc fan-out above
    http_streams = []
    for i in range(http_watchers):
        c = HttpClient(pool.workers[i % len(pool.workers)].url)
        http_streams.append(c.watch("pods", namespace="default"))
    http_counts = [0] * len(http_streams)
    stop_http = threading.Event()

    def _http_drain(idx: int) -> None:
        while not stop_http.is_set():
            ev = http_streams[idx].next(timeout=0.2)
            if ev is not None and ev.type != "ERROR":
                http_counts[idx] += 1

    http_threads = [threading.Thread(target=_http_drain, args=(i,),
                                     daemon=True,
                                     name=f"fanout-http-{i}")
                    for i in range(len(http_streams))]
    for t in http_threads:
        t.start()

    # ---- client-side drainers: one per worker, bulk-draining that
    # worker's watchers (take_all = one lock hold per backlog)
    drained = [0] * len(pool.workers)
    stop_drain = threading.Event()

    def _drainer(wi: int) -> None:
        mine = watchers[wi]
        while True:
            got = 0
            for w in mine:
                got += len(w.take_all())
            drained[wi] += got
            if stop_drain.is_set() and got == 0:
                return
            if got == 0:
                time.sleep(0.002)

    drain_threads = [threading.Thread(target=_drainer, args=(wi,),
                                      daemon=True,
                                      name=f"fanout-drain-{wi}")
                     for wi in range(len(pool.workers))]
    for t in drain_threads:
        t.start()

    # ---- the create storm, sampled per step on the step axis
    creates_total = 0
    t0 = time.monotonic()
    try:
        for step in range(storm_steps):
            base = name_base + step * creates_per_step
            for off in range(0, creates_per_step, batch):
                n = min(batch, creates_per_step - off)
                entries = [(f"{prefix}bench-pod-{base + off + k:06d}",
                            _bench_pod(base + off + k), None)
                           for k in range(n)]
                store.create_batch(entries)
                creates_total += n
            # let the shard pumps catch this step's entries up before
            # sampling, so the step's lag observations are complete
            deadline = time.monotonic() + settle_timeout_s
            while any(sh.pending() > 0 for sh in shards) \
                    and time.monotonic() < deadline:
                time.sleep(0.005)
            evaluator.observe(scraper.sample(t=float(step)))
        elapsed = time.monotonic() - t0

        # drain samples so a trailing TRIP gets its CLEAR edge
        for extra in range(1, 9):
            evaluator.observe(scraper.sample(t=float(storm_steps - 1
                                                     + extra)))

        # ---- teardown order matters: stop the client drainers LAST,
        # after delivery quiesced, so drained == delivered is a real
        # accounting identity
        deadline = time.monotonic() + settle_timeout_s
        while any(sh.pending() > 0 for sh in shards) \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        stop_drain.set()
        for t in drain_threads:
            t.join(timeout=10.0)
        stop_http.set()
        for t in http_threads:
            t.join(timeout=5.0)
        # close the HTTP streams NOW (not in the finally) so their
        # server-side handlers exit and land the per-worker request
        # counter before the readout below
        for s in http_streams:
            try:
                s.stop()
            except Exception:
                pass
        if http_streams:
            time.sleep(0.2)

        # cross-worker read sanity: ANY worker serves the shared store,
        # so one HTTP list per worker must see every storm pod — this
        # also lands apiserver_worker_requests under each worker label
        list_counts = []
        for w in pool.workers:
            items, _rev = HttpClient(w.url).list("pods",
                                                 namespace="default")
            list_counts.append(len(items))

        # ---- readout
        per_worker: Dict[str, dict] = {}
        lag_all: List[float] = []
        for labels, stats in metrics.summary_stats(
                WATCH_LAG_HISTOGRAM).items():
            shard_name = dict(labels).get("shard")
            if shard_name is None:
                continue  # the default shard's unlabeled path
            per_worker[shard_name] = {
                "lag_p50_ms": round(stats["p50"] * 1e3, 3),
                "lag_p99_ms": round(stats["p99"] * 1e3, 3),
                "lag_samples": stats["count"]}
        for labels, samples in metrics.summary_samples(
                WATCH_LAG_HISTOGRAM).items():
            if dict(labels).get("shard") is not None:
                lag_all.extend(samples)
        lag_all.sort()
        for wi, sh in enumerate(shards):
            d = per_worker.setdefault(sh.name, {})
            d["watchers"] = len(watchers[wi])
            d["delivered"] = sh.delivered_events
            d["queue_depth_last"] = metrics.gauge(
                FANOUT_QUEUE_DEPTH_GAUGE, {"shard": sh.name})
            d["worker_requests"] = metrics.counter(
                APISERVER_WORKER_REQUESTS, {"worker": str(wi)})
        delivered_total = sum(sh.delivered_events for sh in shards)
        alive = store.watcher_count()

        return FanoutArm(
            workers=workers, n_watchers=n_watchers,
            creates_total=creates_total,
            elapsed_s=round(elapsed, 3),
            create_pods_per_sec=round(creates_total / max(1e-9, elapsed),
                                      1),
            deliver_events_total=delivered_total,
            deliver_events_per_sec=round(
                sum(drained) / max(1e-9, elapsed), 1),
            drained_events_total=sum(drained),
            drained_expected=creates_total * n_watchers,
            per_worker=per_worker,
            lag_p50_ms=round(_percentile(lag_all, 0.50) * 1e3, 3),
            lag_p99_ms=round(_percentile(lag_all, 0.99) * 1e3, 3),
            overlap=store.drain_overlap(),
            alerts=evaluator.events_dict(),
            scrape_samples=len(scraper.series()),
            http_events=sum(http_counts),
            watchers_alive_end=alive,
            cross_worker_lists=list_counts)
    finally:
        stop_drain.set()
        stop_http.set()
        for s in http_streams:
            try:
                s.stop()
            except Exception:
                pass
        pool.stop()


def run_fanout_soak(n_watchers: int = 10_000, workers: int = 4,
                    storm_steps: int = 10, creates_per_step: int = 200,
                    batch: int = 100, seed: int = 0,
                    http_watchers: int = 4,
                    settle_timeout_s: float = 30.0,
                    compare_single: bool = True) -> FanoutSoakResult:
    """The tentpole bench: an N-worker storm arm, optionally preceded
    by a 1-worker baseline arm of the SAME storm for the scaling
    readout. Fresh store/pool/metrics per arm — no cross-arm mixing.
    Deterministic inputs (pod names from a fixed base, samples on the
    step axis) so the SLO timeline in the artifact replays."""
    baseline = None
    if compare_single and workers > 1:
        baseline = _run_arm(n_watchers, 1, storm_steps,
                            creates_per_step, batch, seed,
                            http_watchers, settle_timeout_s,
                            name_base=0)
    arm = _run_arm(n_watchers, workers, storm_steps, creates_per_step,
                   batch, seed, http_watchers, settle_timeout_s,
                   name_base=0)

    result = FanoutSoakResult(
        n_watchers=n_watchers, workers=workers, storm_steps=storm_steps,
        creates_per_step=creates_per_step, seed=seed, arm=arm,
        baseline=baseline)
    if baseline is not None:
        ratio = (arm.deliver_events_per_sec
                 / max(1e-9, baseline.deliver_events_per_sec))
        result.scaling_ratio = round(ratio, 2)
        if ratio >= SCALING_RATIO_BAR:
            result.scaling_gate = "wallclock"
            result.scaling_ok = True
        else:
            # the honest 1-core path: the GIL serializes pump
            # wall-clock, so gate on the multi-consumer overlap
            # witness instead — were N consumers genuinely mid-fan-out
            # at once?
            ov = arm.overlap
            result.scaling_gate = "overlap"
            result.scaling_ok = bool(ov.get("max_concurrent", 0) >= 2
                                     and ov.get("overlapped", 0) > 0)
            result.caveat = (
                f"1-core GIL caveat: wall-clock delivery ratio "
                f"{result.scaling_ratio}x (bar {SCALING_RATIO_BAR}x) "
                f"not demonstrable on this box; gated on the "
                f"multi-consumer overlap witness instead "
                f"(max_concurrent={ov.get('max_concurrent')}, "
                f"overlap_frac={ov.get('overlap_frac')})")
    return result


def main() -> None:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--watchers", type=int, default=10_000)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--creates-per-step", type=int, default=200)
    ap.add_argument("--no-baseline", action="store_true")
    args = ap.parse_args()
    r = run_fanout_soak(n_watchers=args.watchers, workers=args.workers,
                        storm_steps=args.steps,
                        creates_per_step=args.creates_per_step,
                        compare_single=not args.no_baseline)
    print(json.dumps({"metric": "fanout_soak", **r.as_dict()}))


if __name__ == "__main__":
    main()
