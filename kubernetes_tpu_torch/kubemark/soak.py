"""Soak: a steady-state control plane under continuous pod churn, with
leak gates.

Reference: test/soak/ (cauldron/serve_hostnames run clusters for hours
and fail on drift). Without a soak, watcher lists, modeler
tombstones, event TTLs and RSS are reasoned about, never demonstrated
over a run longer than a bench window. This harness runs the full in-proc stack (registry + hollow fleet + batch
scheduler) while a churner creates, confirms and deletes pods at a
modest rate, sampling the leak-prone state on a cadence:

  - RSS (VmRSS from /proc/self/status)
  - store watcher-list length (dead watchers must be swept)
  - store key count (deleted pods must not accrete)
  - modeler assumed-pod + forget-tombstone counts (TTL'd)
  - live thread count (per-connection/per-pod threads must exit)

check() applies relative-drift gates between the warm baseline (taken
after the first churn cycle, so steady-state allocations don't count
as leaks) and the final sample.

The port's copy: the batch loop's engine runs on the CUDA device unless
the caller passes `device` (the tests pass device="cpu"); on the card
each sample also records the caching allocator's allocated bytes
(`device_bytes`), which the gates do not read.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..api.client import InProcClient
from ..api.registry import Registry
from ..sched.batch import BatchScheduler
from ..sched.device.engine import resolve_device
from ..sched.factory import ConfigFactory
from .benchmark import _bench_pod
from .fleet import HollowFleet

RSS_GROWTH_LIMIT = 0.35      # fraction over the warm baseline
THREAD_GROWTH_LIMIT = 8      # absolute extra threads tolerated
KEY_GROWTH_LIMIT = 50        # store keys beyond the warm baseline


def self_warm(store, t0: float, duration_s: float) -> bool:
    """The RSS baseline is valid once the store's watch-history deque
    has filled to its designed bound (its memory is budget, not leak);
    cap the wait at 40% of the run so a slow churner still leaves a
    measurement window."""
    with store._lock:
        full = len(store._history) == store._history.maxlen
    return full or (time.time() - t0) > 0.4 * duration_s


def _rss_kb() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    return 0


@dataclass
class SoakResult:
    duration_s: float
    cycles: int
    pods_churned: int
    samples: List[Dict[str, float]] = field(default_factory=list)

    @property
    def baseline(self) -> Dict[str, float]:
        return self.samples[0] if self.samples else {}

    @property
    def final(self) -> Dict[str, float]:
        return self.samples[-1] if self.samples else {}

    def check(self) -> None:
        """Hard leak gates (the soak suite's contract: drift IS
        failure). RSS/watchers/threads/keys gate start-vs-end against
        the warm baseline; tombstones are TTL-bounded BY DESIGN at
        churn_rate x TTL (measured ~26k oscillating at ~850 pods/s),
        so their gate is plateau-shaped: the second half of the run
        must not exceed the first half's peak by more than noise —
        monotonic growth means the TTL GC died."""
        b, f = self.baseline, self.final
        assert len(self.samples) >= 2, (
            "the sampler never produced a distinct baseline and final "
            "sample — the run measured nothing (sampler start is gated "
            "on self_warm; a stalled churner can skip it)")
        assert f["rss_kb"] <= b["rss_kb"] * (1 + RSS_GROWTH_LIMIT), (
            f"RSS grew {b['rss_kb']}kB -> {f['rss_kb']}kB "
            f"(> {RSS_GROWTH_LIMIT:.0%} over baseline)")
        assert f["watchers"] <= b["watchers"], (
            f"store watcher list grew {b['watchers']} -> "
            f"{f['watchers']} (dead watchers not swept)")
        assert f["threads"] <= b["threads"] + THREAD_GROWTH_LIMIT, (
            f"thread count grew {b['threads']} -> {f['threads']}")
        assert f["store_keys"] <= b["store_keys"] + KEY_GROWTH_LIMIT, (
            f"store keys grew {b['store_keys']} -> {f['store_keys']} "
            f"(deleted pods accreting?)")
        if "ledger" in f:
            assert f["ledger"] <= b.get("ledger", 0) + KEY_GROWTH_LIMIT, (
                f"incremental-encoder ledger grew {b.get('ledger')} -> "
                f"{f['ledger']} (deleted pods not removed from the "
                f"device state)")
            assert f.get("ledger_unknown_node", 0) <= \
                b.get("ledger_unknown_node", 0) + KEY_GROWTH_LIMIT, (
                "unknown-node bucket accreting")
        mid = len(self.samples) // 2
        first_peak = max(s["tombstones"] for s in self.samples[:mid + 1])
        second_peak = max(s["tombstones"] for s in self.samples[mid:])
        assert second_peak <= first_peak * 1.5 + 500, (
            f"modeler tombstones kept growing: first-half peak "
            f"{first_peak}, second-half peak {second_peak} "
            f"(TTL GC not running?)")

    def as_dict(self) -> dict:
        return {"duration_s": round(self.duration_s, 1),
                "cycles": self.cycles,
                "pods_churned": self.pods_churned,
                "baseline": self.baseline, "final": self.final,
                "n_samples": len(self.samples)}


def run_soak(duration_s: float = 600.0, n_nodes: int = 200,
             pods_per_cycle: int = 200,
             sample_every_s: float = 5.0,
             history_window: Optional[int] = None,
             device=None) -> SoakResult:
    """Churn cycles until the clock runs out: create a pod wave, wait
    until every pod is bound AND confirmed Running, delete the wave,
    wait until the store forgets it. Leak state is sampled throughout;
    the first sample is taken AFTER one full cycle (warm baseline).

    history_window: the store's watch window retains up to that many
    events BY DESIGN (~135MB at the default 100k with pod-sized
    objects) — short CI runs pass a small window so the by-design
    fill finishes before the baseline and the RSS gate measures
    leaks, not the window budget.

    device: where the batch engine runs; None is the CUDA device and
    raises without one."""
    from ..core.store import Store
    device = resolve_device(device)
    registry = (Registry() if history_window is None
                else Registry(store=Store(window=history_window)))
    client = InProcClient(registry)
    fleet = HollowFleet(client, n_nodes, cpu="4", memory="32Gi",
                        max_pods=40, heartbeat_interval=30.0).run()
    factory = ConfigFactory(client, rate_limit=False).start()
    sched = BatchScheduler(factory.create_batch(device=device)).run()
    store = registry.store
    modeler = factory.modeler

    samples: List[Dict[str, float]] = []

    def sample() -> None:
        with store._lock:
            watchers = len(store._watchers)
            keys = len(store._data)
        with modeler._lock:
            tombs = len(modeler._forgotten)
            assumed = len(modeler._assumed._items)
        inc = sched._inc
        if inc is not None:
            with inc._lock:
                ledger = len(inc.pods)
                unknown = sum(len(v) for v in
                              inc.unknown_node_pods.values())
        else:
            ledger = unknown = 0
        extra = {}
        if device.type == "cuda":
            import torch
            extra["device_bytes"] = torch.cuda.memory_allocated(device)
        samples.append({
            "t": round(time.time() - t0, 1),
            "rss_kb": _rss_kb(),
            "watchers": watchers,
            "store_keys": keys,
            "tombstones": tombs,
            "assumed": assumed,
            "ledger": ledger,
            "ledger_unknown_node": unknown,
            "threads": threading.active_count(), **extra})

    def wait_until(cond, timeout_s: float = 120.0) -> bool:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if cond():
                return True
            time.sleep(0.1)
        return False

    t0 = time.time()
    cycles = 0
    churned = 0
    stop_sampler = threading.Event()

    def sampler():
        while not stop_sampler.wait(sample_every_s):
            sample()

    try:
        assert wait_until(
            lambda: len(factory.node_lister.list()) >= n_nodes), \
            "fleet never registered"
        from .benchmark import _warmup_batch
        _warmup_batch(sched, factory)

        deadline = t0 + duration_s
        sampler_started = False
        while time.time() < deadline:
            base = cycles * pods_per_cycle
            names = [f"bench-pod-{base + i:06d}"
                     for i in range(pods_per_cycle)]
            # columnar create: the production writers' path (template
            # + name rows) soaks too, not just object-per-pod creates
            client.create_from_template("pods", _bench_pod(0), names,
                                        "default")

            def all_running():
                pods, _ = registry.list("pods", "default")
                running = {p.metadata.name for p in pods
                           if p.status.phase == "Running"}
                return all(n in running for n in names)

            assert wait_until(all_running), \
                f"cycle {cycles}: pods never all Running"
            for n in names:
                client.delete("pods", n, "default")

            def all_gone():
                pods, _ = registry.list("pods", "default")
                live = {p.metadata.name for p in pods}
                return not any(n in live for n in names)

            assert wait_until(all_gone), \
                f"cycle {cycles}: deleted pods still present"
            cycles += 1
            churned += pods_per_cycle
            if not sampler_started and self_warm(store, t0, duration_s):
                # warm baseline: caches, thread pools, compile
                # artifacts AND the watch-history window (which
                # retains its maxlen events by design — ~135MB at the
                # default 100k) all exist — growth from HERE is leak,
                # not budgeted fill
                sample()
                threading.Thread(target=sampler, daemon=True).start()
                sampler_started = True
        # all_gone above proved the DELETEs committed to the STORE,
        # but the scheduler's incremental encoder drains them from its
        # own watch stream — on a loaded box that drain can trail the
        # final sample and read as ledger growth. Settle it (bounded):
        # a genuine leak never drains and still fails the gate. The
        # ledger is keyed "namespace/name" (the JAX soak looks up bare
        # names here, so its settle never waits).
        inc = sched._inc
        if inc is not None and cycles:
            keys = [f"default/{n}" for n in names]

            def ledger_drained():
                with inc._lock:
                    return not any(k in inc.pods for k in keys)

            wait_until(ledger_drained, timeout_s=15.0)
        sample()  # final
    finally:
        stop_sampler.set()
        sched.stop()
        factory.stop()
        fleet.stop()

    return SoakResult(duration_s=time.time() - t0, cycles=cycles,
                      pods_churned=churned, samples=samples)


def main() -> None:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--nodes", type=int, default=200)
    ap.add_argument("--pods-per-cycle", type=int, default=200)
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--out", default="",
                    help="write the result JSON to this file as well")
    ap.add_argument("--cpu", action="store_true",
                    help="run the engine on the CPU (default: the CUDA "
                         "device, which must be present)")
    args = ap.parse_args()

    import torch

    from ..utils.platform import pick_device
    device = pick_device(args.cpu)
    # the device that ran it: "cpu", or the card's name
    platform = (torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu")
    r = run_soak(args.minutes * 60.0, args.nodes, args.pods_per_cycle,
                 device=device)
    doc = {"metric": "soak", "platform": platform, "nodes": args.nodes,
           "pods_per_cycle": args.pods_per_cycle, **r.as_dict()}
    try:
        r.check()
        doc["gates"] = {"ok": True}
    except AssertionError as e:
        doc["gates"] = {"ok": False, "reason": str(e)}
    # the artifact records failures too — a failed round must not
    # leave the previous round's ok:true on disk
    if args.out:
        from .gpu_evidence import _atomic_write_json
        _atomic_write_json(args.out, doc)
    print(json.dumps(doc))
    if not args.no_check and not doc["gates"]["ok"]:
        raise SystemExit(f"soak gate failed: {doc['gates']['reason']}")


if __name__ == "__main__":
    main()
