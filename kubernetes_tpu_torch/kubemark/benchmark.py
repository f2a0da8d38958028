"""BenchmarkScheduling, ported.

Reference: test/integration/scheduler_test.go:278-354 — in-process master
+ scheduler, 1000 fake nodes (4 CPU / 32Gi / 32-pod cap :329-354), N pods
created by 30 concurrent writer goroutines (:379), clock stops when the
scheduled-pod lister has seen every pod. Here the master is the in-proc
registry, the nodes come from a HollowFleet (full kubemark wiring: the
fleet also confirms pods Running), and the scheduler is either the serial
control loop or the device batch loop — the benchmark measures the whole
bind pipeline, not just the scoring math.

The port's copy: the batch loop's engine runs on the CUDA device unless
the caller passes `device` (the tests pass device="cpu").
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

from ..api.client import InProcClient
from ..api.registry import Registry
from ..core import types as api
from ..core.quantity import parse_quantity
from ..sched.batch import BatchScheduler
from ..sched.device.engine import resolve_device
from ..sched.factory import ConfigFactory
from ..sched.scheduler import Scheduler
from .fleet import HollowFleet

WRITER_THREADS = 30  # ref: scheduler_test.go:379
# the JAX benchmark's fleet heartbeat (its run_scheduling_benchmark passes
# heartbeat_interval=600.0): the same traffic under the same name
HEARTBEAT_INTERVAL_S = 600.0


@dataclass
class BenchmarkResult:
    n_nodes: int
    n_pods: int
    scheduled: int
    running: int
    elapsed_s: float          # create-start -> all pods bound
    pods_per_sec: float
    mode: str                 # "batch" | "serial"
    started_at: float = 0.0   # epoch of create-start (profilers scope
    #                           samples to [started_at, +elapsed_s])
    # batch mode: the engine's host->device transfer accounting over the
    # MEASURED window (warmup excluded) — full vs delta upload tiles and
    # bytes; None in serial mode
    upload_stats: Optional[dict] = None
    # batch mode: the engine's scan accounting over the measured window
    # (runs, scan steps, host seconds in run_chunked); None in serial mode
    scan_stats: Optional[dict] = None


_BENCH_REQUESTS = {"cpu": parse_quantity("100m"),
                   "memory": parse_quantity("64Mi")}


def _bench_pod(i: int) -> api.Pod:
    # shape from the reference fixture: 100m / no memory request
    # isn't specified there; keep requests small enough that 1000x32-cap
    # nodes absorb any N used in tests/benches
    return api.Pod(
        metadata=api.ObjectMeta(name=f"bench-pod-{i:06d}",
                                namespace="default",
                                labels={"app": "bench"}),
        spec=api.PodSpec(containers=[api.Container(
            name="c", image="benchmark-image",
            resources=api.ResourceRequirements(
                requests=dict(_BENCH_REQUESTS)))]),
        status=api.PodStatus(phase="Pending"))


def _warmup_batch(sched: BatchScheduler, factory: ConfigFactory) -> None:
    """Warm the engine at the benchmark's real node-table shape (the
    scheduler's own encoder path) outside the measured window. The JAX
    engine compiles one XLA program per chunk rung here; the port's scan
    kernel is built once, at its first launch, for every shape, so one
    short run on the smallest rung is enough to build and load it and
    to bring up the device context and its allocator's pools."""
    c = sched.config
    inc = sched._incremental()
    if inc is not None:
        # the measured path: incremental arrays (node axis = n_cap)
        enc = inc.encode_tile([_bench_pod(0)],
                              factory.service_lister.list(),
                              factory.controller_lister.list())
        c.engine.run_chunked(enc, c.min_pad)
        return
    from ..sched.device import ClusterSnapshot
    snap = ClusterSnapshot(
        nodes=factory.node_lister.list(),
        existing_pods=[],
        services=factory.service_lister.list(),
        controllers=factory.controller_lister.list(),
        pending_pods=[_bench_pod(0)])
    c.engine.schedule(snap, chunk=c.min_pad)


def run_scheduling_benchmark(n_nodes: int = 1000, n_pods: int = 1000,
                             mode: str = "batch",
                             max_pods_per_node: int = 32,
                             wait_running: bool = False,
                             timeout_s: float = 300.0,
                             registry: Optional[Registry] = None,
                             chaos_seed: Optional[int] = None,
                             chaos_error_rate: float = 0.01,
                             device=None,
                             delta_uploads: bool = True,
                             mesh=None) -> BenchmarkResult:
    """Stand up master + fleet + scheduler, blast pods from 30 writers,
    measure time until every pod is bound (and optionally Running).

    registry: the master to run against (e.g. one over a
    `Store(publish_inline=True)`); None builds a default one.

    chaos_seed: when set, every component's client rides the seeded
    fault injector (chaos.ChaosClient at chaos_error_rate on all verbs)
    so the number is recorded UNDER fault load. None (the default)
    leaves the hot path untouched.

    device: where the batch engine runs; None is the CUDA device and
    raises without one.

    delta_uploads: False forces the engine to re-upload the full node
    tables every tile (no device table mirror) — the control arm of the
    delta-scatter A/B, as in the JAX benchmark.

    mesh: a NodeMesh to split the engine's node axis over (the batch
    loop's `mesh=`); its device stands for `device`."""
    if mode == "batch" and mesh is None:
        # no card and no device named: raise before anything starts
        resolve_device(device)
    # GIL slice: 1ms measured best at first (the scheduler thread parked
    # behind 30 writers at every dispatch); after the contention fixes
    # (thread-local uids, in-place rv stamping, informer-riding
    # counter) the default 5ms wins — fewer forced handoffs across ~40
    # threads — and tightens the run-to-run spread (A/B in PROFILE_e2e.md)
    import sys
    sys.setswitchinterval(0.005)
    registry = registry or Registry()
    client = InProcClient(registry)
    if chaos_seed is not None:
        from ..chaos import ChaosClient, FaultPlan
        client = ChaosClient(client, FaultPlan(seed=chaos_seed,
                                               error_rate=chaos_error_rate))
    # the fleet beats as in the JAX benchmark: every node once per 600 s,
    # one shard of a tenth of the fleet every 30-90 s. The reference's
    # BenchmarkScheduling fixture has NO kubelets (nodes are API
    # objects, scheduler_test.go:329); the fleet is here to confirm
    # Running. A window of seconds sees no beat; a window of minutes
    # sees a shard's node updates, each of which moves the encoder's
    # state_epoch, so the next tile starts from a full upload instead
    # of the device carry. Both are the JAX benchmark's traffic.
    fleet = HollowFleet(client, n_nodes, cpu="4", memory="32Gi",
                        max_pods=max_pods_per_node,
                        heartbeat_interval=HEARTBEAT_INTERVAL_S).run()
    factory = ConfigFactory(client, rate_limit=False).start()
    if mode == "batch":
        sched = BatchScheduler(factory.create_batch(
            device=None if mesh is not None else device, mesh=mesh)).run()
        sched.config.engine.delta_uploads = delta_uploads
    elif mode == "serial":
        sched = Scheduler(factory.create()).run()
    else:
        raise ValueError(f"unknown mode {mode!r}")

    try:
        # wait until the scheduler's node cache sees the fleet
        deadline = time.time() + timeout_s
        while time.time() < deadline and \
                len(factory.node_lister.list()) < n_nodes:
            time.sleep(0.05)

        if mode == "batch":
            # warm the engine at the real node-table shape before the
            # clock starts: a live scheduler process is warm (the
            # reference benchmark likewise measures a warm in-process
            # scheduler, scheduler_test.go:278)
            _warmup_batch(sched, factory)
            # transfer accounting restarts at the measured window (the
            # warmup's uploads are not steady state)
            sched.config.engine.upload_stats = {
                k: 0 for k in sched.config.engine.upload_stats}
            sched.config.engine.scan_stats = {
                k: 0 for k in sched.config.engine.scan_stats}

        # the live-server GC posture (utils/gctune.py): the booted
        # fleet + node caches freeze out of the young generations and
        # gen-0 stops firing every ~700 allocations (it showed at ~25%
        # of the JAX package's profile ticks). Applies
        # to both modes — hyperkube server entries make the same move.
        from ..utils.gctune import tuned_gc
        gc_ctx = tuned_gc()
        gc_ctx.__enter__()

        # completion counter rides the scheduler's OWN scheduled-pod
        # informer (exactly the reference: BenchmarkScheduling waits on
        # the config's ScheduledPodLister, scheduler_test.go:278) — a
        # separate watch would add a 4th pods watcher to every store
        # fan-out inside the measured window
        bound = set()
        bound_lock = threading.Lock()
        all_bound = threading.Event()

        def count_binding(pod):
            if pod.metadata.name.startswith("bench-pod-") and \
                    pod.spec.node_name:
                with bound_lock:
                    bound.add(pod.metadata.name)
                    if len(bound) >= n_pods:
                        all_bound.set()

        factory.scheduled_observers.append(count_binding)

        start = time.time()
        next_i = iter(range(n_pods))
        lock = threading.Lock()
        # each writer claims a chunk and POSTs it through the batched
        # create path: one store window + one watch flush per chunk
        # instead of per pod (the create storm was ~1.6s of the 30k-pod
        # wall time when every pod paid its own lock + fan-out)
        chunk = 256

        # columnar create: the 30 writers ship one template + a name
        # column per chunk instead of a materialized dataclass per pod
        # (registry.create_from_template — validation once, shared
        # spec/status, fresh metadata per row). The reference's
        # BenchmarkScheduling likewise stamps pods off one template
        # fixture (test/integration/scheduler_test.go:329).
        template = _bench_pod(0)

        def writer():
            while True:
                with lock:
                    ids = []
                    for _ in range(chunk):
                        i = next(next_i, None)
                        if i is None:
                            break
                        ids.append(i)
                if not ids:
                    return
                names = [f"bench-pod-{i:06d}" for i in ids]
                while True:
                    try:
                        client.create_from_template(
                            "pods", template, names, "default")
                        break
                    except Exception:
                        # only injected faults are retried (a fault
                        # fires before the call reaches the registry,
                        # so the claimed chunk is never half-created);
                        # real errors keep crashing the writer
                        if chaos_seed is None or time.time() > deadline:
                            raise
                        time.sleep(0.01)

        writers = [threading.Thread(target=writer, daemon=True)
                   for _ in range(WRITER_THREADS)]
        for w in writers:
            w.start()
        for w in writers:
            w.join()

        all_bound.wait(timeout=max(0.0, deadline - time.time()))
        elapsed = time.time() - start
        factory.scheduled_observers.remove(count_binding)
        with bound_lock:
            scheduled = len(bound)

        running = 0
        if wait_running:
            while time.time() < deadline:
                pods, _ = registry.list("pods", "default")
                running = sum(1 for p in pods
                              if p.metadata.name.startswith("bench-pod-")
                              and p.status.phase == "Running")
                if running >= n_pods:
                    break
                time.sleep(0.05)

        return BenchmarkResult(
            n_nodes=n_nodes, n_pods=n_pods, scheduled=scheduled,
            running=running, elapsed_s=elapsed,
            pods_per_sec=scheduled / elapsed if elapsed > 0 else 0.0,
            mode=mode, started_at=start,
            upload_stats=(dict(sched.config.engine.upload_stats)
                          if mode == "batch" else None),
            scan_stats=(dict(sched.config.engine.scan_stats)
                        if mode == "batch" else None))
    finally:
        try:
            gc_ctx.__exit__(None, None, None)
        except NameError:
            pass  # failure before the tuning point
        sched.stop()
        factory.stop()
        fleet.stop()


def main() -> None:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nodes", type=int, default=1000)
    ap.add_argument("--pods", type=int, default=1000)
    ap.add_argument("--mode", choices=["batch", "serial"], default="batch")
    ap.add_argument("--device", default=None,
                    help="where the batch engine runs (default: cuda)")
    ap.add_argument("--wait-running", action="store_true")
    ap.add_argument("--full-uploads", action="store_true",
                    help="re-upload the full node tables every tile (the "
                         "control arm of the delta-scatter A/B)")
    args = ap.parse_args()
    r = run_scheduling_benchmark(
        args.nodes, args.pods, args.mode,
        wait_running=args.wait_running, device=args.device,
        delta_uploads=not args.full_uploads)
    print(json.dumps({
        "metric": f"e2e_scheduling_throughput_{r.mode}",
        "nodes": r.n_nodes, "pods": r.n_pods, "scheduled": r.scheduled,
        "elapsed_s": round(r.elapsed_s, 3),
        "value": round(r.pods_per_sec, 1), "unit": "pods/sec",
        "vs_baseline": round(r.pods_per_sec / 50.0, 1),
        "upload_stats": r.upload_stats}))


if __name__ == "__main__":
    main()
