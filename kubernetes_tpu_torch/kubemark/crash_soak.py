"""Process-crash soak: the durability/HA acceptance harness.

Stands up the full control plane over HTTP with a WAL-backed store and
REDUNDANT singletons — two batch schedulers and two controller-managers,
each pair under lease-based leader election (utils/leaderelection.py) —
with every component client behind the seeded API-fault injector. An RC
drives a commit storm, and a seeded `CrashPlan` kills processes at
deterministic points of its progress:

  apiserver kill        the store is REBUILT from its WAL
                        (Store.recover) and a fresh server takes the
                        same port; the gate compares the recovered
                        ledger against the pre-crash one — same
                        revision, same live object set, no resurrected
                        expired keys — then watchers re-list and the
                        fleet reconverges
  active-scheduler kill the standby waits out the lease, rebuilds its
                        device state from a fresh snapshot, and binds
                        the remainder (zero duplicate bindings: CAS)
  active-manager kill   the standby controller-manager resumes
                        replication under a new fencing term

Convergence gates (the durability / HA acceptance bar): every replica
Running on a node, zero duplicate bindings ever observed, at most one
lease holder per fencing term, the applied kill schedule equal to the
plan's pure replay, and the durability counters (wal_records_total,
wal_recoveries_total, leader_transitions_total) moving. Shared verbatim
by the pytest gates (tests/test_torch_chaos.py) and chip_smoke.py's
crash phase, so the record carries exactly the invariant the test
enforces.

The port's copy: both schedulers' engines run on the CUDA device unless
the caller passes `device` (the tests pass device="cpu"). The killed
scheduler is reaped (BatchScheduler.reap): its threads end and its
engine drops its device tables, so the standby in the same process
inherits none of them; its factory's informers stop with it. The
invariant tracker follows the pods through a watch and reads convergence
from its own view (confirmed by one LIST), where the JAX copy LISTs
every pod every 30 ms; the hollow fleet confirms Running over
CONFIRM_WORKERS calls side by side; the run holds the interpreter's
switch interval at 1 ms. At 1000 nodes every component of this one
interpreter shares it with ~100 heartbeats a second over HTTP, and the
JAX copy's arrangement did not converge in 300 s (PERF.md section 6).
The result also names each engine's device, the tiles by how their
tables reached the device, and the seconds from the start to
convergence.
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple

from ..api.client import HttpClient, InProcClient
from ..api.registry import Registry
from ..api.server import ApiServer
from ..chaos import ChaosClient, CrashChaos, CrashPlan, FaultPlan
from ..controllers.manager import ControllerManager
from ..core import types as api
from ..core import watch as watchpkg
from ..core.store import Store
from ..core.errors import AlreadyExists
from ..obs import tracer as _obs_tracer
from ..obs.flightrec import FlightRecorder
from ..sched.batch import BatchScheduler
from ..sched.device.engine import resolve_device
from ..sched.factory import ConfigFactory
from ..utils.clock import REAL, Clock
from ..utils.leaderelection import LeaderElectionConfig, LeaderElector
from ..utils.metrics import global_metrics
from .benchmark import _bench_pod
from .fleet import HollowFleet

#: counters the soak gates on (satellite: utils/metrics.py
#: DURABILITY_COUNTERS) — recorded as before/after deltas because the
#: global registry is process-wide
_GATED_COUNTERS = ("wal_records_total", "wal_recoveries_total",
                   "leader_transitions_total",
                   "lease_renew_failures_total")


#: status calls the hollow fleet confirms Running with at once: over
#: HTTP each pod is a PUT, and one pump's PUTs in turn, each waiting for
#: the interpreter the whole control plane shares, fell behind the binds
#: at 1000 nodes
CONFIRM_WORKERS = 32


@dataclass
class CrashSoakResult:
    converged: bool
    n_nodes: int
    replicas: int
    #: kill points actually applied (bound-pod progress), per target
    killed: Dict[str, int] = field(default_factory=dict)
    #: the plan's pure replay — the reproducibility gate
    schedule: Dict[str, int] = field(default_factory=dict)
    schedule_replayed: bool = True
    #: apiserver-kill recovery: the pre-crash vs recovered ledger
    recovery: Dict = field(default_factory=dict)
    #: (uid, old_node, new_node) triples — gate: empty
    duplicate_bindings: List[Tuple[str, str, str]] = \
        field(default_factory=list)
    #: every (lease, term) observed with more than one holder — gate:
    #: empty (at most one holder per fencing term)
    term_violations: List = field(default_factory=list)
    #: highest fencing term observed per lease
    terms: Dict[str, int] = field(default_factory=dict)
    #: durability-counter deltas across the run
    counters: Dict[str, float] = field(default_factory=dict)
    #: which replica (a/b) held each singleton at quiesce
    leaders_at_end: Dict[str, str] = field(default_factory=dict)
    converge_s: float = 0.0
    #: flight-recorder bundles written (flight_dir runs): one per kill
    flight_bundles: List[str] = field(default_factory=list)
    #: the device of each scheduler's engine (a/b)
    engine_devices: Dict[str, str] = field(default_factory=dict)
    #: whether the killed scheduler's threads ended and its engine
    #: released its device tables (BatchScheduler.reap)
    reaped: bool = False
    #: seconds from the start of the run to convergence (or the end)
    elapsed_s: float = 0.0
    #: both engines' tiles by how their tables reached the device
    #: (BatchEngine.upload_stats: full, delta, reuse)
    upload_tiles: Dict[str, int] = field(default_factory=dict)
    detail: str = ""

    def as_dict(self) -> Dict:
        return asdict(self)


def run_crash_soak(n_nodes: int = 6, replicas: int = 24, seed: int = 0,
                   fault_rate: float = 0.05,
                   wal_dir: Optional[str] = None,
                   fsync_policy: str = "batch",
                   timeout: float = 180.0,
                   lease_duration: float = 1.5,
                   renew_deadline: float = 1.0,
                   retry_period: float = 0.15,
                   heartbeat_interval: float = 1.0,
                   post_kill_scale: Optional[int] = None,
                   clock: Optional[Clock] = None,
                   flight_dir: Optional[str] = None,
                   device=None) -> CrashSoakResult:
    """One seeded crash soak; see the module docstring for the
    scenario. Lease timings default to soak-compressed values (the
    production 15s/10s/2s would make each failover a quarter-minute
    wait).

    post_kill_scale (default replicas//2): after the last kill the RC
    is scaled UP by this many replicas — a wave that only the standby
    controller-manager can create and only the standby scheduler can
    bind, so convergence structurally proves both failovers (and the
    lease takeovers advance each fencing term past the killed
    leader's).

    device: where both schedulers' engines run; None is the CUDA device
    and raises without one."""
    device = resolve_device(device)
    clock = clock or REAL
    t_start = clock.monotonic()
    own_tmp = wal_dir is None
    wal_dir = wal_dir or tempfile.mkdtemp(prefix="kube-wal-")
    base = {name: global_metrics.counter_sum(name)
            for name in _GATED_COUNTERS}
    store = Store(wal_dir=wal_dir, fsync_policy=fsync_policy)
    registry = Registry(store=store)
    srv = ApiServer(registry, port=0).start()
    port = srv.port
    plan = FaultPlan(seed=seed, error_rate=fault_rate)
    chaos = ChaosClient(HttpClient(srv.url), plan)
    crash_plan = CrashPlan(seed=seed)
    crash = CrashChaos(crash_plan, total=replicas)
    result = CrashSoakResult(converged=False, n_nodes=n_nodes,
                             replicas=replicas,
                             schedule=crash_plan.schedule(replicas))
    recorder = (FlightRecorder(flight_dir, clock=clock)
                if flight_dir else None)

    # ---- invariant trackers ride the live registry directly (no
    # chaos, no HTTP) and re-point after the apiserver restart
    ctx = {"registry": registry, "store": store}
    lock = threading.Lock()
    bound_to: Dict[str, str] = {}          # pod uid -> node
    duplicates: List[Tuple[str, str, str]] = []
    term_holders: Dict[Tuple[str, int], set] = {}
    #: the soak's pods as the tracker last saw them (uid -> pod): the
    #: store's label-selected set, kept by one list and a watch from
    #: its revision, re-listed after the apiserver restart
    seen: Dict[str, api.Pod] = {}
    stop_tracker = threading.Event()

    def observe(p: api.Pod) -> None:
        node = p.spec.node_name
        if not node:
            return
        prev = bound_to.get(p.metadata.uid)
        if prev is not None and prev != node:
            duplicates.append((p.metadata.uid, prev, node))
        bound_to[p.metadata.uid] = node

    def observe_leases(reg) -> None:
        leases, _ = reg.list("leases", "kube-system")
        with lock:
            for l in leases:
                if l.spec.holder_identity:
                    term_holders.setdefault(
                        (l.metadata.name, l.spec.lease_transitions),
                        set()).add(l.spec.holder_identity)

    def track():
        """Every pod event through a watch (the JAX copy polls a full
        LIST every 30 ms, which at thousands of pods took most of the
        interpreter from the components under test); the leases, a few
        objects, are still polled every 30 ms."""
        while not stop_tracker.is_set():
            reg = ctx["registry"]
            try:
                pods, rev = reg.list("pods", "default",
                                     label_selector="app=crash")
                w = reg.watch("pods", "default", since_rev=rev,
                              label_selector="app=crash")
            except Exception:
                clock.sleep(0.03)
                continue
            with lock:
                seen.clear()
                for p in pods:
                    seen[p.metadata.uid] = p
                    observe(p)
            next_leases = 0.0
            try:
                while not stop_tracker.is_set() \
                        and ctx["registry"] is reg:
                    if clock.monotonic() >= next_leases:
                        try:
                            observe_leases(reg)
                        except Exception:
                            pass
                        next_leases = clock.monotonic() + 0.03
                    ev = w.next(timeout=0.03)
                    if ev is None:
                        if w.stopped:
                            break           # re-list
                        continue
                    if ev.type == watchpkg.ERROR:
                        break               # expired window: re-list
                    p = ev.object
                    with lock:
                        if ev.type == watchpkg.DELETED:
                            seen.pop(p.metadata.uid, None)
                        else:
                            seen[p.metadata.uid] = p
                        observe(p)
            finally:
                w.stop()

    tracker = threading.Thread(target=track, daemon=True,
                               name="crash-soak-tracker")
    tracker.start()

    def bound_count() -> int:
        with lock:
            return len(bound_to)

    # ---- the redundant control plane
    def lease_cfg(name: str, ident: str) -> LeaderElectionConfig:
        return LeaderElectionConfig(
            lease_name=name, identity=ident, namespace="kube-system",
            lease_duration=lease_duration, renew_deadline=renew_deadline,
            retry_period=retry_period)

    fleet = HollowFleet(chaos, n_nodes,
                        heartbeat_interval=heartbeat_interval,
                        jitter_seed=seed,
                        confirm_workers=CONFIRM_WORKERS).run()
    factories = {k: ConfigFactory(chaos, rate_limit=False).start()
                 for k in ("a", "b")}
    dead_factories = set()
    scheds = {k: BatchScheduler(
        factories[k].create_batch(device=device),
        elector=LeaderElector(chaos,
                              lease_cfg("batch-scheduler", f"sched-{k}"))
    ).run() for k in ("a", "b")}
    result.engine_devices = {k: str(s.config.engine.device)
                             for k, s in scheds.items()}
    managers = {k: ControllerManager(
        chaos, elect=lease_cfg("controller-manager", f"cm-{k}")).run()
        for k in ("a", "b")}

    def wait_until(cond, deadline):
        while clock.monotonic() < deadline:
            if cond():
                return True
            clock.sleep(0.05)
        return cond()

    def active(pair):
        for k, comp in pair.items():
            if comp.is_leader:
                return k, comp
        return None, None

    # every component shares this interpreter: a 1 ms GIL slice (the
    # density SLO run's) keeps the HTTP round trips of the fleet's
    # confirms and the leases' renewals from waiting 5 ms slices behind
    # the scan and the informers; restored when the run ends
    prev_switch = sys.getswitchinterval()
    sys.setswitchinterval(0.001)
    try:
        deadline = clock.monotonic() + timeout
        if not wait_until(
                lambda: len(factories["a"].node_lister.list()) >= n_nodes,
                deadline):
            result.detail = "fleet never registered"
            return result

        rc = api.ReplicationController(
            metadata=api.ObjectMeta(name="crash", namespace="default"),
            spec=api.ReplicationControllerSpec(
                replicas=replicas, selector={"app": "crash"},
                template=api.PodTemplateSpec(
                    metadata=api.ObjectMeta(labels={"app": "crash"}),
                    spec=_bench_pod(0).spec)))
        while True:  # RC creation rides the fault injector too
            try:
                chaos.create("replicationcontrollers", rc)
                break
            except AlreadyExists:
                break  # a replayed create already committed the RC
            except Exception:
                if clock.monotonic() > deadline:
                    result.detail = "rc create never landed"
                    return result
                clock.sleep(0.05)

        # ---- apply the crash schedule as progress crosses each point
        for point, target in crash.pending():
            if not wait_until(lambda: bound_count() >= point, deadline):
                result.detail = (f"never reached kill point {point} "
                                 f"for {target} ({bound_count()} bound)")
                return result
            if target == "apiserver":
                srv.stop()
                # the dead process's ledger, sampled for the gate (the
                # WAL on disk is what recovery actually reads)
                store.wal_close()
                pre_rev = store.current_revision
                pre_live = {k: v[1] for k, v in store._data.items()
                            if not store._expired(v, clock.now())}
                recovered = Store.recover(wal_dir,
                                          fsync_policy=fsync_policy)
                now = clock.now()
                rec_live = {k: v[1] for k, v in recovered._data.items()
                            if not recovered._expired(v, now)}
                result.recovery = {
                    "pre_revision": pre_rev,
                    "recovered_revision": recovered.current_revision,
                    "revision_match":
                        recovered.current_revision == pre_rev,
                    "live_set_match": rec_live == pre_live,
                    **recovered.recovery_stats,
                }
                registry = Registry(store=recovered)
                ctx["registry"] = registry
                ctx["store"] = recovered
                srv = ApiServer(registry, host="127.0.0.1",
                                port=port).start()
            elif target == "scheduler":
                if not wait_until(
                        lambda: active(scheds)[0] is not None, deadline):
                    result.detail = "no scheduler ever led"
                    return result
                k, leader = active(scheds)
                leader.kill()
                result.reaped = leader.reap()
                # a dead process's informers die with it (the JAX copy
                # leaves the killed scheduler's factory watching)
                factories[k].stop()
                dead_factories.add(k)
            else:  # controller-manager
                if not wait_until(
                        lambda: active(managers)[0] is not None,
                        deadline):
                    result.detail = "no controller-manager ever led"
                    return result
                _k, leader = active(managers)
                leader.kill()
            crash.record(target, point)
            if recorder is not None:
                # chaos-kill post-mortem: the plan position + span
                # buffer at the instant of the kill (the series tail
                # comes from the workload soak's recorder — this soak
                # has no scraper, and the recorder writes what exists)
                recorder.dump(f"chaos-kill-{target}",
                              tracer=_obs_tracer(), chaos=crash,
                              extra={"point": point, "target": target})

        result.killed = crash.trace()
        if recorder is not None:
            result.flight_bundles = list(recorder.bundles)
        result.schedule_replayed = (
            result.killed == crash_plan.schedule(replicas)
            == result.schedule)
        t_kill = clock.monotonic()

        # the failover-proof wave: these pods do not exist yet, so the
        # DEAD controller-manager cannot have created them nor the dead
        # scheduler bound them — converging past this scale-up means
        # the standbys actually took over (see docstring)
        final_replicas = replicas + (post_kill_scale
                                     if post_kill_scale is not None
                                     else replicas // 2)
        while True:
            try:
                sc = chaos.get_scale("replicationcontrollers", "crash",
                                     "default")
                sc.spec.replicas = final_replicas
                chaos.update_scale("replicationcontrollers", "crash",
                                   sc, "default")
                break
            except Exception:
                if clock.monotonic() > deadline:
                    result.detail = "post-kill scale-up never landed"
                    return result
                clock.sleep(0.05)

        def settled(pods) -> bool:
            live = [p for p in pods
                    if p.metadata.deletion_timestamp is None]
            return (len(live) == final_replicas
                    and all(p.spec.node_name for p in live)
                    and all(p.status.phase == "Running" for p in live))

        def converged():
            # the tracker's view first (no LIST a poll); then the store
            # itself confirms
            with lock:
                view = list(seen.values())
            if not settled(view):
                return False
            reg = ctx["registry"]
            try:
                pods, _ = reg.list("pods", "default",
                                   label_selector="app=crash")
            except Exception:
                return False
            return settled(pods)

        ok = wait_until(converged, deadline)
        result.converge_s = round(clock.monotonic() - t_kill, 3)
        result.elapsed_s = round(clock.monotonic() - t_start, 3)
        result.converged = ok
        with lock:
            result.duplicate_bindings = list(duplicates)
            result.term_violations = [
                (lease, term, sorted(holders))
                for (lease, term), holders in sorted(term_holders.items())
                if len(holders) > 1]
            result.terms = {}
            for (lease, term), _h in term_holders.items():
                result.terms[lease] = max(result.terms.get(lease, 0),
                                          term)
        result.upload_tiles = {
            kind: sum(s.config.engine.upload_stats[f"{kind}_tiles"]
                      for s in scheds.values())
            for kind in ("full", "delta", "reuse")}
        result.leaders_at_end = {
            "scheduler": active(scheds)[0] or "",
            "controller-manager": active(managers)[0] or ""}
        result.counters = {
            name: round(global_metrics.counter_sum(name) - base[name], 1)
            for name in _GATED_COUNTERS}
        if not ok:
            reg = ctx["registry"]
            pods, _ = reg.list("pods", "default",
                               label_selector="app=crash")
            live = [p for p in pods
                    if p.metadata.deletion_timestamp is None]
            result.detail = (
                f"{len(live)}/{replicas} live, "
                f"{sum(1 for p in live if p.spec.node_name)} bound, "
                f"{sum(1 for p in live if p.status.phase == 'Running')} "
                f"running")
        return result
    finally:
        sys.setswitchinterval(prev_switch)
        stop_tracker.set()
        for m in managers.values():
            m.stop()
        for s in scheds.values():
            s.stop()
        for k, f in factories.items():
            if k not in dead_factories:
                f.stop()
        fleet.stop()
        srv.stop()
        ctx["store"].wal_close()
        if own_tmp:
            import shutil
            shutil.rmtree(wal_dir, ignore_errors=True)


# ------------------------------------------------------------ WAL bench

def run_wal_bench(n_records: int = 5000,
                  wal_dir: Optional[str] = None) -> Dict:
    """The fsync-policy A/B plus recovery timing: a create storm against
    a WAL-backed store under each policy, then a recovery replay of the
    `batch` arm measuring wall-clock and replayed records/s."""
    import shutil

    out: Dict = {"records": n_records}
    base = wal_dir or tempfile.mkdtemp(prefix="kube-walbench-")
    keep_dir = None
    try:
        for policy in ("always", "batch"):
            d = os.path.join(base, policy)
            st = Store(wal_dir=d, fsync_policy=policy)
            t0 = time.monotonic()
            for i in range(n_records):
                st.create(f"/registry/pods/default/w{i:06d}",
                          _bench_pod(i))
            elapsed = time.monotonic() - t0
            st.wal_close()
            out[policy] = {
                "elapsed_s": round(elapsed, 3),
                "records_per_sec": round(n_records / elapsed, 1)}
            keep_dir = d if policy == "batch" else keep_dir
        rec = Store.recover(keep_dir)
        stats = rec.recovery_stats
        out["recovery"] = {
            "wall_s": stats["seconds"],
            "replayed_records": stats["replayed_records"],
            "replayed_records_per_sec": round(
                stats["replayed_records"] / stats["seconds"], 1)
            if stats["seconds"] else None,
            "recovered_revision": stats["recovered_revision"]}
        rec.wal_close()
        return out
    finally:
        if wal_dir is None:
            shutil.rmtree(base, ignore_errors=True)
