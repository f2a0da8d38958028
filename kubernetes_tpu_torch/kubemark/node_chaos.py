"""Node-kill soak: the fleet-scale node-failure acceptance harness.

Stands up the full in-proc stack — registry, hollow fleet, batch
scheduler, replication manager, node-lifecycle controller — with every
component client wrapped in the seeded API-fault injector, runs an RC
to steady state, then hard-kills a seeded fraction of the fleet
mid-run (chaos.NodeFaultPlan -> HollowFleet.kill_nodes) and measures
recovery:

  kill -> stale heartbeats -> NodeController marks Unknown -> the
  scheduler's sched_ok mask retires the nodes -> uid-preconditioned
  eviction drains their pods -> the RC recreates -> the scheduler
  rebinds onto live nodes -> the fleet confirms Running.

Convergence gates (the node-failure acceptance bar): every RC replica
Running on a LIVE node, zero pods anywhere still bound to a dead node,
and the applied kill set equal to the plan's pure replay (same seed ->
identical schedule). Shared verbatim by the pytest soak
(tests/test_torch_chaos.py) and chip_smoke.py's node_chaos phase, so
the number the record carries is exactly the invariant the test
enforces.

The port's copy: the batch loop's engine runs on the CUDA device unless
the caller passes `device` (the tests pass device="cpu"). The partition
gate runs no scheduler; it takes `device` all the same, so that no
entry point of this module runs without a card unless one is named.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from ..api.client import InProcClient
from ..api.registry import Registry
from ..chaos import ChaosClient, FaultPlan, NodeChaos, NodeFaultPlan
from ..controllers.node import NodeController
from ..controllers.replication import ReplicationManager
from ..core import types as api
from ..core.errors import AlreadyExists
from ..utils.clock import REAL, Clock
from ..sched.batch import BatchScheduler
from ..sched.device.engine import resolve_device
from ..sched.factory import ConfigFactory
from .benchmark import _bench_pod
from .fleet import HollowFleet


@dataclass
class NodeKillResult:
    converged: bool
    n_nodes: int
    replicas: int
    killed: List[str] = field(default_factory=list)
    #: seconds from RC creation to the kill
    kill_at_s: float = 0.0
    #: seconds from the kill to convergence (the recovery time)
    converge_s: float = 0.0
    #: pods the NodeController deleted off dead nodes
    evictions: int = 0
    #: bindings committed after the kill (replacement placements)
    rebinds: int = 0
    #: pods still bound to dead nodes at quiesce (gate: 0)
    dead_bound: int = 0
    #: times the partition valve engaged during the run (expected 0 for
    #: a sub-threshold kill; the partition gate drives it explicitly)
    partition_halts: int = 0
    #: the applied kill set equals the plan's pure replay
    schedule_replayed: bool = True
    #: why convergence failed, for the assertion message
    detail: str = ""

    def as_dict(self) -> Dict:
        return asdict(self)


def run_node_kill_soak(n_nodes: int = 40, replicas: int = 30,
                       kill_fraction: float = 0.10, seed: int = 0,
                       fault_rate: float = 0.05,
                       timeout: float = 120.0,
                       heartbeat_interval: float = 0.5,
                       monitor_period: float = 0.1,
                       monitor_grace_period: float = 1.5,
                       pod_eviction_timeout: float = 0.3,
                       registry: Optional[Registry] = None,
                       clock: Optional[Clock] = None,
                       device=None) -> NodeKillResult:
    """One seeded node-kill soak; see the module docstring for the
    scenario. Timing knobs default to soak-compressed values (the
    production defaults would make recovery a 5+ minute wait).
    device: where the batch engine runs; None is the CUDA device and
    raises without one."""
    device = resolve_device(device)
    clock = clock or REAL
    registry = registry or Registry()
    plan = FaultPlan(seed=seed, error_rate=fault_rate)
    client = ChaosClient(InProcClient(registry), plan)
    node_plan = NodeFaultPlan(seed=seed, kill_fraction=kill_fraction)

    fleet = HollowFleet(client, n_nodes,
                        heartbeat_interval=heartbeat_interval,
                        jitter_seed=seed).run()
    factory = ConfigFactory(client, rate_limit=False).start()
    sched = BatchScheduler(factory.create_batch(device=device)).run()
    rc_mgr = ReplicationManager(client).run()
    # eviction limiter opened up: the soak's compressed timings would
    # otherwise spend minutes draining at the production 0.1 qps
    node_ctl = NodeController(
        client, monitor_period=monitor_period,
        monitor_grace_period=monitor_grace_period,
        pod_eviction_timeout=pod_eviction_timeout,
        eviction_qps=1000.0, eviction_burst=1000).run()
    chaos_nodes = NodeChaos(fleet, node_plan)
    result = NodeKillResult(converged=False, n_nodes=n_nodes,
                            replicas=replicas)

    # rebind counter rides the scheduler's own scheduled-pod informer
    # (one ADDED per committed binding — the reflector's field selector
    # admits a pod only once it is bound)
    post_kill = {"armed": False, "count": 0}

    def count_rebind(pod):
        if post_kill["armed"] and pod.spec.node_name:
            post_kill["count"] += 1

    factory.scheduled_observers.append(count_rebind)

    def wait_until(cond, deadline):
        while clock.monotonic() < deadline:
            if cond():
                return True
            clock.sleep(0.05)
        return cond()

    try:
        deadline = clock.monotonic() + timeout
        if not wait_until(
                lambda: len(factory.node_lister.list()) >= n_nodes,
                deadline):
            result.detail = "fleet never registered"
            return result

        rc = api.ReplicationController(
            metadata=api.ObjectMeta(name="nodekill", namespace="default"),
            spec=api.ReplicationControllerSpec(
                replicas=replicas, selector={"app": "nodekill"},
                template=api.PodTemplateSpec(
                    metadata=api.ObjectMeta(labels={"app": "nodekill"}),
                    spec=_bench_pod(0).spec)))
        t0 = clock.monotonic()
        while True:  # RC creation rides the fault injector too
            try:
                client.create("replicationcontrollers", rc)
                break
            except AlreadyExists:
                break  # a replayed create already committed the RC
            except Exception:
                if clock.monotonic() > deadline:
                    result.detail = "rc create never landed"
                    return result
                clock.sleep(0.05)

        def live_pods():
            pods, _ = registry.list("pods", "default",
                                    label_selector="app=nodekill")
            return [p for p in pods if p.metadata.deletion_timestamp is None]

        def bound_count():
            return sum(1 for p in live_pods() if p.spec.node_name)

        # steady in-flight state before the kill: at least half placed
        if not wait_until(lambda: bound_count() >= replicas // 2,
                          deadline):
            result.detail = "never reached half-bound before kill"
            return result

        result.kill_at_s = round(clock.monotonic() - t0, 3)
        post_kill["armed"] = True
        killed = chaos_nodes.kill()
        t_kill = clock.monotonic()
        result.killed = killed
        result.schedule_replayed = (
            killed == node_plan.kill_set(fleet.node_names())
            == node_plan.schedule(fleet.node_names())["kill"])
        dead = set(killed)

        def converged():
            pods = live_pods()
            if len(pods) != replicas:
                return False
            if not all(p.spec.node_name and p.spec.node_name not in dead
                       and p.status.phase == "Running" for p in pods):
                return False
            # the fleet-wide quiesce gate: NOTHING (any namespace,
            # terminating or not) still bound to a dead node
            all_pods, _ = registry.list("pods", "default")
            return not any(p.spec.node_name in dead for p in all_pods)

        ok = wait_until(converged, deadline)
        result.converge_s = round(clock.monotonic() - t_kill, 3)
        result.converged = ok
        result.evictions = node_ctl.evictions_total
        result.partition_halts = node_ctl.partition_halts_total
        result.rebinds = post_kill["count"]
        all_pods, _ = registry.list("pods", "default")
        result.dead_bound = sum(1 for p in all_pods
                                if p.spec.node_name in dead)
        if not ok:
            pods = live_pods()
            result.detail = (
                f"{len(pods)}/{replicas} live, "
                f"{sum(1 for p in pods if p.status.phase == 'Running')} "
                f"running, {result.dead_bound} on dead nodes")
        return result
    finally:
        factory.scheduled_observers.remove(count_rebind)
        chaos_nodes.stop()
        node_ctl.stop()
        rc_mgr.stop()
        sched.stop()
        factory.stop()
        fleet.stop()


def run_partition_gate(n_nodes: int = 20, freeze_fraction: float = 0.6,
                       seed: int = 0, timeout: float = 60.0,
                       heartbeat_interval: float = 0.3,
                       monitor_period: float = 0.1,
                       monitor_grace_period: float = 1.0,
                       pod_eviction_timeout: float = 0.2,
                       clock: Optional[Clock] = None,
                       device=None) -> Dict:
    """The partition safety-valve acceptance: freeze the heartbeats of
    > unhealthy_threshold of the fleet at once -> the NodeController
    must HALT evictions (zero pods deleted while halted), then resume
    after the heartbeats thaw. Returns the observations the test (and
    anyone replaying the README workflow) asserts on. device: as in
    run_node_kill_soak (None is the CUDA device and raises without
    one); nothing here runs on it."""
    resolve_device(device)
    clock = clock or REAL
    registry = Registry()
    client = InProcClient(registry)
    fleet = HollowFleet(client, n_nodes,
                        heartbeat_interval=heartbeat_interval,
                        jitter_seed=seed).run()
    node_ctl = NodeController(
        client, monitor_period=monitor_period,
        monitor_grace_period=monitor_grace_period,
        pod_eviction_timeout=pod_eviction_timeout,
        eviction_qps=1000.0, eviction_burst=1000).run()
    plan = NodeFaultPlan(seed=seed, freeze_fraction=freeze_fraction)
    chaos_nodes = NodeChaos(fleet, plan)
    out = {"halted": False, "evictions_while_halted": 0,
           "resumed": False, "halts": 0, "frozen": []}

    def wait_until(cond, t):
        deadline = clock.monotonic() + t
        while clock.monotonic() < deadline:
            if cond():
                return True
            clock.sleep(0.05)
        return cond()

    try:
        if not wait_until(
                lambda: len(registry.list("nodes")[0]) >= n_nodes,
                timeout / 3):
            return out
        # a victim pod on a frozen node: were the valve broken, the
        # mass-Unknown marking would evict it
        victim_host = sorted(plan.freeze_set(fleet.node_names()))[0]
        pod = _bench_pod(0)
        pod.spec.node_name = victim_host
        client.create("pods", pod)

        out["frozen"] = chaos_nodes.freeze()
        halted = wait_until(lambda: node_ctl.evictions_halted, timeout / 3)
        out["halted"] = halted
        # hold the partition well past grace + eviction timeout: zero
        # evictions may be issued while the valve is engaged
        clock.sleep(3 * (monitor_grace_period + pod_eviction_timeout))
        out["evictions_while_halted"] = node_ctl.evictions_total
        chaos_nodes.thaw()
        out["resumed"] = wait_until(
            lambda: not node_ctl.evictions_halted, timeout / 3)
        out["halts"] = node_ctl.partition_halts_total
        return out
    finally:
        chaos_nodes.stop()
        node_ctl.stop()
        fleet.stop()
