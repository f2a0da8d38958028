"""The port's chaos package, controllers and chaos harnesses against the
JAX package's (kubernetes_tpu_torch/chaos, controllers, kubemark/
node_chaos.py, the benchmark's chaos arm, obs/flightrec.py).

Cross-package: for seeds 0-9 the port's plans make the same decisions
as the JAX package's (FaultPlan per verb, CrashPlan, ShardKillPlan,
NodeFaultPlan, WorkloadPlan), the same scripted calls through both
ChaosClients draw the same traces and outcomes, and a FlightRecorder
bundle is byte-equal. Then the tests of tests/test_chaos.py, ported:
the plans' determinism, watch cuts, the chaos soak (its invariants over
ApiServer and HttpClient, and over InProcClient), the node-kill soak
(40 nodes), the partition gate and the process-crash soak (6 nodes, 24
replicas; its two-invocation repro is marked slow as in the JAX file);
and the benchmark's chaos arm with every pod bound exactly once; and the
hollow fleet confirming Running over several calls at once. All on the
CPU (device="cpu"); without a device named, every entry point needs a
CUDA device and raises without one."""

import dataclasses
import os
import threading
import time

import pytest
import torch

from kubernetes_tpu.api.client import InProcClient as JaxClient
from kubernetes_tpu.api.registry import Registry as JaxRegistry
from kubernetes_tpu.chaos import ChaosClient as JaxChaosClient
from kubernetes_tpu.chaos import CrashChaos as JaxCrashChaos
from kubernetes_tpu.chaos import CrashPlan as JaxCrashPlan
from kubernetes_tpu.chaos import FaultPlan as JaxFaultPlan
from kubernetes_tpu.chaos import NodeFaultPlan as JaxNodeFaultPlan
from kubernetes_tpu.chaos import WorkloadPlan as JaxWorkloadPlan
from kubernetes_tpu.chaos import VERBS as JAX_VERBS
from kubernetes_tpu.chaos import __all__ as JAX_CHAOS_ALL
from kubernetes_tpu.chaos.crash import ShardKillPlan as JaxShardKillPlan
from kubernetes_tpu.obs.flightrec import FlightRecorder as JaxRecorder
from kubernetes_tpu.utils.clock import FakeClock as JaxClock
from kubernetes_tpu_torch import chaos as port_chaos
from kubernetes_tpu_torch.api.cache import Informer
from kubernetes_tpu_torch.api.client import InProcClient
from kubernetes_tpu_torch.api.registry import Registry
from kubernetes_tpu_torch.chaos import (VERBS, ChaosClient, CrashChaos,
                                        CrashPlan, FaultPlan, NodeFaultPlan,
                                        WorkloadPlan)
from kubernetes_tpu_torch.chaos.crash import ShardKillPlan
from kubernetes_tpu_torch.kubemark import fixtures as fx
from kubernetes_tpu_torch.obs.flightrec import FlightRecorder
from kubernetes_tpu_torch.utils.clock import FakeClock

from test_chaos import mkpod as jax_mkpod
from test_torch_encode import cross

SEEDS = range(10)
NAMES = [f"hollow-{i:05d}" for i in range(50)]


def mkpod(name, labels=None):
    return cross([jax_mkpod(name, labels)])[0]


def wait_until(cond, timeout=60.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


# ------------------------------------------------- plans, cross-package

def test_chaos_package_exports_the_jax_list():
    assert sorted(port_chaos.__all__) == sorted(JAX_CHAOS_ALL)
    assert port_chaos.VERBS == JAX_VERBS


def test_chaos_client_wraps_exactly_the_jax_verbs():
    """Every method the JAX ChaosClient defines, the port's defines, and
    no other: the same verbs draw from the same streams."""
    assert sorted(vars(ChaosClient)) == sorted(vars(JaxChaosClient))


@pytest.mark.chaos
@pytest.mark.parametrize("seed", SEEDS)
def test_fault_plan_decisions_match_jax(seed):
    """Per verb, the first 64 decisions (fault and injected delay) and
    the pure schedule replay, with faults and latency both drawn."""
    kw = dict(seed=seed, error_rate=0.3, verb_rates={"watch": 0.6},
              latency_rate=0.4, latency=0.25)
    port, ref = FaultPlan(**kw), JaxFaultPlan(**kw)
    for verb in VERBS:
        rng, ref_rng = port.stream(verb), ref.stream(verb)
        rate = port.rate_for(verb)
        assert rate == ref.rate_for(verb)
        assert [port.draw(rng, rate) for _ in range(64)] == \
            [ref.draw(ref_rng, rate) for _ in range(64)], verb
        assert port.schedule(verb, 64) == ref.schedule(verb, 64), verb


def _drive(chaos_cls, plan, inner, pod):
    """A fixed single-threaded call script through a ChaosClient over
    `inner` -> (trace, outcomes)."""
    chaos = chaos_cls(inner, plan)
    outcomes = []
    for i in range(40):
        for call in (lambda: chaos.create("pods", pod(f"d-{i:02d}")),
                     lambda: chaos.list("pods", "default"),
                     lambda: chaos.get("pods", f"d-{i:02d}", "default"),
                     lambda: chaos.delete("pods", f"d-{i // 2:02d}",
                                          "default")):
            try:
                call()
                outcomes.append("ok")
            except Exception as e:
                outcomes.append(type(e).__name__)
    return chaos.trace(), outcomes


@pytest.mark.chaos
@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_client_trace_matches_jax(seed):
    """The same script through both ChaosClients over their in-process
    registries: the same draws per verb and the same outcome per call
    (an injected fault, a NotFound, or ok)."""
    port = _drive(ChaosClient, FaultPlan(seed=seed, error_rate=0.3),
                  InProcClient(Registry()), mkpod)
    ref = _drive(JaxChaosClient, JaxFaultPlan(seed=seed, error_rate=0.3),
                 JaxClient(JaxRegistry()), jax_mkpod)
    assert port == ref


@pytest.mark.chaos
@pytest.mark.parametrize("seed", SEEDS)
def test_crash_and_shard_kill_plans_match_jax(seed):
    for total in (10, 100, 30000):
        assert CrashPlan(seed=seed).schedule(total) == \
            JaxCrashPlan(seed=seed).schedule(total)
        assert CrashPlan(seed=seed).order(total) == \
            JaxCrashPlan(seed=seed).order(total)
    for n_shards, kills in ((4, 1), (6, 2), (8, 3)):
        port = ShardKillPlan(seed=seed, n_shards=n_shards, kills=kills)
        ref = JaxShardKillPlan(seed=seed, n_shards=n_shards, kills=kills)
        assert port.victims() == ref.victims()
        for total in (48, 256, 30000):
            assert port.schedule(total) == ref.schedule(total)
            assert port.order(total) == ref.order(total)


@pytest.mark.chaos
@pytest.mark.parametrize("seed", SEEDS)
def test_node_fault_plan_matches_jax(seed):
    kw = dict(seed=seed, kill_fraction=0.1, freeze_fraction=0.6,
              flap_fraction=0.2)
    port, ref = NodeFaultPlan(**kw), JaxNodeFaultPlan(**kw)
    fleet = [f"hollow-{i:05d}" for i in range(1000)]
    for names in (NAMES, fleet):
        assert port.kill_set(names) == ref.kill_set(names)
        assert port.schedule(names) == ref.schedule(names)


@pytest.mark.chaos
@pytest.mark.parametrize("seed", SEEDS)
def test_workload_plan_events_match_jax(seed):
    port, ref = WorkloadPlan(seed=seed), JaxWorkloadPlan(seed=seed)
    assert [dataclasses.astuple(e) for e in port.events()] == \
        [dataclasses.astuple(e) for e in ref.events()]
    assert {g: [dataclasses.astuple(e) for e in evs]
            for g, evs in port.schedule().items()} == \
        {g: [dataclasses.astuple(e) for e in evs]
         for g, evs in ref.schedule().items()}
    assert port.demand_curve() == ref.demand_curve()
    assert port.expected_services() == ref.expected_services()
    assert port.final_ds_selector() == ref.final_ds_selector()
    assert port.surge_tick() == ref.surge_tick()


# ------------------------------------------------------ flight recorder

def _bundles(recorder_cls, clock_cls, crash_chaos_cls, plan_cls, root):
    """Two bundles and one over capacity, under a FakeClock -> the
    recorder and every file's bytes, by path under `root`."""
    clock = clock_cls(start=1234.5)
    rec = recorder_cls(root, clock=clock, capacity=2)
    chaos = crash_chaos_cls(plan_cls(seed=3), total=100)
    for point, target in chaos.pending()[:2]:
        chaos.record(target, point)
    rec.dump("shard-parity gate!", chaos=chaos,
             extra={"bound": 47, "victims": [1], "ok": False})
    clock.step(2.5)
    rec.dump("slo: crowd bind availability", chaos={"kill": ["n1"]},
             extra={"note": "second"})
    rec.dump("over capacity")
    files = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            path = os.path.join(d, f)
            files[os.path.relpath(path, root)] = open(path, "rb").read()
    return rec, files


def test_flight_recorder_bundle_byte_equal_to_jax(tmp_path):
    port, port_files = _bundles(FlightRecorder, FakeClock, CrashChaos,
                                CrashPlan, str(tmp_path / "port"))
    ref, ref_files = _bundles(JaxRecorder, JaxClock, JaxCrashChaos,
                              JaxCrashPlan, str(tmp_path / "jax"))
    assert len(port_files) == 4 and port_files == ref_files
    assert (port.dropped, len(port.bundles)) == (ref.dropped,
                                                 len(ref.bundles)) == (1, 2)


# --------------------------------------- determinism (test_chaos.py)

@pytest.mark.chaos
class TestDeterminism:
    def _drive(self, seed):
        """A fixed single-threaded call script; returns the trace."""
        plan = FaultPlan(seed=seed, error_rate=0.3)
        chaos = ChaosClient(InProcClient(Registry()), plan)
        outcomes = []
        for i in range(40):
            try:
                chaos.create("pods", mkpod(f"d-{i:02d}"))
                outcomes.append("ok")
            except Exception as e:
                outcomes.append(type(e).__name__)
            try:
                chaos.list("pods", "default")
                outcomes.append("ok")
            except Exception as e:
                outcomes.append(type(e).__name__)
        return plan, chaos.trace(), outcomes

    def test_same_seed_bit_identical_runs(self):
        plan, trace_a, out_a = self._drive(seed=1234)
        _, trace_b, out_b = self._drive(seed=1234)
        assert trace_a == trace_b
        assert out_a == out_b
        for verb in ("create", "list"):
            assert trace_a[verb] == plan.schedule(verb, len(trace_a[verb]))

    def test_different_seeds_differ(self):
        _, trace_a, _ = self._drive(seed=1)
        _, trace_b, _ = self._drive(seed=2)
        assert trace_a != trace_b

    def test_schedule_independent_of_cross_verb_interleaving(self):
        plan = FaultPlan(seed=7, error_rate=0.5)
        chaos = ChaosClient(InProcClient(Registry()), plan)
        registry_pod = mkpod("x")

        def hammer(verb):
            for _ in range(50):
                try:
                    if verb == "create":
                        chaos.create("pods", registry_pod)
                    else:
                        chaos.get("pods", "x", "default")
                except Exception:
                    pass

        threads = [threading.Thread(target=hammer, args=(v,))
                   for v in ("create", "get")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        trace = chaos.trace()
        assert trace["create"] == plan.schedule("create", 50)
        assert trace["get"] == plan.schedule("get", 50)

    def test_draw_always_consumes_four(self):
        """A decision is a function of its index alone: faulting and
        clean calls consume identical RNG amounts."""
        plan_hot = FaultPlan(seed=9, error_rate=1.0)
        plan_cold = FaultPlan(seed=9, error_rate=0.0)
        rng_hot, rng_cold = plan_hot.stream("get"), plan_cold.stream("get")
        for _ in range(20):
            plan_hot.draw(rng_hot, 1.0)
            plan_cold.draw(rng_cold, 0.0)
        assert rng_hot.random() == rng_cold.random()


@pytest.mark.chaos
class TestWatchCuts:
    def test_watch_cut_after_n_events(self):
        plan = FaultPlan(seed=0, watch_cut_after=3)
        chaos = ChaosClient(InProcClient(Registry()), plan)
        w = chaos.watch("pods", "default")
        for i in range(5):
            chaos.create("pods", mkpod(f"c-{i}"))
        seen = [ev.type for ev in w]
        assert seen[:3] == ["ADDED"] * 3
        assert "ERROR" in seen
        assert w.failed

    def test_forced_cut_and_informer_recovery(self):
        chaos = ChaosClient(InProcClient(Registry()), FaultPlan(seed=0))
        seen = {}
        informer = Informer(chaos, "pods",
                            on_add=lambda p: seen.setdefault(
                                p.metadata.name, True)).start()
        try:
            assert wait_until(lambda: informer.has_synced)
            chaos.create("pods", mkpod("before"))
            assert wait_until(lambda: "before" in seen)
            assert chaos.cut_watches() >= 1
            chaos.create("pods", mkpod("after"))
            assert wait_until(lambda: "after" in seen)
            assert informer.reflector.reconnects >= 1
        finally:
            informer.stop()


@pytest.mark.chaos
class TestNodeFaultPlanDeterminism:
    def test_same_seed_same_victims(self):
        a = NodeFaultPlan(seed=11, kill_fraction=0.2)
        b = NodeFaultPlan(seed=11, kill_fraction=0.2)
        assert a.kill_set(NAMES) == b.kill_set(NAMES)
        assert a.schedule(NAMES) == b.schedule(NAMES)

    def test_selection_independent_of_name_order(self):
        plan = NodeFaultPlan(seed=11, kill_fraction=0.2)
        assert plan.kill_set(NAMES) == plan.kill_set(list(reversed(NAMES)))

    def test_streams_independent(self):
        kill_only = NodeFaultPlan(seed=5, kill_fraction=0.1)
        both = NodeFaultPlan(seed=5, kill_fraction=0.1, freeze_fraction=0.5)
        assert kill_only.kill_set(NAMES) == both.kill_set(NAMES)

    def test_different_seeds_differ(self):
        a = NodeFaultPlan(seed=1, kill_fraction=0.2)
        b = NodeFaultPlan(seed=2, kill_fraction=0.2)
        assert a.kill_set(NAMES) != b.kill_set(NAMES)


@pytest.mark.chaos
class TestCrashPlanDeterminism:
    def test_same_seed_same_schedule(self):
        a, b = CrashPlan(seed=9), CrashPlan(seed=9)
        assert a.schedule(100) == b.schedule(100)
        assert a.order(100) == b.order(100)

    def test_different_seeds_differ(self):
        assert CrashPlan(seed=1).schedule(100) != \
            CrashPlan(seed=2).schedule(100)

    def test_streams_independent_of_target_set(self):
        full = CrashPlan(seed=7)
        solo = CrashPlan(seed=7, targets=("scheduler",))
        assert full.schedule(200)["scheduler"] == \
            solo.schedule(200)["scheduler"]

    def test_kill_points_interrupt_the_run(self):
        for seed in range(20):
            for t, p in CrashPlan(seed=seed).schedule(10).items():
                assert 1 <= p <= 9, (seed, t, p)


# ----------------------------------------------------------- chaos soak

@pytest.mark.chaos
@pytest.mark.parametrize("transport", ["inproc", "http"])
def test_chaos_soak_converges_with_single_bindings(transport):
    """Seeded 5% faults on all verbs + one forced watch cut: the RC
    reaches desired replicas, every scheduled pod holds exactly one
    binding, and the run's fault schedule is the seed's pure replay.
    tests/test_chaos.py's soak body (fixtures.run_chaos_soak), over
    ApiServer and HttpClient as the JAX soak runs it, and over
    InProcClient. The JAX soak also runs the store's locks under the
    lock-order witness; the port has no lint package, so that check
    stays out here."""
    ok, rebinds, pods, trace, plan = fx.run_chaos_soak(
        seed=42, transport=transport, device="cpu")
    assert ok, [(p.metadata.name, p.spec.node_name, p.status.phase)
                for p in pods]
    assert rebinds == [], rebinds
    for verb in VERBS:
        assert trace[verb] == plan.schedule(verb, len(trace[verb])), verb
    assert any(trace[verb] for verb in VERBS)


# ------------------------------------------------------- node-kill chaos

@pytest.mark.chaos
def test_node_kill_soak_converges_off_dead_nodes():
    """5% API faults on every verb, 10% of the hollow fleet hard-killed
    mid-run: every replica Running on a live node, zero pods still bound
    to a dead node, the applied kill set the seed's pure replay."""
    from kubernetes_tpu_torch.kubemark.node_chaos import run_node_kill_soak
    r = run_node_kill_soak(n_nodes=40, replicas=30, kill_fraction=0.10,
                           seed=1205, fault_rate=0.05, timeout=120,
                           device="cpu")
    assert r.converged, r.as_dict()
    assert r.dead_bound == 0
    assert r.killed and len(r.killed) == 4
    assert r.killed == JaxNodeFaultPlan(
        seed=1205, kill_fraction=0.10).kill_set(
            [f"hollow-{i:05d}" for i in range(40)])
    assert r.schedule_replayed
    assert r.evictions >= 1
    assert r.rebinds >= 1


@pytest.mark.chaos
def test_partition_gate_halts_and_resumes_evictions():
    from kubernetes_tpu_torch.kubemark.node_chaos import run_partition_gate
    out = run_partition_gate(n_nodes=20, freeze_fraction=0.6, seed=3,
                             device="cpu")
    assert out["halted"], out
    assert out["evictions_while_halted"] == 0
    assert out["resumed"], out
    assert out["halts"] >= 1
    assert len(out["frozen"]) == 12
    assert out["frozen"] == JaxNodeFaultPlan(
        seed=3, freeze_fraction=0.6).freeze_set(
            [f"hollow-{i:05d}" for i in range(20)])


# -------------------------------------------- the benchmark's chaos arm

@pytest.mark.chaos
def test_benchmark_chaos_arm_binds_every_pod_exactly_once():
    """run_scheduling_benchmark(chaos_seed=...) at 200 nodes x 2000 pods:
    every pod bound, each binding observed once and never re-pointed."""
    from kubernetes_tpu_torch.kubemark.benchmark import \
        run_scheduling_benchmark
    registry = Registry()
    bound_to, rebinds = {}, []
    watcher = InProcClient(registry).watch("pods", "default")

    def track():
        for ev in watcher:
            pod = ev.object
            if ev.type == "DELETED" or not pod.spec.node_name:
                continue
            prev = bound_to.get(pod.metadata.uid)
            if prev is not None and prev != pod.spec.node_name:
                rebinds.append(pod.metadata.name)
            bound_to[pod.metadata.uid] = pod.spec.node_name

    tracker = threading.Thread(target=track, daemon=True)
    tracker.start()
    try:
        r = run_scheduling_benchmark(200, 2000, "batch", registry=registry,
                                     chaos_seed=1, chaos_error_rate=0.01,
                                     device="cpu")
        assert wait_until(lambda: len(bound_to) >= 2000, timeout=30)
    finally:
        watcher.stop()
    pods, _ = registry.list("pods", "default")
    assert r.scheduled == 2000
    assert len(pods) == 2000 and all(p.spec.node_name for p in pods)
    assert len(bound_to) == 2000 and rebinds == []


# ------------------------------------------------ process-crash soak

def _assert_crash_soak_gates(r):
    """tests/test_chaos.py's crash-soak assertions, on the port's
    result, plus the killed scheduler reaped and both engines on the
    device the run named."""
    assert r.converged, r.as_dict()
    # apiserver kill: recovery is the pre-crash ledger prefix
    assert r.recovery, "apiserver kill never fired"
    assert r.recovery["revision_match"], r.recovery
    assert r.recovery["live_set_match"], r.recovery
    assert r.recovery["replayed_records"] >= 1
    # scheduler/manager kills: standbys took over, exactly-once binds
    assert r.duplicate_bindings == []
    assert r.term_violations == []
    assert set(r.killed) == {"apiserver", "scheduler",
                             "controller-manager"}
    assert r.schedule_replayed, (r.killed, r.schedule)
    assert r.terms["batch-scheduler"] >= 2
    assert r.terms["controller-manager"] >= 2
    assert r.counters["wal_records_total"] >= 1
    assert r.counters["wal_recoveries_total"] >= 1
    assert r.counters["leader_transitions_total"] >= 4
    assert r.counters["lease_renew_failures_total"] >= 1
    assert r.reaped
    assert r.engine_devices == {"a": "cpu", "b": "cpu"}


@pytest.mark.chaos
@pytest.mark.durability
def test_crash_soak_survives_control_plane_kills():
    """tests/test_chaos.py's crash soak on the port at its own shape (6
    nodes, 24 replicas): WAL-backed store, redundant schedulers and
    controller-managers under lease election, 5% API faults, and a
    seeded CrashPlan killing the apiserver, the active scheduler and the
    active controller-manager; the kill schedule is the JAX CrashPlan's."""
    from kubernetes_tpu_torch.kubemark.crash_soak import run_crash_soak
    r = run_crash_soak(n_nodes=6, replicas=24, seed=0, fault_rate=0.05,
                       timeout=150, device="cpu")
    _assert_crash_soak_gates(r)
    assert r.schedule == JaxCrashPlan(seed=0).schedule(24)


@pytest.mark.chaos
@pytest.mark.durability
@pytest.mark.slow
def test_crash_soak_reproducible_across_invocations():
    """The long gate, on the port: two crash soaks with one seed both
    converge with no duplicate binding or term violation and apply the
    same kill schedule."""
    from kubernetes_tpu_torch.kubemark.crash_soak import run_crash_soak
    results = [run_crash_soak(n_nodes=6, replicas=24, seed=1337,
                              fault_rate=0.05, timeout=150, device="cpu")
               for _ in range(2)]
    for r in results:
        assert r.converged, r.as_dict()
        assert r.duplicate_bindings == []
        assert r.term_violations == []
        assert r.schedule_replayed
        assert r.recovery["revision_match"], r.recovery
        assert r.recovery["live_set_match"], r.recovery
    a, b = results
    assert a.killed == b.killed == a.schedule


# ---------------------------------------------------- no card, no run

@pytest.mark.parametrize("entry", ["soak", "shard_soak", "node_kill",
                                   "partition", "chaos_arm", "platform",
                                   "crash_soak"])
def test_entry_points_refuse_to_run_without_a_card(monkeypatch, entry):
    from kubernetes_tpu_torch.kubemark import (crash_soak, node_chaos,
                                               shard_soak, soak)
    from kubernetes_tpu_torch.kubemark.benchmark import \
        run_scheduling_benchmark
    from kubernetes_tpu_torch.utils.platform import pick_device
    calls = {"soak": lambda: soak.run_soak(duration_s=1.0, n_nodes=2),
             "shard_soak": shard_soak.run_shard_kill_soak,
             "node_kill": lambda: node_chaos.run_node_kill_soak(n_nodes=2),
             "partition": lambda: node_chaos.run_partition_gate(n_nodes=2),
             "chaos_arm": lambda: run_scheduling_benchmark(2, 1,
                                                           chaos_seed=1),
             "platform": pick_device,
             "crash_soak": lambda: crash_soak.run_crash_soak(n_nodes=2)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    threads = threading.active_count()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert threading.active_count() == threads  # nothing was started


def test_fleet_confirms_over_http_on_several_workers():
    """HollowFleet(confirm_workers=4) over an HttpClient (no status
    batching on the wire): a burst of bound pods is confirmed Running
    by four calls side by side, every pod once, and the pool stops with
    the fleet."""
    from kubernetes_tpu_torch.api.client import HttpClient
    from kubernetes_tpu_torch.api.server import ApiServer
    from kubernetes_tpu_torch.kubemark.fleet import HollowFleet
    registry = Registry()
    srv = ApiServer(registry, port=0).start()
    client = InProcClient(registry)
    fleet = HollowFleet(HttpClient(srv.url), 6, heartbeat_interval=600.0,
                        confirm_workers=4)
    names = []
    try:
        fleet.run()
        for i in range(60):
            p = mkpod(f"cw-{i:02d}")
            client.create("pods", p, "default")
            names.append(p.metadata.name)
        client.bind_batch_hosts([("default", n, f"hollow-{i % 6:05d}")
                                 for i, n in enumerate(names)])
        assert wait_until(lambda: sum(
            p.status.phase == "Running"
            for p in client.list("pods", "default")[0]) == 60, timeout=60)
        assert any(t.name.startswith("fleet-confirm")
                   for t in threading.enumerate())
    finally:
        fleet.stop()
        srv.stop()
    assert fleet.running_count() == 60
