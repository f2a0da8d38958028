"""The port's NodeController (kubernetes_tpu_torch/controllers/node.py)
through the JAX package's lifecycle suite (tests/test_node_controller.py):
stale-heartbeat -> Unknown -> rate-limited eviction, recovery cancelling
eviction, transient delete-failure requeue, the partition safety valve
(halt/resume), flap damping, and the uid-preconditioned eviction that
spares a racing replacement pod. The nodes and pods are the JAX suite's
fixtures, carried over the wire into the port's types.

Pattern follows nodecontroller_test.go: the controller against the
in-proc registry with a fake clock driving the monitor ticks."""

import pytest

from kubernetes_tpu_torch.api.client import InProcClient
from kubernetes_tpu_torch.api.registry import Registry
from kubernetes_tpu_torch.controllers import NodeController
from kubernetes_tpu_torch.core import types as api
from kubernetes_tpu_torch.utils.clock import FakeClock

from test_sched_e2e import pending_pod as jax_pending_pod
from test_sched_e2e import ready_node as jax_ready_node
from test_torch_encode import cross


def ready_node(name):
    return cross([jax_ready_node(name)])[0]


def pending_pod(name):
    return cross([jax_pending_pod(name)])[0]


@pytest.fixture()
def cluster():
    registry = Registry()
    yield registry, InProcClient(registry)


def hb_node(name, ts):
    n = ready_node(name)
    for c in n.status.conditions:
        c.last_heartbeat_time = ts
    return n


def beat(client, name, ts, ready="True"):
    """Refresh a node's reported heartbeat (and optionally its Ready
    status) — what a live kubelet's status sync does."""
    node = client.get("nodes", name)
    node.status.conditions = [
        api.NodeCondition(type="Ready", status=ready,
                          last_heartbeat_time=ts),
        api.NodeCondition(type="OutOfDisk", status="False",
                          last_heartbeat_time=ts)]
    client.update_status("nodes", node)


def bound_pod(name, node):
    pod = pending_pod(name)
    pod.spec.node_name = node
    return pod


def pod_names(client):
    return {p.metadata.name for p in client.list("pods", "default")[0]}


class TestEvictionLifecycle:
    def test_stale_heartbeat_unknown_then_rate_limited_eviction(
            self, cluster):
        """Two dead nodes, eviction burst of 1: the first drain evicts
        one node's pods, the second node waits for the limiter's
        refill — the reference's RateLimitedTimedQueue behavior."""
        _, client = cluster
        clock = FakeClock(start=1000.0)
        nc = NodeController(client, clock=clock, monitor_grace_period=40,
                            pod_eviction_timeout=1.0,
                            eviction_qps=1.0, eviction_burst=1,
                            partition_min_cluster=99)
        for n in ("n1", "n2", "n3"):
            client.create("nodes", hb_node(n, "hb-1"))
        client.create("pods", bound_pod("p1", "n1"))
        client.create("pods", bound_pod("p2", "n2"))
        nc.monitor_once()   # baseline
        beat(client, "n3", "hb-2")
        clock.step(41)
        nc.monitor_once()   # n1/n2 stale -> Unknown (transition stamped)
        for name in ("n1", "n2"):
            conds = {c.type: c.status for c in client.get(
                "nodes", name).status.conditions}
            assert conds["Ready"] == "Unknown"
        beat(client, "n3", "hb-3")
        clock.step(2)
        nc.monitor_once()   # past eviction timeout: ONE token -> one node
        assert len(pod_names(client)) == 1
        # n1 (drained first — deterministic min-name order) recovers;
        # the next token goes to n2 (a still-dead drained node would
        # otherwise be re-queued each tick and hold the line)
        beat(client, "n1", "hb-revive")
        beat(client, "n3", "hb-4")
        clock.step(2)       # limiter refills (1 qps)
        nc.monitor_once()
        assert pod_names(client) == set()
        assert nc.evictions_total == 2

    def test_ready_again_cancels_eviction(self, cluster):
        _, client = cluster
        clock = FakeClock(start=1000.0)
        nc = NodeController(client, clock=clock, monitor_grace_period=40,
                            pod_eviction_timeout=300, eviction_qps=1000,
                            eviction_burst=1000, partition_min_cluster=99)
        client.create("nodes", hb_node("n1", "hb-1"))
        client.create("pods", bound_pod("p1", "n1"))
        nc.monitor_once()
        clock.step(41)
        nc.monitor_once()   # Unknown
        beat(client, "n1", "hb-2")  # kubelet back
        clock.step(100)
        nc.monitor_once()
        clock.step(400)     # far past the eviction timeout
        beat(client, "n1", "hb-3")
        nc.monitor_once()
        assert pod_names(client) == {"p1"}
        assert nc.evictions_total == 0

    def test_transient_delete_failure_requeues_node(self, cluster):
        """A delete that fails transiently must keep the node queued —
        the next drain retries until the pods are gone."""
        _, client = cluster

        class FlakyDelete:
            def __init__(self, inner, failures):
                self.inner = inner
                self.failures = failures

            def delete(self, *a, **kw):
                if self.failures > 0:
                    self.failures -= 1
                    raise ConnectionError("transient")
                return self.inner.delete(*a, **kw)

            def __getattr__(self, name):
                return getattr(self.inner, name)

        flaky = FlakyDelete(client, failures=2)
        clock = FakeClock(start=1000.0)
        nc = NodeController(flaky, clock=clock, monitor_grace_period=40,
                            pod_eviction_timeout=1.0, eviction_qps=1000,
                            eviction_burst=1000, partition_min_cluster=99)
        client.create("nodes", hb_node("n1", "hb-1"))
        client.create("pods", bound_pod("p1", "n1"))
        nc.monitor_once()
        clock.step(41)
        nc.monitor_once()   # Unknown
        clock.step(2)
        nc.monitor_once()   # drain 1: delete fails, node stays queued
        assert pod_names(client) == {"p1"}
        assert "n1" in nc._eviction_queue
        clock.step(1)
        nc.monitor_once()   # drain 2: fails again
        clock.step(1)
        nc.monitor_once()   # drain 3: succeeds
        assert pod_names(client) == set()


class TestPartitionValve:
    def _fleet(self, client, n):
        for i in range(n):
            client.create("nodes", hb_node(f"n{i}", "hb-1"))

    def test_mass_staleness_halts_then_resumes(self, cluster):
        """>55% of the fleet going stale at once reads as a master-side
        partition: zero evictions while halted; heartbeats recovering
        drops the fraction and eviction of the genuinely-dead node
        resumes."""
        _, client = cluster
        clock = FakeClock(start=1000.0)
        nc = NodeController(client, clock=clock, monitor_grace_period=40,
                            pod_eviction_timeout=1.0, eviction_qps=1000,
                            eviction_burst=1000)
        self._fleet(client, 10)
        client.create("pods", bound_pod("p1", "n1"))
        nc.monitor_once()
        # 6/10 go stale simultaneously (the partition); 4 keep beating
        for i in (6, 7, 8, 9):
            beat(client, f"n{i}", "hb-2")
        clock.step(41)
        nc.monitor_once()
        assert nc.evictions_halted
        assert nc.partition_halts_total == 1
        # hold the partition well past the eviction timeout: nothing dies
        for _ in range(5):
            for i in (6, 7, 8, 9):
                beat(client, f"n{i}", f"hb-{clock.now()}")
            clock.step(10)
            nc.monitor_once()
        assert nc.evictions_total == 0
        assert pod_names(client) == {"p1"}
        # partition heals for all but n1 (that one really died)
        for i in range(10):
            if i != 1:
                beat(client, f"n{i}", "hb-heal")
        nc.monitor_once()
        assert not nc.evictions_halted
        clock.step(45)
        for i in range(10):
            if i != 1:
                beat(client, f"n{i}", "hb-heal-2")
        nc.monitor_once()   # n1 stale -> Unknown
        clock.step(2)
        for i in range(10):
            if i != 1:
                beat(client, f"n{i}", "hb-heal-3")
        nc.monitor_once()   # eviction resumes for the real corpse
        assert pod_names(client) == set()
        assert nc.evictions_total == 1

    def test_small_cluster_never_halts(self, cluster):
        """A 2-node cluster losing a node is not a partition signal
        (partition_min_cluster floor)."""
        _, client = cluster
        clock = FakeClock(start=1000.0)
        nc = NodeController(client, clock=clock, monitor_grace_period=40,
                            pod_eviction_timeout=1.0, eviction_qps=1000,
                            eviction_burst=1000)
        self._fleet(client, 2)
        client.create("pods", bound_pod("p1", "n0"))
        nc.monitor_once()
        clock.step(41)
        nc.monitor_once()
        assert not nc.evictions_halted
        clock.step(2)
        nc.monitor_once()
        assert pod_names(client) == set()


class TestFlapDamping:
    def test_flapping_node_not_queued(self, cluster):
        """A node bouncing Ready<->NotReady inside the damping window is
        never queued for eviction while it flaps; once it settles
        NotReady past the window, eviction proceeds."""
        _, client = cluster
        clock = FakeClock(start=1000.0)
        nc = NodeController(client, clock=clock, monitor_grace_period=40,
                            pod_eviction_timeout=3.0, eviction_qps=1000,
                            eviction_burst=1000, partition_min_cluster=99,
                            flap_threshold=3, flap_window=60.0)
        client.create("nodes", hb_node("n1", "hb-0"))
        client.create("pods", bound_pod("p1", "n1"))
        nc.monitor_once()
        # bounce: three Ready-status flips 2s apart (all inside the
        # damping window)
        for i in range(3):
            ready = "False" if i % 2 == 0 else "True"
            beat(client, "n1", f"hb-{i + 1}", ready=ready)
            nc.monitor_once()
            clock.step(2)
        # now NotReady and held past the eviction timeout, but the
        # transitions are still inside the window: damped, not queued
        clock.step(4)
        beat(client, "n1", "hb-hold", ready="False")
        nc.monitor_once()
        assert nc.flap_damped_total > 0
        assert pod_names(client) == {"p1"}  # never evicted mid-flap
        # the node settles NotReady; the window drains the transitions
        clock.step(61)
        beat(client, "n1", "hb-settled", ready="False")
        nc.monitor_once()
        assert pod_names(client) == set()
        assert nc.evictions_total == 1


class TestUidPreconditionedEviction:
    def test_stale_drain_spares_replacement(self, cluster):
        """The drain observed uid A; by delete time the name belongs to
        a replacement (uid B). The uid-preconditioned delete Conflicts
        and the replacement survives — without it, a stale drain kills
        the fresh pod and the RC loops forever."""
        registry, client = cluster

        class StaleList:
            """Serve the pre-replacement pod list exactly once (the
            window between the drain's LIST and its DELETE)."""

            def __init__(self, inner):
                self.inner = inner
                self.stale = None

            def list(self, resource, *a, **kw):
                if resource == "pods" and self.stale is not None:
                    out, self.stale = self.stale, None
                    return out
                return self.inner.list(resource, *a, **kw)

            def __getattr__(self, name):
                return getattr(self.inner, name)

        stale_client = StaleList(client)
        clock = FakeClock(start=1000.0)
        nc = NodeController(stale_client, clock=clock,
                            monitor_grace_period=40,
                            pod_eviction_timeout=1.0, eviction_qps=1000,
                            eviction_burst=1000, partition_min_cluster=99)
        client.create("nodes", hb_node("n1", "hb-1"))
        client.create("pods", bound_pod("p1", "n1"))
        nc.monitor_once()
        clock.step(41)
        nc.monitor_once()
        # capture the pre-replacement view, then race the replacement in
        stale_client.stale = client.list(
            "pods", "default", field_selector="spec.nodeName=n1")
        old_uid = client.get("pods", "p1", "default").metadata.uid
        client.delete("pods", "p1", "default", grace_period_seconds=0)
        client.create("pods", bound_pod("p1", "n-healthy"))
        new_uid = client.get("pods", "p1", "default").metadata.uid
        assert new_uid != old_uid
        clock.step(2)
        nc.monitor_once()   # drain uses the STALE list (uid A)
        survivor = client.get("pods", "p1", "default")
        assert survivor.metadata.uid == new_uid
        # and the conflict counted as done: the node is drained/dequeued
        assert "n1" not in nc._eviction_queue
