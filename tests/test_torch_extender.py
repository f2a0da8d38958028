"""The port's extender sidecar answers the JAX package's own HTTP client
exactly as the JAX sidecar does: the same Filter node lists and the same
Prioritize HostPriority lists for the same pods, nodes and cluster
state (port backend on the CPU).

One known exception, pinned to the serial oracle instead: on the mixed
fixture the JAX sidecar's Prioritize answer is one point low on nodes
where BalancedResourceAllocation's `10 - |cpu_frac - mem_frac| * 10`
sits exactly on an integer (cpu_frac = 0.9, mem_frac = 0): XLA on the
CPU contracts the multiply and subtract into one fused multiply-add, so
the floor sees 0.99999999999999978 instead of 1.0. The port keeps the
two operations separate, as the oracle (and the reference) computes
them."""

import random

import pytest

from kubernetes_tpu.sched import priorities as prios
from kubernetes_tpu.sched.api import ExtenderConfig
from kubernetes_tpu.sched.extender import HTTPExtender
from kubernetes_tpu.sched.extender_server import DeviceBackend as JaxBackend
from kubernetes_tpu.sched.extender_server import \
    ExtenderServer as JaxServer
from kubernetes_tpu.sched.generic import prioritize_nodes
from kubernetes_tpu.sched.listers import (FakeControllerLister,
                                          FakeNodeLister, FakePodLister,
                                          FakeServiceLister)
from kubernetes_tpu_torch.sched.extender_server import (DeviceBackend,
                                                        ExtenderServer)

from test_device_parity import rand_cluster
from test_pallas_filter import _snapshot as filter_snapshot
from test_torch_encode import POLICY, cross, port_policy

CASES = {
    "mixed": lambda: (filter_snapshot(random.Random(9), 40, 6, 30), None),
    "spread": lambda: (rand_cluster(2), None),
    "wide_policy": lambda: (rand_cluster(3), POLICY),
}


def _client(server):
    return HTTPExtender(ExtenderConfig(
        url_prefix=server.url, filter_verb="filter",
        prioritize_verb="prioritize", weight=1))


def _answers(server, snap):
    client = _client(server)
    out = []
    for pod in snap.pending_pods:
        fit = [n.metadata.name for n in client.filter(pod, snap.nodes)]
        prio, weight = client.prioritize(pod, snap.nodes)
        out.append((fit, prio, weight))
    return out


def _serve(snap, policy):
    """-> (JAX sidecar's answers, port sidecar's answers)."""
    existing, services, controllers = (snap.existing_pods, snap.services,
                                       snap.controllers)
    port_state = (cross(existing), cross(services), cross(controllers))
    jax_server = JaxServer(JaxBackend(
        policy=policy,
        state_provider=lambda: (existing, services, controllers))).start()
    port_server = ExtenderServer(DeviceBackend(
        policy=port_policy(policy), device="cpu",
        state_provider=lambda: port_state)).start()
    try:
        return _answers(jax_server, snap), _answers(port_server, snap)
    finally:
        jax_server.stop()
        port_server.stop()


def _oracle_priorities(snap, pod):
    """The serial oracle's default-provider priority totals per host."""
    spread = prios.SelectorSpread(FakeServiceLister(snap.services),
                                  FakeControllerLister(snap.controllers))
    out = prioritize_nodes(
        pod, FakePodLister(snap.existing_pods),
        [(prios.least_requested_priority, 1),
         (prios.balanced_resource_allocation, 1),
         (spread.calculate_spread_priority, 1)],
        FakeNodeLister(snap.nodes))
    return {e.host: e.score for e in out}


def _check_answers(got, snap):
    assert any(0 < len(fit) < len(snap.nodes) for fit, _, _ in got)
    assert all(len(prio) == len(snap.nodes) for _, prio, _ in got)


@pytest.mark.parametrize("case", ["spread", "wide_policy"])
def test_extender_answers_match_jax(case):
    snap, policy = CASES[case]()
    want, got = _serve(snap, policy)
    assert got == want
    _check_answers(got, snap)


def test_extender_mixed_matches_jax_filter_and_oracle_priorities():
    snap, policy = CASES["mixed"]()
    want, got = _serve(snap, policy)
    _check_answers(got, snap)
    assert [fit for fit, _, _ in got] == [fit for fit, _, _ in want]
    for pod, (_, prio, weight) in zip(snap.pending_pods, got):
        assert weight == 1
        assert {e.host: e.score for e in prio} == \
            _oracle_priorities(snap, pod)


def test_filter_errors_are_in_band():
    """A backend failure fails the pod in-band, as the JAX sidecar does."""
    class Broken:
        def filter(self, pod, nodes):
            raise RuntimeError("kernel refused")

        def prioritize(self, pod, nodes):
            raise RuntimeError("kernel refused")

    snap = filter_snapshot(random.Random(1), 5, 1, 0)
    server = ExtenderServer(Broken()).start()
    try:
        client = _client(server)
        with pytest.raises(Exception, match="kernel refused"):
            client.filter(snap.pending_pods[0], snap.nodes)
        assert client.prioritize(snap.pending_pods[0], snap.nodes) == ([], 1)
    finally:
        server.stop()
