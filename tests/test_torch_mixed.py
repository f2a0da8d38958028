"""Mixed mode in the port (kubernetes_tpu_torch.sched.device_assist,
factory.create_mixed) against the JAX package's, on the CPU: the device
probe's predicates and priorities on every node, two HTTP extenders
filtering and scoring the survivors, the serial control loop binding.

The twin of tests/test_extender_server.py's mixed-mode tests (the
reference's TestSchedulerExtender placement, machine3), and a run of
both packages' mixed mode over the same nodes and pods, which must bind
every pod to the same node. Tolerance 0: placements are names."""

import pytest
import torch

from kubernetes_tpu.api.client import InProcClient as JaxClient
from kubernetes_tpu.api.registry import Registry as JaxRegistry
from kubernetes_tpu.sched.api import ExtenderConfig as JaxExtenderConfig
from kubernetes_tpu.sched.api import Policy as JaxPolicy
from kubernetes_tpu.sched.extender_server import \
    CallableBackend as JaxCallableBackend
from kubernetes_tpu.sched.extender_server import \
    ExtenderServer as JaxExtenderServer
from kubernetes_tpu.sched.factory import ConfigFactory as JaxFactory
from kubernetes_tpu.sched.scheduler import Scheduler as JaxScheduler
from kubernetes_tpu_torch.api.client import InProcClient
from kubernetes_tpu_torch.api.registry import Registry
from kubernetes_tpu_torch.sched.api import (ExtenderConfig, HostPriority,
                                            Policy)
from kubernetes_tpu_torch.sched.device_assist import DeviceAssistedAlgorithm
from kubernetes_tpu_torch.sched.extender_server import (CallableBackend,
                                                        ExtenderServer)
from kubernetes_tpu_torch.sched.factory import ConfigFactory
from kubernetes_tpu_torch.sched.scheduler import Scheduler

from test_extender_server import (machine_1_2_3_predicate,
                                  machine_2_3_5_predicate, pending_pod,
                                  ready_node, wait_until)
from test_torch_encode import cross


def machine_2_prioritizer(pod, nodes):
    return [HostPriority(n.metadata.name,
                         10 if n.metadata.name == "machine2" else 1)
            for n in nodes]


def machine_3_prioritizer(pod, nodes):
    return [HostPriority(n.metadata.name,
                         10 if n.metadata.name == "machine3" else 1)
            for n in nodes]


def _servers(backend_cls, server_cls, prio2, prio3):
    return (server_cls(backend_cls(predicates=[machine_1_2_3_predicate],
                                   prioritizers=[(prio2, 1)])).start(),
            server_cls(backend_cls(predicates=[machine_2_3_5_predicate],
                                   prioritizers=[(prio3, 1)])).start())


def _policy(policy_cls, config_cls, servers):
    return policy_cls(extenders=[
        config_cls(url_prefix=servers[0].url, filter_verb="filter",
                   prioritize_verb="prioritize", weight=3),
        config_cls(url_prefix=servers[1].url, filter_verb="filter",
                   prioritize_verb="prioritize", weight=4)])


def test_mixed_mode_scheduler_with_extenders():
    """The port's twin of the JAX package's test: machine3, and the
    bound pod in the encoder's ledger through the on_assume hook."""
    servers = _servers(CallableBackend, ExtenderServer,
                       machine_2_prioritizer, machine_3_prioritizer)
    client = InProcClient(Registry())
    factory = ConfigFactory(client, rate_limit=False).start()
    config = factory.create_mixed(
        _policy(Policy, ExtenderConfig, servers), device="cpu")
    assert config is not None, "policy should qualify for mixed mode"
    assert isinstance(config.algorithm, DeviceAssistedAlgorithm)
    assert config.algorithm.engine.device.type == "cpu"
    sched = Scheduler(config).run()
    try:
        for i in range(5):
            client.create("nodes", cross([ready_node(f"machine{i + 1}")])[0])
        client.create("pods", cross([pending_pod("mixed-pod")])[0])
        assert wait_until(
            lambda: client.get("pods", "mixed-pod").spec.node_name,
            timeout=30)
        assert client.get("pods", "mixed-pod").spec.node_name == "machine3"
        inc = config.algorithm.inc
        assert wait_until(
            lambda: inc.pods.get("default/mixed-pod") is not None
            and inc.pods["default/mixed-pod"].node == "machine3")
        client.create("pods", cross([pending_pod("mixed-pod-2")])[0])
        assert wait_until(
            lambda: client.get("pods", "mixed-pod-2").spec.node_name,
            timeout=30)
    finally:
        sched.stop()
        factory.stop()
        for s in servers:
            s.stop()


NODES = [("machine1", "4", "32Gi"), ("machine2", "2", "8Gi"),
         ("machine3", "1", "4Gi"), ("machine4", "4", "16Gi"),
         ("machine5", "8", "32Gi")]
PODS = [(f"p{j}", cpu, mem) for j, (cpu, mem) in enumerate(
    [("100m", "200Mi"), ("500m", "1Gi"), ("900m", "2Gi"), ("0", "0"),
     ("250m", "100Mi"), ("1", "3Gi")])]


def _bindings(pkg):
    """One package's mixed mode over NODES, the PODS created one at a
    time (each bound before the next arrives) -> {pod: node}."""
    if pkg == "jax":
        servers = _servers(JaxCallableBackend, JaxExtenderServer,
                           _jax_prio(2), _jax_prio(3))
        client = JaxClient(JaxRegistry())
        factory = JaxFactory(client, rate_limit=False).start()
        config = factory.create_mixed(
            _policy(JaxPolicy, JaxExtenderConfig, servers))
        sched, conv = JaxScheduler(config).run(), (lambda o: o)
    else:
        servers = _servers(CallableBackend, ExtenderServer,
                           machine_2_prioritizer, machine_3_prioritizer)
        client = InProcClient(Registry())
        factory = ConfigFactory(client, rate_limit=False).start()
        config = factory.create_mixed(
            _policy(Policy, ExtenderConfig, servers), device="cpu")
        sched, conv = Scheduler(config).run(), (lambda o: cross([o])[0])
    try:
        for name, cpu, mem in NODES:
            client.create("nodes", conv(ready_node(name, cpu=cpu, mem=mem)))
        assert wait_until(lambda: len(factory.node_lister.list()) == 5)
        out = {}
        for name, cpu, mem in PODS:
            client.create("pods", conv(pending_pod(name, cpu=cpu, mem=mem)))
            assert wait_until(
                lambda: client.get("pods", name).spec.node_name, timeout=30)
            out[name] = client.get("pods", name).spec.node_name
        return out
    finally:
        sched.stop()
        factory.stop()
        for s in servers:
            s.stop()


def _jax_prio(favourite):
    from kubernetes_tpu.sched.api import HostPriority as JaxHostPriority

    def prioritize(pod, nodes):
        return [JaxHostPriority(n.metadata.name,
                                10 if n.metadata.name ==
                                f"machine{favourite}" else 1)
                for n in nodes]
    return prioritize


def test_mixed_mode_binds_as_the_jax_mixed_mode():
    got = _bindings("port")
    assert got == _bindings("jax")
    assert set(got.values()) <= {"machine2", "machine3"}


def test_mixed_mode_requires_extenders_and_plain_policy():
    factory = ConfigFactory(InProcClient(Registry()), rate_limit=False)
    assert factory.create_mixed(Policy(), device="cpu") is None
    assert factory.create_mixed(None) is None
    from kubernetes_tpu_torch.sched.api import (PredicatePolicy,
                                                ServiceAffinityArgs)
    pol = Policy(
        predicates=[PredicatePolicy(
            name="ServiceAffinity",
            service_affinity=ServiceAffinityArgs(labels=["zone"]))],
        extenders=[ExtenderConfig(url_prefix="http://x",
                                  filter_verb="filter")])
    assert factory.create_mixed(pol, device="cpu") is None


def test_mixed_mode_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    factory = ConfigFactory(InProcClient(Registry()), rate_limit=False)
    pol = Policy(extenders=[ExtenderConfig(url_prefix="http://x",
                                           filter_verb="filter")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        factory.create_mixed(pol)
