"""Pins kubernetes_tpu_torch.kubemark.fixtures.SMOKE_DIGESTS to the JAX
engine's answer at full size (5000 nodes x 30000 plain pods, 5000 x 8192
spread pods): the JAX BatchEngine.run_chunked(enc, 8192) gives exactly
those sha256 digests and bound counts. chip_smoke.py holds the port on
the card, which has no JAX, to the same digests. The port's fixture is
also checked to encode byte-identically to bench.py's.

It also pins E2E_COUNTS, the per-node counts digest the card's e2e phase
(the live pipeline under the kubemark benchmark, 5000 nodes x 30000
pods) must reproduce: one uninterrupted JAX engine run over the JAX
fleet's nodes and benchmark pods, which the port's fleet and benchmark
pods encode byte-identically to.

And it pins PREEMPT_DIGEST, the card's preempt phase: the JAX engine's
victim search over the JAX encoder's tables of the full-width
preemption fixture, and the port's CPU path over its own."""

import pytest

import bench
from kubernetes_tpu.kubemark.benchmark import _bench_pod as jax_bench_pod
from kubernetes_tpu.kubemark.fleet import HollowFleet as JaxFleet
from kubernetes_tpu.sched.device import ClusterSnapshot as JaxSnapshot
from kubernetes_tpu.sched.device import BatchEngine as JaxEngine
from kubernetes_tpu.sched.device import encode_snapshot as jax_encode
from kubernetes_tpu_torch.kubemark.benchmark import _bench_pod
from kubernetes_tpu_torch.kubemark.fixtures import (E2E_COUNTS,
                                                    PREEMPT_DIGEST,
                                                    SMOKE_CHUNK,
                                                    SMOKE_DIGESTS,
                                                    assigned_digest,
                                                    engine_snapshot,
                                                    node_counts_digest,
                                                    preempt_digest,
                                                    preempt_encoder,
                                                    preempt_pods,
                                                    preempt_spec,
                                                    smoke_pod_pad)
from kubernetes_tpu_torch.kubemark.fleet import HollowFleet
from kubernetes_tpu_torch.sched.device import ClusterSnapshot, encode_snapshot

from test_torch_encode import assert_enc_equal


@pytest.mark.parametrize("name", sorted(SMOKE_DIGESTS))
def test_smoke_digests_are_the_jax_engines(name):
    want = SMOKE_DIGESTS[name]
    n, p, plain = want["n_nodes"], want["n_pods"], want["plain"]
    jax_enc = jax_encode(bench._engine_snapshot(n, p, plain=plain),
                         pod_pad_to=smoke_pod_pad(p))
    port_enc = encode_snapshot(engine_snapshot(n, p, plain=plain),
                               pod_pad_to=smoke_pod_pad(p))
    assert_enc_equal(jax_enc, port_enc)
    assigned, _ = JaxEngine().run_chunked(jax_enc, SMOKE_CHUNK)
    assert assigned_digest(assigned, jax_enc.n_pods) == \
        (want["sha256"], want["bound"])


def test_e2e_counts_are_the_jax_engines():
    want = E2E_COUNTS
    n, p = want["n_nodes"], want["n_pods"]
    kw = dict(cpu="4", memory="32Gi", max_pods=want["max_pods"])
    jax_fleet, fleet = JaxFleet(None, n, **kw), HollowFleet(None, n, **kw)
    jax_enc = jax_encode(JaxSnapshot(
        nodes=[jax_fleet._node_object(i) for i in range(n)],
        pending_pods=[jax_bench_pod(i) for i in range(p)]),
        pod_pad_to=smoke_pod_pad(p))
    port_enc = encode_snapshot(ClusterSnapshot(
        nodes=[fleet._node_object(i) for i in range(n)],
        pending_pods=[_bench_pod(i) for i in range(p)]),
        pod_pad_to=smoke_pod_pad(p))
    assert_enc_equal(jax_enc, port_enc)
    assigned, _ = JaxEngine().run_chunked(jax_enc, SMOKE_CHUNK)
    hosts = [jax_enc.node_names[i] if i >= 0 else None
             for i in assigned[:jax_enc.n_pods]]
    assert node_counts_digest(jax_fleet.node_names(), hosts) == \
        (want["sha256"], want["bound"])


def _jax_preempt_objects(spec):
    """The preemption fixture's objects in the JAX package's types, built
    as fixtures._preempt_node / _preempt_pod build the port's."""
    from kubernetes_tpu.core import types as jax_api
    from kubernetes_tpu.core.quantity import Quantity as JaxQuantity

    def node(name, cpu, mem, pods, zone):
        return jax_api.Node(
            metadata=jax_api.ObjectMeta(name=name, labels={"zone": zone}),
            status=jax_api.NodeStatus(capacity={
                "cpu": JaxQuantity(cpu), "memory": JaxQuantity(mem * 1000),
                "pods": JaxQuantity(pods * 1000)}))

    def pod(name, node_name, prio, cpu, mem, zone=""):
        requests = {}
        if cpu or mem:
            requests = {"cpu": JaxQuantity(cpu),
                        "memory": JaxQuantity(mem * 1000)}
        return jax_api.Pod(
            metadata=jax_api.ObjectMeta(name=name, namespace="default",
                                        uid=f"uid-{name}"),
            spec=jax_api.PodSpec(
                containers=[jax_api.Container(
                    name="c", image="i",
                    resources=jax_api.ResourceRequirements(
                        requests=requests))],
                node_name=node_name, priority=prio,
                node_selector={"zone": zone} if zone else {}))

    nodes, bound, preemptors = spec
    return ([node(*n) for n in nodes], [pod(*b) for b in bound],
            [pod(name, "", prio, cpu, mem, zone)
             for name, prio, cpu, mem, zone in preemptors])


def test_preempt_digest_is_the_jax_engines():
    """PREEMPT_DIGEST is the JAX engine's victim search over the JAX
    encoder's tables of the full-width fixture (5000 nodes x 16 bound
    pods, 64 preemptors); chip_smoke holds the card to it."""
    from kubernetes_tpu.sched.device.incremental import \
        IncrementalEncoder as JaxIncremental
    nodes, bound, preemptors = _jax_preempt_objects(preempt_spec())
    inc = JaxIncremental()
    for n in nodes:
        inc.on_node_add(n)
    for b in bound:
        inc.on_pod_add(b)
    engine = JaxEngine()
    results = []
    for p in preemptors:
        table = inc.victim_table(p)
        results.append((engine.find_victims(table), table))
    assert preempt_digest(results) == PREEMPT_DIGEST
    assert {t.v for _, t in results} == {1, 8, 16}
    assert 0 < sum(r.feasible for r, _ in results) < len(results)


def test_preempt_digest_on_the_ports_cpu_path():
    """The port's encoder and the victim kernel's plain version give the
    same digest at full width, and every search equals the oracle."""
    from kubernetes_tpu_torch.sched.device import BatchEngine
    from kubernetes_tpu_torch.sched.preemption import oracle_find_victims
    spec = preempt_spec()
    inc = preempt_encoder(spec)
    engine = BatchEngine(device="cpu")
    results = []
    for p in preempt_pods(spec):
        table = inc.victim_table(p)
        got = engine.find_victims(table)
        want = oracle_find_victims(table)
        assert (got.pick, got.kstar, got.feasible) == \
            (want.pick, want.kstar, want.feasible)
        results.append((got, table))
    assert preempt_digest(results) == PREEMPT_DIGEST
