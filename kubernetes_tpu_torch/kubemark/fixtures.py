"""Snapshot generators for the port's smoke run and tests.

`engine_snapshot` is the engine-only fixture of the JAX package's
bench.py (`_engine_snapshot`): kubemark-shape nodes (4 CPU / 32Gi / 40
pods, from the reference's BenchmarkScheduling fixture and kubemark
density) in 8 zones, and homogeneous 100m / 500Mi pods, optionally
behind one `web` service (which turns the SelectorSpread tier on).

`mixed_snapshot` exercises every predicate of the filter kernel: host
ports, node selectors, GCE disks, pinned hosts, tight pod caps and
existing pods (the JAX package's pallas-filter test fixture).

`SMOKE_DIGESTS` pins the JAX engine's answer for the smoke fixtures
(`BatchEngine.run_chunked(enc, 8192)` on
`encode_snapshot(snap, pod_pad_to=<multiple of 8192>)`): the sha256 of
the int32 `assigned` array of the real pods and the count of bound pods.
A CPU test recomputes them with the JAX engine; the card, which has no
JAX, is held to them.

`E2E_COUNTS` pins the live pipeline's answer at the north-star size
(kubemark.benchmark.run_scheduling_benchmark(5000, 30000, "batch")): the
sha256 of the per-node counts of bound pods, in node-name order. The
benchmark's pods are identical, so the k-th placement does not depend on
which pod arrives k-th, and the counts are those of one uninterrupted
engine run over the fleet's nodes; a CPU test computes them with the JAX
engine that way.

`preempt_spec` is the full-width preemption fixture: 5000 nodes, each
full by CPU with 16 bound pods of seeded priorities (80,000 pods), and
64 seeded preemptors of varied priority and request (some with no
feasible victim set, some requesting nothing, some with a node
selector). `preempt_encoder` / `preempt_pods` build it in the port;
`PREEMPT_DIGEST` pins the sha256 of the 64 victim searches
(`preempt_digest`), which a CPU test recomputes with the JAX engine.
"""

from __future__ import annotations

import hashlib
import json
import random

import numpy as np

from ..core import types as api
from ..core.quantity import Quantity
from ..sched.device.tables import ClusterSnapshot

GI = 1024 ** 3
MI = 1024 ** 2

# chunk the smoke runs use, and the pod-axis padding multiple
SMOKE_CHUNK = 8192

SMOKE_DIGESTS = {
    "plain_5000x30000": {
        "n_nodes": 5000, "n_pods": 30000, "plain": True,
        "sha256": "45ac8a37d0573884836e324e9112775462ed46db65e3423a985534b3dc785c53",
        "bound": 30000},
    "spread_5000x8192": {
        "n_nodes": 5000, "n_pods": 8192, "plain": False,
        "sha256": "5aadfd8a6552c5e39d7d309ca034c504debac2a1e961d3f19a83d9f9c984592d",
        "bound": 8192},
}


E2E_COUNTS = {
    "n_nodes": 5000, "n_pods": 30000, "max_pods": 32,
    "sha256": "9d2e7731530a7252b14bb2c659906a71922a7eac001e8fe04ba6d0f8b86b141b",
    "bound": 30000}


PREEMPT_SEED = 5
PREEMPT_SHAPE = (5000, 16, 64)     # nodes, bound pods a node, preemptors
PREEMPT_DIGEST = "f1a101e2193f1e457138c6866165cdd0a217a8d83b231ab02eb96dbc6db30b91"


def preempt_spec(seed: int = PREEMPT_SEED, n_nodes: int = PREEMPT_SHAPE[0],
                 per_node: int = PREEMPT_SHAPE[1],
                 n_preemptors: int = PREEMPT_SHAPE[2]):
    """The preemption fixture as plain data, so that either package can
    build its objects from it: -> (nodes [(name, cpu milli, memory
    bytes, pod cap, zone)], bound pods [(name, node, priority, cpu
    milli, memory bytes)], preemptors [(name, priority, cpu milli,
    memory bytes, zone selector or "")]). Each node's cpu capacity is
    the sum of its pods' requests: the fleet is full by CPU. A third of
    the nodes cap their pod count at the pods they hold."""
    rng = random.Random(seed)
    nodes, bound = [], []
    for i in range(n_nodes):
        name = f"n{i:05d}"
        cpus = [rng.choice([100, 200, 250, 300, 400])
                for _ in range(per_node)]
        for k, cpu in enumerate(cpus):
            bound.append((f"{name}-{k:02d}", name,
                          rng.choice([-1000, -100, -10, 0, 10, 100, 1000]),
                          cpu, rng.choice([64, 128, 256]) * MI))
        nodes.append((name, sum(cpus), 32 * GI,
                      per_node if i % 3 == 0 else 2 * per_node,
                      f"z{i % 8}"))
    preemptors = []
    for j in range(n_preemptors):
        cpu = rng.choice([100, 500, 1000, 2500, 8000])
        mem = rng.choice([0, 256 * MI, GI])
        if j % 8 == 0:
            cpu = mem = 0
        preemptors.append((f"surge-{j:02d}",
                           rng.choice([-2000, -100, 0, 50, 500, 2000]),
                           cpu, mem, f"z{j % 8}" if j % 5 == 0 else ""))
    return nodes, bound, preemptors


def _preempt_node(name, cpu, mem, pods, zone) -> api.Node:
    return api.Node(
        metadata=api.ObjectMeta(name=name, labels={"zone": zone}),
        status=api.NodeStatus(capacity={
            "cpu": Quantity(cpu), "memory": Quantity(mem * 1000),
            "pods": Quantity(pods * 1000)}))


def _preempt_pod(name, node, prio, cpu, mem, zone="") -> api.Pod:
    requests = {}
    if cpu or mem:
        requests = {"cpu": Quantity(cpu), "memory": Quantity(mem * 1000)}
    return api.Pod(
        metadata=api.ObjectMeta(name=name, namespace="default",
                                uid=f"uid-{name}"),
        spec=api.PodSpec(
            containers=[api.Container(
                name="c", image="i",
                resources=api.ResourceRequirements(requests=requests))],
            node_name=node, priority=prio,
            node_selector={"zone": zone} if zone else {}))


def preempt_encoder(spec):
    """The port's IncrementalEncoder holding the spec's nodes and bound
    pods, each assumed straight into it (no store)."""
    from ..sched.device.incremental import IncrementalEncoder
    nodes, bound, _ = spec
    inc = IncrementalEncoder()
    for n in nodes:
        inc.on_node_add(_preempt_node(*n))
    for b in bound:
        inc.on_pod_add(_preempt_pod(*b))
    return inc


def preempt_pods(spec):
    """The spec's preemptors as the port's pods."""
    return [_preempt_pod(name, "", prio, cpu, mem, zone)
            for name, prio, cpu, mem, zone in spec[2]]


def preempt_digest(results) -> str:
    """sha256 over victim searches, given as (OracleResult, its
    VictimTable) pairs in order: pick, k*, feasible, the per-node k* and
    score arrays and the victim keys of each."""
    h = hashlib.sha256()
    for res, table in results:
        h.update(json.dumps([int(res.pick), int(res.kstar),
                             bool(res.feasible),
                             [list(k) for k in res.victim_keys(table)]]
                            ).encode())
        h.update(np.ascontiguousarray(res.node_kstar, np.int64).tobytes())
        h.update(np.ascontiguousarray(res.node_score, np.int64).tobytes())
    return h.hexdigest()


def node_counts_digest(node_names, hosts):
    """-> (sha256 hex of the int32 count of `hosts` on each of
    `node_names` in sorted name order, pods counted). Hosts outside the
    node list (or None) are not counted."""
    names = sorted(node_names)
    slot = {n: i for i, n in enumerate(names)}
    counts = np.zeros(len(names), np.int32)
    for h in hosts:
        if h in slot:
            counts[slot[h]] += 1
    return hashlib.sha256(counts.tobytes()).hexdigest(), int(counts.sum())


def assigned_digest(assigned, n_pods: int):
    """-> (sha256 hex of int32 assigned[:n_pods], bound count)."""
    a = np.ascontiguousarray(np.asarray(assigned)[:n_pods], dtype=np.int32)
    return hashlib.sha256(a.tobytes()).hexdigest(), int((a >= 0).sum())


def smoke_pod_pad(n_pods: int) -> int:
    return -(-n_pods // SMOKE_CHUNK) * SMOKE_CHUNK


def engine_snapshot(n_nodes: int, n_pods: int,
                    plain: bool = False) -> ClusterSnapshot:
    nodes = [
        api.Node(
            metadata=api.ObjectMeta(name=f"node-{i:05d}",
                                    labels={"zone": f"z{i % 8}"}),
            status=api.NodeStatus(capacity={
                "cpu": Quantity(4000),
                "memory": Quantity(32 * GI * 1000),
                "pods": Quantity(40 * 1000)}))
        for i in range(n_nodes)]
    services = [api.Service(
        metadata=api.ObjectMeta(name="web", namespace="default"),
        spec=api.ServiceSpec(selector={"app": "web"}))]
    pods = [
        api.Pod(
            metadata=api.ObjectMeta(name=f"pod-{j:06d}", namespace="default",
                                    labels={"app": "web"}),
            spec=api.PodSpec(containers=[api.Container(
                name="c", image="img",
                resources=api.ResourceRequirements(requests={
                    "cpu": Quantity(100),
                    "memory": Quantity(500 * MI * 1000)}))]))
        for j in range(n_pods)]
    if plain:
        services = []
        for p in pods:
            p.metadata.labels = {}
    return ClusterSnapshot(nodes=nodes, services=services,
                           pending_pods=pods)


def mixed_snapshot(seed: int, n_nodes: int, n_pods: int,
                   n_existing: int) -> ClusterSnapshot:
    rng = random.Random(seed)
    nodes = []
    for i in range(n_nodes):
        labels = {"zone": f"z{i % 3}"}
        if i % 2:
            labels["disk"] = "ssd"
        nodes.append(api.Node(
            metadata=api.ObjectMeta(name=f"n{i:04d}", labels=labels),
            status=api.NodeStatus(capacity={
                "cpu": Quantity(rng.choice([1000, 2000, 4000])),
                "memory": Quantity(rng.choice([256, 512]) * MI * 1000),
                "pods": Quantity(rng.choice([2, 40]) * 1000)})))
    existing = []
    for j in range(n_existing):
        vols = []
        if j % 9 == 0:
            vols.append(api.Volume(name="d", gce_persistent_disk=(
                api.GCEPersistentDiskVolumeSource(pd_name=f"pd-{j % 4}"))))
        existing.append(api.Pod(
            metadata=api.ObjectMeta(name=f"e{j}", namespace="default"),
            spec=api.PodSpec(
                node_name=f"n{j % n_nodes:04d}",
                volumes=vols,
                containers=[api.Container(
                    name="c", image="i",
                    ports=([api.ContainerPort(host_port=9000 + j % 3)]
                           if j % 5 == 0 else []),
                    resources=api.ResourceRequirements(requests={
                        "cpu": Quantity(rng.choice([100, 500])),
                        "memory": Quantity(
                            rng.choice([50, 100]) * MI * 1000)}))])))
    pods = []
    for j in range(n_pods):
        vols = []
        if j % 6 == 0:
            vols.append(api.Volume(name="d", gce_persistent_disk=(
                api.GCEPersistentDiskVolumeSource(pd_name=f"pd-{j % 4}"))))
        pods.append(api.Pod(
            metadata=api.ObjectMeta(name=f"p{j:04d}", namespace="default"),
            spec=api.PodSpec(
                node_selector={"disk": "ssd"} if j % 5 == 0 else {},
                node_name=f"n{j % n_nodes:04d}" if j % 11 == 0 else "",
                volumes=vols,
                containers=[api.Container(
                    name="c", image="i",
                    ports=([api.ContainerPort(host_port=9000 + j % 3)]
                           if j % 7 == 0 else []),
                    resources=api.ResourceRequirements(requests={
                        "cpu": Quantity(rng.choice([0, 100, 900])),
                        "memory": Quantity(
                            rng.choice([0, 64, 200]) * MI * 1000)}))])))
    return ClusterSnapshot(nodes=nodes, existing_pods=existing,
                           services=[], pending_pods=pods)
