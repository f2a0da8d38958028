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
"""

from __future__ import annotations

import hashlib
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
