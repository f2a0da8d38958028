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

`scan_tables` makes seeded random engine tables (NodeConst, State,
PodXs as numpy) for holding the scan and probe kernels to their plain
versions: every tier, either layout, and the edges of the predicates
and scores inside the encoder's domain (cap == 0, zero requests,
pinned hosts on and off the table, exceeded nodes, padded slots and
pods, full nodes) and the FMA trap of Balanced (cpu_frac 0.9 against
mem_frac 0 on its first slots and pods). `scan_cases` names the tables
chip_smoke's scan phase and the card tests hold the kernels to: each
tier (`SCAN_TIERS`) and each edge (`SCAN_EDGES`) in both layouts.

`run_chaos_soak` is the JAX package's chaos soak (tests/test_chaos.py)
in the port, over the HTTP plane or in-process: chip_smoke's
`http_chaos` phase and tests/test_torch_chaos.py run it.
"""

from __future__ import annotations

import hashlib
import json
import random

import numpy as np

from ..core import types as api
from ..core.quantity import Quantity, parse_quantity
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


#: the split deployment (kubemark/deployment.run_split: apiserver |
#: hollow-fleet | scheduler, one process each, max_pods 40 a node) under
#: identical bench pods: the per-node counts digest of one uninterrupted
#: engine run over the fleet's nodes, as for E2E_COUNTS; a CPU test
#: computes both entries with the JAX engine. "5000x15000" is
#: chip_smoke's split phase (SLO_5K.json's density tier), "500x1500"
#: the card test's.
SPLIT_COUNTS = {
    "5000x15000": {
        "n_nodes": 5000, "n_pods": 15000, "max_pods": 40,
        "sha256": "ebcd41e62710d351b2eabbb7c6cbf57d6e7b92075006c8a6472b145c9bb9c6d0",
        "bound": 15000},
    "500x1500": {
        "n_nodes": 500, "n_pods": 1500, "max_pods": 40,
        "sha256": "e9f6faca4418b838792896bde73601a57e7b7ff0353f67e58c9a301eee32d2f1",
        "bound": 1500}}


PREEMPT_SEED = 5
PREEMPT_SHAPE = (5000, 16, 64)     # nodes, bound pods a node, preemptors
PREEMPT_DIGEST = "f1a101e2193f1e457138c6866165cdd0a217a8d83b231ab02eb96dbc6db30b91"


def fleet_encoder():
    """The e2e fleet's nodes (E2E_COUNTS' hollow nodes, 5120 slots at
    5000) in an IncrementalEncoder, as the live pipeline holds them: the
    tables of K1's main-path chunk (chip_smoke's scan, mirror and
    scatter phases, gpu_evidence.section_turns)."""
    from ..sched.device.incremental import IncrementalEncoder
    from .fleet import HollowFleet
    n = E2E_COUNTS["n_nodes"]
    fleet = HollowFleet(None, n, cpu="4", memory="32Gi",
                        max_pods=E2E_COUNTS["max_pods"])
    inc = IncrementalEncoder()
    for i in range(n):
        inc.on_node_add(fleet._node_object(i))
    return inc


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


def widest_table(tables):
    """The table the victim kernel is timed on: the widest victim axis,
    then the most valid victims."""
    return max(tables, key=lambda t: (t.v, int(t.v_valid.sum())))


def preempt_tables(spec=None) -> list:
    """Every preemptor's VictimTable on the spec's encoder (default: the
    full-width fixture)."""
    spec = preempt_spec() if spec is None else spec
    inc = preempt_encoder(spec)
    return [inc.victim_table(pod) for pod in preempt_pods(spec)]


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


SCAN_SEED = 17
SCAN_TRAP = 8      # slots and pods of the FMA trap (cpu 900 / 1000, memory 0)


def _bits(rng, shape, density) -> np.ndarray:
    """Random uint32 bitset words, as the engine carries them (int32)."""
    bits = (rng.random(shape + (32,)) < density).astype(np.uint64)
    words = (bits << np.arange(32, dtype=np.uint64)).sum(-1)
    return words.astype(np.uint32).view(np.int32)


def scan_tables(seed: int, p: int, n: int, wide: bool = False,
                groups: int = 0, terms: int = 0, services: int = 0,
                words: int = 1, pod_valid: float = 0.95, fits: bool = True):
    """-> (NodeConst, State, PodXs) of numpy arrays in the engine's
    layout (engine.host_args): P pods against N slots, resources int32
    (or int64 with memory in bytes past 2^31 when `wide`), `words` words
    a bitset, `groups` spread groups, `terms` affinity terms over 3
    domains, `services` service groups over `zones` zones (a table of one
    row each when 0, as the encoder pads them). The last N // 40 slots
    are padding (invalid). `fits=False` gives every node a pod cap of 0:
    nothing fits."""
    from ..sched.device.engine import NodeConst, PodXs, State
    rng = np.random.default_rng(seed)
    dt = np.int64 if wide else np.int32
    m = 1 << 20 if wide else 1           # memory unit
    g, t, s, z, d = max(groups, 1), max(terms, 1), max(services, 1), 3, 3

    def pick(values, size):
        return rng.choice(np.array(values, np.int64), size=size)

    def flag(prob, size):
        return rng.random(size) < prob

    cpu_cap = pick([0, 500, 1000, 2000, 4000, 64000], n)
    mem_cap = pick([0, 256, 1024, 4096, 32768], n) * m
    pod_cap = pick([0, 3, 8, 32, 110], n) if fits else np.zeros(n, np.int64)
    cpu_used = (rng.random(n) * np.maximum(cpu_cap, 3000) * 1.05).astype(
        np.int64)
    mem_used = (rng.random(n) * np.maximum(mem_cap, 4096 * m)
                * 1.05).astype(np.int64)
    nz_cpu = cpu_used + pick([0, 0, 100], n)
    nz_mem = mem_used + pick([0, 0, 200], n) * m
    pod_count = (rng.random(n) * (pod_cap + 1)).astype(np.int64)
    valid = np.ones(n, bool)
    valid[n - n // 40:] = False
    static_score = pick([0, 0, 0, 3, 6], n)
    # the FMA trap: 900m of 1000m cpu with the pod, no memory
    trap = slice(0, min(SCAN_TRAP, n))
    cpu_cap[trap], nz_cpu[trap], cpu_used[trap] = 1000, 800, 800
    mem_cap[trap], nz_mem[trap], mem_used[trap] = 4096 * m, 0, 0
    pod_cap[trap] = 110 if fits else 0
    pod_count[trap], valid[trap], static_score[trap] = 0, True, 0
    node = NodeConst(
        valid=valid, sched_ok=flag(0.97, n) | (np.arange(n) < SCAN_TRAP),
        cpu_cap=cpu_cap.astype(dt), mem_cap=mem_cap.astype(dt),
        pod_cap=pod_cap.astype(np.int32),
        labels=_bits(rng, (n, words), 0.5),
        tie_rank=rng.permutation(n).astype(np.int32),
        exceed_cpu=flag(0.03, n), exceed_mem=flag(0.03, n),
        offgrid_max=pick([0, 0, 2, 5], g).astype(np.int32),
        aff_dom=rng.integers(-1, d, (t, n)).astype(np.int32),
        zone_id=rng.integers(-1, z, n).astype(np.int32),
        zone_scratch=np.zeros(z, np.int32),
        static_mask=flag(0.95, n) | (np.arange(n) < SCAN_TRAP),
        static_score=static_score.astype(dt))
    node.exceed_cpu[trap] = node.exceed_mem[trap] = False
    svc_count = rng.integers(0, 3, (s, n)).astype(np.int32)
    aff_count = rng.integers(0, 3, (t, d)).astype(np.int32)
    aff_count[rng.random(t) < 0.3] = 0
    state = State(
        cpu_used=cpu_used.astype(dt), mem_used=mem_used.astype(dt),
        nz_cpu=nz_cpu.astype(dt), nz_mem=nz_mem.astype(dt),
        pod_count=pod_count.astype(np.int32),
        port_bits=_bits(rng, (n, words), 0.05),
        disk_any=_bits(rng, (n, words), 0.05),
        disk_rw=_bits(rng, (n, words), 0.02),
        spread=rng.integers(0, 4, (g, n)).astype(np.int32),
        aff_count=aff_count, aff_total=aff_count.sum(1).astype(np.int32),
        svc_count=svc_count,
        svc_total=(svc_count.sum(1) + rng.integers(0, 5, s)).astype(
            np.int32))
    for a in (state.port_bits, state.disk_any, state.disk_rw):
        a[trap] = 0

    req_cpu = pick([0, 100, 100, 250, 1000], p)
    req_mem = pick([0, 64, 64, 512], p) * m
    req_cpu[trap], req_mem[trap] = 100, 0
    host = pick([-1] * 30 + [-2, n + 5], p)
    host = np.where(rng.random(p) < 0.03, rng.integers(0, n, p), host)
    host[trap] = -1
    # past the trap, one pod of each pin: off the table, past N, a slot
    pins = np.array([-2, n + 5, n // 2])[:max(0, p - SCAN_TRAP)]
    host[SCAN_TRAP:SCAN_TRAP + pins.size] = pins
    group_id = rng.integers(-1, groups, p) if groups else np.full(p, -1)
    member = (rng.random((p, g)) < 0.3) | (
        group_id[:, None] == np.arange(g)[None])
    svc_group = rng.integers(-1, services, p) if services \
        else np.full(p, -1)
    nz_pod_mem = np.where(req_mem == 0, 200 * m, req_mem)
    nz_pod_mem[trap] = 0
    pods = PodXs(
        valid=flag(pod_valid, p) | (np.arange(p) < SCAN_TRAP),
        req_cpu=req_cpu.astype(dt), req_mem=req_mem.astype(dt),
        zero_req=(req_cpu == 0) & (req_mem == 0),
        nz_cpu=np.where(req_cpu == 0, 100, req_cpu).astype(dt),
        nz_mem=nz_pod_mem.astype(dt),
        sel=_bits(rng, (p, words), 0.02 / words),
        ports=_bits(rng, (p, words), 0.03 / words),
        qany=_bits(rng, (p, words), 0.03 / words),
        qrw=_bits(rng, (p, words), 0.02 / words),
        sany=_bits(rng, (p, words), 0.03 / words),
        srw=_bits(rng, (p, words), 0.02 / words),
        host_idx=host.astype(np.int32), group_id=group_id.astype(np.int32),
        member=member.astype(np.int32),
        aff_req=flag(0.2, (p, t)) if terms else np.zeros((p, t), bool),
        anti_req=flag(0.1, (p, t)) if terms else np.zeros((p, t), bool),
        aff_member=(rng.random((p, t)) < 0.3).astype(np.int32),
        svc_group=svc_group.astype(np.int32),
        svc_member=(rng.random((p, s)) < 0.4).astype(np.int32))
    if not pod_valid:
        pods.valid[:] = False
    for a in (pods.sel, pods.ports, pods.qany, pods.qrw, pods.sany,
              pods.srw):
        a[trap] = 0
    pods.zero_req[trap] = False
    return node, state, pods


# tier -> (spread groups, affinity terms, service groups) of scan_tables
SCAN_TIERS = {"node_local": (0, 0, 0), "spread": (3, 0, 0),
              "affinity": (0, 4, 0), "service_anti": (0, 0, 2),
              "all": (2, 3, 2)}
# edge -> scan_tables keywords, over every tier at once
SCAN_EDGES = {"p1": {"p": 1}, "n1500": {"n": 1500}, "n37": {"n": 37},
              "all_invalid": {"pod_valid": 0.0},
              "nothing_fits": {"fits": False}, "words3": {"words": 3}}
SCAN_DEGENERATE = ("all_invalid", "nothing_fits")   # edges placing no pod


def scan_cases(p: int = 64, n: int = 5120) -> dict:
    """-> {"<tier or edge>/<i32 or i64>": case} over every tier and edge
    in both layouts, P pods x N slots unless the edge sets them. A case
    holds `tables` (scan_tables' keywords, the seed among them) and the
    kernels' `weights`, `anti_weight`, `has_aff` and `has_spread`: a
    tier alone at weights (1, 1, 1) and 2, every tier at once at
    (2, 3, 5) and 4."""
    named = {**{t: (tiers, {}) for t, tiers in SCAN_TIERS.items()},
             **{e: (SCAN_TIERS["all"], kw) for e, kw in SCAN_EDGES.items()}}
    cases = {}
    for name, ((groups, terms, services), kw) in named.items():
        weights, anti = ((2, 3, 5), 4) if groups and terms and services \
            else ((1, 1, 1), 2)
        for wide in (False, True):
            cases[f"{name}/{'i64' if wide else 'i32'}"] = {
                "tables": {"seed": SCAN_SEED + len(cases), "p": p, "n": n,
                           "wide": wide, "groups": groups, "terms": terms,
                           "services": services, **kw},
                "weights": weights, "anti_weight": anti if services else 0,
                "has_aff": terms > 0, "has_spread": groups > 0}
    return cases


# K1's cluster edges (slots -> CTAs): N below C x threads, one slot,
# fewer slots than CTAs (empty ranges), a slot past a multiple of 16,
# every slot fitting, pods pinned to slots of other CTAs
CLUSTER_EDGES = {"n1": dict(n=1, p=16), "n17": dict(n=17, p=40),
                 "n37": dict(n=37, p=64), "n5121": dict(n=5121, p=48),
                 "every_fits": dict(n=700, p=64, every_fits=True),
                 "pinned_across": dict(n=640, p=48,
                                       pins=(639, 0, 320, 41, 599, 600))}


def cluster_edge_tables(name: str):
    """scan_tables (every tier's tables) at one of CLUSTER_EDGES, seeded
    by the name: `every_fits` makes every valid slot take every pod (no
    caps, pod caps, bitsets, pins or masks in the way); `pins` pins pods
    8, 9, ... each to one slot that fits it and nothing else."""
    kw = CLUSTER_EDGES[name]
    n, p = kw["n"], kw["p"]
    node, state, pods = scan_tables(SCAN_SEED + len(name), p, n, False, 2,
                                    2, 2)
    if kw.get("every_fits"):
        node.valid[:] = node.sched_ok[:] = node.static_mask[:] = True
        node.exceed_cpu[:] = node.exceed_mem[:] = False
        node.cpu_cap[:] = node.mem_cap[:] = 0
        node.pod_cap[:] = 1 << 20
        node.labels[:] = -1
        state.port_bits[:] = state.disk_any[:] = state.disk_rw[:] = 0
        pods.host_idx[:] = -1
        pods.valid[:] = True
        pods.aff_req[:] = pods.anti_req[:] = False
    for i, slot in enumerate(kw.get("pins", ())):
        node.valid[slot] = node.sched_ok[slot] = True
        node.static_mask[slot] = True
        node.exceed_cpu[slot] = node.exceed_mem[slot] = False
        node.cpu_cap[slot] = node.mem_cap[slot] = 0
        node.pod_cap[slot] = 1 << 20
        node.labels[slot] = -1
        state.port_bits[slot] = state.disk_any[slot] = 0
        state.disk_rw[slot] = 0
        k = SCAN_TRAP + i
        pods.host_idx[k] = slot
        pods.valid[k] = True
        pods.aff_req[k] = pods.anti_req[k] = False
    return node, state, pods


# the mesh sizes the sharded kernels are held at (virtual shards on one
# card; the CPU tests run the same through NodeMesh(["cpu"] * S))
SHARD_COUNTS = (2, 4, 8)
# the scan cases the sharded K1 is held to its twin at (every tier in
# both layouts, and the edges whose slots split over every count)
SHARD_CASES = ("node_local", "spread", "affinity", "service_anti", "all",
               "p1", "all_invalid", "nothing_fits", "words3")


def shard_pad(tables, shards: int):
    """(NodeConst, State, PodXs) of numpy arrays with the node axis
    padded to a multiple of `shards` by invalid slots (no zone, no
    affinity domain, every count 0), as the encoders pad it
    (`node_pad_to`, `mesh_devices`) -> the same three."""
    from ..sched.device.mesh import NODE_SPLIT, STATE_SPLIT
    node, state, pods = tables
    n = node.valid.shape[0]
    extra = -n % shards

    def pad(tree, split):
        out = {}
        for f, a in zip(type(tree)._fields, tree):
            if f in split and extra:
                widths = [(0, 0)] * a.ndim
                widths[split[f]] = (0, extra)
                fill = -1 if f in ("zone_id", "aff_dom") else 0
                a = np.pad(a, widths, constant_values=fill)
            out[f] = a
        return type(tree)(**out)

    return pad(node, NODE_SPLIT), pad(state, STATE_SPLIT), pods


def shard_survivor_drill(n_nodes: int = 64, n_pods: int = 96,
                         shards: int = 4, dead: int = 2,
                         device=None) -> dict:
    """The shard-failure drill over NodeMesh([device] * shards) (device
    None: the card; the tests pass "cpu"): a live batch loop over
    `shards` shard leases (FakeClock), the first half of the pods bound,
    then shard `dead`'s owner dies (renewals stop, no release) and the
    second half is created. Right after the loop dispatches the first
    tile of the second half, and before that tile is finalized, the
    clock runs past the dead lease's expiry (the survivors renewing), so
    the lease expires with the tile in flight: the loop's monitor sees
    it before the next dispatch, fences the lease, re-shards onto the
    survivors and requeues the in-flight tile's pods under
    `shard-<dead>`, and they bind on the survivors. -> what the drill
    saw: every pod bound, the shard counters, the mesh size after, the
    pods in flight at the expiry and those requeued under the dead
    shard, and the tiles that reached their commit under an epoch vector
    the encoder no longer holds with what they handed to the commit
    path (the fence drops them: must be 0)."""
    import threading
    import time as _time
    from ..api.client import InProcClient
    from ..api.registry import Registry
    from ..sched.batch import BatchScheduler
    from ..sched.device.shardfail import ShardLeaseMonitor, ShardLeaseSet
    from ..sched.factory import ConfigFactory
    from ..utils.clock import FakeClock
    from ..utils.metrics import MetricsRegistry
    from .fleet import HollowFleet

    def wait(cond, timeout=120.0):
        end = _time.monotonic() + timeout
        while _time.monotonic() < end:
            if cond():
                return True
            _time.sleep(0.02)
        return False

    from ..sched.device import BatchEngine
    from ..sched.device.engine import resolve_device
    from ..sched.device.mesh import NodeMesh
    mesh = NodeMesh([resolve_device(device)] * shards)
    clock = FakeClock()
    metrics = MetricsRegistry()
    client = InProcClient(Registry())
    leases = ShardLeaseSet(client, shards, clock=clock, lease_duration=3.0,
                           renew_deadline=2.0, retry_period=1.0,
                           metrics=metrics)
    assert leases.acquire_all()
    monitor = ShardLeaseMonitor(client, leases.lease_names(), clock=clock,
                                lease_duration=3.0, metrics=metrics)
    monitor.poll()
    fleet = HollowFleet(client, n_nodes, cpu="4", memory="32Gi", max_pods=32)
    for i in range(n_nodes):
        client.create("nodes", fleet._node_object(i))
    factory = ConfigFactory(client, rate_limit=False).start()
    engine = BatchEngine(mesh=mesh)
    config = factory.create_batch(engine=engine, shard_monitor=monitor,
                                  metrics=metrics)
    sched = BatchScheduler(config)
    # the fence's check: a tile that reaches _finalize under an epoch
    # vector the encoder no longer holds must hand nothing to the commit
    # path (the commit queue, or the committer's direct commit), on the
    # thread that finalizes it
    seen = threading.local()
    stale = {"tiles": 0, "handed": 0}
    finalize, commit, put = sched._finalize, sched._commit, \
        sched._commit_q.put
    dispatch, requeue = sched._schedule_incremental, sched._requeue
    # armed once the owner is dead: the next dispatch expires its lease
    # while the dispatched tile is still in flight
    expiry = {"armed": False, "in_flight": 0, "requeued": 0}

    def expire_in_flight(*args, **kw):
        out = dispatch(*args, **kw)
        if expiry["armed"] and sched._prev is not None:
            expiry["armed"] = False
            expiry["in_flight"] = len(sched._prev.pods)
            for _ in range(4):
                leases.renew(skip=[dead])
                clock.step(1.0)
        return out

    def counted_requeue(pod, host, reason):
        if host == f"shard-{dead}":
            expiry["requeued"] += 1
        return requeue(pod, host, reason)

    def count(fn):
        def wrapped(*args, **kw):
            seen.calls = getattr(seen, "calls", 0) + 1
            return fn(*args, **kw)
        return wrapped

    def watched(fl, *args, **kw):
        inc = sched._inc
        delta = getattr(fl.enc, "delta", None)
        old = (fl.shard_epochs is not None and inc is not None
               and delta is not None and inc.encoder_id == delta.encoder_id
               and inc.shard_epochs() != fl.shard_epochs)
        before = getattr(seen, "calls", 0)
        out = finalize(fl, *args, **kw)
        if old:
            stale["tiles"] += 1
            stale["handed"] += getattr(seen, "calls", 0) - before
        return out

    sched._finalize, sched._commit = watched, count(commit)
    sched._commit_q.put = count(put)
    sched._schedule_incremental = expire_in_flight
    sched._requeue = counted_requeue
    sched.run()
    try:
        assert wait(lambda: len(factory.node_lister.list()) == n_nodes)
        half = n_pods // 2

        def bound(lo, hi):
            pods = client.list("pods")[0]
            names = {f"drill-{i:04d}" for i in range(lo, hi)}
            return sum(1 for p in pods if p.metadata.name in names
                       and p.spec.node_name) == hi - lo

        for i in range(half):
            client.create("pods", _drill_pod(i))
        first = wait(lambda: bound(0, half))
        leases.kill(dead)
        expiry["armed"] = True
        for i in range(half, n_pods):
            client.create("pods", _drill_pod(i))
        second = wait(lambda: bound(half, n_pods))
        reshards = metrics.counter("shard_reshards_total")
    finally:
        sched.stop()
        factory.stop()
    return {"shards": shards, "dead": dead, "first_half_bound": first,
            "second_half_bound": second,
            "mesh_after": engine.n_shards,
            "reshards": reshards,
            "lease_transitions": metrics.counter(
                "shard_lease_transitions_total",
                {"lease": leases.lease_names()[dead]}),
            "replay_rows": metrics.counter("shard_replay_rows_total"),
            "in_flight_at_expiry": expiry["in_flight"],
            "requeued_in_flight": expiry["requeued"],
            "stale_tiles_fenced": stale["tiles"],
            "handed_under_dead_epoch": stale["handed"]}


def _drill_pod(i: int) -> api.Pod:
    return api.Pod(
        metadata=api.ObjectMeta(name=f"drill-{i:04d}", namespace="default"),
        spec=api.PodSpec(containers=[api.Container(
            name="c", image="img",
            resources=api.ResourceRequirements(requests={
                "cpu": parse_quantity("100m"),
                "memory": parse_quantity("64Mi")}))]),
        status=api.PodStatus(phase="Pending"))


def _chaos_pod(name: str, labels=None) -> api.Pod:
    """tests/test_chaos.py's pod: 100m / 64Mi."""
    return api.Pod(
        metadata=api.ObjectMeta(name=name, namespace="default",
                                labels=labels or {}),
        spec=api.PodSpec(containers=[api.Container(
            name="c", image="img",
            resources=api.ResourceRequirements(
                requests={"cpu": parse_quantity("100m"),
                          "memory": parse_quantity("64Mi")}))]),
        status=api.PodStatus(phase="Pending"))


def run_chaos_soak(seed: int, replicas: int = 16, n_nodes: int = 6,
                   fault_rate: float = 0.05, timeout: float = 150.0,
                   transport: str = "http", device=None):
    """The JAX package's chaos soak (tests/test_chaos.py run_chaos_soak)
    in the port: a replication controller, the batch scheduler and a
    hollow fleet, every one of them through one seeded fault injector
    (FaultPlan at `fault_rate` on every verb), and one forced watch cut
    once a quarter of the replicas are bound. transport="http" puts the
    injector over an HttpClient to an ApiServer on the registry, as the
    JAX soak does, so the scheduler is fed through the HTTP watch path;
    "inproc" over an InProcClient. An invariant tracker watches the
    registry directly (no faults, no HTTP): every binding observed once,
    never re-pointed. device: where the batch engine runs; None is the
    CUDA device and raises without one. -> (converged, rebinds, pods,
    trace, plan)."""
    import threading
    import time

    from ..api.client import HttpClient, InProcClient
    from ..api.registry import Registry
    from ..api.server import ApiServer
    from ..chaos import ChaosClient, FaultPlan
    from ..controllers.replication import ReplicationManager
    from ..sched.batch import BatchScheduler
    from ..sched.device.engine import resolve_device
    from ..sched.factory import ConfigFactory
    from .fleet import HollowFleet

    if transport not in ("http", "inproc"):
        raise ValueError(f"transport {transport!r}: http or inproc")
    device = resolve_device(device)

    def wait_until(cond, limit):
        end = time.time() + limit
        while time.time() < end:
            if cond():
                return True
            time.sleep(0.05)
        return cond()

    registry = Registry()
    srv = None
    if transport == "http":
        srv = ApiServer(registry, port=0).start()
        inner = HttpClient(srv.url)
    else:
        inner = InProcClient(registry)
    plan = FaultPlan(seed=seed, error_rate=fault_rate)
    chaos = ChaosClient(inner, plan)

    bound_to, rebinds = {}, []
    lock = threading.Lock()
    tracker_w = InProcClient(registry).watch("pods", "default")

    def track():
        for ev in tracker_w:
            pod = ev.object
            if ev.type == "DELETED" or not pod.spec.node_name:
                continue
            with lock:
                prev = bound_to.get(pod.metadata.uid)
                if prev is not None and prev != pod.spec.node_name:
                    rebinds.append((pod.metadata.name, prev,
                                    pod.spec.node_name))
                bound_to[pod.metadata.uid] = pod.spec.node_name

    threading.Thread(target=track, daemon=True).start()

    fleet = HollowFleet(chaos, n_nodes, heartbeat_interval=1.0).run()
    factory = ConfigFactory(chaos, rate_limit=False).start()
    sched = BatchScheduler(factory.create_batch(device=device)).run()
    rc_mgr = ReplicationManager(chaos).run()
    try:
        wait_until(lambda: len(factory.node_lister.list()) == n_nodes, 60)
        rc = api.ReplicationController(
            metadata=api.ObjectMeta(name="soak", namespace="default"),
            spec=api.ReplicationControllerSpec(
                replicas=replicas, selector={"app": "soak"},
                template=api.PodTemplateSpec(
                    metadata=api.ObjectMeta(labels={"app": "soak"}),
                    spec=_chaos_pod("t", labels={"app": "soak"}).spec)))
        # the RC's creation rides the injector too (retried until it
        # lands: an injected fault fires before the request is sent)
        deadline = time.time() + 30
        while True:
            try:
                chaos.create("replicationcontrollers", rc)
                break
            except Exception:
                if time.time() > deadline:
                    raise
                time.sleep(0.05)

        def converged():
            pods, _ = registry.list("pods", "default",
                                    label_selector="app=soak")
            live = [p for p in pods if p.metadata.deletion_timestamp
                    is None]
            return (len(live) == replicas
                    and all(p.spec.node_name for p in live)
                    and all(p.status.phase == "Running" for p in live))

        # some progress, then every component's streams drop at once
        # (the apiserver-restart moment)
        wait_until(lambda: len(bound_to) >= max(2, replicas // 4),
                   timeout / 2)
        chaos.cut_watches()
        ok = wait_until(converged, timeout)
        pods, _ = registry.list("pods", "default", label_selector="app=soak")
        return ok, list(rebinds), pods, chaos.trace(), plan
    finally:
        rc_mgr.stop()
        sched.stop()
        factory.stop()
        fleet.stop()
        tracker_w.stop()
        if srv is not None:
            srv.stop()
