"""Host-side snapshot encoder: api objects -> Struct-of-Arrays device tables.

The port's own copy of the JAX package's encoder, with the incremental
encoder's `TableDelta` journal (pure numpy; the torch engine turns its
arrays into tensors in `engine.device_args`).

This is the strings->tensors boundary (SURVEY.md section 7 hard part 3).
Label key=value pairs, host ports, and volume conflict keys are interned
into per-batch dictionaries and become bitset words — exact (dictionary
interning, not hashing), so there is no collision fallback to reason about.

Semantics mirrored bit-for-bit from the serial oracle (and therefore from
the reference, plugin/pkg/scheduler/algorithm):

  - initial per-node resource sums replay CheckPodsExceedingFreeResources'
    order-dependent skip-on-misfit accounting (predicates.go:160-185) over
    the snapshot's pod list order;
  - nonzero-request default sums (100 milliCPU / 200MiB per container,
    priorities.go:53-54) are kept separately for the priority math;
  - selector-spread groups replicate SelectorSpread.calculate_spread_priority
    (selector_spreading.go:43-114): per (namespace, selector-set) group,
    per-node match counts over ALL namespace pods (no phase filter — the
    reference lists everything), plus the max count over hosts outside the
    node table (unassigned "" bucket and unknown nodes);
  - volume conflict keys encode NoDiskConflict (predicates.go:75-137):
    GCE PD read-only nuance via a separate rw bitset, AWS EBS by volume id,
    Ceph RBD one key per (monitor, pool, image).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...core import labels as labelspkg
from ...core import types as api
from ..predicates import (filter_non_running_pods, get_resource_request,
                          node_schedulable, term_namespaces)
from ..priorities import get_nonzero_requests

WORD = 32


def _words(nbits: int) -> int:
    return max(1, (nbits + WORD - 1) // WORD)


class _Interner:
    """Exact string->bit-index dictionary."""

    def __init__(self):
        self.ids: Dict[object, int] = {}

    def intern(self, key: object) -> int:
        idx = self.ids.get(key)
        if idx is None:
            idx = len(self.ids)
            self.ids[key] = idx
        return idx

    def __len__(self) -> int:
        return len(self.ids)


def _set_bit(row: np.ndarray, idx: int) -> None:
    row[idx // WORD] |= np.uint32(1 << (idx % WORD))


@dataclass
class DevicePolicy:
    """Policy knobs the device engine supports beyond the default provider
    (scheduler-policy-file surface; ref: plugin/pkg/scheduler/api).

    - anti_affinity_label: ServiceAntiAffinity custom priority — spread a
      service's pods across values of this node label
      (selector_spreading.go:117-196); weight from the policy entry.
    - label_presence: CheckNodeLabelPresence custom predicates
      (predicates.go:292) — list of (labels, presence).
    - label_priorities: CalculateNodeLabelPriority custom priorities
      (priorities.go:148) — list of (label, presence, weight).
    """
    anti_affinity_label: Optional[str] = None
    anti_affinity_weight: int = 1
    label_presence: List[Tuple[Tuple[str, ...], bool]] = field(
        default_factory=list)
    label_priorities: List[Tuple[str, bool, int]] = field(
        default_factory=list)

    @property
    def needs_anti_affinity(self) -> bool:
        return self.anti_affinity_label is not None


@dataclass
class ClusterSnapshot:
    """What the algorithm would see through its listers at batch start.

    `existing_pods` must be in the merged pod lister's list order (scheduled
    pods then assumed pods — modeler.py list()); the order matters for the
    exceeding-resources replay. `pending_pods` are the pods to place, in
    FIFO order, and must not appear in `existing_pods`.
    """
    nodes: List[api.Node]
    existing_pods: List[api.Pod] = field(default_factory=list)
    services: List[api.Service] = field(default_factory=list)
    controllers: List[api.ReplicationController] = field(default_factory=list)
    pending_pods: List[api.Pod] = field(default_factory=list)
    # Full node cache (schedulable or not) for resolving existing pods'
    # topology domains in affinity terms — the serial path's node_by_name
    # resolves ANY cached node (ReadyNodeLister.get), not just candidates.
    # None -> fall back to `nodes`.
    all_nodes: Optional[List[api.Node]] = None


@dataclass
class NodeArrays:
    valid: np.ndarray       # bool[N] — real (unpadded) table row
    sched_ok: np.ndarray    # bool[N] — node_schedulable at encode time
                            #   (Ready, not Unknown, not cordoned); the
                            #   engine masks on valid & sched_ok, so a
                            #   dead node stays IN the table (its pods
                            #   keep their spread counts and topology
                            #   domains) but never receives a binding
    cpu_cap: np.ndarray     # i64[N] (milli)
    mem_cap: np.ndarray     # i64[N] (bytes)
    pod_cap: np.ndarray     # i32[N]
    label_words: np.ndarray  # u32[N, L]
    tie_rank: np.ndarray    # i32[N] — higher wins ties (name-descending pick)
    exceed_cpu: np.ndarray  # bool[N] — snapshot had a cpu-misfit pod
    exceed_mem: np.ndarray  # bool[N]
    aff_dom: np.ndarray     # i32[T, N] — topology-domain id per affinity
                            #   term (-1: node lacks the term's topology key)
    zone_id: np.ndarray     # i32[N] — ServiceAntiAffinity label value id
                            #   (-1: unlabeled; all -1 when not configured)
    zone_scratch: np.ndarray  # i32[Z] zeros — carries the zone-count shape
                            #   into the jitted step
    static_mask: np.ndarray  # bool[N] — AND of configured label-presence
                            #   predicates (CheckNodeLabelPresence)
    static_score: np.ndarray  # i64[N] — weighted sum of configured static
                            #   priorities (CalculateNodeLabelPriority)


@dataclass
class PodArrays:
    valid: np.ndarray       # bool[P]
    req_cpu: np.ndarray     # i64[P]
    req_mem: np.ndarray     # i64[P]
    zero_req: np.ndarray    # bool[P]
    nz_cpu: np.ndarray      # i64[P]
    nz_mem: np.ndarray      # i64[P]
    sel_words: np.ndarray   # u32[P, L]
    port_words: np.ndarray  # u32[P, PW]  (query == set for host ports)
    disk_qany: np.ndarray   # u32[P, K]
    disk_qrw: np.ndarray    # u32[P, K]
    disk_sany: np.ndarray   # u32[P, K]
    disk_srw: np.ndarray    # u32[P, K]
    host_idx: np.ndarray    # i32[P] (-1 unpinned, -2 pinned off-table)
    group_id: np.ndarray    # i32[P] (-1 = no spread selectors)
    member: np.ndarray      # i32[P, G]
    aff_req: np.ndarray     # bool[P, T] — pod requires affinity term t
    anti_req: np.ndarray    # bool[P, T] — pod requires anti-affinity term t
    aff_member: np.ndarray  # i32[P, T] — pod falls in term t's scope
                            #   (counts into the term's domains once placed)
    svc_group: np.ndarray   # i32[P] — ServiceAntiAffinity service group
                            #   (-1: pod has no matching service)
    svc_member: np.ndarray  # i32[P, S] — pod matches group's (ns, selector)


@dataclass
class StateArrays:
    cpu_used: np.ndarray    # i64[N]
    mem_used: np.ndarray    # i64[N]
    nz_cpu: np.ndarray      # i64[N]
    nz_mem: np.ndarray      # i64[N]
    pod_count: np.ndarray   # i32[N]
    port_bits: np.ndarray   # u32[N, PW]
    disk_any: np.ndarray    # u32[N, K]
    disk_rw: np.ndarray     # u32[N, K]
    spread: np.ndarray      # i32[G, N]
    aff_count: np.ndarray   # i32[T, D] — placed pods in term t's scope per
                            #   topology domain
    aff_total: np.ndarray   # i32[T] — placed pods in term t's scope anywhere
                            #   (drives the bootstrap rule)
    svc_count: np.ndarray   # i32[S, N] — service-group pods per table node
                            #   (zone reduction happens under the per-step
                            #   mask, matching the oracle's filtered lister)
    svc_total: np.ndarray   # i32[S] — service-group pods anywhere


@dataclass
class TableDelta:
    """Slot-granular change journal of one encode against the encoder's
    persistent node tables, consumed by the engine's device-resident
    table cache (engine._TableCache).

    `table_gen` is the encoder's monotonic mutation counter at encode
    time; `node_dirty_gen[slot]` / `state_dirty_gen[slot]` are the
    counter values when that slot's NodeConst-side / State-side rows
    last changed (captured under the encoder lock, so they are
    consistent with the host arrays this encode copied); `full_gen` is
    the counter at the last whole-table invalidation (capacity growth,
    which reshapes and re-shards every array). A cache whose content is
    current at generation g needs exactly the rows with dirty_gen > g
    re-uploaded — and a full re-upload iff full_gen > g. The split
    matters because State rows churn on every assumed pod while
    NodeConst rows move only on node events: a steady pipeline scatters
    a handful of NodeConst rows (or none) per tile.

    `encoder_id` names the encoder INSTANCE whose mutation counter the
    generations count. Generations from two encoders are incomparable
    even at identical table shapes (each counts its own timeline), so
    the engine's cache must also match on identity — otherwise a fresh
    encoder's low generations would read as "nothing changed" against a
    mirror holding another encoder's rows.

    `shard_epochs[s]` is the encoder's epoch for mesh shard s at encode
    time. An epoch moves only when the slot->shard mapping moves — a
    survivor re-shard after a shard owner's lease expires rewrites the
    whole vector (length changes to the survivor count, every entry
    bumps past the old maximum). A cached device mirror is only valid
    for a delta carrying the SAME vector: any difference means the rows
    it holds live on the wrong devices (or on a dead one), so the cache
    must miss and reseed from host truth — the materialized journal
    replay. Epochs are scoped to one encoder_id; across instances they
    are incomparable, exactly like the generations."""
    table_gen: int
    node_dirty_gen: np.ndarray   # i64[n_cap]
    state_dirty_gen: np.ndarray  # i64[n_cap]
    full_gen: int
    encoder_id: int
    shard_epochs: Tuple[int, ...] = (0,)

    def replay_slots(self, from_gen: int) -> np.ndarray:
        """Slots journaled on EITHER side since `from_gen` — the rows a
        mirror current at that generation must replay to catch up. A
        re-shard re-journals every occupied slot at fresh generations,
        so replay_slots(pre-failure full_gen) is exactly the row set
        rebuilt on the survivors (shard_replay_rows_total counts it)."""
        return np.nonzero((self.node_dirty_gen > from_gen)
                          | (self.state_dirty_gen > from_gen))[0]


@dataclass
class EncodeResult:
    node_tab: NodeArrays
    pod_batch: PodArrays
    init_state: StateArrays
    offgrid_max: np.ndarray      # i32[G]
    node_names: List[str]        # index -> name (padded entries "")
    n_nodes: int                 # valid (unpadded) node count
    n_pods: int                  # valid (unpadded) pod count
    # >1 when the resource arrays were narrowed to i32: every memory
    # quantity is stored divided by this exact common divisor
    mem_scale: int = 1
    # incremental-encoder only: the _Group objects behind pod_batch's
    # group_id column, so assume_assigned can bump their per-node rows
    # without re-matching selectors
    tile_groups: Optional[list] = None
    # incremental-encoder only: the encoder's state_epoch at encode time
    # (assume_assigned's fast path and the device-carry chain both
    # require no intervening mutations)
    state_epoch: int = -1
    # incremental-encoder only: dirty-slot journal for the engine's
    # device-resident table cache (None -> the encode has no generation
    # tracking and the engine always uploads the full tables)
    delta: Optional[TableDelta] = None


_I32_BOUND = 1 << 30  # slack below 2^31 for the x10 score scaling


def _maybe_narrow(nt: NodeArrays, st: StateArrays, pb: PodArrays,
                  weights_hint: int = 64):
    """Narrow the i64 resource/score arrays to i32 when provably exact.

    Memory quantities (bytes) exceed i32, but every formula that touches
    them is scale-invariant under an EXACT common divisor g:
    floor((a/g)*10 / (b/g)) == floor(a*10/b) when g|a and g|b (integer
    identity), and f64((a/g))/f64((b/g)) is the correctly-rounded
    quotient of the same rational as f64(a)/f64(b), hence bit-identical.
    So divide all memory values by their collective gcd and cast to i32
    — on TPU this halves the emulated-64-bit op count of the scan step,
    on CPU it halves the per-step memory traffic. Ineligible inputs
    (scaled values still too large, oversized cpu milli-values) keep the
    wide arrays; the engine compiles per-dtype, so both coexist.

    Returns (nt, st, pb, mem_scale)."""
    mem_arrays = [nt.mem_cap, st.mem_used, st.nz_mem, pb.req_mem,
                  pb.nz_mem]
    g = 0
    for arr in mem_arrays:
        if arr.size:
            g = int(np.gcd(int(g), int(np.gcd.reduce(np.abs(arr)))))
    if g == 0:
        g = 1
    # accumulation bound: the scan adds each pod's request into the used
    # vectors (zero-capacity nodes accept without limit), so the final
    # sums must stay in range too
    max_mem = max((int(np.max(np.abs(a))) if a.size else 0)
                  for a in mem_arrays) // g
    mem_growth = (int(np.max(pb.req_mem)) // g if pb.req_mem.size else 0) \
        * max(1, pb.req_mem.shape[0])
    nz_growth = (int(np.max(pb.nz_mem)) // g if pb.nz_mem.size else 0) \
        * max(1, pb.nz_mem.shape[0])
    cpu_arrays = [nt.cpu_cap, st.cpu_used, st.nz_cpu, pb.req_cpu,
                  pb.nz_cpu]
    max_cpu = max((int(np.max(np.abs(a))) if a.size else 0)
                  for a in cpu_arrays)
    cpu_growth = (int(np.max(pb.req_cpu)) if pb.req_cpu.size else 0) \
        * max(1, pb.req_cpu.shape[0])
    max_static = int(np.max(np.abs(nt.static_score))) \
        if nt.static_score.size else 0
    # composite = total * n + tie_rank; bound total conservatively
    n = nt.valid.shape[0]
    total_bound = (30 * weights_hint + max_static) * max(n, 1)
    if max(max_mem * 10, max_mem + mem_growth, nz_growth,
           max_cpu * 10, max_cpu + cpu_growth,
           total_bound) >= _I32_BOUND:
        return nt, st, pb, 1

    i32 = np.int32
    nt = replace(
        nt, cpu_cap=nt.cpu_cap.astype(i32),
        mem_cap=(nt.mem_cap // g).astype(i32),
        static_score=nt.static_score.astype(i32))
    st = replace(
        st, cpu_used=st.cpu_used.astype(i32),
        mem_used=(st.mem_used // g).astype(i32),
        nz_cpu=st.nz_cpu.astype(i32),
        nz_mem=(st.nz_mem // g).astype(i32))
    pb = replace(
        pb, req_cpu=pb.req_cpu.astype(i32),
        req_mem=(pb.req_mem // g).astype(i32),
        nz_cpu=pb.nz_cpu.astype(i32),
        nz_mem=(pb.nz_mem // g).astype(i32))
    return nt, st, pb, g


def _selector_matches(selector: Dict[str, str], labels: Dict[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())


def collect_affinity_terms(pending_pods: Sequence[api.Pod]):
    """Intern a pod batch's inter-pod affinity terms: ->
    (term_meta [(ns_scope frozenset, selector dict, topology_key)],
     pod_terms [(aff term ids, anti term ids)] per pod).

    The interning key is parity-critical (the oracle predicate resolves
    scope per pod, predicates.new_inter_pod_affinity_predicate) and is
    shared by BOTH encoders — the full snapshot encoder below and the
    incremental encoder's ledger-fed tier — so the two cannot drift."""
    term_ids: Dict[object, int] = {}
    term_meta: List[Tuple[frozenset, Dict[str, str], str]] = []
    pod_terms: List[Tuple[List[int], List[int]]] = []

    def intern_term(pod: api.Pod, term: api.PodAffinityTerm) -> int:
        ns_scope = frozenset(term_namespaces(pod, term))
        key = (ns_scope, frozenset(term.label_selector.items()),
               term.topology_key)
        tid = term_ids.get(key)
        if tid is None:
            tid = len(term_meta)
            term_ids[key] = tid
            term_meta.append((ns_scope, dict(term.label_selector),
                              term.topology_key))
        return tid

    for pod in pending_pods:
        aff = pod.spec.affinity
        aff_ids: List[int] = []
        anti_ids: List[int] = []
        if aff is not None:
            if aff.pod_affinity is not None:
                aff_ids = [intern_term(pod, t)
                           for t in aff.pod_affinity.required_during_scheduling]
            if aff.pod_anti_affinity is not None:
                anti_ids = [
                    intern_term(pod, t)
                    for t in aff.pod_anti_affinity.required_during_scheduling]
        pod_terms.append((aff_ids, anti_ids))
    return term_meta, pod_terms


def _matching_services(pod: api.Pod, services: Sequence[api.Service]
                       ) -> List[api.Service]:
    """Services whose selector covers the pod, in lister order (the
    get_pod_services rule: empty service namespace matches any pod
    namespace, empty selectors never match)."""
    return [svc for svc in services
            if (not svc.metadata.namespace
                or svc.metadata.namespace == pod.metadata.namespace)
            and svc.spec.selector
            and _selector_matches(svc.spec.selector, pod.metadata.labels)]


def _pod_spread_selectors(pod: api.Pod,
                          services: Sequence[api.Service],
                          controllers: Sequence[api.ReplicationController]
                          ) -> List[Dict[str, str]]:
    """Selectors SelectorSpread derives for a pod (selector_spreading.go:50-64
    via the service/controller listers; an empty lister namespace matches any
    pod namespace, matching the lister implementations)."""
    out: List[Dict[str, str]] = [
        dict(svc.spec.selector) for svc in _matching_services(pod, services)]
    for rc in controllers:
        if rc.metadata.namespace and \
                rc.metadata.namespace != pod.metadata.namespace:
            continue
        if rc.spec.selector and \
                _selector_matches(rc.spec.selector, pod.metadata.labels):
            out.append(dict(rc.spec.selector))
    return out


def _disk_keys(volume: api.Volume) -> Tuple[List[object], bool]:
    """(conflict keys, gce_read_only). Keys are hashable tuples; RBD yields
    one key per monitor so a shared monitor is a shared bit
    (predicates.go:75-117 isVolumeConflict)."""
    if volume.gce_persistent_disk is not None:
        return ([("gce", volume.gce_persistent_disk.pd_name)],
                volume.gce_persistent_disk.read_only)
    if volume.aws_elastic_block_store is not None:
        return [("ebs", volume.aws_elastic_block_store.volume_id)], False
    if volume.rbd is not None:
        return ([("rbd", mon, volume.rbd.rbd_pool, volume.rbd.rbd_image)
                 for mon in volume.rbd.ceph_monitors], False)
    return [], False


def encode_snapshot(snap: ClusterSnapshot, node_pad_to: int = 1,
                    pod_pad_to: Optional[int] = None,
                    policy: Optional[DevicePolicy] = None) -> EncodeResult:
    """Encode a cluster snapshot into device-ready arrays.

    `node_pad_to`: pad the node axis to a multiple of this (shard count);
    padded nodes have valid=False and never receive assignments.
    `pod_pad_to`: pad the pod axis to at least this many entries (stable
    scan lengths -> stable XLA compile cache); padded pods are invalid and
    never match or update state.
    """
    nodes = snap.nodes
    n_real = len(nodes)
    n_pad = max(1, -(-max(n_real, 1) // node_pad_to) * node_pad_to)
    p = len(snap.pending_pods)
    p_pad = max(1, p, pod_pad_to or 0)

    node_idx: Dict[str, int] = {n.metadata.name: i for i, n in enumerate(nodes)}

    # ------------------------------------------------------ dictionaries
    labels_dict = _Interner()
    for n in nodes:
        for kv in n.metadata.labels.items():
            labels_dict.intern(kv)
    for pod in snap.pending_pods:
        for kv in pod.spec.node_selector.items():
            labels_dict.intern(kv)

    ports_dict = _Interner()
    disk_dict = _Interner()
    for pod in list(snap.existing_pods) + list(snap.pending_pods):
        for c in pod.spec.containers:
            for cp in c.ports:
                if cp.host_port != 0:
                    ports_dict.intern(cp.host_port)
        for v in pod.spec.volumes:
            for key in _disk_keys(v)[0]:
                disk_dict.intern(key)

    L = _words(len(labels_dict))
    PW = _words(len(ports_dict))
    K = _words(len(disk_dict))

    # ------------------------------------------------------ node table
    nt = NodeArrays(
        valid=np.zeros(n_pad, bool),
        sched_ok=np.zeros(n_pad, bool),
        cpu_cap=np.zeros(n_pad, np.int64),
        mem_cap=np.zeros(n_pad, np.int64),
        pod_cap=np.zeros(n_pad, np.int32),
        label_words=np.zeros((n_pad, L), np.uint32),
        tie_rank=np.full(n_pad, -1, np.int32),
        exceed_cpu=np.zeros(n_pad, bool),
        exceed_mem=np.zeros(n_pad, bool),
        aff_dom=np.zeros((0, 0), np.int32),  # filled after term interning
        zone_id=np.full(n_pad, -1, np.int32),
        zone_scratch=np.zeros(1, np.int32),
        static_mask=np.ones(n_pad, bool),
        static_score=np.zeros(n_pad, np.int64))
    for i, n in enumerate(nodes):
        nt.valid[i] = True
        nt.sched_ok[i] = node_schedulable(n)
        cap = n.status.capacity
        nt.cpu_cap[i] = cap["cpu"].milli if "cpu" in cap else 0
        nt.mem_cap[i] = cap["memory"].value if "memory" in cap else 0
        nt.pod_cap[i] = cap["pods"].value if "pods" in cap else 0
        for kv in n.metadata.labels.items():
            _set_bit(nt.label_words[i], labels_dict.intern(kv))
    # deterministic tie-break = lexicographically largest name among the
    # max-score set (reference sort order: score desc then name desc,
    # api/types.go:164-169 + sort.Reverse) -> rank by name ascending
    for rank, name in enumerate(sorted(node_idx)):
        nt.tie_rank[node_idx[name]] = rank

    # ------------------------------------------------------ initial state
    # group pending pods by spread selector set first so G is known
    group_ids: Dict[object, int] = {}
    group_meta: List[Tuple[str, List[Dict[str, str]]]] = []
    pod_groups: List[int] = []
    for pod in snap.pending_pods:
        sels = _pod_spread_selectors(pod, snap.services, snap.controllers)
        if not sels:
            pod_groups.append(-1)
            continue
        key = (pod.metadata.namespace,
               frozenset(frozenset(s.items()) for s in sels))
        gid = group_ids.get(key)
        if gid is None:
            gid = len(group_meta)
            group_ids[key] = gid
            group_meta.append((pod.metadata.namespace, sels))
        pod_groups.append(gid)
    G = max(1, len(group_meta))

    # --------------------------------------------- inter-pod affinity terms
    # (BASELINE config 4; semantics defined by the oracle predicate,
    # predicates.new_inter_pod_affinity_predicate). Terms are interned by
    # (resolved namespace scope, selector, topology key); each term gets a
    # per-node topology-domain id and running scope counts in the carry.
    term_meta, pod_terms = collect_affinity_terms(snap.pending_pods)
    T = max(1, len(term_meta))

    def in_term_scope(p: api.Pod, tid: int) -> bool:
        # same matcher the oracle's pod_matches_term uses, against the
        # interned (namespace scope, selector) pair
        ns_scope, selector, _ = term_meta[tid]
        if p.metadata.namespace not in ns_scope:
            return False
        return labelspkg.selector_from_set(selector).matches(p.metadata.labels)

    # per-term topology domains over the node table
    aff_dom = np.full((T, n_pad), -1, np.int32)
    dom_ids: List[Dict[str, int]] = [dict() for _ in range(T)]
    for tid, (_, _, topo_key) in enumerate(term_meta):
        for i, n in enumerate(nodes):
            value = n.metadata.labels.get(topo_key)
            if value is None:
                continue
            dom = dom_ids[tid].setdefault(value, len(dom_ids[tid]))
            aff_dom[tid, i] = dom
    D = max(1, max((len(d) for d in dom_ids), default=0))

    aff_count = np.zeros((T, D), np.int32)
    aff_total = np.zeros(T, np.int32)
    if term_meta:
        # scope counts over the snapshot's running pods. A pod's domain is
        # resolved through the FULL node cache (all_nodes) — a peer on a
        # cached-but-unschedulable node still occupies its domain, exactly
        # as the serial predicate sees through node_by_name. Domains whose
        # value no candidate node carries can never satisfy a term, so
        # those peers count only toward the bootstrap total.
        labels_by_node: Dict[str, Dict[str, str]] = {
            n.metadata.name: n.metadata.labels
            for n in (snap.all_nodes if snap.all_nodes is not None
                      else snap.nodes)}
        for epod in filter_non_running_pods(snap.existing_pods):
            host_labels = labels_by_node.get(epod.spec.node_name)
            for tid, (_, _, topo_key) in enumerate(term_meta):
                if not in_term_scope(epod, tid):
                    continue
                aff_total[tid] += 1
                if host_labels is None:
                    continue
                value = host_labels.get(topo_key)
                dom = dom_ids[tid].get(value) if value is not None else None
                if dom is not None:
                    aff_count[tid, dom] += 1

    # ----------------------------------------- policy tier (DevicePolicy)
    pol = policy or DevicePolicy()
    for i, n in enumerate(nodes):
        node_labels = n.metadata.labels
        for wanted, presence in pol.label_presence:
            # ref: predicates.go:292 CheckNodeLabelPresence
            for label in wanted:
                exists = label in node_labels
                if (exists and not presence) or (not exists and presence):
                    nt.static_mask[i] = False
        for label, presence, weight in pol.label_priorities:
            # ref: priorities.go:148 — 0 or 10, weighted
            exists = label in node_labels
            success = (exists and presence) or (not exists and not presence)
            nt.static_score[i] += (10 if success else 0) * weight

    # ServiceAntiAffinity groups: one per (namespace, first matching
    # service's selector) over the pending pods (the oracle consults
    # services[0] only, selector_spreading.go:140)
    svc_groups: Dict[object, int] = {}
    svc_meta: List[Tuple[str, Dict[str, str]]] = []
    pod_svc_group: List[int] = []
    if pol.needs_anti_affinity:
        zone_vals: Dict[str, int] = {}
        for i, n in enumerate(nodes):
            value = n.metadata.labels.get(pol.anti_affinity_label)
            if value is not None:
                nt.zone_id[i] = zone_vals.setdefault(value, len(zone_vals))
        nt.zone_scratch = np.zeros(max(1, len(zone_vals)), np.int32)
        for pod in snap.pending_pods:
            matches = _matching_services(pod, snap.services)
            first = matches[0] if matches else None
            if first is None:
                pod_svc_group.append(-1)
                continue
            key = (pod.metadata.namespace,
                   frozenset(first.spec.selector.items()))
            gid = svc_groups.get(key)
            if gid is None:
                gid = len(svc_meta)
                svc_groups[key] = gid
                svc_meta.append((pod.metadata.namespace,
                                 dict(first.spec.selector)))
            pod_svc_group.append(gid)
    else:
        pod_svc_group = [-1] * len(snap.pending_pods)
    S = max(1, len(svc_meta))

    svc_count = np.zeros((S, n_pad), np.int32)
    svc_total = np.zeros(S, np.int32)
    for gid, (ns, sel) in enumerate(svc_meta):
        # the oracle lists via pod_lister.list(selector) with NO phase
        # filter (selector_spreading.go:140-147)
        for epod in snap.existing_pods:
            if epod.metadata.namespace != ns:
                continue
            if not _selector_matches(sel, epod.metadata.labels):
                continue
            svc_total[gid] += 1
            i = node_idx.get(epod.spec.node_name)
            if i is not None:
                svc_count[gid, i] += 1

    st = StateArrays(
        cpu_used=np.zeros(n_pad, np.int64),
        mem_used=np.zeros(n_pad, np.int64),
        nz_cpu=np.zeros(n_pad, np.int64),
        nz_mem=np.zeros(n_pad, np.int64),
        pod_count=np.zeros(n_pad, np.int32),
        port_bits=np.zeros((n_pad, PW), np.uint32),
        disk_any=np.zeros((n_pad, K), np.uint32),
        disk_rw=np.zeros((n_pad, K), np.uint32),
        spread=np.zeros((G, n_pad), np.int32),
        aff_count=aff_count,
        aff_total=aff_total,
        svc_count=svc_count,
        svc_total=svc_total)
    nt.aff_dom = aff_dom
    offgrid: List[Dict[str, int]] = [dict() for _ in range(G)]

    by_node: Dict[int, List[api.Pod]] = {}
    for pod in snap.existing_pods:
        # spread counts use the UNfiltered pod list (selector_spreading.go)
        for gid, (ns, sels) in enumerate(group_meta):
            if pod.metadata.namespace != ns:
                continue
            if any(_selector_matches(s, pod.metadata.labels) for s in sels):
                host = pod.spec.node_name
                i = node_idx.get(host)
                if i is None:
                    offgrid[gid][host] = offgrid[gid].get(host, 0) + 1
                else:
                    st.spread[gid, i] += 1
        # everything below mirrors MapPodsToMachines' phase filter
        # (predicates.go:429,445)
        if pod.status.phase in (api.POD_SUCCEEDED, api.POD_FAILED):
            continue
        i = node_idx.get(pod.spec.node_name)
        if i is None:
            continue
        by_node.setdefault(i, []).append(pod)

    for i, pods in by_node.items():
        cpu_cap = int(nt.cpu_cap[i])
        mem_cap = int(nt.mem_cap[i])
        cpu_used = 0
        mem_used = 0
        for pod in pods:
            # order-dependent skip-on-misfit replay (predicates.go:160-185)
            req_cpu, req_mem = get_resource_request(pod)
            fits_cpu = cpu_cap == 0 or (cpu_cap - cpu_used) >= req_cpu
            fits_mem = mem_cap == 0 or (mem_cap - mem_used) >= req_mem
            if not fits_cpu:
                nt.exceed_cpu[i] = True
            elif not fits_mem:
                nt.exceed_mem[i] = True
            else:
                cpu_used += req_cpu
                mem_used += req_mem
            for c in pod.spec.containers:
                nz_c, nz_m = get_nonzero_requests(c.resources.requests)
                st.nz_cpu[i] += nz_c
                st.nz_mem[i] += nz_m
                for cp in c.ports:
                    if cp.host_port != 0:
                        _set_bit(st.port_bits[i],
                                 ports_dict.intern(cp.host_port))
            for v in pod.spec.volumes:
                keys, gce_ro = _disk_keys(v)
                for key in keys:
                    bit = disk_dict.intern(key)
                    _set_bit(st.disk_any[i], bit)
                    if v.gce_persistent_disk is not None and not gce_ro:
                        _set_bit(st.disk_rw[i], bit)
        st.cpu_used[i] = cpu_used
        st.mem_used[i] = mem_used
        st.pod_count[i] = len(pods)

    offgrid_max = np.zeros(G, np.int32)
    for gid, buckets in enumerate(offgrid):
        if buckets:
            offgrid_max[gid] = max(buckets.values())

    # ------------------------------------------------------ pod batch
    pb = PodArrays(
        valid=np.zeros(p_pad, bool),
        req_cpu=np.zeros(p_pad, np.int64),
        req_mem=np.zeros(p_pad, np.int64),
        zero_req=np.zeros(p_pad, bool),
        nz_cpu=np.zeros(p_pad, np.int64),
        nz_mem=np.zeros(p_pad, np.int64),
        sel_words=np.zeros((p_pad, L), np.uint32),
        port_words=np.zeros((p_pad, PW), np.uint32),
        disk_qany=np.zeros((p_pad, K), np.uint32),
        disk_qrw=np.zeros((p_pad, K), np.uint32),
        disk_sany=np.zeros((p_pad, K), np.uint32),
        disk_srw=np.zeros((p_pad, K), np.uint32),
        host_idx=np.full(p_pad, -1, np.int32),
        group_id=np.full(p_pad, -1, np.int32),
        member=np.zeros((p_pad, G), np.int32),
        aff_req=np.zeros((p_pad, T), bool),
        anti_req=np.zeros((p_pad, T), bool),
        aff_member=np.zeros((p_pad, T), np.int32),
        svc_group=np.full(p_pad, -1, np.int32),
        svc_member=np.zeros((p_pad, S), np.int32))
    for j, pod in enumerate(snap.pending_pods):
        pb.valid[j] = True
        req_cpu, req_mem = get_resource_request(pod)
        pb.req_cpu[j] = req_cpu
        pb.req_mem[j] = req_mem
        pb.zero_req[j] = req_cpu == 0 and req_mem == 0
        for c in pod.spec.containers:
            nz_c, nz_m = get_nonzero_requests(c.resources.requests)
            pb.nz_cpu[j] += nz_c
            pb.nz_mem[j] += nz_m
            for cp in c.ports:
                if cp.host_port != 0:
                    _set_bit(pb.port_words[j], ports_dict.intern(cp.host_port))
        for kv in pod.spec.node_selector.items():
            _set_bit(pb.sel_words[j], labels_dict.intern(kv))
        for v in pod.spec.volumes:
            keys, gce_ro = _disk_keys(v)
            is_gce = v.gce_persistent_disk is not None
            for key in keys:
                bit = disk_dict.intern(key)
                _set_bit(pb.disk_sany[j], bit)
                if is_gce and gce_ro:
                    _set_bit(pb.disk_qrw[j], bit)
                else:
                    _set_bit(pb.disk_qany[j], bit)
                if is_gce and not gce_ro:
                    _set_bit(pb.disk_srw[j], bit)
        if pod.spec.node_name:
            pb.host_idx[j] = node_idx.get(pod.spec.node_name, -2)
        aff_ids, anti_ids = pod_terms[j]
        for tid in aff_ids:
            pb.aff_req[j, tid] = True
        for tid in anti_ids:
            pb.anti_req[j, tid] = True
        if term_meta:
            for tid in range(len(term_meta)):
                if in_term_scope(pod, tid):
                    pb.aff_member[j, tid] = 1
        pb.group_id[j] = pod_groups[j]
        for gid, (ns, sels) in enumerate(group_meta):
            if pod.metadata.namespace != ns:
                continue
            if any(_selector_matches(s, pod.metadata.labels) for s in sels):
                pb.member[j, gid] = 1
        pb.svc_group[j] = pod_svc_group[j]
        for gid, (ns, sel) in enumerate(svc_meta):
            if pod.metadata.namespace == ns and \
                    _selector_matches(sel, pod.metadata.labels):
                pb.svc_member[j, gid] = 1

    nt, st, pb, mem_scale = _maybe_narrow(nt, st, pb)
    return EncodeResult(
        node_tab=nt, pod_batch=pb, init_state=st, offgrid_max=offgrid_max,
        node_names=[n.metadata.name for n in nodes] + [""] * (n_pad - n_real),
        n_nodes=n_real, n_pods=p, mem_scale=mem_scale)
