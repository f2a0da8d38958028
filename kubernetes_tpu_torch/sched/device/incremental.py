"""Incremental device-state encoder: watch deltas -> persistent arrays.

SURVEY.md section 7 hard part 4: the full encoder (tables.encode_snapshot)
re-walks every node and every existing pod for every tile, so per-tile
host cost grows with cluster size — the serial MapPodsToMachines
pathology (predicates.go:445) reborn on the host. This encoder instead
maintains the Struct-of-Arrays cluster state persistently and applies
watch-stream deltas (the reference's reflector feed,
client/cache/reflector.go:225) plus the scheduler's own assume() calls,
so encoding a tile costs O(tile), independent of cluster size.

Fidelity contract (vs tables.encode_snapshot, which remains the oracle
for parity tests):
  - aggregates, bitsets, and spread counts are maintained to the same
    definitions: resource sums replay CheckPodsExceedingFreeResources'
    skip-on-misfit accounting (predicates.go:160-185), nonzero-request
    sums (priorities.go:53-54), selector-spread groups over the
    UNfiltered pod set (selector_spreading.go:43-114), MapPodsToMachines'
    Succeeded/Failed phase filter for resource state (predicates.go:429).
  - deliberate divergence: the misfit replay runs in event ARRIVAL order,
    not snapshot list order. The two only differ when a node is
    oversubscribed with a mix of fitting and misfitting pods whose order
    matters; the full encoder stays authoritative for that edge and the
    parity suite pins it.
  - scope: the default provider tier plus the inter-pod affinity tier
    (terms/domains/scope-counts computed per tile from the LEDGER —
    one pass over cheap records, not the full O(cluster) re-encode).
    Engines configured with a DevicePolicy needing anti-affinity (zone
    spreading) should not use this path.

Shape stability: node capacity and interner word capacities grow by
doubling, so array shapes change O(log) times over a cluster's life, not
per tile (a device carry chains across tiles only while they agree).

The port's own copy of the JAX package's encoder (numpy only). The
preemption victim table (`victim_table`) waits for the port of
sched/preemption.py and raises until then.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from ...core import types as api
from ..modeler import ASSUMED_POD_TTL
from ..predicates import get_resource_request, node_schedulable
from ..priorities import get_nonzero_requests
from .tables import (WORD, EncodeResult, NodeArrays, PodArrays, StateArrays,
                     TableDelta, _disk_keys, _matching_services,
                     _pod_spread_selectors, _selector_matches, _set_bit,
                     _words, collect_affinity_terms)


class NeedsFullEncode(Exception):
    """Tile needs a feature this encoder doesn't maintain incrementally.

    Currently raised by NO tier (the affinity tier, the last holdout,
    went ledger-fed) — kept as the escape-hatch contract: a future tier
    may raise it and the batch scheduler's handler (sched/batch.py)
    routes such tiles through the full snapshot encoder."""


def replace_pod_batch_dtypes(pb: PodArrays, narrow: bool,
                             mem_scale: int) -> PodArrays:
    """Narrow a freshly-built pod batch's resource arrays in place
    (the tile arrays are private to this encode call)."""
    if not narrow:
        return pb
    pb.req_cpu = pb.req_cpu.astype(np.int32)
    pb.nz_cpu = pb.nz_cpu.astype(np.int32)
    pb.req_mem = (pb.req_mem // mem_scale).astype(np.int32)
    pb.nz_mem = (pb.nz_mem // mem_scale).astype(np.int32)
    return pb


def _grow(arr: np.ndarray, axis: int, new_len: int) -> np.ndarray:
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, new_len - arr.shape[axis])
    return np.pad(arr, pad)


# process-wide encoder identity (TableDelta.encoder_id): never reused
# within a process, unlike id()
_ENCODER_ID_NEXT = 1
_ENCODER_ID_LOCK = threading.Lock()


class _GrowingInterner:
    """String->bit-index dictionary with a word capacity that doubles;
    exposes the current padded word count so bitset shapes stay stable
    between growths."""

    def __init__(self, min_words: int = 1):
        self.ids: Dict[object, int] = {}
        self.words = min_words

    def intern(self, key: object) -> Tuple[int, bool]:
        """-> (bit index, grew) — grew means bitset arrays must widen."""
        idx = self.ids.get(key)
        if idx is not None:
            return idx, False
        idx = len(self.ids)
        self.ids[key] = idx
        if _words(len(self.ids)) > self.words:
            self.words *= 2
            return idx, True
        return idx, False


class _Group:
    """One selector-spread group (ns, selector set): per-node counts plus
    the off-table bucket (unassigned '' / unknown hosts)."""

    __slots__ = ("ns", "sels", "row", "offgrid")

    def __init__(self, ns: str, sels: List[Dict[str, str]], cap: int):
        self.ns = ns
        self.sels = sels
        self.row = np.zeros(cap, np.int32)
        self.offgrid: Dict[str, int] = {}

    def matches(self, ns: str, labels: Dict[str, str]) -> bool:
        return ns == self.ns and any(
            _selector_matches(s, labels) for s in self.sels)


class _PodRecord:
    __slots__ = ("rv", "node", "slot", "ns", "labels", "counted_res",
                 "misfit", "req_cpu", "req_mem", "nz_cpu", "nz_mem",
                 "ports", "disks", "priority", "uid")

    def __init__(self):
        self.rv = ""
        self.node = ""
        self.slot: Optional[int] = None
        self.ns = ""
        self.labels: Dict[str, str] = {}
        self.counted_res = False   # phase not Succeeded/Failed at count time
        self.misfit: Optional[str] = None   # 'cpu' | 'mem' | None
        self.req_cpu = 0
        self.req_mem = 0
        self.nz_cpu = 0
        self.nz_mem = 0
        self.ports: List[int] = []
        self.disks: List[Tuple[int, bool, bool]] = []  # (bit, any_q, rw)
        # preemption columns: the victim search orders candidates by
        # priority and evicts by uid-preconditioned delete (sched/
        # preemption.py) — both must come from the record, not a re-read
        self.priority = 0
        self.uid = ""


class IncrementalEncoder:
    """Persistent cluster arrays fed by pod/node watch deltas."""

    def __init__(self, node_capacity: int = 64, policy=None,
                 mesh_devices: int = 1):
        """policy: a DevicePolicy whose NODE-STATIC tiers (label
        presence/priorities) are maintained incrementally; the
        anti-affinity tier needs per-tile service groups and stays with
        the full encoder (callers must not pass one that needs it).

        mesh_devices: shard count of the engine this encoder feeds. The
        node capacity rounds up to a multiple of it — here and on every
        growth — so the device node axis always splits evenly across
        the mesh without a caller-side pad, and a slot's shard
        assignment (block sharding over stable slots) never moves
        except at a capacity growth, which invalidates the device
        table cache wholesale anyway."""
        if policy is not None and policy.needs_anti_affinity:
            raise ValueError(
                "IncrementalEncoder: anti-affinity policies need the "
                "full per-tile encoder")
        self._policy = policy
        self.mesh_devices = max(1, int(mesh_devices))
        node_capacity = -(-max(1, node_capacity) // self.mesh_devices) \
            * self.mesh_devices
        self._lock = threading.RLock()
        # interners shared across the encoder's life
        self.labels_dict = _GrowingInterner()
        self.ports_dict = _GrowingInterner()
        self.disk_dict = _GrowingInterner()
        # spec-identity -> spec-derived record fields (columnar creates
        # share one spec across a batch; see _build_record)
        self._spec_memo: Dict[int, tuple] = {}

        # ---- node table (slot-stable: a node keeps its index for life) --
        self.n_cap = node_capacity
        self.node_slot: Dict[str, int] = {}
        self.node_names: List[str] = [""] * self.n_cap
        # raw label dicts per slot: the affinity tier resolves topology
        # domains from them (kept for INVALID slots too — a peer pod on
        # a cached-but-unschedulable node still occupies its domain,
        # the serial predicate's node_by_name view)
        self.node_labels: List[Dict[str, str]] = [
            {} for _ in range(self.n_cap)]
        self._free_slots: List[int] = []
        self._next_slot = 0   # high-water mark: len(node_slot) stops
                              # being the next-free index once slots
                              # are ever reclaimed
        # valid: slot is occupied by a known node; sched_ok: that node is
        # a live binding target (predicates.node_schedulable — Ready, not
        # Unknown, not cordoned). The engine masks on valid & sched_ok,
        # so a NotReady node keeps its slot (its pods keep counting into
        # spread rows and topology domains, the serial node_by_name view)
        # but never receives a binding. A condition flip arrives as a
        # node update -> _node_upsert bumps state_epoch, which retires
        # the node from any in-flight device carry (the batch scheduler
        # refuses to chain across an epoch change and re-encodes).
        self.valid = np.zeros(self.n_cap, bool)
        self.sched_ok = np.zeros(self.n_cap, bool)
        self.cpu_cap = np.zeros(self.n_cap, np.int64)
        self.mem_cap = np.zeros(self.n_cap, np.int64)
        self.pod_cap = np.zeros(self.n_cap, np.int32)
        self.label_words = np.zeros((self.n_cap, 1), np.uint32)
        self.tie_rank = np.full(self.n_cap, -1, np.int32)
        self._tie_dirty = False
        # node-static policy tiers (CheckNodeLabelPresence /
        # CalculateNodeLabelPriority), recomputed per node at upsert
        self.static_mask = np.ones(self.n_cap, bool)
        self.static_score = np.zeros(self.n_cap, np.int64)

        # ---- per-node aggregates (the State init the engine consumes) --
        self.cpu_used = np.zeros(self.n_cap, np.int64)
        self.mem_used = np.zeros(self.n_cap, np.int64)
        self.nz_cpu = np.zeros(self.n_cap, np.int64)
        self.nz_mem = np.zeros(self.n_cap, np.int64)
        self.pod_count = np.zeros(self.n_cap, np.int32)
        self.port_bits = np.zeros((self.n_cap, 1), np.uint32)
        self.disk_any = np.zeros((self.n_cap, 1), np.uint32)
        self.disk_rw = np.zeros((self.n_cap, 1), np.uint32)
        self.exceed_cpu = np.zeros(self.n_cap, bool)
        self.exceed_mem = np.zeros(self.n_cap, bool)

        # i32 narrowing metadata (tables._maybe_narrow's contract): the
        # HOST arrays stay raw i64 — only the per-tile device copies are
        # divided by the running gcd and cast when provably exact. The
        # gcd is monotone (only shrinks), so no rescaling ever happens.
        self._mem_gcd = 0
        self._mem_cap_max = 0
        self._mem_req_max = 0
        self._cpu_cap_max = 0
        self._cpu_req_max = 0

        # ---- ledgers --
        self.pods: Dict[str, _PodRecord] = {}
        # per-slot insertion-ordered pod keys (replay order for misfit
        # recompute); unknown-host pods parked by node name
        self.node_pods: Dict[int, List[str]] = {}
        self.unknown_node_pods: Dict[str, Set[str]] = {}
        self.groups: Dict[object, _Group] = {}
        # delete tombstones, keyed (ns/name, uid) like the modeler's
        # (modeler.py _forgotten): a DELETED event that lands BEFORE the
        # committer's assume for the same pod must win, or the assume
        # re-adds a ledger record no future event will ever remove —
        # phantom capacity and an entry leaked for the process lifetime
        # (the 5k-node soak caught ~1-in-54k churned pods doing exactly
        # this under heavy GIL contention). uid-scoped so a recreated
        # same-name pod assumes normally.
        self._del_tombstones: Dict[Tuple[str, str], float] = {}
        self._del_order: deque = deque()

        # ---- device-carry bookkeeping (the pipelined scheduler chains
        # tile k+1's scan off tile k's on-device final state; that's
        # sound only while the host arrays stay bit-equal to what the
        # device carry represents). state_epoch bumps on ANY mutation of
        # the node aggregate state except assume_assigned's own
        # vectorized updates — those match the device scan's one-hot
        # updates exactly, so they keep host == carry.
        self.state_epoch = 0
        # worst-case pods already in flight on device but not yet
        # assumed host-side: _narrow_params must budget for them
        self.inflight_pad = 0

        # ---- dirty-slot journal for the engine's device-resident table
        # cache (tables.TableDelta / engine._TableCache). _table_gen is a
        # monotonic mutation counter; the two per-slot arrays record the
        # counter value at each slot's last change, split by which device
        # table the change lands in: NodeConst rows (caps, labels, tie
        # rank, schedulability, misfit flags) move only on node events
        # and misfits, while State rows (running sums, bitsets) move on
        # every pod event — including assume_assigned's fast path, which
        # deliberately does NOT bump state_epoch (the device carry
        # already holds those updates) but DOES journal here (the cached
        # State init mirror does not). _full_dirty_gen marks the last
        # whole-table invalidation: capacity growth reshapes — and
        # therefore re-shards — every array.
        self._table_gen = 0
        self._node_dirty_gen = np.zeros(self.n_cap, np.int64)
        self._state_dirty_gen = np.zeros(self.n_cap, np.int64)
        self._full_dirty_gen = 0
        # epoch-per-shard: one counter per mesh shard, stamped into
        # every TableDelta. The slot->shard mapping is block sharding
        # over stable slots, so an epoch moves ONLY when that mapping
        # moves — reshard() (survivor re-shard after a shard owner
        # dies) replaces the vector wholesale. The engine's table cache
        # and the batch scheduler's in-flight fencing both compare the
        # whole vector: a tile encoded against a dead shard's epoch can
        # neither reuse the mirror nor commit its bindings.
        self._shard_epochs: Tuple[int, ...] = (0,) * self.mesh_devices
        # instance token stamped into every TableDelta: generations from
        # two encoders are incomparable (see tables.TableDelta), and
        # id() can be recycled after gc — a process-wide counter cannot
        with _ENCODER_ID_LOCK:
            global _ENCODER_ID_NEXT
            self._encoder_id = _ENCODER_ID_NEXT
            _ENCODER_ID_NEXT += 1

    def _mark_node(self, slots) -> None:
        """Caller holds the lock. Journal NodeConst-side change(s) at a
        fresh generation (scalar int or integer array)."""
        self._table_gen += 1
        self._node_dirty_gen[slots] = self._table_gen

    def _mark_state(self, slots) -> None:
        """Caller holds the lock. Journal State-side change(s)."""
        self._table_gen += 1
        self._state_dirty_gen[slots] = self._table_gen

    def _mark_full(self) -> None:
        self._table_gen += 1
        self._full_dirty_gen = self._table_gen

    # ================================================== watch delta feed

    def on_pod_add(self, pod: api.Pod) -> None:
        with self._lock:
            self._pod_upsert(pod)

    def on_pod_update(self, old: api.Pod, new: api.Pod) -> None:
        with self._lock:
            self._pod_upsert(new)

    # the SAME window as the modeler's forget tombstones — the two
    # solve one race at two ledgers and must not drift apart
    _DEL_TOMBSTONE_TTL = ASSUMED_POD_TTL

    def on_pod_delete(self, pod: api.Pod) -> None:
        with self._lock:
            key = f"{pod.metadata.namespace}/{pod.metadata.name}"
            now = time.monotonic()
            tkey = (key, pod.metadata.uid)
            self._del_tombstones[tkey] = now
            self._del_order.append((now, tkey))
            ttl = self._DEL_TOMBSTONE_TTL
            order = self._del_order
            while order and now - order[0][0] > ttl:
                ts, k = order.popleft()
                if self._del_tombstones.get(k) == ts:
                    del self._del_tombstones[k]
            rec = self.pods.pop(key, None)
            if rec is not None:
                self._remove_record(key, rec)

    def _deleted_recently(self, key: str, uid: str) -> bool:
        """Caller holds the lock. True while the pod's DELETED event is
        within the tombstone window — an assume arriving now lost the
        race and must not resurrect the ledger entry."""
        ts = self._del_tombstones.get((key, uid))
        return (ts is not None
                and time.monotonic() - ts <= self._DEL_TOMBSTONE_TTL)

    def assume(self, pod: api.Pod) -> None:
        """Count a just-bound pod before the watch confirms it (the
        modeler.AssumePod moment, modeler.go:113). A pod whose DELETED
        event already landed is NOT resurrected (same rule as the
        modeler's forget tombstones)."""
        with self._lock:
            key = f"{pod.metadata.namespace}/{pod.metadata.name}"
            if self._deleted_recently(key, pod.metadata.uid):
                # a device carry may have counted this pod: re-encode
                # from host truth rather than chaining
                self.state_epoch += 1
                return
            self._pod_upsert(pod)

    def assume_assigned(self, enc: EncodeResult, pods: List[api.Pod],
                        assigned: np.ndarray) -> None:
        """Vectorized assume for a whole scheduled tile.

        `enc` is the EncodeResult this encoder produced for `pods`
        (row j <-> pods[j]); `assigned` is the engine's output (node slot
        or -1 per row). The tile arrays already hold every quantity a
        ledger record needs, so the per-pod spec re-walk assume() would
        do — measured at 20-30us/pod under benchmark load, serialized on
        the scheduler thread — collapses into O(tile) numpy scatter-adds
        plus cheap record construction.

        Fast-path exactness: when no mutation landed since the encode
        (state_epoch unchanged), the device verified every assignment's
        fit sequentially against state identical to the host arrays, so
        _apply_record's misfit branch provably cannot trigger and the
        batched scatter-adds commute to the same result as ordered
        replay. The updates then equal the device scan's one-hot updates
        exactly — which is what keeps the host arrays bit-equal to a
        chained device carry — so the fast path deliberately does NOT
        bump state_epoch. Pods the fast path can't express (host ports,
        disk volumes, an existing ledger record, a non-Pending phase)
        take the slow per-pod path, which does. If the epoch moved, the
        whole tile replays through the slow path."""
        pb = enc.pod_batch
        scale = enc.mem_scale
        with self._lock:
            p = enc.n_pods
            fast_ok = (enc.state_epoch >= 0
                       and self.state_epoch == enc.state_epoch)
            # numpy scalar indexing in a tight loop costs ~10x a list
            # index: lift everything the loop reads into Python lists
            assigned_l = np.asarray(assigned[:p]).tolist()
            ports_any_l = pb.port_words[:p].any(axis=1).tolist()
            disks_any_l = pb.disk_sany[:p].any(axis=1).tolist()
            req_cpu_l = pb.req_cpu[:p].tolist()
            req_mem_l = pb.req_mem[:p].tolist()
            nz_cpu_l = pb.nz_cpu[:p].tolist()
            nz_mem_l = pb.nz_mem[:p].tolist()
            tile_set = enc.tile_groups or []
            other_groups = [g for g in self.groups.values()
                            if g not in tile_set]
            ledger = self.pods
            node_names = self.node_names
            node_pods = self.node_pods
            fast_rows: List[int] = []
            for j in range(p):
                slot = assigned_l[j]
                if slot < 0:
                    continue
                pod = pods[j]
                meta = pod.metadata
                key = f"{meta.namespace}/{meta.name}"
                if self._del_tombstones and \
                        self._deleted_recently(key, meta.uid):
                    # the pod was bound, confirmed AND deleted before
                    # this finalize ran — re-adding it would leak a
                    # ledger record no future event removes. The device
                    # carry counted the pod, the host (correctly) does
                    # not: break the chain so the next tile re-encodes
                    # from host truth.
                    self.state_epoch += 1
                    continue
                if (not fast_ok or ports_any_l[j] or disks_any_l[j]
                        or key in ledger
                        or pod.status.phase in (api.POD_SUCCEEDED,
                                                api.POD_FAILED)):
                    # slow path: full record build + misfit replay
                    # (bumps state_epoch -> the device carry resyncs)
                    self._pod_upsert(api.fast_replace(
                        pod, spec=api.fast_replace(
                            pod.spec, node_name=node_names[slot])))
                    continue
                rec = _PodRecord()
                rec.rv = meta.resource_version or ""
                rec.node = node_names[slot]
                rec.slot = slot
                rec.ns = meta.namespace
                rec.labels = dict(meta.labels)
                rec.counted_res = True
                rec.priority = pod.spec.priority
                rec.uid = meta.uid
                rec.req_cpu = req_cpu_l[j]
                rec.req_mem = req_mem_l[j] * scale
                rec.nz_cpu = nz_cpu_l[j]
                rec.nz_mem = nz_mem_l[j] * scale
                ledger[key] = rec
                lst = node_pods.get(slot)
                if lst is None:
                    node_pods[slot] = [key]
                else:
                    lst.append(key)
                fast_rows.append(j)
                # groups outside this tile may also select the pod
                # (overlapping service selectors): _apply_record checks
                # every group, so must the fast path
                for g in other_groups:
                    if g.matches(rec.ns, rec.labels):
                        g.row[slot] += 1
            if not fast_rows:
                return
            rows = np.asarray(fast_rows, np.int64)
            slots = assigned[rows].astype(np.int64)
            # no state_epoch bump (the device carry already holds these
            # updates) but the cached State init mirror does not: journal
            # the touched slots so the next non-chained dispatch
            # re-uploads exactly these rows
            self._mark_state(slots)
            np.add.at(self.pod_count, slots, 1)
            np.add.at(self.cpu_used, slots, pb.req_cpu[rows])
            np.add.at(self.mem_used, slots,
                      pb.req_mem[rows].astype(np.int64) * scale)
            np.add.at(self.nz_cpu, slots, pb.nz_cpu[rows])
            np.add.at(self.nz_mem, slots,
                      pb.nz_mem[rows].astype(np.int64) * scale)
            for gid, g in enumerate(tile_set):
                members = rows[pb.member[rows, gid] == 1]
                if members.size:
                    np.add.at(g.row, assigned[members].astype(np.int64), 1)

    def on_node_add(self, node: api.Node) -> None:
        with self._lock:
            self._node_upsert(node)

    def on_node_update(self, old: api.Node, new: api.Node) -> None:
        with self._lock:
            self._node_upsert(new)

    def on_node_delete(self, node: api.Node) -> None:
        with self._lock:
            name = node.metadata.name
            slot = self.node_slot.pop(name, None)
            if slot is None:
                return
            self.state_epoch += 1
            self.valid[slot] = False
            self.sched_ok[slot] = False
            # a DELETED node left the informer cache: the serial path's
            # node_by_name can no longer resolve it, so peers bound to
            # it must stop occupying topology domains (NotReady-but-
            # cached nodes keep their labels — they arrive as updates,
            # not deletes, and still resolve domains)
            self.node_labels[slot] = {}
            self.node_names[slot] = ""
            # RECLAIM the slot: node-name churn (autoscalers, recycled
            # hollow fleets) must not grow the device node axis — and
            # every scan's [n_cap] width — without bound. The dead
            # node's pods detach to the off-table bucket (their later
            # deletes resolve slot None and skip slot arrays) and the
            # slot's accumulated state zeroes so a future occupant
            # starts clean; the epoch bump above invalidates any
            # in-flight carry chained on the old layout.
            for key in self.node_pods.pop(slot, []):
                rec = self.pods.get(key)
                if rec is None:
                    continue
                rec.slot = None
                self.unknown_node_pods.setdefault(rec.node,
                                                  set()).add(key)
            for g in self.groups.values():
                moved = int(g.row[slot])
                if moved:
                    g.offgrid[name] = g.offgrid.get(name, 0) + moved
                    g.row[slot] = 0
            self.pod_count[slot] = 0
            self.cpu_used[slot] = 0
            self.mem_used[slot] = 0
            self.nz_cpu[slot] = 0
            self.nz_mem[slot] = 0
            self.port_bits[slot] = 0
            self.disk_any[slot] = 0
            self.disk_rw[slot] = 0
            self.cpu_cap[slot] = 0
            self.mem_cap[slot] = 0
            self.pod_cap[slot] = 0
            # misfit flags too: a reused slot must not inherit the dead
            # node's phantom-oversubscribed state (the fit gate requires
            # not_exceeded — an empty successor would be unschedulable
            # forever)
            self.exceed_cpu[slot] = False
            self.exceed_mem[slot] = False
            self._free_slots.append(slot)
            self._tie_dirty = True
            self._mark_node(slot)
            self._mark_state(slot)

    # ================================================== pod bookkeeping

    def _pod_upsert(self, pod: api.Pod) -> None:
        key = f"{pod.metadata.namespace}/{pod.metadata.name}"
        old = self.pods.get(key)
        if old is not None:
            if old.rv and old.rv == pod.metadata.resource_version:
                return  # idempotent: bootstrap overlap / assume+watch echo
            new_counted = pod.status.phase not in (api.POD_SUCCEEDED,
                                                   api.POD_FAILED)
            if (old.node == pod.spec.node_name
                    and old.counted_res == new_counted
                    and old.labels == pod.metadata.labels):
                old.rv = pod.metadata.resource_version or old.rv
                return  # status-only change: nothing we count moved
            self._remove_record(key, old)
        rec = self._build_record(pod)
        self.pods[key] = rec
        self._apply_record(key, rec)

    def _build_record(self, pod: api.Pod) -> _PodRecord:
        rec = _PodRecord()
        rec.rv = pod.metadata.resource_version or ""
        rec.node = pod.spec.node_name
        rec.ns = pod.metadata.namespace
        rec.labels = dict(pod.metadata.labels)
        rec.counted_res = pod.status.phase not in (api.POD_SUCCEEDED,
                                                   api.POD_FAILED)
        # per-POD fields, set before the spec-memo early return below
        # (a shared template spec carries one priority, but uid is
        # per-object and priority may be overridden post-template)
        rec.priority = pod.spec.priority
        rec.uid = pod.metadata.uid
        # spec-derived fields memoized by spec IDENTITY: the columnar
        # create path (registry.create_from_template) shares one spec
        # across a whole batch, so the quantity parsing + port/disk
        # interning below runs once per template instead of per pod.
        # The cache entry holds the spec object itself, so the id() key
        # cannot be recycled while the entry lives; the side effects
        # the fast path skips (_note_mem gcd, _cpu_req_max, interner
        # growth) are value-idempotent — identical inputs change none
        # of them.
        sp = pod.spec
        ent = self._spec_memo.get(id(sp))
        if ent is not None and ent[0] is sp:
            (_, rec.req_cpu, rec.req_mem, rec.nz_cpu, rec.nz_mem,
             ports, disks) = ent
            rec.ports = list(ports)
            rec.disks = list(disks)
            return rec
        rec.req_cpu, rec.req_mem = get_resource_request(pod)
        for c in pod.spec.containers:
            nz_c, nz_m = get_nonzero_requests(c.resources.requests)
            rec.nz_cpu += nz_c
            rec.nz_mem += nz_m
            for cp in c.ports:
                if cp.host_port != 0:
                    bit, grew = self.ports_dict.intern(cp.host_port)
                    if grew:
                        self.port_bits = _grow(self.port_bits, 1,
                                               self.ports_dict.words)
                    rec.ports.append(bit)
        self._note_mem(rec.req_mem, is_cap=False)
        self._note_mem(rec.nz_mem, is_cap=False)
        self._cpu_req_max = max(self._cpu_req_max, rec.req_cpu,
                                rec.nz_cpu)
        for v in pod.spec.volumes:
            keys, gce_ro = _disk_keys(v)
            is_gce = v.gce_persistent_disk is not None
            for dk in keys:
                bit, grew = self.disk_dict.intern(dk)
                if grew:
                    self.disk_any = _grow(self.disk_any, 1,
                                          self.disk_dict.words)
                    self.disk_rw = _grow(self.disk_rw, 1,
                                         self.disk_dict.words)
                rec.disks.append((bit, True, is_gce and not gce_ro))
        if len(self._spec_memo) >= 64:
            # bound the held-alive specs; bound pods get fresh specs per
            # binding so ids churn — one template dominates in practice
            self._spec_memo.clear()
        self._spec_memo[id(sp)] = (sp, rec.req_cpu, rec.req_mem,
                                   rec.nz_cpu, rec.nz_mem,
                                   tuple(rec.ports), tuple(rec.disks))
        return rec

    def _apply_record(self, key: str, rec: _PodRecord) -> None:
        self.state_epoch += 1
        # spread groups see every pod (no phase filter)
        for g in self.groups.values():
            if g.matches(rec.ns, rec.labels):
                slot = self.node_slot.get(rec.node)
                if slot is None:
                    g.offgrid[rec.node] = g.offgrid.get(rec.node, 0) + 1
                else:
                    g.row[slot] += 1
        slot = self.node_slot.get(rec.node)
        if slot is None:
            self.unknown_node_pods.setdefault(rec.node, set()).add(key)
            return
        rec.slot = slot
        self.node_pods.setdefault(slot, []).append(key)
        if not rec.counted_res:
            return
        self._mark_state(slot)
        self.pod_count[slot] += 1
        self.nz_cpu[slot] += rec.nz_cpu
        self.nz_mem[slot] += rec.nz_mem
        for bit in rec.ports:
            _set_bit(self.port_bits[slot], bit)
        for bit, any_q, rw in rec.disks:
            _set_bit(self.disk_any[slot], bit)
            if rw:
                _set_bit(self.disk_rw[slot], bit)
        # skip-on-misfit replay, arrival order (predicates.go:160-185)
        cap_c = int(self.cpu_cap[slot])
        cap_m = int(self.mem_cap[slot])
        fits_cpu = cap_c == 0 or cap_c - int(self.cpu_used[slot]) >= rec.req_cpu
        fits_mem = cap_m == 0 or cap_m - int(self.mem_used[slot]) >= rec.req_mem
        if not fits_cpu:
            self.exceed_cpu[slot] = True
            rec.misfit = "cpu"
            self._mark_node(slot)  # exceed flags live in NodeConst
        elif not fits_mem:
            self.exceed_mem[slot] = True
            rec.misfit = "mem"
            self._mark_node(slot)
        else:
            self.cpu_used[slot] += rec.req_cpu
            self.mem_used[slot] += rec.req_mem

    def _remove_record(self, key: str, rec: _PodRecord) -> None:
        self.state_epoch += 1
        for g in self.groups.values():
            if g.matches(rec.ns, rec.labels):
                slot = self.node_slot.get(rec.node)
                if slot is None:
                    left = g.offgrid.get(rec.node, 0) - 1
                    if left > 0:
                        g.offgrid[rec.node] = left
                    else:
                        g.offgrid.pop(rec.node, None)
                else:
                    g.row[slot] -= 1
        if rec.slot is None:
            parked = self.unknown_node_pods.get(rec.node)
            if parked is not None:
                parked.discard(key)
                if not parked:
                    del self.unknown_node_pods[rec.node]
            return
        slot = rec.slot
        keys = self.node_pods.get(slot, [])
        try:
            keys.remove(key)
        except ValueError:
            pass
        if not rec.counted_res:
            return
        self._mark_state(slot)
        self.pod_count[slot] -= 1
        self.nz_cpu[slot] -= rec.nz_cpu
        self.nz_mem[slot] -= rec.nz_mem
        if rec.ports or rec.disks or self.exceed_cpu[slot] \
                or self.exceed_mem[slot]:
            # bitsets aren't reference-counted and the misfit replay is
            # order-dependent: rebuild this node's aggregates from its
            # remaining pods (rare path: ports/disks/oversubscription)
            self._replay_node(slot)
        elif rec.misfit is None:
            self.cpu_used[slot] -= rec.req_cpu
            self.mem_used[slot] -= rec.req_mem

    def _replay_node(self, slot: int) -> None:
        """Recompute one node's aggregate state from its pod ledger, in
        insertion order (the arrival-order replay)."""
        self._mark_state(slot)
        self._mark_node(slot)  # rewrites the exceed flags (NodeConst)
        self.cpu_used[slot] = 0
        self.mem_used[slot] = 0
        self.nz_cpu[slot] = 0
        self.nz_mem[slot] = 0
        self.pod_count[slot] = 0
        self.port_bits[slot] = 0
        self.disk_any[slot] = 0
        self.disk_rw[slot] = 0
        self.exceed_cpu[slot] = False
        self.exceed_mem[slot] = False
        cap_c = int(self.cpu_cap[slot])
        cap_m = int(self.mem_cap[slot])
        for key in self.node_pods.get(slot, []):
            rec = self.pods[key]
            if not rec.counted_res:
                continue
            rec.misfit = None
            self.pod_count[slot] += 1
            self.nz_cpu[slot] += rec.nz_cpu
            self.nz_mem[slot] += rec.nz_mem
            for bit in rec.ports:
                _set_bit(self.port_bits[slot], bit)
            for bit, any_q, rw in rec.disks:
                _set_bit(self.disk_any[slot], bit)
                if rw:
                    _set_bit(self.disk_rw[slot], bit)
            fits_cpu = cap_c == 0 or \
                cap_c - int(self.cpu_used[slot]) >= rec.req_cpu
            fits_mem = cap_m == 0 or \
                cap_m - int(self.mem_used[slot]) >= rec.req_mem
            if not fits_cpu:
                self.exceed_cpu[slot] = True
                rec.misfit = "cpu"
            elif not fits_mem:
                self.exceed_mem[slot] = True
                rec.misfit = "mem"
            else:
                self.cpu_used[slot] += rec.req_cpu
                self.mem_used[slot] += rec.req_mem

    # ================================================== node bookkeeping

    def _node_upsert(self, node: api.Node) -> None:
        self.state_epoch += 1
        name = node.metadata.name
        slot = self.node_slot.get(name)
        new_node = slot is None
        if new_node:
            slot = self._alloc_slot(name)
        self._mark_node(slot)
        cap_changed = (
            not new_node and (
                self.cpu_cap[slot] != (node.status.capacity["cpu"].milli
                                       if "cpu" in node.status.capacity else 0)
                or self.mem_cap[slot] != (
                    node.status.capacity["memory"].value
                    if "memory" in node.status.capacity else 0)))
        cap = node.status.capacity
        self.cpu_cap[slot] = cap["cpu"].milli if "cpu" in cap else 0
        self.mem_cap[slot] = cap["memory"].value if "memory" in cap else 0
        self._note_mem(int(self.mem_cap[slot]), is_cap=True)
        self._cpu_cap_max = max(self._cpu_cap_max,
                                int(self.cpu_cap[slot]))
        self.pod_cap[slot] = cap["pods"].value if "pods" in cap else 0
        self.label_words[slot] = 0
        self.node_labels[slot] = dict(node.metadata.labels)
        for kv in node.metadata.labels.items():
            bit, grew = self.labels_dict.intern(kv)
            if grew:
                self.label_words = _grow(self.label_words, 1,
                                         self.labels_dict.words)
            _set_bit(self.label_words[slot], bit)
        self.valid[slot] = True
        self.sched_ok[slot] = node_schedulable(node)
        if self._policy is not None:
            # same math as tables.py's policy tier (predicates.go:292 /
            # priorities.go:148), one node at a time
            labels = node.metadata.labels
            mask = True
            for wanted, presence in self._policy.label_presence:
                for label in wanted:
                    exists = label in labels
                    if (exists and not presence) or \
                            (not exists and presence):
                        mask = False
            score = 0
            for label, presence, weight in self._policy.label_priorities:
                exists = label in labels
                success = (exists and presence) or \
                    (not exists and not presence)
                score += (10 if success else 0) * weight
            self.static_mask[slot] = mask
            self.static_score[slot] = score
        if new_node:
            parked = self.unknown_node_pods.pop(name, None)
            if parked:
                for key in sorted(parked):
                    rec = self.pods[key]
                    # move spread counts from the offgrid bucket to the row
                    for g in self.groups.values():
                        if g.matches(rec.ns, rec.labels):
                            left = g.offgrid.get(name, 0) - 1
                            if left > 0:
                                g.offgrid[name] = left
                            else:
                                g.offgrid.pop(name, None)
                            g.row[slot] += 1
                    rec.slot = slot
                    self.node_pods.setdefault(slot, []).append(key)
                self._replay_node(slot)
        elif cap_changed:
            self._replay_node(slot)

    def _alloc_slot(self, name: str) -> int:
        if self._free_slots:
            slot = self._free_slots.pop()
        else:
            if self._next_slot >= self.n_cap:
                self._grow_nodes()
            slot = self._next_slot
            self._next_slot += 1
        self.node_slot[name] = slot
        self.node_names[slot] = name
        self._tie_dirty = True
        return slot

    def _note_mem(self, value: int, is_cap: bool) -> None:
        if value:
            self._mem_gcd = math.gcd(self._mem_gcd, value)
        if is_cap:
            self._mem_cap_max = max(self._mem_cap_max, value)
        else:
            self._mem_req_max = max(self._mem_req_max, value)

    def _narrow_params(self, static_max: int, tile_len: int):
        """-> (g, eligible) per tables._maybe_narrow's exactness rules:
        scaled scores fit i32 with x10 headroom, the already-accumulated
        running sums (measured from the arrays — zero-capacity nodes
        accumulate without a misfit gate, and nz sums grow on every
        node) plus this tile's worst-case additions stay in range, and
        the composite argmax fits for default-scale weights (the engine
        re-widens itself for larger ones)."""
        g = self._mem_gcd or 1

        def amax(arr):
            return int(arr.max()) if arr.size else 0

        cap_s = self._mem_cap_max // g
        req_s = self._mem_req_max // g
        mem_base = max(cap_s, amax(self.mem_used) // g,
                       amax(self.nz_mem) // g)
        cpu_base = max(self._cpu_cap_max, amax(self.cpu_used),
                       amax(self.nz_cpu))
        # inflight_pad: pods dispatched but not yet assumed host-side
        # (the pipelined scheduler) still add to the running sums the
        # device sees — budget them or the carry could overflow i32
        tiles = max(tile_len, 1) + self.inflight_pad
        bound = max((mem_base + tiles * req_s) * 10,
                    (cpu_base + tiles * self._cpu_req_max) * 10,
                    (30 * 64 + static_max) * max(self.n_cap, 1))
        return g, bound < (1 << 30)

    def _grow_nodes(self) -> None:
        self.state_epoch += 1
        # growth reshapes (and re-shards) the node axis: the device
        # table cache invalidates wholesale
        self._mark_full()
        # double while small, then step by 1024: a 5000-node cluster pads
        # to 5120 lanes (2% waste), not 8192 (64%) — every scan step pays
        # for the full node axis width. Rounded up to a mesh multiple so
        # the sharded axis always splits evenly (slot->shard stays block
        # sharding over stable slots).
        new_cap = self.n_cap * 2 if self.n_cap < 1024 else self.n_cap + 1024
        new_cap = -(-new_cap // self.mesh_devices) * self.mesh_devices
        self._grow_to(new_cap)

    def _grow_to(self, new_cap: int) -> None:
        """Caller holds the lock and has journaled the invalidation.
        Widen every slot-axis array to `new_cap` lanes in place."""
        self._node_dirty_gen = _grow(self._node_dirty_gen, 0, new_cap)
        self._state_dirty_gen = _grow(self._state_dirty_gen, 0, new_cap)
        for attr in ("valid", "sched_ok", "cpu_cap", "mem_cap", "pod_cap",
                     "tie_rank",
                     "cpu_used", "mem_used", "nz_cpu", "nz_mem", "pod_count",
                     "exceed_cpu", "exceed_mem", "static_score"):
            setattr(self, attr, _grow(getattr(self, attr), 0, new_cap))
        self.tie_rank[self.n_cap:] = -1
        # _grow zero-fills; the static mask's neutral value is True
        grown_mask = np.ones(new_cap, bool)
        grown_mask[:self.n_cap] = self.static_mask
        self.static_mask = grown_mask
        for attr in ("label_words", "port_bits", "disk_any", "disk_rw"):
            setattr(self, attr, _grow(getattr(self, attr), 0, new_cap))
        for g in self.groups.values():
            g.row = _grow(g.row, 0, new_cap)
        self.node_names.extend([""] * (new_cap - self.n_cap))
        self.node_labels.extend({} for _ in range(new_cap - self.n_cap))
        self.n_cap = new_cap

    # ================================================ shard epoch / reshard

    @property
    def encoder_id(self) -> int:
        """The instance token stamped into every TableDelta. Two
        encoders' generations AND shard epochs are incomparable; any
        cross-instance comparison must check this first."""
        return self._encoder_id

    def shard_epochs(self) -> Tuple[int, ...]:
        """Current epoch vector (one entry per mesh shard). Compare to
        a dispatched tile's TableDelta.shard_epochs to fence stale
        in-flight work after a reshard (sched/batch.py _finalize)."""
        with self._lock:
            return self._shard_epochs

    def reshard(self, survivors: int) -> int:
        """Re-shard the stable slot->device mapping onto `survivors`
        shards after a shard owner's lease expired.

        The slot axis keeps its stable indices — no row moves WITHIN
        the host truth — but the block partition over devices changes,
        so every device-resident row is on the wrong owner: capacity
        re-rounds to a multiple of the survivor count (growth only; the
        rounded-up cap never shrinks below the occupied high-water
        mark), every occupied slot re-journals at fresh generations,
        full_gen advances (whole-mirror invalidation), state_epoch
        bumps (no device carry survives the mesh change), and the epoch
        vector is replaced — new length, every entry past the old
        maximum, so ANY tile or mirror stamped with the old vector is
        detectably stale. Returns the number of occupied slots the
        journal replay rebuilds on the survivors (the caller feeds
        shard_replay_rows_total)."""
        survivors = max(1, int(survivors))
        with self._lock:
            self.state_epoch += 1
            self._mark_full()
            self.mesh_devices = survivors
            new_cap = -(-self.n_cap // survivors) * survivors
            if new_cap != self.n_cap:
                self._grow_to(new_cap)
            occupied = np.nonzero(self.valid)[0]
            if occupied.size:
                # re-journal every surviving row: the replay the new
                # owners consume (TableDelta.replay_slots from the
                # pre-failure full_gen returns exactly this set)
                self._mark_node(occupied)
                self._mark_state(occupied)
            nxt = max(self._shard_epochs, default=0) + 1
            self._shard_epochs = (nxt,) * survivors
            return int(occupied.size)

    # ==================================================== preemption table

    def victim_table(self, pod: api.Pod):
        """One consistent cut of the preemption search inputs for `pod`
        (the JAX package's sched/preemption.py VictimTable). Not in the
        port yet: raises."""
        raise NotImplementedError(
            "the preemption victim search (sched/preemption.py) is not "
            "ported yet: ROADMAP.md Queue 1, 'Preemption, device half'")

    def _recompute_tie_rank(self) -> None:
        # rank over ALL known names: relative order among valid nodes is
        # what the tie-break consumes, and a superset ranking preserves it
        old = self.tie_rank.copy()
        self.tie_rank[:] = -1
        for rank, name in enumerate(sorted(self.node_slot)):
            self.tie_rank[self.node_slot[name]] = rank
        changed = np.nonzero(old != self.tie_rank)[0]
        if changed.size:
            # a node add/delete shifts the ranks of name-sorted
            # neighbours: journal exactly the slots whose rank moved
            self._mark_node(changed)
        self._tie_dirty = False

    # ================================================== group bookkeeping

    def _group_for(self, ns: str, sels: List[Dict[str, str]]) -> _Group:
        key = (ns, frozenset(frozenset(s.items()) for s in sels))
        g = self.groups.get(key)
        if g is None:
            g = _Group(ns, [dict(s) for s in sels], self.n_cap)
            # first sighting: one full scan of the ledger seeds the counts;
            # afterwards the group maintains itself from deltas
            for rec in self.pods.values():
                if g.matches(rec.ns, rec.labels):
                    slot = self.node_slot.get(rec.node)
                    if slot is None:
                        g.offgrid[rec.node] = g.offgrid.get(rec.node, 0) + 1
                    else:
                        g.row[slot] += 1
            self.groups[key] = g
        return g

    # ================================================== affinity tier

    def _encode_aff_terms(self, pending_pods: List[api.Pod], n_pad: int):
        """The inter-pod affinity structures of one tile
        (tables.py's term intern + domain + scope-count build), computed
        against the LEDGER: per-pod records carry ns/labels/node and the
        node_labels list resolves topology domains, so affinity tiles
        cost one pass over cheap records instead of the full O(cluster)
        api-object re-encode they used to force (the last
        NeedsFullEncode case). Caller holds the lock."""
        # term interning is shared with the full encoder — the parity-
        # critical key lives in exactly one place
        term_meta, pod_terms = collect_affinity_terms(pending_pods)
        T = max(1, len(term_meta))

        # per-term topology domains over CANDIDATE (valid) slots — a
        # domain value only invalid nodes carry can never satisfy a
        # term, mirroring tables.py building domains from snap.nodes
        aff_dom = np.full((T, n_pad), -1, np.int32)
        dom_ids: List[Dict[str, int]] = [dict() for _ in range(T)]
        for tid, (_, _, topo_key) in enumerate(term_meta):
            row = aff_dom[tid]
            doms = dom_ids[tid]
            for slot, name in enumerate(self.node_names):
                if not name or not self.valid[slot] \
                        or not self.sched_ok[slot]:
                    continue
                value = self.node_labels[slot].get(topo_key)
                if value is None:
                    continue
                row[slot] = doms.setdefault(value, len(doms))
        D = max(1, max((len(d) for d in dom_ids), default=0))

        aff_count = np.zeros((T, D), np.int32)
        aff_total = np.zeros(T, np.int32)
        if term_meta:
            # scope counts over the ledger's counted (non-terminal)
            # placed pods; domains resolve through ALL known nodes
            # (valid or not — node_by_name semantics), but only
            # candidate-carried domain values scored above can match
            matchers = [
                (ns_scope, selector, topo_key, dom_ids[tid])
                for tid, (ns_scope, selector, topo_key)
                in enumerate(term_meta)]
            for rec in self.pods.values():
                if not rec.counted_res:
                    continue
                host_slot = self.node_slot.get(rec.node)
                host_labels = (self.node_labels[host_slot]
                               if host_slot is not None else None)
                for tid, (ns_scope, sel, topo_key, doms) in \
                        enumerate(matchers):
                    if rec.ns not in ns_scope:
                        continue
                    if not _selector_matches(sel, rec.labels):
                        continue
                    aff_total[tid] += 1
                    if host_labels is None:
                        continue
                    value = host_labels.get(topo_key)
                    dom = doms.get(value) if value is not None else None
                    if dom is not None:
                        aff_count[tid, dom] += 1
        return (term_meta, pod_terms, aff_dom, dom_ids, aff_count,
                aff_total, T, D)

    # ================================================== tile assembly

    def _intern_pending(self, pod: api.Pod) -> None:
        """Intern every key a pending pod references, growing the
        persistent bitset arrays in lockstep — BEFORE tile arrays are
        allocated, so tile and persistent widths always agree."""
        for c in pod.spec.containers:
            for cp in c.ports:
                if cp.host_port != 0:
                    _, grew = self.ports_dict.intern(cp.host_port)
                    if grew:
                        self.port_bits = _grow(self.port_bits, 1,
                                               self.ports_dict.words)
        for kv in pod.spec.node_selector.items():
            _, grew = self.labels_dict.intern(kv)
            if grew:
                self.label_words = _grow(self.label_words, 1,
                                         self.labels_dict.words)
        for v in pod.spec.volumes:
            for dk in _disk_keys(v)[0]:
                _, grew = self.disk_dict.intern(dk)
                if grew:
                    self.disk_any = _grow(self.disk_any, 1,
                                          self.disk_dict.words)
                    self.disk_rw = _grow(self.disk_rw, 1,
                                         self.disk_dict.words)

    def _encode_spec_cols(self, pb: PodArrays, j: int,
                          pod: api.Pod) -> None:
        """Spec-derived tile columns for row j, written in place — the
        single implementation behind both the scalar per-pod path and
        the columnar broadcast fill (encode_tile), so the two encodes
        cannot drift. Also feeds the narrowing gcd/max accumulators:
        value-idempotent, so running once per shared spec is exact."""
        req_cpu, req_mem = get_resource_request(pod)
        pb.req_cpu[j] = req_cpu
        pb.req_mem[j] = req_mem
        pb.zero_req[j] = req_cpu == 0 and req_mem == 0
        # the tile's quantities join the gcd BEFORE this encode
        # narrows (a gcd-breaking request must keep this and
        # every later tile exact)
        self._note_mem(req_mem, is_cap=False)
        self._cpu_req_max = max(self._cpu_req_max, req_cpu)
        for c in pod.spec.containers:
            nz_c, nz_m = get_nonzero_requests(c.resources.requests)
            pb.nz_cpu[j] += nz_c
            pb.nz_mem[j] += nz_m
            for cp in c.ports:
                if cp.host_port != 0:
                    # pre-interned by _intern_pending: never grows
                    bit, _ = self.ports_dict.intern(cp.host_port)
                    _set_bit(pb.port_words[j], bit)
        self._note_mem(int(pb.nz_mem[j]), is_cap=False)
        self._cpu_req_max = max(self._cpu_req_max, int(pb.nz_cpu[j]))
        for kv in pod.spec.node_selector.items():
            bit, _ = self.labels_dict.intern(kv)
            _set_bit(pb.sel_words[j], bit)
        for v in pod.spec.volumes:
            keys, gce_ro = _disk_keys(v)
            is_gce = v.gce_persistent_disk is not None
            for dk in keys:
                bit, _ = self.disk_dict.intern(dk)
                _set_bit(pb.disk_sany[j], bit)
                if is_gce and gce_ro:
                    _set_bit(pb.disk_qrw[j], bit)
                else:
                    _set_bit(pb.disk_qany[j], bit)
                if is_gce and not gce_ro:
                    _set_bit(pb.disk_srw[j], bit)
        if pod.spec.node_name:
            pb.host_idx[j] = self.node_slot.get(pod.spec.node_name, -2)

    def encode_tile(self, pending_pods: List[api.Pod],
                    services: List[api.Service],
                    controllers: List[api.ReplicationController],
                    pad_to: int = 0) -> EncodeResult:
        """O(tile) encode against the current persistent state.

        pad_to: allocate the pod axis at this length up front (invalid
        rows are zero / valid=False) so run_chunked never re-pads — the
        tail-chunk concatenate was measured GIL-hostile in situ."""
        with self._lock:
            if self._tie_dirty:
                self._recompute_tie_rank()
            seen_specs = set()
            for pod in pending_pods:
                # one interning walk per distinct spec object (columnar
                # creates share one spec across the whole tile)
                sid = id(pod.spec)
                if sid not in seen_specs:
                    seen_specs.add(sid)
                    self._intern_pending(pod)
            n_pad = self.n_cap
            L = self.labels_dict.words
            PW = self.ports_dict.words
            K = self.disk_dict.words
            p = len(pending_pods)
            p_pad = max(1, p, pad_to)

            # ---- pod batch + spread groups of this tile ----
            tile_groups: List[_Group] = []
            group_idx: Dict[int, int] = {}
            pod_groups: List[int] = []
            for pod in pending_pods:
                sels = _pod_spread_selectors(pod, services, controllers)
                if not sels:
                    pod_groups.append(-1)
                    continue
                g = self._group_for(pod.metadata.namespace, sels)
                gid = group_idx.get(id(g))
                if gid is None:
                    gid = len(tile_groups)
                    group_idx[id(g)] = gid
                    tile_groups.append(g)
                pod_groups.append(gid)
            G = max(1, len(tile_groups))

            # ---- inter-pod affinity terms of this tile (tables.py's
            # build, fed from the LEDGER instead of a full pod re-walk:
            # the per-pod records already carry ns/labels/node, so the
            # scope counts cost one pass over cheap records rather than
            # O(cluster) api-object walking per tile) ----
            (term_meta, pod_terms, aff_dom, dom_ids,
             aff_count, aff_total, T, D) = self._encode_aff_terms(
                 pending_pods, n_pad)

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
                svc_member=np.zeros((p_pad, 1), np.int32))
            # ---- columnar spec fill (SURVEY.md section 7 hard part 3):
            # rows sharing one spec object (the registry's
            # template-create contract) encode ONCE via the scalar
            # helper, then broadcast-copy to their sibling rows — the
            # 8192-pod bench tile collapses to one encode + a dozen
            # numpy fancy-index stores. ids are stable here because the
            # pod list holds every spec alive for the duration.
            spec_rows: Dict[int, List[int]] = {}
            for j, pod in enumerate(pending_pods):
                spec_rows.setdefault(id(pod.spec), []).append(j)
            spec_done = np.zeros(p, bool) if p else None
            for idxs in spec_rows.values():
                if len(idxs) < 8:
                    continue
                j0 = idxs[0]
                self._encode_spec_cols(pb, j0, pending_pods[j0])
                ii = np.asarray(idxs[1:], np.intp)
                for col in (pb.req_cpu, pb.req_mem, pb.zero_req,
                            pb.nz_cpu, pb.nz_mem, pb.host_idx,
                            pb.port_words, pb.sel_words, pb.disk_qany,
                            pb.disk_qrw, pb.disk_sany, pb.disk_srw):
                    col[ii] = col[j0]
                spec_done[np.asarray(idxs, np.intp)] = True

            for j, pod in enumerate(pending_pods):
                pb.valid[j] = True
                if not spec_done[j]:
                    self._encode_spec_cols(pb, j, pod)
                pb.group_id[j] = pod_groups[j]
                for gid, g in enumerate(tile_groups):
                    if g.matches(pod.metadata.namespace, pod.metadata.labels):
                        pb.member[j, gid] = 1
                aff_ids, anti_ids = pod_terms[j]
                for tid in aff_ids:
                    pb.aff_req[j, tid] = True
                for tid in anti_ids:
                    pb.anti_req[j, tid] = True
                for tid, (ns_scope, selector, _topo) in enumerate(term_meta):
                    if pod.metadata.namespace in ns_scope and \
                            _selector_matches(selector,
                                              pod.metadata.labels):
                        pb.aff_member[j, tid] = 1

            # ---- views of the persistent state (copied: the reflector
            # threads keep mutating these arrays while the scan runs).
            # The host arrays stay raw i64; when the running gcd proves
            # the i32 rescale exact (tables._maybe_narrow's rules), the
            # device copies narrow here — same single pass as the copy.
            static_max = int(np.max(np.abs(self.static_score))) \
                if self.static_score.size else 0
            mem_scale, narrow = self._narrow_params(static_max, p_pad)

            def res(arr, scale=1):
                if narrow:
                    return ((arr // scale) if scale != 1 else arr) \
                        .astype(np.int32)
                return arr.copy()

            nt = NodeArrays(
                valid=self.valid.copy(),
                sched_ok=self.sched_ok.copy(),
                cpu_cap=res(self.cpu_cap),
                mem_cap=res(self.mem_cap, mem_scale),
                pod_cap=self.pod_cap.copy(),
                label_words=self.label_words.copy(),
                tie_rank=self.tie_rank.copy(),
                exceed_cpu=self.exceed_cpu.copy(),
                exceed_mem=self.exceed_mem.copy(),
                aff_dom=aff_dom,
                zone_id=np.full(n_pad, -1, np.int32),
                zone_scratch=np.zeros(1, np.int32),
                static_mask=self.static_mask.copy(),
                static_score=res(self.static_score))
            spread = (np.stack([g.row for g in tile_groups])
                      if tile_groups else np.zeros((1, n_pad), np.int32))
            offgrid_max = np.zeros(G, np.int32)
            for gid, g in enumerate(tile_groups):
                if g.offgrid:
                    offgrid_max[gid] = max(g.offgrid.values())
            st = StateArrays(
                cpu_used=res(self.cpu_used),
                mem_used=res(self.mem_used, mem_scale),
                nz_cpu=res(self.nz_cpu),
                nz_mem=res(self.nz_mem, mem_scale),
                pod_count=self.pod_count.copy(),
                port_bits=self.port_bits.copy(),
                disk_any=self.disk_any.copy(),
                disk_rw=self.disk_rw.copy(),
                spread=spread.copy(),
                aff_count=aff_count,
                aff_total=aff_total,
                svc_count=np.zeros((1, n_pad), np.int32),
                svc_total=np.zeros(1, np.int32))
            pb = replace_pod_batch_dtypes(pb, narrow, mem_scale)
            # dirty-slot journal snapshot, captured under the same lock
            # as the host-array copies above so the generations are
            # consistent with this encode's table contents
            delta = TableDelta(table_gen=self._table_gen,
                               node_dirty_gen=self._node_dirty_gen.copy(),
                               state_dirty_gen=self._state_dirty_gen.copy(),
                               full_gen=self._full_dirty_gen,
                               encoder_id=self._encoder_id,
                               shard_epochs=self._shard_epochs)
            return EncodeResult(
                node_tab=nt, pod_batch=pb, init_state=st,
                offgrid_max=offgrid_max,
                node_names=list(self.node_names),
                n_nodes=len(self.node_slot), n_pods=p,
                mem_scale=mem_scale if narrow else 1,
                tile_groups=tile_groups,
                state_epoch=self.state_epoch,
                delta=delta)

    # ================================================== wiring helpers

    def detach(self) -> None:
        """Stop consuming informer events. The chained handlers attach()
        installed cannot be unhooked (closures over closures), so they
        stay in the chain as gated no-ops; a scheduler failing over
        builds a FRESH encoder from a fresh snapshot rather than
        trusting this one's carry (sched/batch.py _on_started_leading)."""
        self._detached = True

    def attach(self, factory) -> "IncrementalEncoder":
        """Chain onto the factory's scheduled-pod reflector and node
        informer, then bootstrap from their caches. Events that land
        between attach and bootstrap are absorbed by the ledger's
        resourceVersion idempotency check."""
        sref = factory.scheduled_reflector
        self._detached = False

        def chain(first, second):
            if first is None:
                return second
            def chained(*a):
                first(*a)
                second(*a)
            return chained

        def gate(fn):
            # detach() turns this encoder's share of the chain into a
            # no-op without disturbing other subscribers
            def gated(*a):
                if not self._detached:
                    fn(*a)
            return gated

        sref.on_add = chain(sref.on_add, gate(self.on_pod_add))
        sref.on_update = chain(
            sref.on_update,
            gate(lambda old, new: self.on_pod_update(old, new)))
        sref.on_delete = chain(sref.on_delete, gate(self.on_pod_delete))
        nref = factory.node_informer.reflector
        nref.on_add = chain(nref.on_add, gate(self.on_node_add))
        nref.on_update = chain(
            nref.on_update,
            gate(lambda old, new: self.on_node_update(old, new)))
        nref.on_delete = chain(nref.on_delete, gate(self.on_node_delete))
        for node in factory.node_informer.cache.list():
            self.on_node_add(node)
        for pod in factory.scheduled_cache.list():
            self.on_pod_add(pod)
        # reconcile the snapshot against the NOW-live cache: a pod
        # whose DELETED event raced between the list() above and its
        # bootstrap on_pod_add re-entered the ledger with no future
        # event to remove it (the rv-idempotency check dedupes
        # add/update overlap; it cannot undo an add that post-dates
        # the delete) — phantom capacity for the process lifetime
        with self._lock:
            # the live set is read under the SAME lock the chained
            # handlers serialize on: computed outside it, a pod whose
            # ADDED event landed between the list() and the lock would
            # be misread as stale and evicted
            live = {f"{p.metadata.namespace}/{p.metadata.name}"
                    for p in factory.scheduled_cache.list()}
            stale = [k for k in self.pods if k not in live]
        for key in stale:
            ns, _, name = key.partition("/")
            self.on_pod_delete(api.Pod(metadata=api.ObjectMeta(
                name=name, namespace=ns)))
        return self
