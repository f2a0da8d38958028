"""Device engine: batch scheduling as a sequential per-pod loop on the card.

Replaces the reference's per-pod serial hot loop
(plugin/pkg/scheduler/generic_scheduler.go:111 findNodesThatFit,
:164 PrioritizeNodes, :95 selectHost) with dense math over the node
slots per pod:

  per step (one pod)                reference equivalent
  -------------------------------   -----------------------------------
  predicate masks over [N] slots    for node { for predicate { ... } }
  int 0..10 score vectors           for priority { for node { ... } }
  composite argmax (injective)      sort + rand tie-break (selectHost)
  O(1) scatter state update         Modeler.AssumePod (modeler.go:113)

Sequential-commit semantics (pod k consumes the capacity pod k+1 sees —
the reference serializes scheduleOne for exactly this reason,
scheduler.go:120) live in the carry `State`, which stays on the engine's
device between pods and between chunks. A chunk of pods is one launch
of the scan kernel (scan_kernel.scan_chunk, K1), which walks the pods
in order and commits each into the State before the next; the extender
probe is one launch of the probe kernel (scan_kernel.probe, K5). On the
CPU both compute their plain versions (scan_kernel.scan_chunk_plain:
one pod a step of tensor ops; probe_plain).

Numerics are bit-exact with the JAX engine and the serial oracle:
resource sums in int64 (int32 when the encoder narrowed them exactly),
score integer division via `floordiv_exact`, and the two f64 formulas
(BalancedResourceAllocation priorities.go:198, SelectorSpread
selector_spreading.go:80-114) as separate multiply / subtract / divide
operations, never fused into an FMA (scan_kernel.py, csrc/scan_kernel.cu).

The carry is updated in place: each pod's commit costs O(1) writes
instead of a fresh copy of every state vector. The engine only ever
writes to tensors it made: device_args copies the encoder's arrays, and
run_chunked's tile prologue (one staging buffer, one copy and one launch
of the dirty-row scatter kernel, K3) copies a caller's `state_override`
or the State of the device table mirror, which only that kernel writes,
into a State of the run's own.

Ties break deterministically to the lexicographically largest node name
(composite `total * n + tie_rank`, injective per node), as in the JAX
engine; the chosen host is always a member of the reference's max-score
set.
"""

from __future__ import annotations

import time
from dataclasses import replace as _dc_replace
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..preemption import OracleResult
from . import (filter_kernel, scan_kernel, scatter_kernel, spec_kernel,
               victim_kernel)
from .mesh import NodeMesh
from .tables import ClusterSnapshot, EncodeResult, encode_snapshot

DEFAULT_WEIGHTS = (1, 1, 1)  # LeastRequested, Balanced, SelectorSpread
                             # (algorithmprovider/defaults/defaults.go:54-96)


def resolve_device(device) -> torch.device:
    """The engine runs on the card unless the caller names another device.
    No card and no explicit device is an error, never a quiet CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the engine on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)


class NodeConst(NamedTuple):
    valid: torch.Tensor       # bool[N]
    sched_ok: torch.Tensor    # bool[N]
    cpu_cap: torch.Tensor     # i64[N] (i32 when narrowed)
    mem_cap: torch.Tensor     # i64[N] (i32 when narrowed)
    pod_cap: torch.Tensor     # i32[N]
    labels: torch.Tensor      # u32[N, L] carried as i32
    tie_rank: torch.Tensor    # i32[N]
    exceed_cpu: torch.Tensor  # bool[N]
    exceed_mem: torch.Tensor  # bool[N]
    offgrid_max: torch.Tensor  # i32[G]
    aff_dom: torch.Tensor     # i32[T, N]
    zone_id: torch.Tensor     # i32[N]
    zone_scratch: torch.Tensor  # i32[Z] zeros (shape carrier)
    static_mask: torch.Tensor  # bool[N]
    static_score: torch.Tensor  # i64[N] (i32 when narrowed)


class PodXs(NamedTuple):
    valid: torch.Tensor       # bool[P]
    req_cpu: torch.Tensor     # i64[P]
    req_mem: torch.Tensor     # i64[P]
    zero_req: torch.Tensor    # bool[P]
    nz_cpu: torch.Tensor      # i64[P]
    nz_mem: torch.Tensor      # i64[P]
    sel: torch.Tensor         # u32[P, L] as i32
    ports: torch.Tensor       # u32[P, PW] as i32
    qany: torch.Tensor        # u32[P, K] as i32
    qrw: torch.Tensor         # u32[P, K] as i32
    sany: torch.Tensor        # u32[P, K] as i32
    srw: torch.Tensor         # u32[P, K] as i32
    host_idx: torch.Tensor    # i32[P]
    group_id: torch.Tensor    # i32[P]
    member: torch.Tensor      # i32[P, G]
    aff_req: torch.Tensor     # bool[P, T]
    anti_req: torch.Tensor    # bool[P, T]
    aff_member: torch.Tensor  # i32[P, T]
    svc_group: torch.Tensor   # i32[P]
    svc_member: torch.Tensor  # i32[P, S]


class State(NamedTuple):
    cpu_used: torch.Tensor    # i64[N]
    mem_used: torch.Tensor    # i64[N]
    nz_cpu: torch.Tensor      # i64[N]
    nz_mem: torch.Tensor      # i64[N]
    pod_count: torch.Tensor   # i32[N]
    port_bits: torch.Tensor   # u32[N, PW] as i32
    disk_any: torch.Tensor    # u32[N, K] as i32
    disk_rw: torch.Tensor     # u32[N, K] as i32
    spread: torch.Tensor      # i32[G, N]
    aff_count: torch.Tensor   # i32[T, D]
    aff_total: torch.Tensor   # i32[T]
    svc_count: torch.Tensor   # i32[S, N]
    svc_total: torch.Tensor   # i32[S]


def _pod_slice(pods: PodXs, lo: int, hi: int) -> PodXs:
    return PodXs(*(a[lo:hi] for a in pods))


def _clone_state(state: State) -> State:
    return State(*(a.clone() for a in state))


def _host(a) -> np.ndarray:
    """The encoder's array as the engine carries it: contiguous, with
    uint32 bitsets as int32 views (torch lacks NOT, comparisons and
    scatter for uint32, and AND / OR / NOT / == 0 are bit-identical on
    the view)."""
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _tensor(a, device: torch.device) -> torch.Tensor:
    """numpy -> a new tensor on `device` (always a copy: the engine updates
    its state in place and must not write through to the caller's
    arrays)."""
    return torch.from_numpy(_host(a)).to(device, copy=True)


def _upload(tree, device: torch.device):
    """A NamedTuple of numpy arrays -> the same NamedTuple of tensors."""
    return type(tree)(*(_tensor(a, device) for a in tree))


def _alloc_like(tree):
    """A NamedTuple of new, uninitialised tensors shaped like `tree`'s,
    carved from one buffer on their device (16-byte aligned views,
    scatter_kernel.carve): one allocation where `tree`'s fields each
    took one."""
    layout, off = [], 0
    for t in tree:
        layout.append((off, t.dtype, tuple(t.shape)))
        off += -(-t.numel() * t.element_size() // 16) * 16
    buf = torch.empty(max(off, 16), dtype=torch.uint8,
                      device=tree[0].device)
    return type(tree)(*scatter_kernel.carve(buf, layout))


# the tensor dtype `_tensor` gives each encoder dtype: torch dtypes never
# compare equal to numpy's, so whoever matches an encoding against a
# device carry (sched/batch.py _carry_compatible) goes through this map
CARRY_DTYPES = {np.dtype(np.int64): torch.int64,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.uint32): torch.int32,
                np.dtype(np.bool_): torch.bool}


def _host_nbytes(tree) -> int:
    return sum(int(a.nbytes) for a in tree)


class _TableCache:
    """Device-resident mirror of one incremental encoder's node tables
    (NodeConst + State init), as the JAX engine keeps it.

    `node_gen` / `state_gen` are the encoder generations (TableDelta
    counter values) the two mirrors are current at: a tile whose encode
    carries generation g needs only the rows whose dirty_gen exceeds
    the mirror's gen scattered in. `sig` pins shapes, dtypes, and
    mem_scale — any change (capacity growth, interner widening, a
    narrowing flip) misses and reseeds with a full upload. `src` pins
    the encoder INSTANCE (TableDelta.encoder_id): generations count one
    encoder's private timeline, so a same-shaped tile from a different
    encoder must miss — its low generations would otherwise read as
    "nothing changed" against another encoder's rows. `epochs` pins the
    encoder's shard-epoch vector (TableDelta.shard_epochs) the mirror
    was seeded under: a re-shard replaces the vector, and any difference
    misses and reseeds.

    The mirror's tensors are written only by the dirty-row scatter
    (scatter_kernel), in place. A run never scans on the mirror's State:
    the scan commits into its state in place, so each run starts from a
    copy (the tile prologue's), or tile k + 1 would start from tile k's
    post-scan state."""

    __slots__ = ("sig", "src", "epochs", "node", "state",
                 "node_gen", "state_gen")

    def __init__(self, sig, src, epochs, node, state, node_gen, state_gen):
        self.sig = sig
        self.src = src
        self.epochs = epochs
        self.node = node
        self.state = state
        self.node_gen = node_gen
        self.state_gen = state_gen


# Per-slot (axis-0) fields of the two device tables — the only fields
# the dirty-row scatter touches. Everything else is either slot-axis-1
# ([G,N]/[T,N]/[S,N]) or scalar-shaped, and is a CONSTANT for
# delta-eligible encodes (no spread groups, no affinity terms, no
# service groups): zeros / -1 with shapes pinned by the cache signature.
_NODE_ROW_FIELDS = ("valid", "sched_ok", "cpu_cap", "mem_cap", "pod_cap",
                    "labels", "tie_rank", "exceed_cpu", "exceed_mem",
                    "zone_id", "static_mask", "static_score")
_STATE_ROW_FIELDS = ("cpu_used", "mem_used", "nz_cpu", "nz_mem",
                     "pod_count", "port_bits", "disk_any", "disk_rw")


class PendingAssignment:
    """The assignment of a run dispatched with block=False: `tensor` is
    the i32[P] result on the engine's device. On a CUDA device the run
    also queued its copy into pinned host memory and recorded `event`
    after it, so whichever thread lands the tile waits on that event
    alone (no device-wide synchronize, nothing queued after it) and
    reads the host copy."""

    def __init__(self, tensor: torch.Tensor, on_ready=None):
        self.tensor = tensor
        self.event = None
        self._host = tensor
        # called once when the result is first read (run_chunked: adds
        # the run's K1 device time to scan_stats)
        self._on_ready = on_ready
        if tensor.is_cuda:
            self._host = torch.empty(tensor.shape, dtype=tensor.dtype,
                                     pin_memory=True)
            self._host.copy_(tensor, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def result(self) -> np.ndarray:
        """Wait for the run (this event only) -> i32[P] numpy."""
        if self.event is not None:
            self.event.synchronize()
        if self._on_ready is not None:
            self._on_ready()
            self._on_ready = None
        return self._host.numpy()


class BatchEngine:
    """Batch scheduler on one device. `device=None` means the card; the
    tests pass device="cpu".

    `mesh` (a NodeMesh) splits the node axis into mesh.size blocks, as
    the JAX engine's `mesh=` does: the scan runs as the sharded K1 (a
    cluster a shard, the cross-shard reductions inside it, K7) and the
    victim search as the sharded K4; on a CPU mesh their plain versions
    run shard by shard. The node axis must be a multiple of the mesh
    size (`schedule` pads it; the incremental encoder rounds its
    capacity with `mesh_devices=engine.n_shards`). A one-shard mesh runs
    the unsharded kernels, the same function. The shards share the
    mesh's one device: a mesh over several cards is refused here (its
    per-card placement and launches are not written; ROADMAP.md)."""

    def __init__(self, weights: Tuple[int, int, int] = DEFAULT_WEIGHTS,
                 policy=None, device=None,
                 speculative: Optional[bool] = None,
                 mesh: Optional[NodeMesh] = None):
        self.device = self._mesh_device(mesh, device)
        self.mesh = mesh
        # the sharded scan's replicas and exchange buffer, by shape
        # (scan_kernel.ShardSpace), kept from launch to launch
        self.shard_spaces = {}
        self.weights = tuple(int(w) for w in weights)
        self.policy = policy
        self._anti_weight = (policy.anti_affinity_weight
                             if policy is not None
                             and policy.needs_anti_affinity else 0)
        # the speculative engine (K6, spec_kernel) in place of the scan
        # wherever the encode's tiers allow it (bit-identical results).
        # None = off, as in the JAX engine, whose TPU A/B the scan won;
        # an explicit knob for this card's A/B (gpu_evidence
        # section_engine_spec)
        self._speculative = speculative
        # device-resident mirror of the incremental encoder's node tables
        # (run_chunked's delta-upload path): the dirty-row scatter kernel
        # writes the journaled rows into it in place
        self._table_cache: Optional[_TableCache] = None
        self.delta_uploads = True  # A/B knob: False forces full uploads
        # host->device transfer accounting, under the JAX engine's keys.
        # delta_bytes counts the dirty rows and their int64 indices as
        # they are (the JAX engine pads the row count to a power of two);
        # table_bytes is a gauge: host nbytes of one full (NodeConst,
        # State) pair at the last fetch
        self.upload_stats = {"full_tiles": 0, "delta_tiles": 0,
                             "reuse_tiles": 0, "full_bytes": 0,
                             "delta_bytes": 0, "pod_bytes": 0,
                             "table_bytes": 0}
        # run_chunked accounting: calls, scan steps (padded pods
        # included), host seconds spent in the call, the steps the plain
        # per-pod loop ran instead of the scan kernel (the CPU's; 0 on
        # the card), and the card's ms between CUDA events recorded around
        # each K1 launch (read when the assignment is pulled, never by a
        # synchronize of its own; 0 on the CPU). A pair also counts the
        # launch's own host time where the device waits on it
        # ... and the chunks that took the speculative engine instead of
        # the scan (spec_chunks)
        self.scan_stats = {"runs": 0, "steps": 0, "seconds": 0.0,
                           "eager_steps": 0, "device_ms": 0.0,
                           "spec_chunks": 0}
        # find_victims accounting, one search at a time: host seconds to
        # pack the table and queue its one copy (pack_s), to queue the
        # launch (launch_s) and for the one pull that waits for both
        # (pull_s); on the card, ms between CUDA events around the copy
        # (upload_ms) and around the launch (kernel_ms), read after the
        # pull; the launch's pair also counts the host's time to queue it
        # where the device waits on the host
        self.victim_stats = {"searches": 0, "pack_s": 0.0, "launch_s": 0.0,
                             "pull_s": 0.0, "upload_ms": 0.0,
                             "kernel_ms": 0.0}

    @staticmethod
    def _mesh_device(mesh: Optional[NodeMesh], device) -> torch.device:
        if mesh is None:
            return resolve_device(device)
        if not mesh.one_device:
            raise NotImplementedError(
                f"BatchEngine: {mesh} spans several devices; the engine "
                f"places a mesh's tables on one device (ROADMAP.md)")
        if device is not None and torch.device(device).type \
                != mesh.device.type:
            raise ValueError(f"BatchEngine: device={device} is not the "
                             f"mesh's {mesh.device}")
        return mesh.device

    @property
    def speculative(self) -> bool:
        """Whether eligible chunks take the speculative engine: never
        under a mesh (the JAX engine's rule: its repair would gather
        across shards)."""
        return self.mesh is None and bool(self._speculative)

    def _spec_route(self, has_aff: bool) -> bool:
        """The JAX engine's route (`_get_run`): the speculative engine
        covers the node-local and spread tiers; inter-pod affinity and
        ServiceAntiAffinity scores move globally a commit, so those
        batches keep the scan."""
        return not has_aff and not self._anti_weight and self.speculative

    @property
    def n_shards(self) -> int:
        """Shards the node axis is split over (1 without a mesh)."""
        return 1 if self.mesh is None else self.mesh.size

    def reshard(self, mesh: Optional[NodeMesh]) -> None:
        """Rebuild the engine over a survivor mesh after a shard owner
        died (sched/device/shardfail.py): the table mirror's rows lie on
        the old block partition and the shard spaces are sized for the
        old mesh, so both drop; the next dispatch reseeds the mirror
        with one full upload, the journal replay landing every row on
        its new owner. The survivors stay on the engine's device."""
        if mesh is not None and self._mesh_device(mesh, None) != self.device:
            raise ValueError(f"BatchEngine.reshard: {mesh} is not on the "
                             f"engine's {self.device}")
        self.mesh = mesh
        self._table_cache = None
        self.shard_spaces = {}

    def release(self) -> None:
        """Drop the device-resident state this engine keeps between
        launches (the table mirror and the shard spaces), so that a
        scheduler that died in this process (BatchScheduler.reap) leaves
        no tensors to the standby that takes over. The next dispatch, if
        any, reseeds the mirror with one full upload."""
        self._table_cache = None
        self.shard_spaces = {}

    def _space(self, args: scan_kernel.ScanArgs) -> scan_kernel.ShardSpace:
        """The shard space of this mesh and these sizes (made once)."""
        d = args.dims()
        key = (self.n_shards,) + tuple(d[k] for k in ("t", "d", "s", "z"))
        space = self.shard_spaces.get(key)
        if space is None:
            space = scan_kernel.ShardSpace(self.n_shards, d, self.device)
            self.shard_spaces[key] = space
        return space

    @staticmethod
    def _enc_flags(enc: EncodeResult) -> Tuple[bool, bool]:
        pb = enc.pod_batch
        has_aff = bool(pb.aff_req.any() or pb.anti_req.any())
        has_spread = bool((pb.group_id >= 0).any())
        return has_aff, has_spread

    def _ensure_safe_dtypes(self, enc: EncodeResult) -> EncodeResult:
        """The encoder narrows with a conservative default weight bound;
        an engine configured with larger policy weights must re-widen or
        the i32 composite argmax could wrap (encode can't know the
        engine's weights — this is the engine's half of the contract)."""
        nt = enc.node_tab
        if nt.cpu_cap.dtype != np.int32:
            return enc
        n = nt.valid.shape[0]
        max_static = int(np.max(np.abs(nt.static_score))) \
            if nt.static_score.size else 0
        wsum = sum(abs(w) for w in self.weights) + abs(self._anti_weight)
        if (10 * wsum + max_static + 1) * max(n, 1) < (1 << 30):
            return enc
        i64 = np.int64
        g = enc.mem_scale
        st, pb = enc.init_state, enc.pod_batch
        return _dc_replace(
            enc,
            mem_scale=1,
            node_tab=_dc_replace(
                nt, cpu_cap=nt.cpu_cap.astype(i64),
                mem_cap=nt.mem_cap.astype(i64) * g,
                static_score=nt.static_score.astype(i64)),
            init_state=_dc_replace(
                st, cpu_used=st.cpu_used.astype(i64),
                mem_used=st.mem_used.astype(i64) * g,
                nz_cpu=st.nz_cpu.astype(i64),
                nz_mem=st.nz_mem.astype(i64) * g),
            pod_batch=_dc_replace(
                pb, req_cpu=pb.req_cpu.astype(i64),
                req_mem=pb.req_mem.astype(i64) * g,
                nz_cpu=pb.nz_cpu.astype(i64),
                nz_mem=pb.nz_mem.astype(i64) * g))

    def host_args(self, enc: EncodeResult
                  ) -> Tuple[NodeConst, State, PodXs]:
        """EncodeResult (numpy arrays, from either package's encoder) ->
        (NodeConst, State, PodXs) of numpy arrays as the engine carries
        them (`_host`), not yet on any device."""
        enc = self._ensure_safe_dtypes(enc)
        nt, st, pb = enc.node_tab, enc.init_state, enc.pod_batch
        t = _host
        node = NodeConst(
            valid=t(nt.valid), sched_ok=t(nt.sched_ok),
            cpu_cap=t(nt.cpu_cap), mem_cap=t(nt.mem_cap),
            pod_cap=t(nt.pod_cap), labels=t(nt.label_words),
            tie_rank=t(nt.tie_rank),
            exceed_cpu=t(nt.exceed_cpu), exceed_mem=t(nt.exceed_mem),
            offgrid_max=t(enc.offgrid_max), aff_dom=t(nt.aff_dom),
            zone_id=t(nt.zone_id), zone_scratch=t(nt.zone_scratch),
            static_mask=t(nt.static_mask), static_score=t(nt.static_score))
        state = State(
            cpu_used=t(st.cpu_used), mem_used=t(st.mem_used),
            nz_cpu=t(st.nz_cpu), nz_mem=t(st.nz_mem),
            pod_count=t(st.pod_count), port_bits=t(st.port_bits),
            disk_any=t(st.disk_any), disk_rw=t(st.disk_rw),
            spread=t(st.spread), aff_count=t(st.aff_count),
            aff_total=t(st.aff_total), svc_count=t(st.svc_count),
            svc_total=t(st.svc_total))
        pods = PodXs(valid=t(pb.valid), req_cpu=t(pb.req_cpu),
                     req_mem=t(pb.req_mem), zero_req=t(pb.zero_req),
                     nz_cpu=t(pb.nz_cpu), nz_mem=t(pb.nz_mem),
                     sel=t(pb.sel_words), ports=t(pb.port_words),
                     qany=t(pb.disk_qany), qrw=t(pb.disk_qrw),
                     sany=t(pb.disk_sany), srw=t(pb.disk_srw),
                     host_idx=t(pb.host_idx), group_id=t(pb.group_id),
                     member=t(pb.member), aff_req=t(pb.aff_req),
                     anti_req=t(pb.anti_req), aff_member=t(pb.aff_member),
                     svc_group=t(pb.svc_group),
                     svc_member=t(pb.svc_member))
        return node, state, pods

    def device_args(self, enc: EncodeResult
                    ) -> Tuple[NodeConst, State, PodXs]:
        """EncodeResult -> (NodeConst, State, PodXs) of new tensors on
        the engine's device (a full upload of host_args)."""
        return tuple(_upload(tree, self.device)
                     for tree in self.host_args(enc))

    def _table_sig(self, enc: EncodeResult):
        """Shape/dtype signature of every array feeding NodeConst + State,
        in the encoder's numpy dtypes (a uint32 bitset and an int32
        column are different layouts even though both travel as int32).
        Any mismatch against the cached mirror (capacity growth, interner
        word-count widening, an i32/i64 narrowing flip, a mem_scale
        change) forces a full reseed — the dirty-row journal only covers
        value changes at a fixed layout."""
        nt, st = enc.node_tab, enc.init_state
        arrs = (nt.valid, nt.sched_ok, nt.cpu_cap, nt.mem_cap, nt.pod_cap,
                nt.label_words, nt.tie_rank, nt.exceed_cpu, nt.exceed_mem,
                enc.offgrid_max, nt.aff_dom, nt.zone_id, nt.zone_scratch,
                nt.static_mask, nt.static_score,
                st.cpu_used, st.mem_used, st.nz_cpu, st.nz_mem,
                st.pod_count, st.port_bits, st.disk_any, st.disk_rw,
                st.spread, st.aff_count, st.aff_total, st.svc_count,
                st.svc_total)
        return (enc.mem_scale,) + tuple(
            (np.asarray(a).shape, np.asarray(a).dtype.str) for a in arrs)

    def _delta_eligible(self, enc: EncodeResult,
                        flags: Tuple[bool, bool]) -> bool:
        """The dirty-row scatter only rewrites per-slot (axis-0) columns,
        so it applies exactly when every other table field is a canonical
        constant: an incremental encode (journal present) with no
        affinity terms, no spread groups, and no anti-affinity policy
        (zone scratch tables). Same family as the chain-eligibility test
        in sched/batch.py — the live pipeline's steady state."""
        return (self.delta_uploads and enc.delta is not None
                and flags == (False, False) and not enc.tile_groups
                and self._anti_weight == 0)

    def _fetch_tables(self, enc: EncodeResult, node: NodeConst,
                      state: State, flags: Tuple[bool, bool],
                      state_needed: bool, pro: scatter_kernel.Prologue):
        """Resolve the (NodeConst, State-init) run arguments, given as
        host arrays, through the device-resident mirror. Hit: the rows
        the encoder's journal marks dirty since the mirror's generation
        go into `pro` as scatters, and the run's own State (new tensors)
        as copies of the mirror's, the dirty State rows written into
        both. Miss or ineligible: full host upload (and reseed the
        mirror when eligible; the run's State is then a copy of it).
        -> (node, the run's State or None when not state_needed, a
        function to call once `pro` has launched: it moves the mirror's
        generations and the upload counts, so that a refused launch
        leaves the mirror as it was).

        A chained tile (state_needed=False) adds no State rows and no
        State copy: its state_gen lags and the next unchained tile
        catches up by scattering every row dirtied since."""
        stats = self.upload_stats
        node_b, state_b = _host_nbytes(node), _host_nbytes(state)
        stats["table_bytes"] = node_b + state_b
        if not self._delta_eligible(enc, flags):
            self._table_cache = None
            stats["full_tiles"] += 1
            stats["full_bytes"] += node_b + (state_b if state_needed else 0)
            return (_upload(node, self.device),
                    _upload(state, self.device) if state_needed else None,
                    None)
        sig = self._table_sig(enc)
        delta = enc.delta
        cache = self._table_cache
        if cache is not None and cache.sig == sig \
                and cache.src == delta.encoder_id \
                and cache.epochs == delta.shard_epochs \
                and delta.full_gen <= min(cache.node_gen, cache.state_gen):
            moved = 0
            node_rows = np.nonzero(delta.node_dirty_gen > cache.node_gen)[0]
            if node_rows.size:
                moved += self._scatter_rows(pro, cache.node,
                                            _NODE_ROW_FIELDS, node,
                                            node_rows)
            run = None
            if state_needed:
                run = _alloc_like(cache.state)
                state_rows = np.nonzero(
                    delta.state_dirty_gen > cache.state_gen)[0]
                group = None
                if state_rows.size:
                    moved += self._scatter_rows(pro, cache.state,
                                                _STATE_ROW_FIELDS, state,
                                                state_rows, also=run)
                    group = len(pro.scatters) - 1
                for f in State._fields:
                    pro.copy(getattr(run, f), getattr(cache.state, f),
                             skip=group if f in _STATE_ROW_FIELDS else None)

            def landed():
                cache.node_gen = delta.table_gen
                if state_needed:
                    cache.state_gen = delta.table_gen
                if moved:
                    stats["delta_tiles"] += 1
                    stats["delta_bytes"] += moved
                else:
                    stats["reuse_tiles"] += 1
            return cache.node, run, landed
        # miss: seed the mirror with one full upload
        cache = _TableCache(sig, delta.encoder_id, delta.shard_epochs,
                            _upload(node, self.device),
                            _upload(state, self.device),
                            delta.table_gen, delta.table_gen)
        self._table_cache = cache
        stats["full_tiles"] += 1
        stats["full_bytes"] += node_b + state_b
        run = None
        if state_needed:
            run = _alloc_like(cache.state)
            for d, s in zip(run, cache.state):
                pro.copy(d, s)
        return cache.node, run, None

    @staticmethod
    def _scatter_rows(pro: scatter_kernel.Prologue, dev_tab, fields,
                      host_tab, rows: np.ndarray, also=None) -> int:
        """The journaled dirty rows of one table as one scatter group of
        `pro` (every column in `fields`; with `also`, into that table's
        columns too). No pad: the kernel takes any row count. -> the
        host->device bytes the rows and their int64 indices make."""
        idx = rows.astype(np.int64)
        blocks = [getattr(host_tab, f)[rows] for f in fields]
        pro.scatter([getattr(dev_tab, f) for f in fields], idx, blocks,
                    None if also is None
                    else [getattr(also, f) for f in fields])
        return int(idx.nbytes) + sum(int(b.nbytes) for b in blocks)

    def _scan(self, node: NodeConst, aux: scan_kernel.Reciprocals,
              state: State, pods: PodXs, flags: Tuple[bool, bool],
              events: Optional[list] = None) -> torch.Tensor:
        """The sequential pod loop over one chunk, committing into `state`
        in place: one launch of the scan kernel on the card (the plain
        per-pod loop on the CPU, counted in scan_stats' eager_steps), or,
        where the route takes it, the speculative engine (a pass and a
        repair launch a block; spec_chunks counts the chunk). `events`
        (on the card) gains a pair of CUDA events recorded around the
        launches, after the arguments are checked."""
        has_aff, has_spread = flags
        args = scan_kernel.ScanArgs.from_engine(node, aux, state, pods)
        spec = self._spec_route(has_aff)
        if events is not None:
            pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            pair[0].record()
        if spec:
            out = spec_kernel.spec_chunk(args, self.weights, has_spread)
            self.scan_stats["spec_chunks"] += 1
        elif self.n_shards > 1:
            out = scan_kernel.scan_chunk_sharded(
                args, self.weights, self._anti_weight, has_aff, has_spread,
                self._space(args))
        else:
            out = scan_kernel.scan_chunk(args, self.weights,
                                         self._anti_weight, has_aff,
                                         has_spread)
        if events is not None:
            pair[1].record()
            events.append(pair)
        if not out.is_cuda:
            self.scan_stats["eager_steps"] += out.shape[0]
        return out

    def probe(self, enc: EncodeResult) -> Tuple[np.ndarray, np.ndarray]:
        """-> (mask bool[P, N], total i64[P, N]) of predicate fit and
        priority score per pending pod against the pre-batch state (the
        extender sidecar's Filter / Prioritize answer): one launch of the
        probe kernel on the card, which gives what the JAX engine's vmap
        gives."""
        mask, total = self._probe_tensors(enc)
        return mask.cpu().numpy(), total.cpu().numpy()

    def _probe_tensors(self, enc: EncodeResult
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        node, state, pods = self.device_args(enc)
        has_aff, _ = self._enc_flags(enc)
        # the spread tier stays ON: compiling it out shifts every total by
        # a constant — fine for the scan's argmax, wrong for the absolute
        # HostPriority scores the extender protocol returns
        return scan_kernel.probe(
            scan_kernel.ScanArgs.from_engine(
                node, scan_kernel.reciprocals(node), state, pods),
            self.weights, self._anti_weight, has_aff)

    def filter_masks(self, enc: EncodeResult) -> np.ndarray:
        """-> bool[n_pods, N] predicate-fit masks against the pre-batch
        state (the extender Filter verb). The all-integer predicate tier
        runs as the hand-written filter kernel when the encoding
        qualifies (i32-narrowed, no affinity terms, no policy — see
        filter_kernel.supports) and there is no mesh (the JAX engine's
        rule); anything else takes the probe. A kernel that fails
        raises."""
        if self.mesh is None and self.policy is None \
                and filter_kernel.supports(enc):
            node, state, pods = self.device_args(enc)
            mask = filter_kernel.filter_masks(
                filter_kernel.FilterArgs.from_engine(node, state, pods))
            return mask[:enc.n_pods].cpu().numpy()
        mask, _ = self._probe_tensors(enc)
        return mask[:enc.n_pods].cpu().numpy()

    def run(self, enc: EncodeResult) -> Tuple[np.ndarray, State]:
        """-> (assigned node indices i32[P] (-1 = no fit), final state)."""
        node, state, pods = self.device_args(enc)
        assigned = self._scan(node, scan_kernel.reciprocals(node), state,
                              pods, self._enc_flags(enc))
        return assigned.cpu().numpy(), state

    def _prologue(self, enc: EncodeResult, flags: Tuple[bool, bool],
                  chunk: int, state_override: Optional[State] = None):
        """A tile's tables and pods on the device, before its scan: the
        mirror's dirty rows, the run's State (a copy of the mirror's or
        of `state_override`, or a full upload) and the pods padded with
        invalid ones to a multiple of `chunk`, in one staging buffer,
        one copy and at most one launch of the scatter kernel. ->
        (node, state, pods, the pods before the pad)."""
        node_h, state_h, pods_h = self.host_args(enc)
        pro = scatter_kernel.Prologue()
        node, state, landed = self._fetch_tables(
            enc, node_h, state_h, flags, state_override is None, pro)
        if state_override is not None:
            state = _alloc_like(state_override)
            for d, s in zip(state, state_override):
                pro.copy(d, s)
        p = pods_h.valid.shape[0]
        slots = [pro.carry(a, p + (-p) % chunk) for a in pods_h]
        staged = pro.stage(self.device)
        scatter_kernel.apply_staged(staged)
        if landed is not None:
            landed()
        self.upload_stats["pod_bytes"] += _host_nbytes(pods_h)
        return node, state, PodXs(*staged.views(slots)), p

    def run_chunked(self, enc: EncodeResult, chunk: int = 1024,
                    state_override: Optional[State] = None,
                    block: bool = True):
        """Like run(), but the pod axis runs as fixed-size chunks with the
        carry kept on the device between them (the tail chunk is padded
        with invalid pods, which never touch state), so chunked execution
        equals one long run.

        state_override: start from this on-device State instead of the
        encoded init (chains tile k+1 off tile k's final carry; it is
        copied, never mutated, and the encoded init is not uploaded).
        block=False returns a PendingAssignment instead of waiting: the
        carry stays on the device and the assignment lands with the
        CUDA event recorded after the last chunk. On the card, CUDA
        events around each chunk's launch give scan_stats["device_ms"]
        when the assignment is pulled.

        The node tables (and the State init unless chained) come through
        the device table mirror (_fetch_tables): an incremental encode
        whose journal the mirror can follow moves only its dirty rows;
        anything else uploads in full. upload_stats counts which. The
        tile's prologue goes to the device as one staging buffer
        (scatter_kernel.Prologue): the dirty rows of both tables, the
        pods padded with invalid ones to the chunk multiple (read as
        views into it), then one launch of the dirty-row scatter kernel
        that writes the rows and copies the mirror's State, or the
        carry, into the run's State (none when there is nothing to
        scatter or copy)."""
        t0 = time.monotonic()
        enc = self._ensure_safe_dtypes(enc)
        flags = self._enc_flags(enc)
        node, state, pods, p = self._prologue(enc, flags, chunk,
                                              state_override)
        pad = pods.valid.shape[0] - p
        aux = scan_kernel.reciprocals(node)
        events = [] if self.device.type == "cuda" else None
        outs = [self._scan(node, aux, state, _pod_slice(pods, lo, lo + chunk),
                           flags, events)
                for lo in range(0, p + pad, chunk)]
        on_ready = None
        if events:
            def on_ready():
                self.scan_stats["device_ms"] += sum(
                    start.elapsed_time(end) for start, end in events)
        flat = (torch.cat(outs)[:p] if outs
                else torch.zeros(0, dtype=torch.int32, device=self.device))
        if block:
            out = flat.cpu().numpy()
            if on_ready is not None:
                on_ready()
        else:
            out = PendingAssignment(flat, on_ready)
        self.scan_stats["runs"] += 1
        self.scan_stats["steps"] += p + pad
        self.scan_stats["seconds"] += time.monotonic() - t0
        return out, state

    def find_victims(self, table) -> OracleResult:
        """Run the preemption victim search for one VictimTable
        (incremental.victim_table) through the victim kernel (the
        sharded K4 under a mesh). Returns an OracleResult whose fields
        must be bit-equal to sched.preemption.oracle_find_victims(table)
        at every shape. One upload of the packed table, one launch, one
        pull of pick, kstar and score together. A refused launch
        raises."""
        stats = self.victim_stats
        events = None
        if self.device.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True)
                      for _ in range(3)]
        t0 = time.monotonic()
        staged = victim_kernel.VictimArgs.stage(
            table, pin=self.device.type == "cuda")
        if events:
            events[0].record()
        args = staged.to_device(self.device)
        t1 = time.monotonic()
        if events:
            events[1].record()
        if self.n_shards == 1:
            res = victim_kernel.victim_search(args)
        else:
            res = victim_kernel.victim_search_sharded(args, self.n_shards)
        if events:
            events[2].record()
        t2 = time.monotonic()
        out = res.flat().cpu().numpy()
        t3 = time.monotonic()
        stats["searches"] += 1
        stats["pack_s"] += t1 - t0
        stats["launch_s"] += t2 - t1
        stats["pull_s"] += t3 - t2
        if events:
            stats["upload_ms"] += events[0].elapsed_time(events[1])
            stats["kernel_ms"] += events[1].elapsed_time(events[2])
        n = table.n
        pick = int(out[0])
        kstar, score = out[1:1 + n], out[1 + n:]
        return OracleResult(pick=pick, kstar=int(kstar[pick]),
                            feasible=bool(score[pick] >= 0),
                            node_kstar=kstar.astype(np.int64),
                            node_score=score.astype(np.int64))

    def schedule(self, snap: ClusterSnapshot, pod_pad_to: Optional[int] = None,
                 chunk: Optional[int] = None
                 ) -> Tuple[List[Optional[str]], EncodeResult]:
        """Encode + run + decode: one host name (or None) per pending pod."""
        enc = encode_snapshot(snap, node_pad_to=self.n_shards,
                              pod_pad_to=pod_pad_to, policy=self.policy)
        if chunk:
            assigned, _ = self.run_chunked(enc, chunk)
        else:
            assigned, _ = self.run(enc)
        out: List[Optional[str]] = []
        for j in range(enc.n_pods):
            idx = int(assigned[j])
            out.append(enc.node_names[idx] if idx >= 0 else None)
        return out, enc


def schedule_batch(snap: ClusterSnapshot,
                   weights: Tuple[int, int, int] = DEFAULT_WEIGHTS,
                   policy=None, device=None,
                   mesh: Optional[NodeMesh] = None) -> List[Optional[str]]:
    """One-shot helper (tests, extender sidecar)."""
    return BatchEngine(weights, policy=policy, device=device,
                       mesh=mesh).schedule(snap)[0]
