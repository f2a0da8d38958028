"""Device engine: batch scheduling as a sequential per-pod loop in PyTorch.

Replaces the reference's per-pod serial hot loop
(plugin/pkg/scheduler/generic_scheduler.go:111 findNodesThatFit,
:164 PrioritizeNodes, :95 selectHost) with dense tensor math per pod:

  per step (one pod)                reference equivalent
  -------------------------------   -----------------------------------
  predicate masks over [N] vectors  for node { for predicate { ... } }
  int 0..10 score vectors           for priority { for node { ... } }
  composite argmax (injective)      sort + rand tie-break (selectHost)
  O(1) scatter state update         Modeler.AssumePod (modeler.go:113)

Sequential-commit semantics (pod k consumes the capacity pod k+1 sees —
the reference serializes scheduleOne for exactly this reason,
scheduler.go:120) live in the carry `State`, which stays on the engine's
device between pods and between chunks. The pod loop never syncs with
the host: the argmax, the fit flag and the scatter index stay 0-d
tensors and are used as indices directly.

Numerics are bit-exact with the JAX engine and the serial oracle:
resource sums in int64 (int32 when the encoder narrowed them exactly),
score integer division via `_floordiv_exact`, and the two f64 formulas
(BalancedResourceAllocation priorities.go:198, SelectorSpread
selector_spreading.go:80-114) as separate multiply / subtract / divide
ops — nothing here is compiled or fused, so no FMA can change a floor.

The carry is updated in place: each pod's commit costs O(1) writes
instead of a fresh copy of every state vector. The engine only ever
writes to tensors it made: device_args copies the encoder's arrays, a
caller's `state_override` is cloned once per run, and so is the State
of the device table mirror (run_chunked's delta uploads), which only
the dirty-row scatter writes.

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
from . import filter_kernel, scatter_kernel, victim_kernel
from .tables import ClusterSnapshot, EncodeResult, encode_snapshot

DEFAULT_WEIGHTS = (1, 1, 1)  # LeastRequested, Balanced, SelectorSpread
                             # (algorithmprovider/defaults/defaults.go:54-96)

# pods per block of the stateless probe: bounds its [B, N, W] temporaries
PROBE_BLOCK = 512


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


class _NodeAux(NamedTuple):
    """Loop-invariant values derived from NodeConst once per run (the
    JAX engine leaves this hoisting to XLA)."""
    iota: torch.Tensor        # i32[N]
    safe_cpu: torch.Tensor    # max(cpu_cap, 1)
    safe_mem: torch.Tensor
    safe_cpu_f: torch.Tensor  # f64
    safe_mem_f: torch.Tensor
    inv_cpu: torch.Tensor     # f64 1 / safe_cpu
    inv_mem: torch.Tensor
    aff_has_key: torch.Tensor  # bool[T, N]
    aff_dom_idx: torch.Tensor  # i64[T, N] max(aff_dom, 0)
    labeled: torch.Tensor     # bool[N] zone_id >= 0
    zidx: torch.Tensor        # i64[N] max(zone_id, 0)


def _node_aux(node: NodeConst) -> _NodeAux:
    n = node.valid.shape[0]
    safe_cpu = torch.clamp(node.cpu_cap, min=1)
    safe_mem = torch.clamp(node.mem_cap, min=1)
    safe_cpu_f = safe_cpu.to(torch.float64)
    safe_mem_f = safe_mem.to(torch.float64)
    return _NodeAux(
        iota=torch.arange(n, dtype=torch.int32, device=node.valid.device),
        safe_cpu=safe_cpu, safe_mem=safe_mem,
        safe_cpu_f=safe_cpu_f, safe_mem_f=safe_mem_f,
        inv_cpu=1.0 / safe_cpu_f, inv_mem=1.0 / safe_mem_f,
        aff_has_key=node.aff_dom >= 0,
        aff_dom_idx=torch.clamp(node.aff_dom, min=0).long(),
        labeled=node.zone_id >= 0,
        zidx=torch.clamp(node.zone_id, min=0).long())


def _floordiv_exact(num: torch.Tensor, den: torch.Tensor,
                    inv_den: torch.Tensor) -> torch.Tensor:
    """floor(num/den) for |num| < 2^53, den >= 1, computed without integer
    division: a f64 reciprocal-multiply estimate is within 1 of the true
    quotient (relative error ~2^-51 on an exact f64 product), so two
    integer compare-corrections make it exact. Kept as the JAX engine
    has it so both engines round through the same operations."""
    dt = num.dtype
    e = torch.floor(num.to(torch.float64) * inv_den).to(dt)
    e = e + ((e + 1) * den <= num).to(dt)
    e = e - (e * den > num).to(dt)
    return e


def _mask_and_score(node: NodeConst, aux: _NodeAux,
                    weights: Tuple[int, int, int], anti_weight: int,
                    state: State, pod: PodXs, has_aff: bool = True,
                    has_spread: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Predicate mask + priority totals for a block of B pods, each
    against the same `state`: -> (bool[B, N], total[B, N]).

    The pod dimension is written out (the JAX engine vmaps one pod): the
    scan step calls it with B = 1, the probe with blocks of pods."""
    sdt = node.cpu_cap.dtype

    # ---- predicate masks (predicates.go:127,192,250,258,403) ----
    fits_count = state.pod_count < node.pod_cap                      # [N]
    free_cpu = (node.cpu_cap == 0) | \
        (node.cpu_cap - state.cpu_used >= pod.req_cpu[:, None])
    free_mem = (node.mem_cap == 0) | \
        (node.mem_cap - state.mem_used >= pod.req_mem[:, None])
    res_ok = torch.where(
        pod.zero_req[:, None], fits_count,
        fits_count & ~node.exceed_cpu & ~node.exceed_mem & free_cpu
        & free_mem)
    port_conflict = ((state.port_bits[None] & pod.ports[:, None])
                     != 0).any(dim=2)
    sel_ok = ((pod.sel[:, None] & ~node.labels[None]) == 0).all(dim=2)
    host_ok = (pod.host_idx[:, None] == -1) | \
        (aux.iota[None] == pod.host_idx[:, None])
    disk_conflict = (((state.disk_any[None] & pod.qany[:, None])
                      | (state.disk_rw[None] & pod.qrw[:, None]))
                     != 0).any(dim=2)

    mask = (node.valid & node.sched_ok & pod.valid[:, None] & res_ok
            & ~port_conflict & sel_ok & host_ok & ~disk_conflict
            & node.static_mask)

    if has_aff:
        # inter-pod affinity/anti-affinity: per term t the node's scope
        # count is the placed-pod count in its topology domain; affinity
        # needs the key present and count > 0 (or the bootstrap: the pod
        # self-matches an empty-scope term), anti-affinity count == 0
        counts = torch.gather(state.aff_count, 1, aux.aff_dom_idx)   # [T, N]
        counts = torch.where(aux.aff_has_key, counts, 0)
        boot = (pod.aff_member > 0) & (state.aff_total == 0)         # [B, T]
        aff_ok = (~pod.aff_req[:, :, None]
                  | (aux.aff_has_key[None]
                     & (boot[:, :, None] | (counts > 0)[None]))).all(dim=1)
        anti_ok = (~pod.anti_req[:, :, None]
                   | (counts == 0)[None]).all(dim=1)
        mask = mask & aff_ok & anti_ok

    # ---- priorities (priorities.go:33,77,198; selector_spreading.go:80) ----
    tc = state.nz_cpu + pod.nz_cpu[:, None]                          # [B, N]
    tm = state.nz_mem + pod.nz_mem[:, None]
    cpu_score = torch.where(
        (node.cpu_cap == 0) | (tc > node.cpu_cap), 0,
        _floordiv_exact((node.cpu_cap - tc) * 10, aux.safe_cpu,
                        aux.inv_cpu))
    mem_score = torch.where(
        (node.mem_cap == 0) | (tm > node.mem_cap), 0,
        _floordiv_exact((node.mem_cap - tm) * 10, aux.safe_mem,
                        aux.inv_mem))
    # operands are 0..20, so the halving is a shift, not a division
    least_requested = (cpu_score + mem_score) >> 1

    # true f64 division, as the oracle computes the fraction
    cpu_frac = torch.where(node.cpu_cap == 0, 1.0,
                           tc.to(torch.float64) / aux.safe_cpu_f)
    mem_frac = torch.where(node.mem_cap == 0, 1.0,
                           tm.to(torch.float64) / aux.safe_mem_f)
    diff = torch.abs(cpu_frac - mem_frac)
    balanced = torch.where(
        (cpu_frac >= 1.0) | (mem_frac >= 1.0), 0,
        torch.floor(10.0 - diff * 10.0).to(sdt))

    total = (weights[0] * least_requested + weights[1] * balanced
             + node.static_score)

    if has_spread:
        gid = torch.clamp(pod.group_id, min=0).long()                 # [B]
        counts = state.spread.index_select(0, gid)                   # [B, N]
        max_count = torch.maximum(counts.amax(dim=1),
                                  node.offgrid_max.index_select(0, gid))
        spread_f = (10.0 * (max_count[:, None] - counts).to(torch.float64)
                    / torch.clamp(max_count, min=1).to(
                        torch.float64)[:, None])
        spread = torch.where(
            ((pod.group_id < 0) | (max_count == 0))[:, None], 10,
            torch.floor(spread_f).to(sdt))
        total = total + weights[2] * spread
    # has_spread=False: every pod scores the constant 10 on all nodes,
    # which shifts all totals equally and cannot change the argmax

    if anti_weight:
        # ServiceAntiAffinity (selector_spreading.go:117-196): spread the
        # pod's service across zone-label values, counting peers only on
        # nodes that passed THIS pod's predicates (the zone reduction
        # happens under `mask`)
        g = torch.clamp(pod.svc_group, min=0).long()                 # [B]
        row = state.svc_count.index_select(0, g)                     # [B, N]
        contrib = torch.where(mask & aux.labeled, row, 0)
        zc = torch.zeros((mask.shape[0], node.zone_scratch.shape[0]),
                         dtype=contrib.dtype, device=contrib.device)
        zc.index_add_(1, aux.zidx, contrib)                          # [B, Z]
        count_n = zc.index_select(1, aux.zidx)                       # [B, N]
        svc_total = torch.where(pod.svc_group >= 0,
                                state.svc_total.index_select(0, g), 0)
        sa_f = (10.0 * (svc_total[:, None] - count_n).to(torch.float64)
                / torch.clamp(svc_total, min=1).to(torch.float64)[:, None])
        sa = torch.where(
            ~aux.labeled, 0,
            torch.where((svc_total > 0)[:, None],
                        torch.floor(sa_f).to(sdt), 10))
        total = total + anti_weight * sa

    return mask, total


def _step(node: NodeConst, aux: _NodeAux, weights: Tuple[int, int, int],
          anti_weight: int, state: State, pod: PodXs,
          has_aff: bool, has_spread: bool) -> torch.Tensor:
    """One pod (every PodXs field sliced to length 1): select its node and
    commit it into `state` in place. -> i32[1] assigned index (-1 = none).
    """
    n = node.valid.shape[0]
    mask, total = _mask_and_score(node, aux, weights, anti_weight, state,
                                  pod, has_aff, has_spread)

    # ---- selection (generic_scheduler.go:95 selectHost) ----
    # one composite argmax: scores are non-negative and tie_rank is a
    # distinct 0..n-1 per valid node, so max(total*n + tie_rank) is
    # exactly "max score, then deterministic max tie-rank"
    composite = torch.where(mask[0], total[0] * n + node.tie_rank, -1)
    best, pick = composite.max(dim=0, keepdim=True)        # [1], i64[1]
    fit_any = best >= 0                                    # bool[1]
    assigned = torch.where(fit_any, pick, -1).to(torch.int32)

    # ---- assume-pod state update (modeler.go:113) ----
    # scatter at the picked lane: O(1) writes per pod. A no-fit step
    # scatters a zero delta at the (arbitrary) argmax lane.
    j = pick
    add = fit_any.to(state.cpu_used.dtype)
    add32 = fit_any.to(torch.int32)
    state.cpu_used.index_add_(0, j, add * pod.req_cpu)
    state.mem_used.index_add_(0, j, add * pod.req_mem)
    state.nz_cpu.index_add_(0, j, add * pod.nz_cpu)
    state.nz_mem.index_add_(0, j, add * pod.nz_mem)
    state.pod_count.index_add_(0, j, add32)
    # bitsets: OR the pod's words into the picked row (zero when no fit)
    fit_col = fit_any[:, None]
    state.port_bits.index_copy_(
        0, j, state.port_bits.index_select(0, j)
        | torch.where(fit_col, pod.ports, 0))
    state.disk_any.index_copy_(
        0, j, state.disk_any.index_select(0, j)
        | torch.where(fit_col, pod.sany, 0))
    state.disk_rw.index_copy_(
        0, j, state.disk_rw.index_select(0, j)
        | torch.where(fit_col, pod.srw, 0))
    if has_spread:
        state.spread.index_add_(1, j, (add32 * pod.member).T)
    if has_aff:
        # placed pod joins its in-scope terms' domain counts (domain of
        # the chosen node per term)
        dom_at = node.aff_dom.index_select(1, j)[:, 0]            # [T]
        t_add = torch.where(fit_any & (dom_at >= 0), pod.aff_member[0], 0)
        t = dom_at.shape[0]
        state.aff_count.index_put_(
            (torch.arange(t, device=dom_at.device),
             torch.clamp(dom_at, min=0).long()), t_add, accumulate=True)
        state.aff_total.add_(torch.where(fit_any, pod.aff_member[0], 0))
    if anti_weight:
        state.svc_count.index_add_(1, j, (add32 * pod.svc_member).T)
        state.svc_total.add_(torch.where(fit_any, pod.svc_member[0], 0))
    return assigned


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
    clone, or tile k + 1 would start from tile k's post-scan state."""

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

    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor
        self.event = None
        self._host = tensor
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
        return self._host.numpy()


class BatchEngine:
    """Batch scheduler on one device. `device=None` means the card; the
    tests pass device="cpu"."""

    def __init__(self, weights: Tuple[int, int, int] = DEFAULT_WEIGHTS,
                 policy=None, device=None):
        self.device = resolve_device(device)
        self.weights = tuple(int(w) for w in weights)
        self.policy = policy
        self._anti_weight = (policy.anti_affinity_weight
                             if policy is not None
                             and policy.needs_anti_affinity else 0)
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
        # included) and host seconds spent in the call — for the eager
        # scan, the host's dispatch of every step
        self.scan_stats = {"runs": 0, "steps": 0, "seconds": 0.0}

    @property
    def n_shards(self) -> int:
        """Devices the node axis is split over: one (no mesh yet)."""
        return 1

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

    def _scatter_table(self, dev_tab, fields, host_tab,
                       rows: np.ndarray) -> int:
        """Scatter the journaled dirty rows of one table into its device
        mirror, in place: one launch of the scatter kernel for every
        column in `fields`. No pad: the kernel takes any row count.
        Returns the host->device bytes the rows and indices make."""
        return scatter_kernel.scatter_rows(
            [getattr(dev_tab, f) for f in fields], rows.astype(np.int64),
            [getattr(host_tab, f)[rows] for f in fields])

    def _fetch_tables(self, enc: EncodeResult, node: NodeConst,
                      state: State, flags: Tuple[bool, bool],
                      state_needed: bool
                      ) -> Tuple[NodeConst, Optional[State]]:
        """Resolve the (NodeConst, State-init) run arguments, given as
        host arrays, through the device-resident mirror. Hit: scatter
        only the rows the encoder's journal marks dirty since the
        mirror's generation. Miss or ineligible: full host upload (and
        reseed the mirror when eligible). The State returned is the
        run's own (a clone of the mirror's on the delta path); None when
        not state_needed.

        A chained tile (state_needed=False) skips the State mirror: its
        state_gen lags and the next unchained tile catches up by
        scattering every row dirtied since."""
        stats = self.upload_stats
        node_b, state_b = _host_nbytes(node), _host_nbytes(state)
        stats["table_bytes"] = node_b + state_b
        if not self._delta_eligible(enc, flags):
            self._table_cache = None
            stats["full_tiles"] += 1
            stats["full_bytes"] += node_b + (state_b if state_needed else 0)
            return (_upload(node, self.device),
                    _upload(state, self.device) if state_needed else None)
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
                moved += self._scatter_table(cache.node, _NODE_ROW_FIELDS,
                                             node, node_rows)
            cache.node_gen = delta.table_gen
            if state_needed:
                state_rows = np.nonzero(
                    delta.state_dirty_gen > cache.state_gen)[0]
                if state_rows.size:
                    moved += self._scatter_table(
                        cache.state, _STATE_ROW_FIELDS, state, state_rows)
                cache.state_gen = delta.table_gen
            if moved:
                stats["delta_tiles"] += 1
                stats["delta_bytes"] += moved
            else:
                stats["reuse_tiles"] += 1
            return cache.node, (_clone_state(cache.state) if state_needed
                                else None)
        # miss: seed the mirror with one full upload
        cache = _TableCache(sig, delta.encoder_id, delta.shard_epochs,
                            _upload(node, self.device),
                            _upload(state, self.device),
                            delta.table_gen, delta.table_gen)
        self._table_cache = cache
        stats["full_tiles"] += 1
        stats["full_bytes"] += node_b + state_b
        return cache.node, (_clone_state(cache.state) if state_needed
                            else None)

    def _scan(self, node: NodeConst, aux: _NodeAux, state: State,
              pods: PodXs, flags: Tuple[bool, bool]) -> torch.Tensor:
        """Sequential pod loop; commits into `state` in place."""
        has_aff, has_spread = flags
        p = pods.valid.shape[0]
        out = torch.empty(p, dtype=torch.int32, device=self.device)
        for k in range(p):
            out[k:k + 1] = _step(node, aux, self.weights, self._anti_weight,
                                 state, _pod_slice(pods, k, k + 1),
                                 has_aff, has_spread)
        return out

    def probe(self, enc: EncodeResult) -> Tuple[np.ndarray, np.ndarray]:
        """-> (mask bool[P, N], total i64[P, N]) of predicate fit and
        priority score per pending pod against the pre-batch state (the
        extender sidecar's Filter / Prioritize answer). Pods run in
        blocks of PROBE_BLOCK, each block one written-out pod dimension,
        which gives what the JAX engine's vmap gives."""
        mask, total = self._probe_tensors(enc)
        return mask.cpu().numpy(), total.cpu().numpy()

    def _probe_tensors(self, enc: EncodeResult
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        node, state, pods = self.device_args(enc)
        aux = _node_aux(node)
        has_aff, _ = self._enc_flags(enc)
        # has_spread stays ON: compiling the spread tier out shifts every
        # total by a constant — fine for the scan's argmax, wrong for the
        # absolute HostPriority scores the extender protocol returns
        masks, totals = [], []
        p = pods.valid.shape[0]
        for lo in range(0, p, PROBE_BLOCK):
            m, t = _mask_and_score(node, aux, self.weights,
                                   self._anti_weight, state,
                                   _pod_slice(pods, lo, lo + PROBE_BLOCK),
                                   has_aff, has_spread=True)
            masks.append(m)
            totals.append(t)
        return torch.cat(masks), torch.cat(totals)

    def filter_masks(self, enc: EncodeResult) -> np.ndarray:
        """-> bool[n_pods, N] predicate-fit masks against the pre-batch
        state (the extender Filter verb). The all-integer predicate tier
        runs as the hand-written filter kernel when the encoding
        qualifies (i32-narrowed, no affinity terms, no policy — see
        filter_kernel.supports); anything else takes the probe. A kernel
        that fails raises."""
        if self.policy is None and filter_kernel.supports(enc):
            node, state, pods = self.device_args(enc)
            mask = filter_kernel.filter_masks(
                filter_kernel.FilterArgs.from_engine(node, state, pods))
            return mask[:enc.n_pods].cpu().numpy()
        mask, _ = self._probe_tensors(enc)
        return mask[:enc.n_pods].cpu().numpy()

    def run(self, enc: EncodeResult) -> Tuple[np.ndarray, State]:
        """-> (assigned node indices i32[P] (-1 = no fit), final state)."""
        node, state, pods = self.device_args(enc)
        aux = _node_aux(node)
        assigned = self._scan(node, aux, state, pods, self._enc_flags(enc))
        return assigned.cpu().numpy(), state

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
        CUDA event recorded after the last chunk.

        The node tables (and the State init unless chained) come through
        the device table mirror (_fetch_tables): an incremental encode
        whose journal the mirror can follow moves only its dirty rows;
        anything else uploads in full. upload_stats counts which."""
        t0 = time.monotonic()
        enc = self._ensure_safe_dtypes(enc)
        flags = self._enc_flags(enc)
        node_h, state_h, pods_h = self.host_args(enc)
        node, state = self._fetch_tables(
            enc, node_h, state_h, flags,
            state_needed=state_override is None)
        pods = _upload(pods_h, self.device)
        self.upload_stats["pod_bytes"] += _host_nbytes(pods_h)
        if state_override is not None:
            state = _clone_state(state_override)
        aux = _node_aux(node)
        p = pods.valid.shape[0]
        pad = (-p) % chunk
        if pad:
            pods = PodXs(*(torch.cat([a, torch.zeros(
                (pad,) + tuple(a.shape[1:]), dtype=a.dtype,
                device=a.device)]) for a in pods))
        outs = [self._scan(node, aux, state, _pod_slice(pods, lo, lo + chunk),
                           flags)
                for lo in range(0, p + pad, chunk)]
        flat = (torch.cat(outs)[:p] if outs
                else torch.zeros(0, dtype=torch.int32, device=self.device))
        out = (flat.cpu().numpy() if block else PendingAssignment(flat))
        self.scan_stats["runs"] += 1
        self.scan_stats["steps"] += p + pad
        self.scan_stats["seconds"] += time.monotonic() - t0
        return out, state

    def find_victims(self, table) -> OracleResult:
        """Run the preemption victim search for one VictimTable
        (incremental.victim_table) through the victim kernel. Returns an
        OracleResult whose fields must be bit-equal to
        sched.preemption.oracle_find_victims(table) at every shape. One
        launch, one host pull after it. A refused launch raises."""
        pick, kstar, score = victim_kernel.victim_search(
            victim_kernel.VictimArgs.from_table(table, self.device))
        out = torch.cat([pick.reshape(1), kstar, score]).cpu().numpy()
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
        enc = encode_snapshot(snap, pod_pad_to=pod_pad_to,
                              policy=self.policy)
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
                   policy=None, device=None) -> List[Optional[str]]:
    """One-shot helper (tests, extender sidecar)."""
    return BatchEngine(weights, policy=policy, device=device).schedule(
        snap)[0]
