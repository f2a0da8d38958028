"""The scan step (K1) and the stateless probe (K5): hand-written CUDA
kernels for Hopper.

K1 replaces the XLA program of the JAX engine's pod loop
(`kubernetes_tpu/sched/device/engine.py`, `_make_run`: a `lax.scan` over
`_step`, which runs `_mask_and_score`, `_commit_node_local` and
`_aff_count_update`). For each pod of a chunk in order it computes the
predicate mask and the priority totals over every node slot against
the State the earlier pods left, picks the slot of the largest
composite `total * N + tie_rank` among the fitting ones (-1 when none
fits), and commits the pod into the State at that slot, in place. K5
replaces `_make_probe` (a `vmap` of `_mask_and_score`): every pod of a
batch against the same, unchanged State -> mask bool[P, N] and total
T[P, N], the spread tier always on.

    a = ScanArgs.from_engine(node, reciprocals(node), state, pods)
    assigned = scan_chunk(a, weights, anti_weight, has_aff, has_spread)
    mask, total = probe(a, weights, anti_weight, has_aff)

Source: `csrc/scan_kernel.cu`, one `__device__` body for both: K1 is
one launch of one thread-block cluster of C CTAs (16 where the card
schedules it at the kernel's shared memory, else 8) that walks the
chunk's pods in order with the node axis split over the CTAs; each CTA
keeps its slots' fixed-width fields in shared memory for the whole
chunk, and a pod costs no cluster-wide barrier on the node-local tier
(each CTA pushes its best (composite, slot) into every CTA's shared
memory with st.async, counted off an mbarrier there); the CTA's last
warp stages the next pod's row. K5 splits each pod's nodes over a
cluster of C CTAs where the pods are few (C from 16 at one pod to 1 at
132 pods or more, so that the clusters cover the card's SMs): each CTA
reduces its part of the spread group's max and of the
ServiceAntiAffinity zone histogram, the cluster combines them over
distributed shared memory, then every CTA scores its slots; at C = 1 it
is one block a pod. Templated on the carried integer type (int32 when
the encoder narrowed, int64 otherwise) and the tiers (spread, inter-pod
affinity, ServiceAntiAffinity): the launch plan picks the
instantiation, the cluster size, the slots a CTA and its shared
memory.

Bound: operations (`bounds.scan_ops` / `probe_ops`, INT32 and FP64
instructions an element). K1 runs on C SMs of the card's 132, so it is
read against that bound and the launch floor as it is: the pods are a
chain.

Under a node-axis mesh (`mesh.NodeMesh`, the JAX engine's `_get_run`
with `_node_shardings`) the scan runs as the sharded K1,
`scan_chunk_sharded(a, ..., ShardSpace(S, a.dims(), device))`: a
cluster a shard over its block of slots, all S clusters in one launch
and resident at once, each pod's cross-shard reductions (K7: the
group max, the zone histogram, the best candidate) exchanged as
self-validating records in the ShardSpace's buffer (every 8-byte word a
32-bit payload under a flag of the launch's generation and the
exchange's count, written and polled relaxed, no fence a pod); shards
1..S-1 keep their own copies of the replicated counts there. Its plain twin
`scan_chunk_sharded_plain` runs the same shard by shard.

On CPU tensors the wrappers compute the plain versions,
`scan_chunk_plain` (the per-pod loop of tensor ops the port ran before
the kernel) and `probe_plain` (the batch in blocks of PROBE_BLOCK pods,
each a written-out pod dimension); on CUDA tensors they launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .mesh import NODE_SPLIT, STATE_SPLIT, block_view
# the State counts every shard holds whole and commits alike
from .mesh import STATE_REPLICATED as REPLICATED

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "scan_kernel.cu")
# the kernel's blocking; each must match its #define in the source
SCAN_THREADS = 384         # SCAN_BLOCK_THREADS: the most threads a K1 CTA
PROBE_THREADS = 512        # PROBE_BLOCK_THREADS: K5's block a pod
MAX_SHARED_BYTES = 232448  # SCAN_MAX_SHARED_BYTES
MAX_CLUSTER = 16           # SCAN_MAX_CLUSTER
# K1's cluster sizes, the largest first: 16 is non-portable, 8 portable
CLUSTERS = (MAX_CLUSTER, 8)
# K5's cluster sizes: the CTAs a pod's nodes are split over
PROBE_CLUSTERS = (1, 2, 4, 8, MAX_CLUSTER)
# bit of the instantiation code that asks scan_max_clusters about K5
PROBE_CODE = 16
# SMs of an H100 SXM: what K5's plan covers unless given the card's own
# count (scan_kernel.probe passes it)
CARD_SMS = 132
# pods per block of the plain probe: bounds its [B, N, W] temporaries
PROBE_BLOCK = 512

# the order of the addresses and sizes scan_launch takes (enum ScanPtr,
# enum ScanDim in the source)
PTR_FIELDS = (
    "valid", "sched_ok", "cpu_cap", "mem_cap", "pod_cap", "labels",
    "tie_rank", "exceed_cpu", "exceed_mem", "offgrid_max", "aff_dom",
    "zone_id", "static_mask", "static_score", "inv_cpu", "inv_mem",
    "cpu_used", "mem_used", "nz_cpu", "nz_mem", "pod_count", "port_bits",
    "disk_any", "disk_rw", "spread", "aff_count", "aff_total", "svc_count",
    "svc_total",
    "pod_valid", "req_cpu", "req_mem", "zero_req", "pod_nz_cpu",
    "pod_nz_mem", "sel", "ports", "qany", "qrw", "sany", "srw", "host_idx",
    "group_id", "member", "aff_req", "anti_req", "aff_member", "svc_group",
    "svc_member",
    "assigned", "mask", "total", "work_total", "work_mask", "spec_nodes")
DIM_FIELDS = ("p", "n", "l", "pw", "k", "g", "t", "d", "s", "z", "w_lr",
              "w_bal", "w_spread", "w_anti")
_NODE_PTRS = PTR_FIELDS[:14]
_AUX_PTRS = ("inv_cpu", "inv_mem")
_STATE_PTRS = PTR_FIELDS[16:29]
# PodXs fields whose address goes under another name
_POD_RENAMED = {"valid": "pod_valid", "nz_cpu": "pod_nz_cpu",
                "nz_mem": "pod_nz_mem"}
SCAN, PROBE = 0, 1         # scan_launch's `kind`
SHARDED = 2                # LaunchPlan.kind of the sharded K1 (shard_launch)
# bit of the instantiation code that asks scan_max_clusters about the
# sharded K1
SHARD_CODE = 32
# the order of shard_launch's shard arguments (enum ShardArg in the
# source): the mesh's shards, the slots a shard owns, the spin budget in
# cycles (0: the kernel's default), the shard that withholds its first
# candidate record (-1: none; a check that the kernel raises rather than
# hangs), the exchange buffer's int64 words, and the addresses of that
# buffer and of the replicas
SHARD_FIELDS = ("shards", "block", "budget", "withhold", "xwords", "xchg",
                "replica")
# the most shards the sharded K1 takes: a warp's lanes read the shards'
# records (K7_MAX_SHARDS in the source)
MAX_SHARDS = 32


# ---------------------------------------------------------------------------
# the plain versions (the JAX engine's tensor formulation in PyTorch)


class Reciprocals(NamedTuple):
    """What the kernels read besides NodeConst: f64 1 / max(cap, 1)."""
    inv_cpu: torch.Tensor
    inv_mem: torch.Tensor


def reciprocals(node) -> Reciprocals:
    return Reciprocals(
        1.0 / torch.clamp(node.cpu_cap, min=1).to(torch.float64),
        1.0 / torch.clamp(node.mem_cap, min=1).to(torch.float64))


class NodeAux(NamedTuple):
    """Loop-invariant values the plain versions derive from NodeConst
    once a call (the JAX engine leaves this hoisting to XLA)."""
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


def node_aux(node) -> NodeAux:
    n = node.valid.shape[0]
    safe_cpu = torch.clamp(node.cpu_cap, min=1)
    safe_mem = torch.clamp(node.mem_cap, min=1)
    inv = reciprocals(node)
    return NodeAux(
        iota=torch.arange(n, dtype=torch.int32, device=node.valid.device),
        safe_cpu=safe_cpu, safe_mem=safe_mem,
        safe_cpu_f=safe_cpu.to(torch.float64),
        safe_mem_f=safe_mem.to(torch.float64),
        inv_cpu=inv.inv_cpu, inv_mem=inv.inv_mem,
        aff_has_key=node.aff_dom >= 0,
        aff_dom_idx=torch.clamp(node.aff_dom, min=0).long(),
        labeled=node.zone_id >= 0,
        zidx=torch.clamp(node.zone_id, min=0).long())


def floordiv_exact(num: torch.Tensor, den: torch.Tensor,
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


def mask_and_score(node, aux: NodeAux, weights: Tuple[int, int, int],
                   anti_weight: int, state, pod, has_aff: bool = True,
                   has_spread: bool = True,
                   iota: Optional[torch.Tensor] = None,
                   spread_max_override: Optional[torch.Tensor] = None,
                   zones_override: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Predicate mask + priority totals for a block of B pods, each
    against the same `state`: -> (bool[B, N], total[B, N]).

    The pod dimension is written out (the JAX engine vmaps one pod): the
    plain scan step calls it with B = 1, the plain probe with blocks of
    pods. The two f64 formulas are separate multiply / subtract / divide
    ops: nothing here is compiled or fused, so no FMA can change a
    floor.

    `iota` overrides the node indices the lanes stand for, and
    `spread_max_override` (i32[G]) the spread group's max count: the
    speculative repair (spec_kernel) rescores a GATHERED lane set, where
    lane i is node iota[i] and the lanes' own max is not the group's
    (JAX `_mask_and_score`'s two arguments of the same names).
    `zones_override` (i32[B, Z]) is the pods' ServiceAntiAffinity zone
    histogram in place of the one over these lanes: a shard of the
    sharded scan scores its block against the histogram summed over
    every shard (scan_chunk_sharded_plain)."""
    sdt = node.cpu_cap.dtype
    if iota is None:
        iota = aux.iota

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
        (iota[None] == pod.host_idx[:, None])
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
        floordiv_exact((node.cpu_cap - tc) * 10, aux.safe_cpu,
                       aux.inv_cpu))
    mem_score = torch.where(
        (node.mem_cap == 0) | (tm > node.mem_cap), 0,
        floordiv_exact((node.mem_cap - tm) * 10, aux.safe_mem,
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
        if spread_max_override is None:
            max_count = torch.maximum(counts.amax(dim=1),
                                      node.offgrid_max.index_select(0, gid))
        else:
            max_count = spread_max_override.index_select(0, gid)
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
        zc = (zone_histogram(node, aux, state, pod, mask)
              if zones_override is None else zones_override)         # [B, Z]
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


def zone_histogram(node, aux: NodeAux, state, pod,
                   mask: torch.Tensor) -> torch.Tensor:
    """ServiceAntiAffinity's zone histogram of a block of B pods: per
    zone, the pod's service count over the lanes that pass its
    predicates (`mask`, bool[B, N]) and carry the zone label ->
    i32[B, Z]."""
    g = torch.clamp(pod.svc_group, min=0).long()
    row = state.svc_count.index_select(0, g)                         # [B, N]
    contrib = torch.where(mask & aux.labeled, row, 0)
    zc = torch.zeros((mask.shape[0], node.zone_scratch.shape[0]),
                     dtype=contrib.dtype, device=contrib.device)
    zc.index_add_(1, aux.zidx, contrib)
    return zc


def commit_node_local(state, pod, j: torch.Tensor,
                      fit_any: torch.Tensor) -> torch.Tensor:
    """The node-local half of the assume-pod commit (JAX
    `_commit_node_local`, shared by the scan step and the speculative
    repair): the pod's resources, count, ports and disks added into
    `state` at lane j (i64[1]) in place, a zero delta when not fit_any
    (bool[1]). -> add32, the i32[1] 0 / 1 the callers' group-indexed
    updates scale by."""
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
    return add32


def step(node, aux: NodeAux, weights: Tuple[int, int, int],
         anti_weight: int, state, pod, has_aff: bool,
         has_spread: bool, fits: Optional[torch.Tensor] = None
         ) -> torch.Tensor:
    """One pod (every PodXs field sliced to length 1): select its node and
    commit it into `state` in place. -> i32[1] assigned index (-1 = none).
    `fits` (int64[3]), when given, gains the pod's fitting slots, and
    again when it has a spread group and a service (what the bounds
    count)."""
    n = node.valid.shape[0]
    mask, total = mask_and_score(node, aux, weights, anti_weight, state,
                                 pod, has_aff, has_spread)
    if fits is not None:
        fits.add_(mask.sum() * torch.stack([
            pod.valid[0], pod.group_id[0] >= 0,
            (pod.svc_group[0] >= 0) & bool(anti_weight)]).long())

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
    add32 = commit_node_local(state, pod, j, fit_any)
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


# ---------------------------------------------------------------------------
# the kernels' arguments


class ScanArgs(NamedTuple):
    """The engine's (NodeConst, Reciprocals, State, PodXs) as the kernels
    take them: every tensor on one device, contiguous, in the dtypes of one
    layout (resources and scores in `dtype`, int32 or int64; bitsets int32
    views of uint32 words; flags torch.bool). K1 commits into `state` in
    place."""
    node: NamedTuple
    aux: Reciprocals
    state: NamedTuple
    pods: NamedTuple

    @classmethod
    def from_engine(cls, node, aux, state, pods) -> "ScanArgs":
        """Checked, once for the launches it feeds: raises ValueError on
        a tensor of another device, dtype or shape than the layout's, or
        one not contiguous."""
        a = cls(node, aux, state, pods)
        _check(a)
        return a

    @property
    def dtype(self) -> torch.dtype:
        return self.node.cpu_cap.dtype

    @property
    def device(self) -> torch.device:
        return self.node.valid.device

    def dims(self) -> dict:
        """The sizes of DIM_FIELDS, weights aside: pods, slots, label /
        port / disk words, spread groups, affinity terms and domains,
        services, zones."""
        nd, st, pd = self.node, self.state, self.pods
        return {"p": pd.valid.shape[0], "n": nd.valid.shape[0],
                "l": nd.labels.shape[1], "pw": st.port_bits.shape[1],
                "k": st.disk_any.shape[1], "g": st.spread.shape[0],
                "t": nd.aff_dom.shape[0], "d": st.aff_count.shape[1],
                "s": st.svc_count.shape[0], "z": nd.zone_scratch.shape[0]}

    def pod_slice(self, lo: int, hi: int) -> "ScanArgs":
        """The same nodes and State against pods [lo, hi)."""
        return self._replace(pods=type(self.pods)(
            *(t[lo:hi] for t in self.pods)))

    def nbytes(self) -> int:
        """Bytes of every input read once: the node tables, their two
        reciprocals, the State and the pod rows."""
        tensors = (list(self.node) + [self.aux.inv_cpu, self.aux.inv_mem]
                   + list(self.state) + list(self.pods))
        return sum(t.numel() * t.element_size() for t in tensors)


def _spec(a: ScanArgs) -> dict:
    """Field -> (shape, dtype) of every tensor the kernels read."""
    d = a.dims()
    p, n, t = d["p"], d["n"], d["t"]
    w, i32, b = a.dtype, torch.int32, torch.bool
    node = {"valid": ((n,), b), "sched_ok": ((n,), b),
            "cpu_cap": ((n,), w), "mem_cap": ((n,), w),
            "pod_cap": ((n,), i32), "labels": ((n, d["l"]), i32),
            "tie_rank": ((n,), i32), "exceed_cpu": ((n,), b),
            "exceed_mem": ((n,), b), "offgrid_max": ((d["g"],), i32),
            "aff_dom": ((t, n), i32), "zone_id": ((n,), i32),
            "zone_scratch": ((d["z"],), i32), "static_mask": ((n,), b),
            "static_score": ((n,), w)}
    aux = {"inv_cpu": ((n,), torch.float64),
           "inv_mem": ((n,), torch.float64)}
    state = {"cpu_used": ((n,), w), "mem_used": ((n,), w),
             "nz_cpu": ((n,), w), "nz_mem": ((n,), w),
             "pod_count": ((n,), i32), "port_bits": ((n, d["pw"]), i32),
             "disk_any": ((n, d["k"]), i32), "disk_rw": ((n, d["k"]), i32),
             "spread": ((d["g"], n), i32), "aff_count": ((t, d["d"]), i32),
             "aff_total": ((t,), i32), "svc_count": ((d["s"], n), i32),
             "svc_total": ((d["s"],), i32)}
    pods = {"valid": ((p,), b), "req_cpu": ((p,), w), "req_mem": ((p,), w),
            "zero_req": ((p,), b), "nz_cpu": ((p,), w), "nz_mem": ((p,), w),
            "sel": ((p, d["l"]), i32), "ports": ((p, d["pw"]), i32),
            "qany": ((p, d["k"]), i32), "qrw": ((p, d["k"]), i32),
            "sany": ((p, d["k"]), i32), "srw": ((p, d["k"]), i32),
            "host_idx": ((p,), i32), "group_id": ((p,), i32),
            "member": ((p, d["g"]), i32), "aff_req": ((p, t), b),
            "anti_req": ((p, t), b), "aff_member": ((p, t), i32),
            "svc_group": ((p,), i32), "svc_member": ((p, d["s"]), i32)}
    return {"node": node, "aux": aux, "state": state, "pods": pods}


def _check(a: ScanArgs) -> None:
    if a.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"scan: resources in {a.dtype}, expected int32 "
                         f"or int64")
    device = a.device
    for part, fields in _spec(a).items():
        tree = getattr(a, part)
        for name, (shape, dtype) in fields.items():
            t = getattr(tree, name)
            where = f"scan input {part}.{name}"
            if t.device != device:
                raise ValueError(f"{where} is on {t.device}, expected "
                                 f"{device}")
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"{where}: {tuple(t.shape)} {t.dtype}, "
                                 f"expected {shape} {dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{where} is not contiguous")
    d = a.dims()
    if d["n"] < 1 or min(d[k] for k in ("l", "pw", "k", "g", "t", "d",
                                        "s", "z")) < 1:
        raise ValueError(f"scan: empty table dimension in {d}")
    if d["p"] * d["n"] >= 2 ** 31 or d["n"] * max(d["g"], d["t"], d["s"]) \
            >= 2 ** 31:
        raise ValueError(f"scan: {d} exceeds the kernel's indexing")


class LaunchPlan(NamedTuple):
    """What scan_launch is given besides the addresses and sizes: the
    kernel (SCAN or PROBE), the instantiation (bit 3 int64, bit 2 the
    spread tier, bit 1 the affinity tier, bit 0 ServiceAntiAffinity),
    the grid, the threads a block, the dynamic shared memory, the CTAs
    of a cluster (K1: its one cluster, the grid; K5: a pod's, the grid
    P times that) and the slots each CTA owns (K5 at 1 CTA a pod: 0,
    its block walks them all)."""
    kind: int
    variant: int
    grid: int
    threads: int
    smem: int
    cluster: int
    slots: int


def variant(wide: bool, has_spread: bool, has_aff: bool,
            anti: bool) -> int:
    return 8 * wide + 4 * has_spread + 2 * has_aff + anti


def slot_bytes(d: dict, wide: bool) -> int:
    """Shared memory a K1 CTA holds for one slot (SharedSlots in the
    source): two f64 reciprocals; caps, static score and the four used
    and non-zero resources in the carried type; pod cap, pod count, tie
    rank and zone; the label, port and two disk word rows; a flag byte."""
    return 16 + 7 * (8 if wide else 4) + 16 \
        + 4 * (d["l"] + d["pw"] + 2 * d["k"]) + 1


def pod_words(d: dict, wide: bool, has_spread: bool, has_aff: bool,
              anti: bool) -> int:
    """32-bit words of one staged pod row: five scalars, the four
    resources (two words each when wide), the bitset words (sel, ports,
    qany, qrw, sany, srw), and the terms, group and service members of
    the tiers on."""
    return (5 + 4 * (2 if wide else 1) + d["l"] + d["pw"] + 4 * d["k"]
            + 3 * d["t"] * has_aff + d["g"] * has_spread + d["s"] * anti)


def shared_bytes(kind: int, d: dict, wide: bool, has_spread: bool,
                 has_aff: bool, anti: bool, cluster: int = 1) -> int:
    """Dynamic shared memory of a block: for K1 a CTA's slots, a ring of
    three pod rows and the zone partials (two) and sums; for K5 one pod
    row and the zone histogram (on a cluster, the CTA's part and the
    pod's sum)."""
    e = pod_words(d, wide, has_spread, has_aff, anti)
    if kind == PROBE:
        return 4 * (e + (2 if cluster > 1 else 1) * d["z"])
    slots = -(-d["n"] // cluster)
    return slots * slot_bytes(d, wide) + 4 * (3 * e + 3 * d["z"])


def cta_threads(slots: int) -> int:
    """Threads of a K1 CTA: one a slot in whole warps (a warp at least;
    above SCAN_THREADS - 32 a thread owns several), and the loader warp
    that stages the pod rows."""
    return min(SCAN_THREADS, max(32, -(-slots // 32) * 32) + 32)


def probe_cluster(p: int, sms: int) -> int:
    """K5's CTAs a pod: the fewest of PROBE_CLUSTERS with which P pods'
    clusters cover `sms` SMs, the largest when none does."""
    for c in PROBE_CLUSTERS:
        if p * c >= sms:
            return c
    return PROBE_CLUSTERS[-1]


def probe_threads(n: int, cluster: int) -> int:
    """Threads of a K5 CTA: PROBE_THREADS for a block a pod, else one a
    slot of its share in whole warps, PROBE_THREADS at most."""
    if cluster == 1:
        return PROBE_THREADS
    per_cta = -(-n // cluster)
    return min(PROBE_THREADS, max(32, -(-per_cta // 32) * 32))


def launch_plan(kind: int, d: dict, wide: bool, has_spread: bool,
                has_aff: bool, anti: bool,
                max_clusters: Optional[Callable[[int, int, int, int], int]]
                = None, sms: int = CARD_SMS, shards: int = 0) -> LaunchPlan:
    """The plan for K1 (one cluster over the chunk's slots) or K5 (a
    cluster of probe_cluster(P, sms) CTAs a pod, the spread tier always
    on) over sizes `d` (ScanArgs.dims). Each takes the first cluster size
    of its candidates whose CTAs fit their shared memory and of which
    the card can run a cluster: `max_clusters(code, cluster, threads,
    smem)` (default: the card's own answer, `max_active_clusters`; K5's
    code carries PROBE_CODE; a K5 block a pod asks nothing). K1's
    candidates are CLUSTERS; K5's its cluster size, and 8 where that is
    16. Raises ValueError when none fits.

    `shards` > 0 plans the sharded K1 (kind SCAN) instead: one cluster a
    shard over its block of d["n"] // shards slots, the first of
    CLUSTERS of which the card can hold all `shards` clusters at once
    (their exchange spins on every shard's record, so a shard that
    waited for an SM would wedge the others); kind SHARDED, grid
    shards x cluster."""
    if shards:
        return _sharded_plan(d, wide, has_spread, has_aff, anti,
                             max_clusters or max_active_clusters, shards)
    if kind == PROBE:
        has_spread = True
    code = variant(wide, has_spread, has_aff, anti)
    if max_clusters is None:
        max_clusters = max_active_clusters
    if kind == PROBE:
        first = probe_cluster(d["p"], sms)
        sizes = (first, 8) if first == MAX_CLUSTER else (first,)
    else:
        sizes = CLUSTERS
    refused = []
    for cluster in sizes:
        slots = -(-d["n"] // cluster)
        if kind == PROBE:
            threads = probe_threads(d["n"], cluster)
            ask = code | PROBE_CODE
        else:
            threads, ask = cta_threads(slots), code
        smem = shared_bytes(kind, d, wide, has_spread, has_aff, anti,
                            cluster)
        if smem > MAX_SHARED_BYTES:
            refused.append(f"{cluster} CTAs: {smem} bytes of shared memory "
                           f"a CTA exceed {MAX_SHARED_BYTES}")
            continue
        if (kind == SCAN or cluster > 1) \
                and max_clusters(ask, cluster, threads, smem) < 1:
            refused.append(f"{cluster} CTAs of {threads} threads and {smem} "
                           f"bytes: the card cannot schedule the cluster")
            continue
        if kind == PROBE:
            return LaunchPlan(PROBE, code, d["p"] * cluster, threads, smem,
                              cluster, slots if cluster > 1 else 0)
        return LaunchPlan(SCAN, code, cluster, threads, smem, cluster, slots)
    what = "scan" if kind == SCAN else "probe"
    raise ValueError(f"{what}: no cluster fits {d['n']} slots: "
                     + "; ".join(refused))


def _sharded_plan(d: dict, wide: bool, has_spread: bool, has_aff: bool,
                  anti: bool, max_clusters, shards: int) -> LaunchPlan:
    if not 1 <= shards <= MAX_SHARDS:
        raise ValueError(f"sharded scan: {shards} shards, 1 .. {MAX_SHARDS} "
                         f"supported")
    if d["n"] % shards:
        raise ValueError(f"sharded scan: {d['n']} slots do not split over "
                         f"{shards} shards")
    block = {**d, "n": d["n"] // shards}
    code = variant(wide, has_spread, has_aff, anti) | SHARD_CODE
    refused = []
    for cluster in CLUSTERS:
        slots = -(-block["n"] // cluster)
        threads = cta_threads(slots)
        smem = shared_bytes(SCAN, block, wide, has_spread, has_aff, anti,
                            cluster)
        if smem > MAX_SHARED_BYTES:
            refused.append(f"{cluster} CTAs: {smem} bytes of shared memory "
                           f"a CTA exceed {MAX_SHARED_BYTES}")
            continue
        held = max_clusters(code, cluster, threads, smem)
        if held < shards:
            refused.append(f"{cluster} CTAs of {threads} threads and {smem} "
                           f"bytes: the card holds {held} such clusters at "
                           f"once, not {shards}")
            continue
        return LaunchPlan(SHARDED, code & 15, shards * cluster, threads,
                          smem, cluster, slots)
    raise ValueError(f"sharded scan: no cluster fits {shards} shards of "
                     f"{block['n']} slots: " + "; ".join(refused))


def pack(a: ScanArgs, weights: Tuple[int, int, int], anti_weight: int,
         outputs: dict) -> Tuple[np.ndarray, np.ndarray]:
    """-> (int64 sizes and weights in DIM_FIELDS order, uint64 addresses
    in PTR_FIELDS order). `outputs` names the output and scratch tensors
    a kernel writes; the others go as 0."""
    d = a.dims()
    dims = np.array([d[k] for k in DIM_FIELDS[:10]] + list(weights)
                    + [anti_weight], dtype=np.int64)
    src = {**{f: getattr(a.node, f) for f in _NODE_PTRS},
           **{f: getattr(a.aux, f) for f in _AUX_PTRS},
           **{f: getattr(a.state, f) for f in _STATE_PTRS},
           **{_POD_RENAMED.get(f, f): t
              for f, t in zip(type(a.pods)._fields, a.pods)},
           **outputs}
    ptrs = np.array([src[f].data_ptr() if f in src else 0
                     for f in PTR_FIELDS], dtype=np.uint64)
    return dims, ptrs


# ---------------------------------------------------------------------------
# the launches


@functools.cache
def _library() -> ctypes.CDLL:
    from ._build import load_library
    lib = load_library(SOURCE)
    # kind, variant, cluster, threads, shared bytes, sizes, addresses,
    # stream
    lib.scan_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_longlong,
                                ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p]
    lib.scan_launch.restype = ctypes.c_int
    # variant, cluster, threads, shared bytes, the count out
    lib.scan_max_clusters.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_longlong,
                                      ctypes.POINTER(ctypes.c_int)]
    lib.scan_max_clusters.restype = ctypes.c_int
    # K6 (spec_kernel): kind, variant, k0, count, threads, shared
    # bytes, sizes, addresses, stream
    lib.spec_launch.argtypes = [ctypes.c_int] * 5 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.spec_launch.restype = ctypes.c_int
    # the sharded K1 (K7 inside): variant, cluster, threads, shared
    # bytes, sizes, addresses, shard arguments (SHARD_FIELDS), stream
    lib.shard_launch.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.shard_launch.restype = ctypes.c_int
    lib.scan_error_name.argtypes = [ctypes.c_int]
    lib.scan_error_name.restype = ctypes.c_char_p
    return lib


def error_name(err: int) -> str:
    return _library().scan_error_name(err).decode()


@functools.cache
def _max_active_clusters(device: int, code: int, cluster: int,
                         threads: int, smem: int) -> int:
    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _library().scan_max_clusters(code, cluster, threads, smem,
                                           ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"scan: cluster occupancy query failed: CUDA "
                           f"error {err} ({error_name(err)})")
    return count.value


def max_active_clusters(code: int, cluster: int, threads: int,
                        smem: int) -> int:
    """How many clusters of that shape the current card can run at once
    (cudaOccupancyMaxActiveClusters; 0: none), asked once a shape: K1's
    instantiation `code`, or K5's with PROBE_CODE set."""
    return _max_active_clusters(torch.cuda.current_device(), code, cluster,
                                threads, smem)


def card_sms() -> int:
    """SMs of the current card."""
    return _card_sms(torch.cuda.current_device())


@functools.cache
def _card_sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(plan: LaunchPlan, dims: np.ndarray, ptrs: np.ndarray,
            device: torch.device, shard: Optional[np.ndarray] = None) -> int:
    """Queue one kernel on the current stream -> the CUDA error code of
    the launch (0 = launched); `shard`: the sharded K1's shard arguments
    (SHARD_FIELDS). Module-level so that a check can swap in a launch the
    card refuses (chip_smoke: a cluster larger than the card takes) and
    show that the engine raises."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.kind == SHARDED:
            return _library().shard_launch(
                plan.variant, plan.cluster, plan.threads, plan.smem,
                dims.ctypes.data, ptrs.ctypes.data, shard.ctypes.data,
                stream)
        return _library().scan_launch(
            plan.kind, plan.variant, plan.cluster, plan.threads, plan.smem,
            dims.ctypes.data, ptrs.ctypes.data, stream)


def _require_cuda(a: ScanArgs, what: str) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"{what} kernel runs on cuda, not {a.device}")


def scan_chunk(a: ScanArgs, weights: Tuple[int, int, int],
               anti_weight: int, has_aff: bool,
               has_spread: bool) -> torch.Tensor:
    """Schedule the chunk's pods in order, committing each into a.state
    in place -> i32[P] assigned slot (-1 = none). CPU tensors take the
    plain version; CUDA tensors launch K1 on the current stream (no
    synchronise) and raise if the launch is refused."""
    if a.device.type == "cpu":
        return scan_chunk_plain(a, weights, anti_weight, has_aff,
                                has_spread)
    _require_cuda(a, "scan")
    d = a.dims()
    out = torch.empty(d["p"], dtype=torch.int32, device=a.device)
    if d["p"] == 0:
        return out
    outputs = {"assigned": out}
    if anti_weight:
        outputs["work_total"] = torch.empty(d["n"], dtype=a.dtype,
                                            device=a.device)
        outputs["work_mask"] = torch.empty(d["n"], dtype=torch.uint8,
                                           device=a.device)
    with torch.cuda.device(a.device):
        plan = launch_plan(SCAN, d, a.dtype == torch.int64, has_spread,
                           has_aff, bool(anti_weight))
    dims, ptrs = pack(a, weights, anti_weight, outputs)
    err = _launch(plan, dims, ptrs, a.device)
    if err != 0:
        raise RuntimeError(f"scan kernel launch failed: CUDA error {err} "
                           f"({error_name(err)})")
    scan_chunk.launches += 1
    return out


def probe(a: ScanArgs, weights: Tuple[int, int, int], anti_weight: int,
          has_aff: bool, sms: Optional[int] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every pod against the same, unchanged State -> (mask bool[P, N],
    total[P, N] in a.dtype), the spread tier on. CPU tensors take the
    plain version; CUDA tensors launch K5 on the current stream (no
    synchronise), its pods' clusters covering `sms` SMs (default: the
    card's; 1 takes a block a pod at any P), and raise if the launch is
    refused."""
    if a.device.type == "cpu":
        return probe_plain(a, weights, anti_weight, has_aff)
    _require_cuda(a, "probe")
    d = a.dims()
    mask = torch.empty((d["p"], d["n"]), dtype=torch.bool, device=a.device)
    total = torch.empty((d["p"], d["n"]), dtype=a.dtype, device=a.device)
    if d["p"] == 0:
        return mask, total
    with torch.cuda.device(a.device):
        plan = launch_plan(PROBE, d, a.dtype == torch.int64, True, has_aff,
                           bool(anti_weight),
                           sms=card_sms() if sms is None else sms)
    dims, ptrs = pack(a, weights, anti_weight,
                      {"mask": mask, "total": total})
    err = _launch(plan, dims, ptrs, a.device)
    if err != 0:
        raise RuntimeError(f"probe kernel launch failed: CUDA error {err} "
                           f"({error_name(err)})")
    probe.launches += 1
    return mask, total


# kernel launches since each count was last set to 0
scan_chunk.launches = 0
probe.launches = 0


def scan_chunk_plain(a: ScanArgs, weights: Tuple[int, int, int],
                     anti_weight: int, has_aff: bool, has_spread: bool,
                     fits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1's function as the per-pod loop of tensor ops (about 150
    launches a pod on the card) -> i32[P]; commits into a.state. `fits`:
    see `step`. An invalid pod (the chunk's padding) fits nowhere and
    commits a zero delta, so its step is skipped: its answer is -1."""
    p = a.pods.valid.shape[0]
    aux = node_aux(a.node)
    out = torch.full((p,), -1, dtype=torch.int32, device=a.device)
    for k in np.flatnonzero(a.pods.valid.cpu().numpy()).tolist():
        pod = type(a.pods)(*(t[k:k + 1] for t in a.pods))
        out[k:k + 1] = step(a.node, aux, weights, anti_weight, a.state,
                            pod, has_aff, has_spread, fits)
    return out


def probe_plain(a: ScanArgs, weights: Tuple[int, int, int],
                anti_weight: int, has_aff: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's function as tensor ops over blocks of PROBE_BLOCK pods, each
    block one written-out pod dimension (what the JAX engine's vmap
    gives) -> (mask bool[P, N], total[P, N])."""
    p = a.pods.valid.shape[0]
    aux = node_aux(a.node)
    masks, totals = [], []
    for lo in range(0, p, PROBE_BLOCK):
        pods = a.pod_slice(lo, lo + PROBE_BLOCK).pods
        m, t = mask_and_score(a.node, aux, weights, anti_weight, a.state,
                              pods, has_aff, has_spread=True)
        masks.append(m)
        totals.append(t)
    if not masks:
        n = a.node.valid.shape[0]
        return (torch.zeros((0, n), dtype=torch.bool, device=a.device),
                torch.zeros((0, n), dtype=a.dtype, device=a.device))
    return torch.cat(masks), torch.cat(totals)


# ---------------------------------------------------------------------------
# the sharded scan (K1 over a node-axis mesh, K7 inside it)


def replica_words(d: dict) -> int:
    """int32 words of one shard's copy of the replicated counts:
    aff_count [T, D], aff_total [T], svc_total [S], in that order."""
    return d["t"] * d["d"] + d["t"] + d["s"]


# K7's records (the source's struct K7): int64 words a candidate record
# (the composite's two halves and the slot, padded to four), and the
# last launch generation, after which the kernel zeroes the records and
# counts from 1 again
K7_CAND_WORDS = 4
K7_GEN_MAX = (1 << 30) - 1


def exchange_words(shards: int, z: int) -> int:
    """int64 words of K7's exchange buffer (the source's K7::words): a
    header of 16 (word 0 the generation), a done record a shard, and,
    two by parity, a shard's candidate record, its group-max word and
    its Z zone words. Every record word is a 32-bit payload under a
    32-bit flag."""
    return 16 + shards * (3 + 2 * K7_CAND_WORDS + 2 * z)


class ShardSpace:
    """What the sharded scan keeps on its device from launch to launch:
    the copies of the replicated counts (aff_count, aff_total,
    svc_total) of shards 1 .. S - 1, one int32 row each (shard 0's are
    the State's own), and on a card K7's exchange buffer. Every word of
    its records carries a flag made of the launch's generation and the
    exchange's count, so it is zeroed here and never by the host: a
    launch reads the generation from its header, shard 0 advances it
    once every shard is done, and the launch of generation K7_GEN_MAX
    zeroes the records itself and sets the header back to 0 (a CUDA
    graph's replays wrap alike)."""

    def __init__(self, shards: int, d: dict, device: torch.device):
        self.shards = shards
        self.key = (shards, replica_words(d), d["t"], d["d"], d["s"],
                    d["z"])
        self.replicas = torch.zeros((shards - 1, replica_words(d)),
                                    dtype=torch.int32, device=device)
        self.xchg = (torch.zeros(exchange_words(shards, d["z"]),
                                 dtype=torch.int64, device=device)
                     if device.type == "cuda" else None)

    def fits(self, shards: int, d: dict) -> bool:
        return self.key == (shards, replica_words(d), d["t"], d["d"],
                            d["s"], d["z"])

    def replica(self, k: int, d: dict) -> dict:
        """Shard k's (k >= 1) copies of the replicated counts, as views
        of its row."""
        row = self.replicas[k - 1]
        td, t = d["t"] * d["d"], d["t"]
        return {"aff_count": row[:td].view(t, d["d"]),
                "aff_total": row[td:td + t], "svc_total": row[td + t:]}


def scan_chunk_sharded(a: ScanArgs, weights: Tuple[int, int, int],
                       anti_weight: int, has_aff: bool, has_spread: bool,
                       space: ShardSpace, budget: int = 0,
                       withhold: int = -1) -> torch.Tensor:
    """scan_chunk over a node axis split into space.shards blocks ->
    i32[P], committing into a.state; the same assignment and State.
    CPU tensors take scan_chunk_sharded_plain; CUDA tensors launch the
    sharded K1 on the current stream (a cluster a shard, all resident at
    once, exchanging each pod's records through K7's buffer) and raise
    if the launch is refused or the card cannot hold every shard's
    cluster. `budget` (cycles a spin may take before the kernel traps;
    0: the source's default) and `withhold` (the shard that skips its
    first candidate record) exist for the check that a wedged exchange
    raises instead of hanging."""
    shards = space.shards
    if a.device.type == "cpu":
        return scan_chunk_sharded_plain(a, weights, anti_weight, has_aff,
                                        has_spread, space)
    _require_cuda(a, "sharded scan")
    d = a.dims()
    if not space.fits(shards, d) or space.xchg is None \
            or space.xchg.device != a.device:
        raise ValueError(f"sharded scan: the shard space does not fit "
                         f"{shards} shards of {d} on {a.device}")
    out = torch.empty(d["p"], dtype=torch.int32, device=a.device)
    if d["p"] == 0:
        return out
    outputs = {"assigned": out}
    if anti_weight:
        outputs["work_total"] = torch.empty(d["n"], dtype=a.dtype,
                                            device=a.device)
        outputs["work_mask"] = torch.empty(d["n"], dtype=torch.uint8,
                                           device=a.device)
    with torch.cuda.device(a.device):
        plan = launch_plan(SCAN, d, a.dtype == torch.int64, has_spread,
                           has_aff, bool(anti_weight), shards=shards)
    dims, ptrs = pack(a, weights, anti_weight, outputs)
    shard = np.array([shards, d["n"] // shards, budget, withhold,
                      space.xchg.numel(), space.xchg.data_ptr(),
                      space.replicas.data_ptr() if shards > 1 else 0],
                     dtype=np.int64)
    err = _launch(plan, dims, ptrs, a.device, shard)
    if err != 0:
        raise RuntimeError(f"sharded scan kernel launch failed: CUDA error "
                           f"{err} ({error_name(err)})")
    scan_chunk_sharded.launches += 1
    return out


scan_chunk_sharded.launches = 0


def scan_chunk_sharded_plain(a: ScanArgs, weights: Tuple[int, int, int],
                             anti_weight: int, has_aff: bool,
                             has_spread: bool, space: ShardSpace
                             ) -> torch.Tensor:
    """The sharded K1's function as tensor ops, shard by shard: shard k
    scores the pod over its block of slots [k * B, (k + 1) * B) (views
    of the tables, `mesh.block_view`) against its own copy of the
    replicated counts, and the S records the kernel exchanges a pod are
    reduced here the same way: the group max by max (then the off-table
    max), the zone histogram by sum, the candidates (composite, slot) by
    the larger composite, then the smaller slot, -1 when none is >= 0.
    The winner's owner commits its rows and group columns; every shard
    commits the replicated counts into its own copy. Shards 1 .. S - 1
    copy shard 0's counts (the State's) at the start, as the kernel does
    -> i32[P]."""
    shards = space.shards
    d = a.dims()
    p, n = d["p"], d["n"]
    b = n // shards
    if b * shards != n or not space.fits(shards, d):
        raise ValueError(f"sharded scan: {n} slots over {shards} shards "
                         f"with a space for {space.key}")
    copies = [{f: getattr(a.state, f) for f in REPLICATED}]
    for k in range(1, shards):
        rep = space.replica(k, d)
        for f in REPLICATED:
            rep[f].copy_(getattr(a.state, f))
        copies.append(rep)
    blocks = []
    for k in range(shards):
        lo = k * b
        node = block_view(a.node, NODE_SPLIT, lo, lo + b)
        blocks.append((lo, node, node_aux(node),
                       block_view(a.state, STATE_SPLIT, lo, lo + b,
                                  copies[k]),
                       torch.arange(lo, lo + b, dtype=torch.int32,
                                    device=a.device)))
    out = torch.full((p,), -1, dtype=torch.int32, device=a.device)
    for k in range(p):
        pod = type(a.pods)(*(t[k:k + 1] for t in a.pods))
        if not bool(pod.valid[0]):
            continue
        gid = int(pod.group_id[0])
        override = None
        if has_spread:
            maxc = 0
            if gid >= 0:
                recs = [int(st.spread[gid].max()) for _, _, _, st, _ in blocks]
                maxc = max(max(recs), int(a.node.offgrid_max[gid]))
            override = torch.full((d["g"],), maxc, dtype=torch.int32,
                                  device=a.device)
        zones = None
        if anti_weight:
            zones = sum(zone_histogram(
                node, aux, st, pod,
                mask_and_score(node, aux, weights, 0, st, pod, has_aff,
                               has_spread, iota=iota,
                               spread_max_override=override)[0])
                for _, node, aux, st, iota in blocks)
        recs = []
        for lo, node, aux, st, iota in blocks:
            mask, total = mask_and_score(node, aux, weights, anti_weight, st,
                                         pod, has_aff, has_spread, iota=iota,
                                         spread_max_override=override,
                                         zones_override=zones)
            comp = torch.where(mask[0], total[0] * n + node.tie_rank, -1)
            c, i = comp.max(dim=0)
            recs.append((int(c), lo + int(i)))
        best = max(c for c, _ in recs)
        if best < 0:
            continue
        j = min(jj for c, jj in recs if c == best)
        out[k] = j
        lo, node, _, st, _ = blocks[j // b]
        jl = torch.tensor([j - lo], dtype=torch.long, device=a.device)
        fit = torch.ones(1, dtype=torch.bool, device=a.device)
        commit_node_local(st, pod, jl, fit)
        if has_spread:
            st.spread.index_add_(1, jl, pod.member.T)
        if anti_weight:
            st.svc_count.index_add_(1, jl, pod.svc_member.T)
        for rep in copies:
            if has_aff:
                dom = a.node.aff_dom[:, j]
                t = torch.arange(d["t"], device=a.device)
                rep["aff_count"].index_put_(
                    (t, torch.clamp(dom, min=0).long()),
                    torch.where(dom >= 0, pod.aff_member[0], 0),
                    accumulate=True)
                rep["aff_total"].add_(pod.aff_member[0])
            if anti_weight:
                rep["svc_total"].add_(pod.svc_member[0])
    return out
