"""The speculative engine (K6): a parallel pass and a repair step, both
hand-written CUDA kernels for Hopper.

Replaces the XLA programs of the JAX engine's speculative run
(`kubernetes_tpu/sched/device/engine.py`: `_make_spec_pass`,
`_gather_lanes`, `_spec_step`, `_make_spec_run`). A chunk's pods go in
blocks of SPEC_BLOCK; for each block, against the State the earlier
blocks left:

  K6a, the pass    every pod of the block against the block-start State
                   at once -> composite `total * N + tie_rank` where the
                   pod fits, -1 where not, [b, N] (K5's block-a-pod body
                   writing composites);
  K6b, the repair  the block's pods in order, each given its exact
                   sequential pick: the largest of its frozen composite
                   on the nodes no earlier pod of the block took, and of
                   a rescore against the live State of the nodes they
                   took (the scores are node-local, so only those moved),
                   then the scan's O(1) commit.

On the spread tier the frozen row stays exact on untouched nodes only
while the pod's group's max count equals its block-start value (commits
only raise counts): a per-group flag latches when a commit lifts a count
past the block-start max, and a flagged group's pods take a full-width
rescore against the live State; the others rescore their touched nodes
with the block-start max as the spread override. The result is the
scan's, bit for bit (composites are injective per node, so the two sets
never tie). Eligible: no inter-pod affinity terms and no
ServiceAntiAffinity (their scores move globally per commit); the spread
tier stays eligible (BatchEngine's route, as JAX `_get_run`).

    comp = spec_pass(a, weights, has_spread, k0, b)        # K6a
    spec_repair(a, comp, k0, b, weights, has_spread, out)  # K6b
    assigned = spec_chunk(a, weights, has_spread)          # both, a chunk

Source: `csrc/scan_kernel.cu` (beside K1 and K5, whose device helpers
fits / node_total / beats / offer / commit_slot it shares). K6a draws
each pod's top list (its k + 1 largest fitting composites: pod k sees
at most k touched slots, so its largest untouched one is among them) by
a radix select of the (k + 1)-th largest key and a rank placement, in a
time that does not grow with k. K6b is one CTA run as a pipeline one pod
deep: while its chain warp picks and commits pod k, the producer warps
take pod k + 1's best two over its candidates as commit k - 1 left them
(its list's entries on untouched slots, its rescores of the taken ones)
and its score on each slot pod k may take, as if pod k were committed
there; the chain then drops the entry on pod k's slot and reads its
as-if score, so no f64 score stays on the chain. The block's commits
stay in shared memory as a record a taken slot (added to the tables'
State when read, in two sets so that no reader waits for a commit, and
written back once at the end). Bound: operations and bytes
(bounds.spec_bound).

On CPU tensors the wrappers compute the plain versions (`spec_pass_plain`,
`spec_block_plain`, `spec_run_plain`: JAX's functions as tensor ops);
on CUDA tensors they launch the kernels or raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import scan_kernel as sk

# pods a block: each block gets a fresh pass against the live State, and
# its repair steps rescore at most this many touched nodes. (JAX's
# SPEC_UNROLL unrolls the repair lax.scan for XLA; a loop here or in the
# kernel has no counterpart to it.)
SPEC_BLOCK = 256                   # SPEC_TOP_MAX: the longest top list
PASS_THREADS = sk.PROBE_THREADS   # K6a runs K5's block-a-pod body
REPAIR_THREADS = 384               # SPEC_REPAIR_THREADS
PASS, REPAIR = 0, 1                # spec_launch's `kind`


# ---------------------------------------------------------------------------
# the plain versions (the JAX engine's tensor formulation in PyTorch)


def spec_pass_plain(a: sk.ScanArgs, weights: Tuple[int, int, int],
                    has_spread: bool,
                    aux: Optional[sk.NodeAux] = None) -> torch.Tensor:
    """Every pod of `a` against a.state (JAX `_make_spec_pass`) ->
    composites [P, N] in a.dtype: total * N + tie_rank where the pod
    fits, -1 where it does not."""
    n = a.node.valid.shape[0]
    if aux is None:
        aux = sk.node_aux(a.node)
    mask, total = sk.mask_and_score(a.node, aux, weights, 0, a.state,
                                    a.pods, has_aff=False,
                                    has_spread=has_spread)
    return torch.where(mask, total * n + a.node.tie_rank, -1)


def spec_top_plain(rows: torch.Tensor, count: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6a's output from the frozen composite rows [b, N]: for pod k of
    the block its top k + 1 fitting slots, largest composite first ->
    (composites [b, count] in the rows' dtype, slots int32 [b, count]),
    -1 past the pod's k + 1 entries and past its fitting slots.

    Exact for the repair: at pod k at most k slots are touched, so the
    largest untouched fitting slot has at most k touched slots above it
    and ranks among the first k + 1 (composites are injective per slot,
    so the ranking is strict)."""
    b, n = rows.shape
    vals, idx = torch.sort(rows, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :count], idx[:, :count]
    if n < count:
        pad = count - n
        vals = torch.cat([vals, torch.full((b, pad), -1, dtype=vals.dtype,
                                           device=vals.device)], dim=1)
        idx = torch.cat([idx, torch.full((b, pad), -1, dtype=idx.dtype,
                                         device=idx.device)], dim=1)
    r = torch.arange(count, device=rows.device)
    keep = (r[None, :] <= torch.arange(b, device=rows.device)[:, None]) \
        & (vals >= 0)
    return (torch.where(keep, vals, -1),
            torch.where(keep, idx, -1).to(torch.int32))


def gather_lanes(node, aux: sk.NodeAux, state, tidx: torch.Tensor,
                 lane_valid: torch.Tensor):
    """Node constants, their derived values and the State at lanes
    `tidx` (i64, clamped; invalid lanes masked out through node.valid)
    -> (node, aux, state) of the lanes (JAX `_gather_lanes`). Fields the
    node-local and spread tiers never read keep their whole arrays."""
    g = node._replace(
        valid=node.valid[tidx] & lane_valid, sched_ok=node.sched_ok[tidx],
        cpu_cap=node.cpu_cap[tidx], mem_cap=node.mem_cap[tidx],
        pod_cap=node.pod_cap[tidx], labels=node.labels[tidx],
        tie_rank=node.tie_rank[tidx], exceed_cpu=node.exceed_cpu[tidx],
        exceed_mem=node.exceed_mem[tidx],
        static_mask=node.static_mask[tidx],
        static_score=node.static_score[tidx])
    x = aux._replace(
        iota=tidx.to(torch.int32), safe_cpu=aux.safe_cpu[tidx],
        safe_mem=aux.safe_mem[tidx], safe_cpu_f=aux.safe_cpu_f[tidx],
        safe_mem_f=aux.safe_mem_f[tidx], inv_cpu=aux.inv_cpu[tidx],
        inv_mem=aux.inv_mem[tidx])
    s = state._replace(
        cpu_used=state.cpu_used[tidx], mem_used=state.mem_used[tidx],
        nz_cpu=state.nz_cpu[tidx], nz_mem=state.nz_mem[tidx],
        pod_count=state.pod_count[tidx], port_bits=state.port_bits[tidx],
        disk_any=state.disk_any[tidx], disk_rw=state.disk_rw[tidx],
        spread=state.spread[:, tidx])
    return g, x, s


class Carry:
    """The repair's carry within one block (JAX `_spec_step`'s tuple):
    nodes touched by the block's commits, the lane of each pod's pick,
    the pods so far, the spread groups' latches and their block-start
    max counts. The State itself is committed in place."""

    def __init__(self, node, state, b: int):
        n, g = node.valid.shape[0], state.spread.shape[0]
        dev = node.valid.device
        self.touched = torch.zeros(n, dtype=torch.bool, device=dev)
        self.touched_idx = torch.full((b,), -1, dtype=torch.int32,
                                      device=dev)
        self.k = 0
        self.flag = torch.zeros(g, dtype=torch.bool, device=dev)
        self.max_start = torch.maximum(state.spread.amax(dim=1),
                                       node.offgrid_max)


def spec_step_plain(node, aux: sk.NodeAux, weights: Tuple[int, int, int],
                    state, carry: Carry, pod, row, has_spread: bool
                    ) -> Tuple[torch.Tensor, bool]:
    """One repair step (JAX `_spec_step`) for one pod (PodXs fields of
    length 1) and its frozen composite row [N], or its top list (the
    (composites, slots) row of spec_top_plain, what the kernel reads):
    its exact sequential pick, committed into `state` in place; `carry`
    moves on. -> (i32[1] assigned, whether the pod took the full-width
    rescore)."""
    n = node.valid.shape[0]
    t = carry.touched_idx.shape[0]
    dev = node.valid.device
    stale = False
    if has_spread:
        gid = int(pod.group_id[0])
        stale = gid >= 0 and bool(carry.flag[gid])
    if stale:
        # the group max moved since the block start: the frozen row is
        # stale for this pod; the scan step's selection, full width
        mask, total = sk.mask_and_score(node, aux, weights, 0, state, pod,
                                        has_aff=False, has_spread=True)
        composite = torch.where(mask[0], total[0] * n + node.tie_rank, -1)
        best, pick = composite.max(dim=0, keepdim=True)
        fit_any = best >= 0
    else:
        # untouched nodes: the frozen composites are exact; touched
        # lanes: rescored against the live State
        if isinstance(row, tuple):
            # the largest untouched entry of the top k + 1
            c, sl = row
            c = torch.where((sl >= 0) & ~carry.touched[sl.clamp(min=0)],
                            c, -1)
            fv, at = c.max(dim=0, keepdim=True)
            fi = sl[at].long()
        else:
            frozen = torch.where(carry.touched, -1, row)
            fv, fi = frozen.max(dim=0, keepdim=True)
        lane_valid = (torch.arange(t, device=dev) < carry.k) \
            & (carry.touched_idx >= 0)
        tidx = torch.clamp(carry.touched_idx, min=0).long()
        gnode, gaux, gstate = gather_lanes(node, aux, state, tidx,
                                           lane_valid)
        mask_t, total_t = sk.mask_and_score(
            gnode, gaux, weights, 0, gstate, pod, has_aff=False,
            has_spread=has_spread, iota=gaux.iota,
            spread_max_override=carry.max_start if has_spread else None)
        comp_t = torch.where(mask_t[0], total_t[0] * n + gnode.tie_rank, -1)
        tv, tl = comp_t.max(dim=0, keepdim=True)
        ti = tidx[tl]
        pick = torch.where(tv > fv, ti, fi)
        fit_any = torch.maximum(tv, fv) >= 0
    assigned = torch.where(fit_any, pick, -1).to(torch.int32)

    # the scan's commit; the spread counts join on the spread tier, and
    # the latch reads the picked column before the commit
    j = torch.clamp(pick, min=0)
    if has_spread:
        member = pod.member[0]
        before = state.spread.index_select(1, j)[:, 0]
        carry.flag |= fit_any & (member > 0) \
            & (before + member > carry.max_start)
    add32 = sk.commit_node_local(state, pod, j, fit_any)
    if has_spread:
        state.spread.index_add_(1, j, (add32 * pod.member).T)
    carry.touched[j] |= fit_any
    carry.touched_idx[carry.k] = assigned[0]
    carry.k += 1
    return assigned, stale


def spec_block_plain(a: sk.ScanArgs, comp,
                     weights: Tuple[int, int, int], has_spread: bool,
                     aux: Optional[sk.NodeAux] = None,
                     slow: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The repair of one block: `a`'s pods in order against their frozen
    rows `comp` [b, N] (JAX's repair), or their top lists (the
    (composites, slots) pair of spec_top_plain: K6b's function),
    committing into a.state -> i32[b]. `slow` (bool[b]), when given,
    marks the valid pods that took the full-width rescore."""
    b = a.pods.valid.shape[0]
    if aux is None:
        aux = sk.node_aux(a.node)
    carry = Carry(a.node, a.state, b)
    out = torch.empty(b, dtype=torch.int32, device=a.device)
    for k in range(b):
        pod = type(a.pods)(*(t[k:k + 1] for t in a.pods))
        row = (comp[0][k], comp[1][k]) if isinstance(comp, tuple) \
            else comp[k]
        out[k:k + 1], stale = spec_step_plain(a.node, aux, weights, a.state,
                                              carry, pod, row, has_spread)
        if slow is not None:
            slow[k] = stale and bool(pod.valid[0])
    return out


def _pad_pods(pods, pad: int):
    return type(pods)(*(torch.cat([t, torch.zeros(
        (pad,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)])
        for t in pods))


def spec_run_plain(a: sk.ScanArgs, weights: Tuple[int, int, int],
                   has_spread: bool, block: int = SPEC_BLOCK,
                   slow: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX `_make_spec_run` on a chunk: blocks of min(block, P) pods (the
    last padded with invalid pods), each a pass against the live State
    and its repair, committing into a.state -> i32[P]. `slow` (bool[P]):
    see spec_block_plain."""
    p = a.pods.valid.shape[0]
    b = min(block, p) if p else 1
    pad = (-p) % b
    pods = _pad_pods(a.pods, pad) if pad else a.pods
    aux = sk.node_aux(a.node)
    marks = torch.zeros(p + pad, dtype=torch.bool, device=a.device)
    outs = []
    for lo in range(0, p + pad, b):
        blk = a._replace(pods=type(pods)(*(t[lo:lo + b] for t in pods)))
        comp = spec_pass_plain(blk, weights, has_spread, aux)
        outs.append(spec_block_plain(blk, comp, weights, has_spread, aux,
                                     marks[lo:lo + b]))
    if slow is not None:
        slow.copy_(marks[:p])
    if not outs:
        return torch.zeros(0, dtype=torch.int32, device=a.device)
    return torch.cat(outs)[:p]


# ---------------------------------------------------------------------------
# the launches


def plan(kind: int, d: dict, wide: bool, has_spread: bool,
         count: int) -> sk.LaunchPlan:
    """K6a (PASS: a block of PASS_THREADS a pod, `count` pods, pass_bytes
    of shared memory) or K6b (REPAIR: one CTA of REPAIR_THREADS with
    repair_bytes). Raises ValueError for more than SPEC_BLOCK pods (the
    longest top list) or where either's shared memory exceeds the
    card's."""
    if count > SPEC_BLOCK:
        raise ValueError(f"speculative block of {count} pods: at most "
                         f"{SPEC_BLOCK}")
    code = sk.variant(wide, has_spread, False, False)
    if kind == PASS:
        smem = pass_bytes(d, wide, has_spread)
        what = f"speculative pass: {smem} bytes of shared memory for " \
            f"{d['n']} slots"
        p = sk.LaunchPlan(PASS, code, count, PASS_THREADS, smem, 1, 0)
    else:
        smem = repair_bytes(d, wide, has_spread, count)
        what = f"speculative repair: {smem} bytes of shared memory for " \
            f"{count} pods over {d['n']} slots"
        p = sk.LaunchPlan(REPAIR, code, 1, REPAIR_THREADS, smem, 1, 0)
    if smem > sk.MAX_SHARED_BYTES:
        raise ValueError(f"{what} exceed {sk.MAX_SHARED_BYTES}")
    return p


def pass_bytes(d: dict, wide: bool, has_spread: bool) -> int:
    """K6a's dynamic shared memory (spec_dispatch in the source): the
    pod's row (rounded to 8 bytes), its N composites, the selected
    entries (SPEC_BLOCK composites and slots) and a 256-bin histogram."""
    e = sk.pod_words(d, wide, has_spread, False, False)
    t = 8 if wide else 4
    return -(-4 * e // 8) * 8 + t * (d["n"] + SPEC_BLOCK) \
        + 4 * (SPEC_BLOCK + 256)


def repair_bytes(d: dict, wide: bool, has_spread: bool, count: int) -> int:
    """K6b's dynamic shared memory (spec_dispatch in the source): two
    sets of count + 1 records of the block's commits, the second on an
    8-byte boundary (a record: four resources in the carried type; the
    pod count, port and disk words and, on the spread tier, the group
    counts in 32-bit words; the last record stays zero), the block's pod
    rows, two words a spread group, a word a pod (the slot its record
    holds) and a half-word a slot (its record)."""
    e = sk.pod_words(d, wide, has_spread, False, False)
    g = d["g"] if has_spread else 0
    record = 4 * (8 if wide else 4) + 4 * (1 + d["pw"] + 2 * d["k"] + g)
    one = (count + 1) * record          # the second set 8-byte aligned
    return -(-one // 8) * 8 + one + 4 * count * e + 8 * d["g"] \
        + 4 * count + 2 * d["n"]


class Top(NamedTuple):
    """K6a's output for a block of b pods: row k holds pod k's top k + 1
    fitting composites and their slots, -1 past them (spec_top_plain)."""
    comp: torch.Tensor        # [b, b] in the carried type
    slot: torch.Tensor        # int32 [b, b]


def _launch(p: sk.LaunchPlan, k0: int, count: int, dims: np.ndarray,
            ptrs: np.ndarray, device: torch.device) -> int:
    """Queue one K6 kernel on the current stream -> the CUDA error code
    (0 = launched). Module-level so that a check can swap in a launch
    the card refuses."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        return sk._library().spec_launch(
            p.kind, p.variant, k0, count, p.threads, p.smem,
            dims.ctypes.data, ptrs.ctypes.data, stream)


def _checked(p, k0, count, dims, ptrs, device, what: str) -> None:
    err = _launch(p, k0, count, dims, ptrs, device)
    if err != 0:
        raise RuntimeError(f"speculative {what} kernel launch failed: CUDA "
                           f"error {err} ({sk.error_name(err)})")


def _top_empty(a: sk.ScanArgs, count: int) -> Top:
    return Top(torch.empty((count, count), dtype=a.dtype, device=a.device),
               torch.empty((count, count), dtype=torch.int32,
                           device=a.device))


def spec_pass(a: sk.ScanArgs, weights: Tuple[int, int, int],
              has_spread: bool, k0: int, count: int,
              top: Optional[Top] = None, packed=None) -> Top:
    """Pods [k0, k0 + count) of `a` against a.state -> their top lists
    (into `top` when given). CPU tensors take the plain version
    (spec_top_plain of spec_pass_plain); CUDA tensors launch K6a on the
    current stream (no synchronise) and raise if the launch is
    refused."""
    if a.device.type == "cpu":
        out = Top(*spec_top_plain(spec_pass_plain(
            a.pod_slice(k0, k0 + count), weights, has_spread), count))
        if top is not None:
            top.comp.copy_(out.comp)
            top.slot.copy_(out.slot)
            return top
        return out
    sk._require_cuda(a, "speculative pass")
    d = a.dims()
    if top is None:
        top = _top_empty(a, count)
    dims, ptrs = packed if packed is not None else sk.pack(
        a, weights, 0, {"total": top.comp, "spec_nodes": top.slot})
    _checked(plan(PASS, d, a.dtype == torch.int64, has_spread, count), k0,
             count, dims, ptrs, a.device, "pass")
    spec_pass.launches += 1
    return top


def spec_repair(a: sk.ScanArgs, top: Top, k0: int, count: int,
                weights: Tuple[int, int, int], has_spread: bool,
                assigned: torch.Tensor, slow: Optional[torch.Tensor] = None,
                packed=None) -> None:
    """Pods [k0, k0 + count) of `a` in order against their top lists
    `top`, each committed into a.state; their picks into assigned[k0:
    k0 + count] (and `slow`, uint8 / bool[P], 1 where a valid pod took
    the full-width rescore). CPU tensors take the plain version
    (spec_block_plain over the lists); CUDA tensors launch K6b on the
    current stream (no synchronise) and raise if the launch is
    refused."""
    if a.device.type == "cpu":
        blk = a.pod_slice(k0, k0 + count)
        marks = torch.zeros(count, dtype=torch.bool)
        assigned[k0:k0 + count] = spec_block_plain(
            blk, (top.comp, top.slot), weights, has_spread, slow=marks)
        if slow is not None:
            slow[k0:k0 + count] = marks.to(slow.dtype)
        return
    sk._require_cuda(a, "speculative repair")
    d = a.dims()
    outputs = {"total": top.comp, "spec_nodes": top.slot,
               "assigned": assigned}
    if slow is not None:
        outputs["work_mask"] = slow
    dims, ptrs = packed if packed is not None else sk.pack(a, weights, 0,
                                                           outputs)
    _checked(plan(REPAIR, d, a.dtype == torch.int64, has_spread, count), k0,
             count, dims, ptrs, a.device, "repair")
    spec_repair.launches += 1


def spec_chunk(a: sk.ScanArgs, weights: Tuple[int, int, int],
               has_spread: bool, block: int = SPEC_BLOCK,
               slow: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The speculative run over one chunk, committing into a.state in
    place -> i32[P]. CPU tensors take spec_run_plain; CUDA tensors
    launch K6a and K6b alternately, a block at a time, on the current
    stream (no synchronise, no pull between blocks) and raise if a
    launch is refused. `slow`: see spec_repair."""
    if a.device.type == "cpu":
        if slow is not None and slow.dtype != torch.bool:
            marks = torch.zeros(slow.shape, dtype=torch.bool)
            out = spec_run_plain(a, weights, has_spread, block, marks)
            slow.copy_(marks)
            return out
        return spec_run_plain(a, weights, has_spread, block, slow)
    sk._require_cuda(a, "speculative")
    d = a.dims()
    p = d["p"]
    out = torch.empty(p, dtype=torch.int32, device=a.device)
    if p == 0:
        return out
    b = min(block, p)
    top = _top_empty(a, b)
    outputs = {"total": top.comp, "spec_nodes": top.slot, "assigned": out}
    if slow is not None:
        outputs["work_mask"] = slow
    packed = sk.pack(a, weights, 0, outputs)
    for k0 in range(0, p, b):
        count = min(b, p - k0)
        spec_pass(a, weights, has_spread, k0, count, top, packed)
        spec_repair(a, top, k0, count, weights, has_spread, out, slow,
                    packed)
    return out


def spec_work(assigned: np.ndarray, valid: np.ndarray, group_id: np.ndarray,
              slow: np.ndarray, block: int = SPEC_BLOCK):
    """What K6b's run on these pods did, from its outputs: the top-list
    entries it read (k + 1 for the valid pod k of a block on the fast
    path), the slots it rescored (for each such pod, the distinct slots
    the earlier pods of its block took), those of them for pods with a
    spread group, and the pods that took the full-width rescore ->
    (entries, rescored, rescored_spread, slow pods). The bound counts
    them (bounds.spec_repair_terms)."""
    p = assigned.shape[0]
    b = min(block, p) if p else 1
    entries = rescored = rescored_spread = 0
    for lo in range(0, p, b):
        taken = set()
        for k in range(lo, min(lo + b, p)):
            if valid[k] and not slow[k]:
                entries += k - lo + 1
                rescored += len(taken)
                if group_id[k] >= 0:
                    rescored_spread += len(taken)
            if assigned[k] >= 0:
                taken.add(int(assigned[k]))
    return entries, rescored, rescored_spread, int(np.count_nonzero(slow))


# kernel launches since each count was last set to 0
spec_pass.launches = 0
spec_repair.launches = 0
