"""The preemption victim-search kernel: a hand-written CUDA kernel for Hopper.

Replaces the XLA program of the JAX engine's victim search
(`kubernetes_tpu/sched/device/engine.py`, `_make_preempt`, run by
`BatchEngine.find_victims`). For one preemptor against one VictimTable
(sched/preemption.py): per node the fewest lowest-priority victims whose
eviction makes the preemptor fit (k*), the injective int64 composite
score (fewest evictions, lowest senior victim, tie_rank; -1 where no
victim set helps), and the node of the first largest score (pick,
`np.argmax`'s rule; 0 with every score -1).

    pick, kstar, score = victim_search(VictimArgs.from_table(t, device))

`from_table` packs the table into one host buffer (pinned for a card)
and moves it in one non-blocking copy; the fields are views into the
device copy. The three results are views of one int64 buffer, which
`VictimResult.flat()` pulls in one copy.

Source: `csrc/victim_kernel.cu`: a group of lanes a node (a half-warp
at V <= 16) across the victim axis, so a row is one round trip of
independent loads; warp scans, ballots and a first set bit give k* and
nv; the first maximum is reduced in the same launch, by the last block
to finish, over a grid of at most one CTA an SM (`launch_plan`). Bound:
bytes (~2.3 MB at 5000 nodes x 16 victims, ~0.7 us), below one launch:
the kernel is read against the launch floor. `bounds.victim_bound`
counts what the function needs (`walk`), not the whole rows the kernel
reads.

Under a node-axis mesh `victim_search_sharded(args, S)` is the sharded
search (the JAX engine's `find_victims` with row shardings): each
shard's blocks over its ceil(N / S) rows, the last block of a shard
reducing the shard's winner and the last shard the shards' winners
(K7), in one launch; `victim_search_sharded_plain` is its twin.

On CPU tensors the wrapper computes `victim_search_plain`, the JAX
kernel's own tensor formulation (prefix sums, a [N, V+1] feasibility
matrix, a first-True argmax); on CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..preemption import PMAX, SCORE_STRIDE, SENIOR_NONE
from .scan_kernel import CARD_SMS, card_sms

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "victim_kernel.cu")
BLOCK_THREADS = 1024      # VICTIM_BLOCK_THREADS: the most a CTA


# the packed upload's parts, in buffer order: the int64 node vectors
# [N], the int64 victim matrices [N, V], then the flags as bytes
_I64_NODE = ("cpu_cap", "mem_cap", "pod_cap", "cpu_used", "mem_used",
             "pod_count", "tie_rank")
_I64_VICTIM = ("v_prio", "v_cpu", "v_mem")
_BYTES = ("cand", "v_valid")
ALIGN = 16


def _align(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


@functools.lru_cache(maxsize=64)
def packed_layout(n: int, v: int) -> Tuple[dict, int]:
    """-> ({field: (byte offset, shape, dtype, bytes)}, total bytes) of
    one table packed into a single buffer, each part 16-byte aligned."""
    parts, off = {}, 0
    for names, shape, dtype in ((_I64_NODE, (n,), torch.int64),
                                (_I64_VICTIM, (n, v), torch.int64),
                                (("cand",), (n,), torch.bool),
                                (("v_valid",), (n, v), torch.bool)):
        size = n * (v if len(shape) == 2 else 1) * (
            8 if dtype == torch.int64 else 1)
        for name in names:
            parts[name] = (off, shape, dtype, size)
            off = _align(off + size)
    return parts, off


def _views(buf: torch.Tensor, parts: dict) -> dict:
    """The fields as views into a packed uint8 buffer."""
    return {name: buf[off:off + size].view(dtype).view(shape)
            for name, (off, shape, dtype, size) in parts.items()}


class VictimArgs(NamedTuple):
    """Kernel inputs: node vectors [N], victim matrices [N, V], the
    preemptor's scalars as python ints / bool. Integers int64, flags
    torch.bool. `packed`, when set, is the one uint8 buffer the tensor
    fields are views of (from_table)."""
    cand: torch.Tensor
    cpu_cap: torch.Tensor
    mem_cap: torch.Tensor
    pod_cap: torch.Tensor
    cpu_used: torch.Tensor
    mem_used: torch.Tensor
    pod_count: torch.Tensor
    tie_rank: torch.Tensor
    v_prio: torch.Tensor
    v_cpu: torch.Tensor
    v_mem: torch.Tensor
    v_valid: torch.Tensor
    prio: int
    req_cpu: int
    req_mem: int
    zero_req: bool
    packed: Optional[torch.Tensor] = None

    @classmethod
    def from_table(cls, t, device) -> "VictimArgs":
        """A VictimTable's arrays on `device` in one upload: packed on
        the host into one buffer (pinned for a card), copied once
        without blocking, the fields views into the copy. The CPU packs
        the same buffer and keeps it."""
        device = torch.device(device)
        return cls.stage(t, pin=device.type == "cuda").to_device(device)

    @classmethod
    def stage(cls, t, pin: bool = False) -> "VictimArgs":
        """The table packed into one uint8 host buffer (pinned when
        `pin`), the fields views into it."""
        parts, nbytes = packed_layout(t.n, t.v)
        host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
        arr = host.numpy()
        for name, (off, shape, dtype, size) in parts.items():
            np.copyto(arr[off:off + size].view(
                np.int64 if dtype == torch.int64 else np.bool_).reshape(
                    shape), getattr(t, name), casting="unsafe")
        return cls(**_views(host, parts), prio=int(t.prio),
                   req_cpu=int(t.req_cpu), req_mem=int(t.req_mem),
                   zero_req=bool(t.zero_req), packed=host)

    def to_device(self, device) -> "VictimArgs":
        """Staged args on `device`: the packed buffer in one copy, not
        waited for (none on the CPU)."""
        device = torch.device(device)
        if self.packed.device == device:
            return self
        buf = self.packed.to(device, non_blocking=True)
        n, v = self.shape
        return self._replace(**_views(buf, packed_layout(n, v)[0]),
                             packed=buf)

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.v_prio.shape)

    def nbytes(self) -> int:
        """Bytes the function must move: each input read once, kstar and
        score (int64[N]) and pick written once."""
        n, _ = self.shape
        return sum(getattr(self, f).numel() * getattr(self, f).element_size()
                   for f in _NODE_FIELDS + _VICTIM_FIELDS) + 16 * n + 8


_NODE_FIELDS = ("cand", "cpu_cap", "mem_cap", "pod_cap", "cpu_used",
                "mem_used", "pod_count", "tie_rank")
_VICTIM_FIELDS = ("v_prio", "v_cpu", "v_mem", "v_valid")


def _release_fits(a: VictimArgs):
    """-> (vm bool[N, V], res_ok bool[N, V+1]): the victims the preemptor
    may evict, and whether evicting the first k of them (k = 0..V)
    makes it fit, cand and k <= nv aside."""
    n, v = a.shape
    dev = a.v_prio.device
    vm = a.v_valid & (a.v_prio < a.prio)
    zero_col = torch.zeros((n, 1), dtype=torch.int64, device=dev)
    rc = torch.cat([zero_col, torch.cumsum(
        torch.where(vm, a.v_cpu, 0), dim=1)], dim=1)
    rm = torch.cat([zero_col, torch.cumsum(
        torch.where(vm, a.v_mem, 0), dim=1)], dim=1)
    k = torch.arange(v + 1, dtype=torch.int64, device=dev)[None, :]
    fits_count = (a.pod_count[:, None] - k) < a.pod_cap[:, None]
    if a.zero_req:
        return vm, fits_count
    free_cpu = (a.cpu_cap[:, None] == 0) | (
        a.cpu_cap[:, None] - (a.cpu_used[:, None] - rc) >= a.req_cpu)
    free_mem = (a.mem_cap[:, None] == 0) | (
        a.mem_cap[:, None] - (a.mem_used[:, None] - rm) >= a.req_mem)
    return vm, fits_count & free_cpu & free_mem


def _first_true(m: torch.Tensor) -> torch.Tensor:
    """Index of the first True in each row (0 where none): argmax
    rejects bool, so int8, whose first maximum is the first True."""
    return torch.argmax(m.to(torch.int8), dim=1)


def _search_rows(a: VictimArgs, n_total: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (kstar i64[rows], score i64[rows]) of a's rows, the score's
    composite over a node axis of n_total slots (the whole table's,
    when a is one shard's block of it)."""
    _, v = a.shape
    vm, res_ok = _release_fits(a)
    nv = vm.to(torch.int64).sum(dim=1)
    k = torch.arange(v + 1, dtype=torch.int64, device=vm.device)[None, :]
    feas = a.cand[:, None] & (k <= nv[:, None]) & res_ok
    any_k = feas.any(dim=1)
    kstar = _first_true(feas)
    senior = torch.gather(a.v_prio, 1, torch.clamp(kstar - 1, min=0)[:, None]
                          )[:, 0] if v else torch.zeros_like(kstar)
    senior = torch.where(kstar > 0, senior, SENIOR_NONE)
    score = ((v - kstar) * SCORE_STRIDE + (PMAX - senior)) * n_total \
        + a.tie_rank
    return kstar, torch.where(any_k, score, -1)


def victim_search_plain(a: VictimArgs
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX kernel's formulation in PyTorch -> (pick i64[], kstar
    i64[N], score i64[N])."""
    kstar, score = _search_rows(a, a.shape[0])
    return torch.argmax(score), kstar, score


def shard_rows(a: VictimArgs, lo: int, hi: int) -> VictimArgs:
    """The table's node rows [lo, hi) (views), the preemptor's scalars
    as they are."""
    return a._replace(packed=None, **{
        f: getattr(a, f)[lo:hi] for f in _NODE_FIELDS + _VICTIM_FIELDS})


def victim_search_sharded_plain(a: VictimArgs, shards: int
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The sharded K4's function shard by shard: shard k searches its
    block of ceil(N / shards) rows (kstar and score stay split by row)
    and posts its first largest (score, row); the records reduce to the
    larger score, then the smaller row, which is np.argmax's pick over
    the whole table -> (pick i64[], kstar i64[N], score i64[N])."""
    n, _ = a.shape
    b = -(-n // shards)
    kstar = torch.empty(n, dtype=torch.int64, device=a.cand.device)
    score = torch.empty_like(kstar)
    recs = []
    for k in range(shards):
        lo, hi = k * b, min(n, (k + 1) * b)
        if lo >= hi:
            continue
        kstar[lo:hi], score[lo:hi] = _search_rows(shard_rows(a, lo, hi), n)
        c, i = score[lo:hi].max(dim=0)
        recs.append((int(c), lo + int(i)))
    best = max(c for c, _ in recs)
    pick = min(j for c, j in recs if c == best)
    return torch.tensor(pick, dtype=torch.int64), kstar, score


def walk(a: VictimArgs) -> Tuple[int, int]:
    """-> (victim entries read, walk steps) of the kernel's search over
    this table: per candidate node it steps k = 0.. to the first k whose
    release fits (V when none does), reading entry k - 1 at each k >= 1,
    and reads on past that k only while fewer than k entries were
    evictable. What bounds.victim_bound counts."""
    n, v = a.shape
    vm, res_ok = _release_fits(a)
    f = torch.where(res_ok.any(dim=1), _first_true(res_ok), v)
    read = f.clone()
    if v:
        cum = torch.cumsum(vm.to(torch.int64), dim=1)                 # [N, V]
        seen = torch.gather(torch.cat([torch.zeros_like(cum[:, :1]), cum],
                                      dim=1), 1, f[:, None])[:, 0]
        i = torch.arange(v, device=vm.device)[None, :]
        reach = (cum >= f[:, None]) & (i >= f[:, None])
        more = torch.where(reach.any(dim=1), _first_true(reach) + 1, v) - f
        read = read + torch.where(seen < f, more, 0)
    cand = a.cand.to(torch.int64)
    return int((read * cand).sum()), int(((f + 1) * cand).sum())


def _check(a: VictimArgs) -> None:
    n, v = a.shape
    device = a.cand.device
    for name in _NODE_FIELDS + _VICTIM_FIELDS:
        t = getattr(a, name)
        shape = (n,) if name in _NODE_FIELDS else (n, v)
        dtype = torch.bool if name in ("cand", "v_valid") else torch.int64
        if t.device != device:
            raise ValueError(f"victim input {name} is on {t.device}, "
                             f"expected {device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"victim input {name}: {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"victim input {name} is not contiguous")
    if n >= 2 ** 31 or v >= 2 ** 31:
        raise ValueError(f"victim table {n} x {v} exceeds int32 indexing")
    for name in ("prio", "req_cpu", "req_mem"):
        if abs(getattr(a, name)) >= 2 ** 63:
            raise ValueError(f"victim scalar {name} exceeds int64")


class LaunchPlan(NamedTuple):
    """How one search is launched: `group` lanes a node (a power of two,
    1..32), `threads` a CTA, `grid` CTAs, every node a group."""
    group: int
    threads: int
    grid: int


def group_width(v: int) -> int:
    """Lanes a node: the power of two at or above V, 32 at most (V > 32
    walks chunks of 32)."""
    return min(32, 1 << max(v - 1, 0).bit_length())


def launch_plan(n: int, v: int, sms: int = CARD_SMS) -> LaunchPlan:
    """Every node a group, the nodes shared evenly by at most one CTA an
    SM (`sms` of them) in whole warps, as many CTAs as BLOCK_THREADS
    threads need past that."""
    g = group_width(v)
    per_cta = -(-n // sms) * g
    threads = min(BLOCK_THREADS, max(32, -(-per_cta // 32) * 32))
    return LaunchPlan(g, threads, -(-n * g // threads))


def out_words(n: int, plan: LaunchPlan) -> int:
    """int64 words of the launch's one output buffer: pick, kstar [N],
    score [N], and the blocks' winners (score, index)."""
    return 1 + 2 * n + 2 * plan.grid


class VictimResult(NamedTuple):
    """pick i64[], kstar i64[N], score i64[N]: views of one int64 buffer
    in that order, which `flat()` returns whole (one pull)."""
    pick: torch.Tensor
    kstar: torch.Tensor
    score: torch.Tensor

    def flat(self) -> torch.Tensor:
        n = self.kstar.shape[0]
        return torch.as_strided(self.pick, (1 + 2 * n,), (1,),
                                self.pick.storage_offset())


def _result(out: torch.Tensor, n: int) -> VictimResult:
    return VictimResult(out[0], out[1:1 + n], out[1 + n:1 + 2 * n])


@functools.cache
def _library() -> ctypes.CDLL:
    from ._build import load_library
    lib = load_library(SOURCE)
    # the sharded search: grid, threads, group, shards, rows a shard, N,
    # V, then as victim_search_launch
    lib.victim_sharded_launch.argtypes = (
        [ctypes.c_int] * 7 + [ctypes.c_void_p] * 12
        + [ctypes.c_longlong] * 3 + [ctypes.c_int]
        + [ctypes.c_void_p] * 3)
    lib.victim_sharded_launch.restype = ctypes.c_int
    # grid, threads, group, N, V, 12 input pointers, prio, req_cpu,
    # req_mem, zero_req, the output buffer, the counter, stream
    lib.victim_search_launch.argtypes = (
        [ctypes.c_int] * 5 + [ctypes.c_void_p] * 12
        + [ctypes.c_longlong] * 3 + [ctypes.c_int]
        + [ctypes.c_void_p] * 3)
    lib.victim_search_launch.restype = ctypes.c_int
    lib.victim_error_name.argtypes = [ctypes.c_int]
    lib.victim_error_name.restype = ctypes.c_char_p
    return lib


def error_name(err: int) -> str:
    return _library().victim_error_name(err).decode()


@functools.cache
def _done_counter(device: torch.device) -> torch.Tensor:
    """The kernel's count of finished blocks on `device`: zeroed
    once here, and set back to 0 by each launch's last block. Launches
    share it, so they must not overlap: each is queued on the current
    stream, and the port queues them all on one."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def _launch(a: VictimArgs, out: torch.Tensor, plan: LaunchPlan) -> int:
    """Queue the kernel on the current stream -> the CUDA error code of
    the launch (0 = launched). Module-level so that a check can swap in
    a launch the card refuses (chip_smoke: `threads` past the kernel's
    launch bounds) and show that find_victims raises."""
    n, v = a.shape
    dev = a.cand.device
    done = _done_counter(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        return _library().victim_search_launch(
            plan.grid, plan.threads, plan.group, n, v,
            *(getattr(a, f).data_ptr()
              for f in _NODE_FIELDS + _VICTIM_FIELDS),
            a.prio, a.req_cpu, a.req_mem, int(a.zero_req),
            out.data_ptr(), done.data_ptr(), stream)


def victim_search(a: VictimArgs) -> VictimResult:
    """-> (pick i64[], kstar i64[N], score i64[N]), views of one buffer.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    on the current stream (no synchronise) and raise if the launch is
    refused."""
    device = a.cand.device
    n, v = a.shape
    if device.type == "cpu":
        out = torch.empty(1 + 2 * n, dtype=torch.int64)
        pick, kstar, score = victim_search_plain(a)
        out[0], out[1:1 + n], out[1 + n:] = pick, kstar, score
        return _result(out, n)
    if device.type != "cuda":
        raise ValueError(f"victim kernel runs on cuda, not {device}")
    _check(a)
    if n == 0:
        raise ValueError("victim search over an empty node table")
    with torch.cuda.device(device):
        plan = launch_plan(n, v, card_sms())
    out = torch.empty(out_words(n, plan), dtype=torch.int64, device=device)
    err = _launch(a, out, plan)
    if err != 0:
        raise RuntimeError(f"victim kernel launch failed: CUDA error "
                           f"{err} ({error_name(err)})")
    victim_search.launches += 1
    return _result(out, n)


# kernel launches since the count was last set to 0
victim_search.launches = 0


# the most shards the sharded search takes (its counters a device)
MAX_SHARDS = 64


@functools.cache
def _shard_counters(device: torch.device) -> torch.Tensor:
    """The sharded search's counts on `device`: [0] the shards done,
    [1 + k] shard k's blocks done; zeroed once here, each set back to 0
    by the launch's last arriver that reads it."""
    return torch.zeros(1 + MAX_SHARDS, dtype=torch.int32, device=device)


def sharded_plan(n: int, v: int, shards: int,
                 sms: int = CARD_SMS) -> Tuple[LaunchPlan, int]:
    """-> (the plan of the whole grid, the rows a shard): each shard's
    ceil(N / shards) rows planned as launch_plan plans a table over its
    share of the SMs, the shards' blocks side by side in one grid."""
    b = -(-n // shards)
    per = launch_plan(b, v, max(1, sms // shards))
    return per._replace(grid=per.grid * shards), b


def sharded_out_words(n: int, plan: LaunchPlan, shards: int) -> int:
    """out_words, then the shards' winners (score, row)."""
    return out_words(n, plan) + 2 * shards


def _sharded_launch(a: VictimArgs, out: torch.Tensor, plan: LaunchPlan,
                    shards: int, b: int) -> int:
    n, v = a.shape
    dev = a.cand.device
    done = _shard_counters(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        return _library().victim_sharded_launch(
            plan.grid, plan.threads, plan.group, shards, b, n, v,
            *(getattr(a, f).data_ptr()
              for f in _NODE_FIELDS + _VICTIM_FIELDS),
            a.prio, a.req_cpu, a.req_mem, int(a.zero_req),
            out.data_ptr(), done.data_ptr(), stream)


def victim_search_sharded(a: VictimArgs, shards: int) -> VictimResult:
    """victim_search over a node axis split into `shards` blocks of rows
    (the JAX engine's find_victims under a mesh: kstar and score split
    by row, pick reduced across shards) -> the same (pick, kstar,
    score). CPU tensors take victim_search_sharded_plain; CUDA tensors
    launch the sharded K4 (each shard's blocks over its rows, the last
    block of a shard reducing the shard's winner, the last shard the
    shards' winners: K7) and raise if the launch is refused."""
    device = a.cand.device
    n, v = a.shape
    if not 1 <= shards <= MAX_SHARDS:
        raise ValueError(f"sharded victim search: {shards} shards, 1 .. "
                         f"{MAX_SHARDS} supported")
    if device.type == "cpu":
        out = torch.empty(1 + 2 * n, dtype=torch.int64)
        pick, kstar, score = victim_search_sharded_plain(a, shards)
        out[0], out[1:1 + n], out[1 + n:] = pick, kstar, score
        return _result(out, n)
    if device.type != "cuda":
        raise ValueError(f"victim kernel runs on cuda, not {device}")
    _check(a)
    if n == 0:
        raise ValueError("victim search over an empty node table")
    with torch.cuda.device(device):
        plan, b = sharded_plan(n, v, shards, card_sms())
    out = torch.empty(sharded_out_words(n, plan, shards), dtype=torch.int64,
                      device=device)
    err = _sharded_launch(a, out, plan, shards, b)
    if err != 0:
        raise RuntimeError(f"sharded victim kernel launch failed: CUDA "
                           f"error {err} ({error_name(err)})")
    victim_search_sharded.launches += 1
    return _result(out, n)


victim_search_sharded.launches = 0
