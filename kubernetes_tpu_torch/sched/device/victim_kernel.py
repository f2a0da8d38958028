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

Source: `csrc/victim_kernel.cu`: one thread a node walks its victim
prefix in order, as `oracle_find_victims` does, and stops at the first
k that fits; a block reduction, then the last block to finish, find the
first maximum in the same launch. Bound: bytes (~2.3 MB at 5000 nodes x
16 victims, ~0.7 us), below one launch: the kernel is read against the
launch floor.

On CPU tensors the wrapper computes `victim_search_plain`, the JAX
kernel's own tensor formulation (prefix sums, a [N, V+1] feasibility
matrix, a first-True argmax); on CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..preemption import PMAX, SCORE_STRIDE, SENIOR_NONE

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "victim_kernel.cu")
BLOCK_THREADS = 256       # VICTIM_BLOCK_THREADS


class VictimArgs(NamedTuple):
    """Kernel inputs: node vectors [N], victim matrices [N, V], the
    preemptor's scalars as python ints / bool. Integers int64, flags
    torch.bool."""
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

    @classmethod
    def from_table(cls, t, device) -> "VictimArgs":
        """A VictimTable's arrays on `device` (one copy each)."""
        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(
                a, dtype=dtype)).to(device)
        return cls(
            cand=up(t.cand, np.bool_), cpu_cap=up(t.cpu_cap, np.int64),
            mem_cap=up(t.mem_cap, np.int64), pod_cap=up(t.pod_cap, np.int64),
            cpu_used=up(t.cpu_used, np.int64),
            mem_used=up(t.mem_used, np.int64),
            pod_count=up(t.pod_count, np.int64),
            tie_rank=up(t.tie_rank, np.int64), v_prio=up(t.v_prio, np.int64),
            v_cpu=up(t.v_cpu, np.int64), v_mem=up(t.v_mem, np.int64),
            v_valid=up(t.v_valid, np.bool_), prio=int(t.prio),
            req_cpu=int(t.req_cpu), req_mem=int(t.req_mem),
            zero_req=bool(t.zero_req))

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.v_prio.shape)

    def nbytes(self) -> int:
        """Bytes the function must move: each input read once, kstar and
        score (int64[N]) and pick written once."""
        n, _ = self.shape
        return sum(a.numel() * a.element_size() for a in self
                   if isinstance(a, torch.Tensor)) + 16 * n + 8


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


def victim_search_plain(a: VictimArgs
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX kernel's formulation in PyTorch -> (pick i64[], kstar
    i64[N], score i64[N])."""
    n, v = a.shape
    vm, res_ok = _release_fits(a)
    nv = vm.to(torch.int64).sum(dim=1)
    k = torch.arange(v + 1, dtype=torch.int64, device=vm.device)[None, :]
    feas = a.cand[:, None] & (k <= nv[:, None]) & res_ok
    any_k = feas.any(dim=1)
    kstar = _first_true(feas)
    senior = torch.gather(a.v_prio, 1, torch.clamp(kstar - 1, min=0)[:, None]
                          )[:, 0] if v else torch.zeros_like(kstar)
    senior = torch.where(kstar > 0, senior, SENIOR_NONE)
    score = ((v - kstar) * SCORE_STRIDE + (PMAX - senior)) * n + a.tie_rank
    score = torch.where(any_k, score, -1)
    return torch.argmax(score), kstar, score


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


@functools.cache
def _library() -> ctypes.CDLL:
    from ._build import load_library
    lib = load_library(SOURCE)
    # grid, threads, N, V, 12 input pointers, prio, req_cpu, req_mem,
    # zero_req, kstar, score, pick, 3 scratch pointers, stream
    lib.victim_search_launch.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.c_void_p] * 12
        + [ctypes.c_longlong] * 3 + [ctypes.c_int]
        + [ctypes.c_void_p] * 7)
    lib.victim_search_launch.restype = ctypes.c_int
    lib.victim_error_name.argtypes = [ctypes.c_int]
    lib.victim_error_name.restype = ctypes.c_char_p
    return lib


def error_name(err: int) -> str:
    return _library().victim_error_name(err).decode()


@functools.cache
def _done_counter(device: torch.device) -> torch.Tensor:
    """The kernel's count of finished blocks on `device`: zeroed once
    here, and set back to 0 by each launch's last block. Launches share
    it, so they must not overlap: each is queued on the current stream,
    and the port queues them all on one."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def _launch(a: VictimArgs, kstar: torch.Tensor, score: torch.Tensor,
            pick: torch.Tensor, threads: int = BLOCK_THREADS) -> int:
    """Queue the kernel on the current stream -> the CUDA error code of
    the launch (0 = launched). Module-level so that a check can swap in
    a launch the card refuses (chip_smoke: `threads` past the kernel's
    launch bounds) and show that find_victims raises."""
    n, v = a.shape
    grid = -(-n // threads)
    dev = a.cand.device
    block_score = torch.empty(grid, dtype=torch.int64, device=dev)
    block_index = torch.empty(grid, dtype=torch.int32, device=dev)
    done = _done_counter(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        return _library().victim_search_launch(
            grid, threads, n, v,
            *(getattr(a, f).data_ptr()
              for f in _NODE_FIELDS + _VICTIM_FIELDS),
            a.prio, a.req_cpu, a.req_mem, int(a.zero_req),
            kstar.data_ptr(), score.data_ptr(), pick.data_ptr(),
            block_score.data_ptr(), block_index.data_ptr(),
            done.data_ptr(), stream)


def victim_search(a: VictimArgs
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (pick i64[], kstar i64[N], score i64[N]). CPU tensors take the
    plain version; CUDA tensors launch the kernel on the current stream
    (no synchronise) and raise if the launch is refused."""
    device = a.cand.device
    if device.type == "cpu":
        return victim_search_plain(a)
    if device.type != "cuda":
        raise ValueError(f"victim kernel runs on cuda, not {device}")
    _check(a)
    n, _ = a.shape
    if n == 0:
        raise ValueError("victim search over an empty node table")
    kstar = torch.empty(n, dtype=torch.int64, device=device)
    score = torch.empty(n, dtype=torch.int64, device=device)
    pick = torch.empty((), dtype=torch.int64, device=device)
    err = _launch(a, kstar, score, pick)
    if err != 0:
        raise RuntimeError(f"victim kernel launch failed: CUDA error "
                           f"{err} ({error_name(err)})")
    victim_search.launches += 1
    return pick, kstar, score


# kernel launches since the count was last set to 0
victim_search.launches = 0
