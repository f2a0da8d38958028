"""The predicate-filter kernel: a hand-written CUDA kernel for Hopper.

Replaces the JAX package's Pallas TPU kernel
`kubernetes_tpu/sched/device/pallas_filter.py` (`_filter_kernel`, called
through `_filter_call`). It computes the [P, N] predicate-fit mask of P
pending pods against N nodes and the pre-batch state, for the extender
Filter verb (plugin/pkg/scheduler/extender.go:95): PodFitsResources
(pod count, cpu / mem free with `cap == 0` as unlimited, the snapshot's
exceed flags, the zero-request bypass), PodFitsHostPorts,
MatchNodeSelector and NoDiskConflict as bitset word loops, HostName, the
static label-presence mask, and `valid & sched_ok & pod.valid`. Every
predicate is integer or bitset arithmetic, so the kernel and its plain
version agree bit for bit.

Source: `csrc/filter_kernel.cu`, built with nvcc for sm_90a at first use
(`_build.load_library`) and called through ctypes.

Bound: bytes. The output is one byte per (pod, node) and dominates: at
P = 8192, N = 5000 it is 41 MB against ~0.2 MB of inputs, so the least
time on an H100 SXM is ~41 MB / 3.35 TB/s ~ 12 us. The design follows
from that: one thread per output element with nodes on threadIdx.x, so
each warp writes 32 consecutive output bytes and reads its node columns
coalesced; the block's pod rows are staged in shared memory once; the
mask is written as uint8 straight into a torch.bool tensor (a quarter of
the TPU kernel's int32 output, and no cast afterwards).

On a CPU tensor the wrapper computes `filter_masks_plain` instead; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import numpy as np
import torch

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "filter_kernel.cu")
# pod rows per block; must match FILTER_BLOCK_PODS in the source
BLOCK_PODS = 8
_MAX_GRID_Y = 65535


class FilterArgs(NamedTuple):
    """Kernel inputs. Node vectors are [N], node bitsets [N, W], pod
    vectors [P], pod bitsets [P, W]. Integers are int32 (the narrowed
    encoding), bitsets int32 views of uint32 words, flags torch.bool."""
    valid: torch.Tensor        # bool[N]: valid & sched_ok
    cpu_cap: torch.Tensor
    mem_cap: torch.Tensor
    pod_cap: torch.Tensor
    exceed_cpu: torch.Tensor   # bool[N]
    exceed_mem: torch.Tensor   # bool[N]
    static_mask: torch.Tensor  # bool[N]
    labels: torch.Tensor       # [N, L]
    cpu_used: torch.Tensor
    mem_used: torch.Tensor
    pod_count: torch.Tensor
    port_bits: torch.Tensor    # [N, PW]
    disk_any: torch.Tensor     # [N, K]
    disk_rw: torch.Tensor      # [N, K]
    pvalid: torch.Tensor       # bool[P]
    preq_cpu: torch.Tensor
    preq_mem: torch.Tensor
    pzero: torch.Tensor        # bool[P]
    psel: torch.Tensor         # [P, L]
    pports: torch.Tensor       # [P, PW]
    pqany: torch.Tensor        # [P, K]
    pqrw: torch.Tensor         # [P, K]
    phost: torch.Tensor        # [P]

    @classmethod
    def from_engine(cls, node, state, pods) -> "FilterArgs":
        """From the engine's (NodeConst, State, PodXs). sched_ok folds
        into the valid lane mask: the two are AND-ed identically in the
        probe's mask."""
        return cls(
            valid=node.valid & node.sched_ok, cpu_cap=node.cpu_cap,
            mem_cap=node.mem_cap, pod_cap=node.pod_cap,
            exceed_cpu=node.exceed_cpu, exceed_mem=node.exceed_mem,
            static_mask=node.static_mask, labels=node.labels,
            cpu_used=state.cpu_used, mem_used=state.mem_used,
            pod_count=state.pod_count, port_bits=state.port_bits,
            disk_any=state.disk_any, disk_rw=state.disk_rw,
            pvalid=pods.valid, preq_cpu=pods.req_cpu,
            preq_mem=pods.req_mem, pzero=pods.zero_req, psel=pods.sel,
            pports=pods.ports, pqany=pods.qany, pqrw=pods.qrw,
            phost=pods.host_idx)

    def pod_slice(self, lo: int, hi: int) -> "FilterArgs":
        """The same nodes and state against pods [lo, hi)."""
        return self._replace(**{f: getattr(self, f)[lo:hi]
                                for f in _POD_FIELDS})

    @property
    def shape(self):
        return self.pvalid.shape[0], self.valid.shape[0]

    def nbytes(self) -> int:
        """Bytes the function must move: each input read once, the bool
        [P, N] output written once."""
        p, n = self.shape
        return sum(t.numel() * t.element_size() for t in self) + p * n


_POD_FIELDS = ("pvalid", "preq_cpu", "preq_mem", "pzero", "psel", "pports",
               "pqany", "pqrw", "phost")


def supports(enc) -> bool:
    """Kernel eligibility for this encoding: i32-narrowed resources
    (the wide i64 path takes the probe), no inter-pod affinity terms."""
    pb = enc.pod_batch
    if enc.node_tab.cpu_cap.dtype != np.int32:
        return False
    if bool(pb.aff_req.any() or pb.anti_req.any()):
        return False
    return True


def filter_masks_plain(a: FilterArgs) -> torch.Tensor:
    """The kernel's function as tensor ops: -> bool[P, N]."""
    n = a.valid.shape[0]
    fits_count = a.pod_count < a.pod_cap                              # [N]
    free_cpu = (a.cpu_cap == 0) | (a.cpu_cap - a.cpu_used
                                   >= a.preq_cpu[:, None])
    free_mem = (a.mem_cap == 0) | (a.mem_cap - a.mem_used
                                   >= a.preq_mem[:, None])
    not_exceeded = ~a.exceed_cpu & ~a.exceed_mem
    res_ok = fits_count & (a.pzero[:, None]
                           | (not_exceeded & free_cpu & free_mem))
    port_ok = ((a.port_bits[None] & a.pports[:, None]) == 0).all(dim=2)
    sel_ok = ((a.psel[:, None] & ~a.labels[None]) == 0).all(dim=2)
    disk_ok = (((a.disk_any[None] & a.pqany[:, None])
                | (a.disk_rw[None] & a.pqrw[:, None])) == 0).all(dim=2)
    node_idx = torch.arange(n, dtype=torch.int32, device=a.valid.device)
    host_ok = (a.phost[:, None] == -1) | (node_idx[None] == a.phost[:, None])
    return (a.valid & a.pvalid[:, None] & res_ok & port_ok & sel_ok
            & host_ok & disk_ok & a.static_mask)


def _check(a: FilterArgs) -> None:
    p, n = a.shape
    device = a.valid.device
    lw, pw, kw = a.labels.shape[1], a.port_bits.shape[1], a.disk_any.shape[1]
    want = {
        "valid": ((n,), torch.bool), "cpu_cap": ((n,), torch.int32),
        "mem_cap": ((n,), torch.int32), "pod_cap": ((n,), torch.int32),
        "exceed_cpu": ((n,), torch.bool), "exceed_mem": ((n,), torch.bool),
        "static_mask": ((n,), torch.bool), "labels": ((n, lw), torch.int32),
        "cpu_used": ((n,), torch.int32), "mem_used": ((n,), torch.int32),
        "pod_count": ((n,), torch.int32),
        "port_bits": ((n, pw), torch.int32),
        "disk_any": ((n, kw), torch.int32), "disk_rw": ((n, kw), torch.int32),
        "pvalid": ((p,), torch.bool), "preq_cpu": ((p,), torch.int32),
        "preq_mem": ((p,), torch.int32), "pzero": ((p,), torch.bool),
        "psel": ((p, lw), torch.int32), "pports": ((p, pw), torch.int32),
        "pqany": ((p, kw), torch.int32), "pqrw": ((p, kw), torch.int32),
        "phost": ((p,), torch.int32)}
    for name, (shape, dtype) in want.items():
        t = getattr(a, name)
        if t.device != device:
            raise ValueError(f"filter input {name} is on {t.device}, "
                             f"expected {device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"filter input {name}: {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"filter input {name} is not contiguous")
    if -(-p // BLOCK_PODS) > _MAX_GRID_Y:
        raise ValueError(f"{p} pods exceed the kernel's grid limit")


@functools.cache
def _library() -> ctypes.CDLL:
    from ._build import load_library
    lib = load_library(SOURCE)
    # (P, N, LW, PW, KW), one pointer per FilterArgs field, out, stream
    lib.filter_masks_launch.argtypes = (
        [ctypes.c_int] * 5
        + [ctypes.c_void_p] * (len(FilterArgs._fields) + 2))
    lib.filter_masks_launch.restype = ctypes.c_int
    lib.filter_error_name.argtypes = [ctypes.c_int]
    lib.filter_error_name.restype = ctypes.c_char_p
    return lib


def _launch(a: FilterArgs, out: torch.Tensor) -> int:
    """Queue the kernel on the current stream -> the CUDA error code of
    the launch (0 = launched). Module-level so that the evidence tool can
    swap in a launch CUDA refuses, as the JAX evidence swapped
    pallas_filter._filter_call, and show that filter_masks raises."""
    p, n = a.shape
    with torch.cuda.device(a.valid.device):
        stream = torch.cuda.current_stream().cuda_stream
        return _library().filter_masks_launch(
            p, n, a.labels.shape[1], a.port_bits.shape[1],
            a.disk_any.shape[1], *(t.data_ptr() for t in a),
            out.data_ptr(), stream)


def filter_masks(a: FilterArgs) -> torch.Tensor:
    """-> bool[P, N] fit mask. CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream (no synchronise) and
    raise if the launch is refused."""
    if a.valid.device.type == "cpu":
        return filter_masks_plain(a)
    if a.valid.device.type != "cuda":
        raise ValueError(f"filter kernel runs on cuda, not {a.valid.device}")
    _check(a)
    p, n = a.shape
    out = torch.empty((p, n), dtype=torch.bool, device=a.valid.device)
    if p == 0 or n == 0:
        return out
    err = _launch(a, out)
    if err != 0:
        name = _library().filter_error_name(err).decode()
        raise RuntimeError(
            f"filter kernel launch failed: CUDA error {err} ({name})")
    filter_masks.launches += 1
    return out


# kernel launches since the count was last set to 0
filter_masks.launches = 0
