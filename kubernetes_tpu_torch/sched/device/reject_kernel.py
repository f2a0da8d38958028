"""The row-wise argsort kernel: a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel of the JAX package's evidence tool
(`kubernetes_tpu/kubemark/tpu_evidence.py`, `_section_pallas._bad_call.
bad_kernel`): `o[r, :] = jnp.argsort(x[r, :])` as int32 on f32[8, 128].
Mosaic cannot lower that body, and the TPU kernel existed to prove that a
real kernel rejection reaches the caller. The port computes the function
for real and shows the rejection half with a launch CUDA refuses
(`argsort_rows(x, block_threads=2048)`): the wrapper raises RuntimeError
naming the CUDA error, and the port's engine has no latch that would
swallow it (kubemark/gpu_evidence.py, `kernels` section).

Order: `jnp.argsort`'s, not torch's. XLA sorts floats by a key in which
+0 and -0 are equal, denormals are zero (XLA flushes them on the CPU and
the TPU; torch.argsort does not), and every NaN sorts after +inf; the
sort is stable, so equal keys keep index order.

Source: `csrc/reject_kernel.cu`. Each element becomes one distinct 64-bit
key (NaN flag, the float's order-preserving integer image, the column
index), and a bitonic network sorts the keys: for C <= 1024 one warp a
row with its keys in registers (`__shfl_xor_sync` between lanes), for
wider rows one block a row with its keys in shared memory. Bound:
bytes; at [8, 128] it moves 8 KiB, ~2.4 ns at 3.35 TB/s, so a launch
costs far more than its bound. `empty_launch` queues a kernel that does
nothing: the launch floor every kernel's time is read against.

On a CPU tensor the wrapper computes `argsort_rows_plain`; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import torch

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "reject_kernel.cu")
MAX_BLOCK_THREADS = 1024
# up to here a warp sorts a row in registers, 32 keys a lane at most
WARP_MAX_COLS = 1024
# the 64-bit keys of one row live in the shared path's static-size window
# of dynamic shared memory (no opt-in attribute is needed)
_MAX_COLS = 48 * 1024 // 8


class LaunchPlan(NamedTuple):
    """What `argsort_rows_launch` is given: keys a lane of the warp
    kernel (0 = the shared-memory kernel), blocks, threads a block."""
    keys_per_lane: int
    grid: int
    threads: int


def _sort_keys(x: torch.Tensor):
    """XLA's float sort key: -> (key, is_nan). Zeros and denormals map
    to +0; NaN maps to key 0 with its flag set."""
    nan = torch.isnan(x)
    tiny = torch.finfo(torch.float32).tiny
    key = torch.where(nan | (x.abs() < tiny), torch.zeros_like(x), x)
    return key, nan


def argsort_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's function as tensor ops: f32[R, C] -> i32[R, C], the
    stable row-wise argsort in jnp.argsort's order. Ranks every element
    by counting what sorts before it, as the kernel does."""
    r, c = x.shape
    key, nan = _sort_keys(x)
    idx = torch.arange(c, device=x.device)
    ki, kj = key[:, :, None], key[:, None, :]            # [R, i, j]
    ni, nj = nan[:, :, None], nan[:, None, :]
    before = (~nj & ni) | ((nj == ni) & (
        (kj < ki) | ((kj == ki) & (idx[None, None, :] < idx[None, :, None]))))
    rank = before.sum(dim=2)                              # [R, C]
    out = torch.empty((r, c), dtype=torch.int32, device=x.device)
    out.scatter_(1, rank, idx.to(torch.int32).expand(r, c).contiguous())
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    from ._build import load_library
    lib = load_library(SOURCE)
    lib.argsort_rows_launch.argtypes = (
        [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3)
    lib.argsort_rows_launch.restype = ctypes.c_int
    lib.argsort_rows_error_name.argtypes = [ctypes.c_int]
    lib.argsort_rows_error_name.restype = ctypes.c_char_p
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int
    return lib


def launch_plan(rows: int, cols: int, block_threads: int = 0) -> LaunchPlan:
    """The kernel and grid for f32[rows, cols]. block_threads 0 picks one
    warp a block on the warp path (one row a block: the rows spread over
    the SMs, so no two share one SM's shuffle unit) and 1024 threads on
    one row a block on the shared path; any other multiple of 32 is
    launched as it is, more than the card takes included."""
    threads = block_threads or (32 if cols <= WARP_MAX_COLS
                                else MAX_BLOCK_THREADS)
    if threads <= 0 or threads % 32:
        raise ValueError(f"block_threads {threads} is not a positive "
                         f"multiple of 32 (the kernel works in whole warps)")
    if cols > WARP_MAX_COLS:
        return LaunchPlan(0, rows, threads)
    k = 1
    while 32 * k < cols:
        k *= 2
    return LaunchPlan(k, -(-rows // (threads // 32)), threads)


def _launch(x: torch.Tensor, out: torch.Tensor, plan: LaunchPlan) -> int:
    """Queue the kernel on the current stream as `plan` says -> the CUDA
    error code of the launch (0 = launched)."""
    r, c = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        return _library().argsort_rows_launch(
            r, c, *plan, x.data_ptr(), out.data_ptr(), stream)


def empty_launch(device) -> None:
    """Queue the kernel that does nothing (one warp) on the current
    stream: the launch floor probe. Not a kernel of the system: it
    has no plain version and no launch count."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().empty_launch(stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err} "
                           f"({error_name(err)})")


def error_name(err: int) -> str:
    return _library().argsort_rows_error_name(err).decode()


def argsort_rows(x: torch.Tensor, block_threads: int = 0) -> torch.Tensor:
    """-> i32[R, C] stable row-wise argsort of f32[R, C].

    block_threads: the kernel's block size; 0 lets launch_plan pick it.
    Any other multiple of 32 is launched as it is: the evidence tool passes more than the card's 1024 threads to
    show that a refused launch raises RuntimeError."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"argsort_rows takes f32[R, C], not "
                         f"{x.dtype}{list(x.shape)}")
    plan = launch_plan(*x.shape, block_threads)   # raises on a bad block
    if x.device.type == "cpu":
        return argsort_rows_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"argsort kernel runs on cuda, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("argsort input is not contiguous")
    r, c = x.shape
    if c > _MAX_COLS:
        raise ValueError(f"{c} columns exceed the kernel's {_MAX_COLS}")
    out = torch.empty((r, c), dtype=torch.int32, device=x.device)
    if r == 0 or c == 0:
        return out
    err = _launch(x, out, plan)
    if err != 0:
        raise RuntimeError(f"argsort kernel launch failed: CUDA error "
                           f"{err} ({error_name(err)})")
    argsort_rows.launches += 1
    return out


# kernel launches since the count was last set to 0
argsort_rows.launches = 0
