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

Source: `csrc/reject_kernel.cu` (one block per row, the row's keys in
shared memory, each element ranked by counting the elements that sort
before it). Bound: bytes; at [8, 128] it moves 8 KiB, ~2.4 ns at
3.35 TB/s, so a launch costs far more than its bound.

On a CPU tensor the wrapper computes `argsort_rows_plain`; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "reject_kernel.cu")
MAX_BLOCK_THREADS = 1024
# keys + NaN flags of one row live in the kernel's static-size window of
# dynamic shared memory (no opt-in attribute is set)
_MAX_COLS = 48 * 1024 // 8


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
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
    lib.argsort_rows_launch.restype = ctypes.c_int
    lib.argsort_rows_error_name.argtypes = [ctypes.c_int]
    lib.argsort_rows_error_name.restype = ctypes.c_char_p
    return lib


def default_block_threads(cols: int) -> int:
    """min(C, 1024) rounded up to a whole warp."""
    return min(MAX_BLOCK_THREADS, -(-max(cols, 1) // 32) * 32)


def _launch(x: torch.Tensor, out: torch.Tensor, block_threads: int) -> int:
    """Queue the kernel on the current stream -> the CUDA error code of
    the launch (0 = launched)."""
    r, c = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        return _library().argsort_rows_launch(
            r, c, block_threads, x.data_ptr(), out.data_ptr(), stream)


def error_name(err: int) -> str:
    return _library().argsort_rows_error_name(err).decode()


def argsort_rows(x: torch.Tensor, block_threads: int = 0) -> torch.Tensor:
    """-> i32[R, C] stable row-wise argsort of f32[R, C].

    block_threads: the kernel's block size; 0 picks
    default_block_threads(C). Any other value is launched as it
    is: the evidence tool passes more than the card's 1024 threads to
    show that a refused launch raises RuntimeError."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"argsort_rows takes f32[R, C], not "
                         f"{x.dtype}{list(x.shape)}")
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
    err = _launch(x, out, block_threads or default_block_threads(c))
    if err != 0:
        raise RuntimeError(f"argsort kernel launch failed: CUDA error "
                           f"{err} ({error_name(err)})")
    argsort_rows.launches += 1
    return out


# kernel launches since the count was last set to 0
argsort_rows.launches = 0
