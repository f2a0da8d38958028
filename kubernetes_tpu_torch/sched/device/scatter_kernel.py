"""The dirty-row scatter kernel: a hand-written CUDA kernel for Hopper.

Replaces the XLA program of the JAX engine's device table mirror
(`kubernetes_tpu/sched/device/engine.py`, `_scatter_rows_fn`, called by
`_scatter_table`): the rows of one table that the encoder's TableDelta
journal marks dirty are written into every per-slot column of the
device mirror, in place. JAX pads the row count to a power of two only
to bound its compiles; here one kernel serves every R, so nothing pads.

    scatter_rows(columns, idx, rows)

`columns` are the mirror's device tensors (bool, int32 and int64 vectors,
the [N, W] word columns; uint32 words carried as int32 views), `idx` the
dirty slots (int64 numpy, no duplicates) and `rows` the host rows, one
numpy array [R, ...] a column. The host packs the indices and the rows
behind a small table of field descriptors (device pointer, bytes a row,
offset of the packed rows, word size) into one staging buffer in pinned
memory (`stage`), copies it to the device once without blocking, and
launches the kernel once for the whole table. Each call stages into a
new pinned buffer: PyTorch's pinned-memory allocator hands a freed
buffer out again only after the copy that read it has completed, so the
previous tile's copy can never see the next tile's rows.

Source: `csrc/scatter_kernel.cu`. Bound: bytes (the indices and rows
read once, the rows written once); at a few dirty rows a table a
launch costs far more than its bound.

On CPU tensors the wrapper stages the same buffer (in ordinary memory)
and runs `scatter_staged_plain`, the kernel's function as tensor ops: a
byte-row `index_copy_` per field out of the staging buffer. On CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Sequence

import numpy as np
import torch

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "scatter_kernel.cu")
BLOCK_THREADS = 256        # SCATTER_BLOCK_THREADS
# x blocks a field at most: the blocks stride over the rest
MAX_GRID_X = 1024
_MAX_FIELDS = 65535        # grid y
ALIGN = 16
# one descriptor: struct ScatterField in the source
DESCRIPTOR = np.dtype([("dst", "<u8"), ("row_bytes", "<i8"),
                       ("src_off", "<i8"), ("word", "<i8")])


class Staged(NamedTuple):
    """A packed staging buffer and where its parts lie. `buf` is uint8
    on the host (pinned for a card launch) or, once copied, on the
    device; `fields` holds (row_bytes, src_off, word) per column."""
    buf: torch.Tensor
    rows: int
    idx_off: int
    fields: tuple


def _align(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def _host_view(a: np.ndarray) -> np.ndarray:
    """uint32 words travel as int32, as the engine carries them."""
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _row_bytes(t: torch.Tensor) -> int:
    return int(np.prod(t.shape[1:], dtype=np.int64)) * t.element_size()


def _word(row_bytes: int, ptr: int) -> int:
    """The widest copy word dividing the row and the column's address."""
    for w in (8, 4, 2):
        if row_bytes % w == 0 and ptr % w == 0:
            return w
    return 1


def _check(columns: Sequence[torch.Tensor], idx: np.ndarray,
           rows: Sequence[np.ndarray]) -> None:
    if not columns or len(columns) != len(rows):
        raise ValueError(f"scatter needs one row block a column: "
                         f"{len(columns)} columns, {len(rows)} blocks")
    if len(columns) > _MAX_FIELDS:
        raise ValueError(f"{len(columns)} columns exceed the grid")
    n = columns[0].shape[0]
    device = columns[0].device
    if idx.dtype != np.int64 or idx.ndim != 1:
        raise ValueError(f"scatter indices must be int64[R], not "
                         f"{idx.dtype}{list(idx.shape)}")
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise ValueError(f"scatter index out of [0, {n})")
    for i, (t, r) in enumerate(zip(columns, rows)):
        if t.device != device or t.shape[0] != n:
            raise ValueError(f"column {i}: {t.device} {tuple(t.shape)}, "
                             f"expected {device} with {n} rows")
        if not t.is_contiguous():
            raise ValueError(f"column {i} is not contiguous")
        if tuple(r.shape) != (idx.size,) + tuple(t.shape[1:]) \
                or r.dtype.itemsize != t.element_size():
            raise ValueError(f"rows {i}: {r.dtype}{list(r.shape)} do not "
                             f"fit column {t.dtype}{list(t.shape)}")


def stage(columns: Sequence[torch.Tensor], idx: np.ndarray,
          rows: Sequence[np.ndarray], pin: bool = False) -> Staged:
    """Pack descriptors, indices and rows into one uint8 host buffer
    (pinned when `pin`): the kernel's single input."""
    r = int(idx.size)
    idx_off = _align(len(columns) * DESCRIPTOR.itemsize)
    fields, off = [], _align(idx_off + 8 * r)
    for t in columns:
        rb = _row_bytes(t)
        fields.append((rb, off, _word(rb, t.data_ptr())))
        off = _align(off + rb * r)
    buf = torch.empty(off, dtype=torch.uint8, pin_memory=pin)
    host = buf.numpy()
    desc = np.zeros(len(columns), DESCRIPTOR)
    desc["dst"] = [t.data_ptr() for t in columns]
    desc["row_bytes"], desc["src_off"], desc["word"] = zip(*fields)
    host[:desc.nbytes] = desc.view(np.uint8)
    host[idx_off:idx_off + 8 * r] = idx.view(np.uint8)
    for (rb, o, _), a in zip(fields, rows):
        host[o:o + rb * r] = _host_view(a).reshape(-1).view(np.uint8)
    return Staged(buf, r, idx_off, tuple(fields))


def scatter_staged_plain(columns: Sequence[torch.Tensor],
                         staged: Staged) -> None:
    """The kernel's function as tensor ops, on a staging buffer on the
    columns' device: per field, the packed rows as bytes, index_copy_-ed
    into the column's byte rows."""
    buf, r = staged.buf, staged.rows
    idx = buf[staged.idx_off:staged.idx_off + 8 * r].view(torch.int64)
    for t, (rb, off, _) in zip(columns, staged.fields):
        dst = t.view(-1).view(torch.uint8).view(t.shape[0], rb)
        dst.index_copy_(0, idx, buf[off:off + rb * r].view(r, rb))


@functools.cache
def _library() -> ctypes.CDLL:
    from ._build import load_library
    lib = load_library(SOURCE)
    lib.scatter_rows_launch.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    lib.scatter_rows_launch.restype = ctypes.c_int
    lib.scatter_error_name.argtypes = [ctypes.c_int]
    lib.scatter_error_name.restype = ctypes.c_char_p
    return lib


def grid_x(staged: Staged) -> int:
    """x blocks a field: enough for the widest field's words, capped."""
    words = max(staged.rows * rb // w for rb, _, w in staged.fields)
    return max(1, min(MAX_GRID_X, -(-words // BLOCK_THREADS)))


def _launch(staged: Staged) -> int:
    """Queue the kernel on the current stream over a staging buffer on
    the device -> the CUDA error code of the launch (0 = launched).
    Module-level so that a check can swap in a launch CUDA refuses."""
    with torch.cuda.device(staged.buf.device):
        stream = torch.cuda.current_stream().cuda_stream
        return _library().scatter_rows_launch(
            grid_x(staged), len(staged.fields), staged.rows,
            staged.idx_off, staged.buf.data_ptr(), stream)


def launch_staged(staged: Staged) -> None:
    """Launch the kernel over a staging buffer already on the card (the
    wrapper's second half; chip_smoke times it alone)."""
    err = _launch(staged)
    if err != 0:
        name = _library().scatter_error_name(err).decode()
        raise RuntimeError(
            f"scatter kernel launch failed: CUDA error {err} ({name})")
    scatter_rows.launches += 1
    scatter_rows.rows += staged.rows


def to_device(staged: Staged, device) -> Staged:
    """The staging buffer on `device`: one copy, not waited for."""
    return staged._replace(buf=staged.buf.to(device, non_blocking=True))


def scatter_rows(columns: Sequence[torch.Tensor], idx: np.ndarray,
                 rows: Sequence[np.ndarray]) -> int:
    """Write `rows` into rows `idx` of every column, in place -> the
    bytes the journal says must move (the indices and the rows: what
    the JAX engine's upload_stats counts, without its pad).

    CPU columns take the plain version; CUDA columns launch the kernel
    on the current stream (no synchronise) and raise if it is
    refused."""
    _check(columns, idx, rows)
    moved = int(idx.nbytes) + sum(int(_host_view(a).nbytes) for a in rows)
    if idx.size == 0:
        return moved
    device = columns[0].device
    if device.type == "cpu":
        scatter_staged_plain(columns, stage(columns, idx, rows))
        return moved
    if device.type != "cuda":
        raise ValueError(f"scatter kernel runs on cuda, not {device}")
    launch_staged(to_device(stage(columns, idx, rows, pin=True), device))
    return moved


# kernel launches since the count was last set to 0, and the rows they
# wrote
scatter_rows.launches = 0
scatter_rows.rows = 0
