"""The dirty-row scatter kernel (K3): a delta tile's table prologue in one
copy and one launch, hand-written CUDA for Hopper.

Replaces the XLA program of the JAX engine's device table mirror
(`kubernetes_tpu/sched/device/engine.py`, `_scatter_rows_fn`, called by
`_scatter_table`): the rows of a table that the encoder's TableDelta
journal marks dirty are written into every per-slot column of the
device mirror, in place. JAX pads the row count to a power of two only
to bound its compiles; here one kernel serves every R, so nothing pads.

The engine gathers everything a tile needs on the card before its scan
into one `Prologue`:

    pro = Prologue()
    g = pro.scatter(mirror_cols, idx, host_rows, also=run_cols)
    pro.copy(run_col, mirror_col, skip=g)     # the rest of the column
    slot = pro.carry(pod_column, rows)        # a host array, zero-padded
    staged = pro.stage(device)                # one buffer, one copy
    apply_staged(staged)                      # one launch
    pods, = staged.views([slot])

`scatter` writes packed host rows into rows `idx` of each column (and of
a second column where `also` names one: a dirty State row goes into the
mirror and into the run's own State); `copy` copies one column into
another, leaving out the rows a scatter group writes (so that no thread
of the launch reads a mirror row that another thread writes); `carry`
puts a host array, padded with zero rows, into the same buffer, where it
is read as a typed view and never touched by the kernel. `stage` packs
the descriptors, the index sections, the skip bitmaps, the rows and the
carried arrays into one uint8 host buffer (pinned for the card), each
section 16-byte aligned, and copies it to the device once without
blocking. Each stage takes a new pinned buffer: PyTorch's pinned-memory
allocator hands a freed buffer out again only after the copy that read
it has completed, so the previous tile's copy never sees the next
tile's rows.

Source: `csrc/scatter_kernel.cu`. Bound: bytes (bounds.prologue_bound).

On CPU tensors `apply_staged` runs `prologue_plain`, the kernel's
function as tensor ops over the same staging buffer: the copies (bitmap
honoured), then the scatters as byte-row `index_copy_`s. On CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "scatter_kernel.cu")
BLOCK_THREADS = 256        # SCATTER_BLOCK_THREADS
# x blocks a descriptor at most: the blocks stride over the rest
MAX_GRID_X = 1024
MAX_DESCS = 65535          # grid y
ALIGN = 16
SCATTER, COPY = 0, 1       # enum ScatterKind
# one descriptor: struct ScatterDesc in the source
DESCRIPTOR = np.dtype([("dst", "<u8"), ("dst2", "<u8"), ("src", "<u8"),
                       ("aux", "<u8"), ("elems", "<i4"), ("words", "<i4"),
                       ("word", "<i4"), ("kind", "<i4"), ("magic", "<u4"),
                       ("shift", "<i4"), ("pad", "<i8")])
_TORCH = {np.dtype(np.bool_): torch.bool, np.dtype(np.int32): torch.int32,
          np.dtype(np.uint32): torch.int32, np.dtype(np.int64): torch.int64}


def _align(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def _host_view(a: np.ndarray) -> np.ndarray:
    """uint32 words travel as int32, as the engine carries them."""
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _row_bytes(t: torch.Tensor) -> int:
    return math.prod(t.shape[1:]) * t.element_size()


def _word(nbytes: int, *ptrs: int) -> int:
    """The widest copy word dividing the row and every address."""
    for w in (8, 4, 2):
        if nbytes % w == 0 and all(p % w == 0 for p in ptrs):
            return w
    return 1


def magic(d: int):
    """-> (m, s) with n // d == (n * m >> 32) >> s for 0 <= n < 2^31 and
    d >= 2, m < 2^32 (the kernel's umulhi and shift); (0, 0) for d = 1,
    which the kernel takes as the row itself. With l = ceil(log2 d) and
    m = ceil(2^(31 + l) / d), the error m d - 2^(31 + l) is below d <=
    2^l, so n times it stays below 2^(31 + l) and the floor is exact."""
    if d < 2:
        return 0, 0
    lg = (d - 1).bit_length()
    m = -(-(1 << (31 + lg)) // d)
    if m >= 1 << 32:
        raise ValueError(f"no 32-bit magic number for {d}")
    return m, lg - 1


class _Scatter(NamedTuple):
    idx: np.ndarray           # int64[R]
    columns: tuple            # device tensors written
    also: tuple               # second columns written, or Nones
    rows: tuple               # host arrays [R, ...]


class _Copy(NamedTuple):
    dst: torch.Tensor
    src: torch.Tensor
    skip: Optional[int]       # the scatter group whose rows are left out


class _Carry(NamedTuple):
    array: np.ndarray
    rows: int


class Staged(NamedTuple):
    """A packed staging buffer and where its parts lie. `buf` is the
    uint8 buffer on the columns' device (on the card, the target of the
    one copy from `host`, which is pinned); `ops` hold, per descriptor,
    what the plain version needs: ("scatter", dst, dst2, rows_off,
    idx_off, R, row_bytes) or ("copy", dst, src, bitmap_off or None,
    rows, row_bytes); `carried` the (offset, dtype, shape) of each
    carried array; `rows` the rows scattered."""
    host: torch.Tensor
    buf: torch.Tensor
    n_desc: int
    grid_x: int
    ops: tuple
    carried: tuple
    rows: int
    nbytes: int

    def views(self, slots) -> List[torch.Tensor]:
        """The carried arrays at `slots`, each a typed view into the
        device buffer (carved as `carve` does)."""
        return carve(self.buf, [self.carried[i] for i in slots])


def carve(buf: torch.Tensor, layout) -> List[torch.Tensor]:
    """Typed views into a uint8 buffer, one per (byte offset, dtype,
    shape) of `layout`, each offset a multiple of its dtype's size.

    Each torch op that makes a view hands the GIL round, and a thread
    that hands it round in a process whose other threads keep it busy
    (an API server's) waits for it again: so the buffer is viewed once a
    dtype, each array is sliced out of that view (slicing keeps the GIL)
    and only arrays of more than one dimension take a view to their
    shape."""
    typed = {}
    out = []
    for off, dtype, shape in layout:
        base = typed.get(dtype)
        if base is None:
            base = typed[dtype] = buf.view(dtype)
        k = off // dtype.itemsize
        a = base[k:k + math.prod(shape)]
        out.append(a if len(shape) == 1 else a.view(shape))
    return out


def _check_columns(columns, rows, n, device) -> None:
    for i, (t, r) in enumerate(zip(columns, rows)):
        if t.device != device or t.shape[0] != n:
            raise ValueError(f"column {i}: {t.device} {tuple(t.shape)}, "
                             f"expected {device} with {n} rows")
        if not t.is_contiguous():
            raise ValueError(f"column {i} is not contiguous")
        if tuple(r.shape[1:]) != tuple(t.shape[1:]) \
                or r.dtype.itemsize != t.element_size():
            raise ValueError(f"rows {i}: {r.dtype}{list(r.shape)} do not "
                             f"fit column {t.dtype}{list(t.shape)}")


class Prologue:
    """A tile's scatters, copies and carried host arrays, gathered on the
    host for one staging buffer, one copy and one launch."""

    def __init__(self):
        self.scatters: List[_Scatter] = []
        self.copies: List[_Copy] = []
        self.carries: List[_Carry] = []

    @property
    def device(self) -> Optional[torch.device]:
        for s in self.scatters:
            return s.columns[0].device
        for c in self.copies:
            return c.dst.device
        return None

    def scatter(self, columns: Sequence[torch.Tensor], idx: np.ndarray,
                rows: Sequence[np.ndarray],
                also: Optional[Sequence[torch.Tensor]] = None) -> int:
        """Write host `rows` ([R, ...] a column) into rows `idx` (int64,
        no duplicates) of every column, and of the column of the same
        place in `also` -> the group's number (what `copy` skips)."""
        if not columns or len(columns) != len(rows):
            raise ValueError(f"scatter needs one row block a column: "
                             f"{len(columns)} columns, {len(rows)} blocks")
        also = tuple(also) if also is not None else (None,) * len(columns)
        if len(also) != len(columns):
            raise ValueError("`also` needs one column a column")
        n, device = columns[0].shape[0], columns[0].device
        if idx.dtype != np.int64 or idx.ndim != 1:
            raise ValueError(f"scatter indices must be int64[R], not "
                             f"{idx.dtype}{list(idx.shape)}")
        if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= n):
            raise ValueError(f"scatter index out of [0, {n})")
        _check_columns(columns, rows, n, device)
        for t, a in zip(columns, rows):
            if a.shape[0] != idx.size:
                raise ValueError(f"{a.shape[0]} rows for {idx.size} "
                                 f"indices")
            if idx.size * _row_bytes(t) >= 1 << 31 or \
                    t.numel() * t.element_size() >= 1 << 31:
                raise ValueError("a column past 2^31 bytes")
        for t, o in zip(columns, also):
            if o is not None and (o.shape != t.shape or o.dtype != t.dtype
                                  or o.device != device
                                  or not o.is_contiguous()):
                raise ValueError(f"second column {tuple(o.shape)} "
                                 f"{o.dtype} does not match "
                                 f"{tuple(t.shape)} {t.dtype}")
        self.scatters.append(_Scatter(idx, tuple(columns), also,
                                      tuple(_host_view(a) for a in rows)))
        return len(self.scatters) - 1

    def copy(self, dst: torch.Tensor, src: torch.Tensor,
             skip: Optional[int] = None) -> None:
        """Copy column `src` into `dst` (same shape, dtype and device),
        leaving out the rows of scatter group `skip` (which that group
        writes into `dst` itself)."""
        if dst.shape != src.shape or dst.dtype != src.dtype \
                or dst.device != src.device:
            raise ValueError(f"copy {tuple(src.shape)} {src.dtype} "
                             f"{src.device} into {tuple(dst.shape)} "
                             f"{dst.dtype} {dst.device}")
        if not (dst.is_contiguous() and src.is_contiguous()):
            raise ValueError("copy of a column that is not contiguous")
        if dst.numel() * dst.element_size() >= 1 << 31:
            raise ValueError("a column past 2^31 bytes")
        if skip is not None:
            group = self.scatters[skip]
            if group.columns[0].shape[0] != dst.shape[0]:
                raise ValueError(f"skip group of {group.columns[0].shape[0]}"
                                 f" rows for a column of {dst.shape[0]}")
        self.copies.append(_Copy(dst, src, skip))

    def carry(self, a: np.ndarray, rows: int) -> int:
        """Put host array `a` ([R, ...], R <= rows) into the buffer as
        `rows` rows, the rest zero -> its number for Staged.view."""
        a = _host_view(a)
        if a.dtype not in _TORCH or a.shape[0] > rows:
            raise ValueError(f"cannot carry {a.dtype}{list(a.shape)} as "
                             f"{rows} rows")
        self.carries.append(_Carry(a, rows))
        return len(self.carries) - 1

    @property
    def rows(self) -> int:
        return sum(int(s.idx.size) for s in self.scatters)

    def stage(self, device) -> Staged:
        """Pack everything into one buffer on `device` (one copy, not
        waited for, from a pinned host buffer on the card)."""
        device = torch.device(device)
        d = self.device
        if d is not None and (d.type != device.type or None not in (
                d.index, device.index) and d.index != device.index):
            raise ValueError(f"prologue columns on {d}, staged for {device}")
        n_desc = sum(len(s.columns) for s in self.scatters if s.idx.size) \
            + len(self.copies)
        if n_desc > MAX_DESCS:
            raise ValueError(f"{n_desc} descriptors exceed the grid")
        skipped = {c.skip for c in self.copies if c.skip is not None}
        # layout: descriptors, then per group its indices, bitmap, rows
        off = _align(n_desc * DESCRIPTOR.itemsize)
        groups = []
        for g, s in enumerate(self.scatters):
            r = int(s.idx.size)
            idx_off, off = off, _align(off + 8 * r)
            bm_off = None
            if g in skipped:
                bm_off = off
                off = _align(off + 4 * -(-s.columns[0].shape[0] // 32))
            row_offs = []
            for a in s.rows:
                row_offs.append(off)
                off = _align(off + a.nbytes)
            groups.append((idx_off, bm_off, row_offs))
        carried = []
        for c in self.carries:
            shape = (c.rows,) + tuple(c.array.shape[1:])
            carried.append((off, _TORCH[c.array.dtype], shape))
            off = _align(off + math.prod(shape) * c.array.dtype.itemsize)
        cuda = device.type == "cuda"
        host = torch.empty(max(off, ALIGN), dtype=torch.uint8,
                           pin_memory=cuda)
        buf = torch.empty_like(host, device=device) if cuda else host
        base = buf.data_ptr()
        h = host.numpy()
        desc, ops = [], []
        for s, (idx_off, bm_off, row_offs) in zip(self.scatters, groups):
            r = int(s.idx.size)
            h[idx_off:idx_off + 8 * r] = s.idx.view(np.uint8)
            if bm_off is not None:
                # bit n of word n // 32: the rows the copy leaves out
                n = s.columns[0].shape[0]
                bits = np.zeros(-(-n // 32) * 32, np.bool_)
                bits[s.idx] = True
                bm = np.packbits(bits, bitorder="little")
                h[bm_off:bm_off + bm.nbytes] = bm
            for t, o, a, ro in zip(s.columns, s.also, s.rows, row_offs):
                h[ro:ro + a.nbytes] = a.reshape(-1).view(np.uint8)
                if not r:
                    continue
                rb = _row_bytes(t)
                dst2 = o.data_ptr() if o is not None else 0
                w = _word(rb, t.data_ptr(), dst2, base + ro)
                words = rb // w
                desc.append((t.data_ptr(), dst2, base + ro, base + idx_off,
                             r * words, words, w, SCATTER, *magic(words), 0))
                ops.append(("scatter", t, o, ro, idx_off, r, rb))
        for c in self.copies:
            if c.skip is None:          # the whole column as one row
                n, rb = 1, c.dst.numel() * c.dst.element_size()
                bm = None
            else:
                n, rb = c.dst.shape[0], _row_bytes(c.dst)
                bm = groups[c.skip][1]
            w = _word(rb, c.dst.data_ptr(), c.src.data_ptr())
            words = rb // w
            desc.append((c.dst.data_ptr(), 0, c.src.data_ptr(),
                         0 if bm is None else base + bm, n * words, words, w,
                         COPY, *magic(words), 0))
            ops.append(("copy", c.dst, c.src, bm, n, rb))
        desc = np.array(desc, DESCRIPTOR)
        h[:desc.nbytes] = desc.view(np.uint8)
        for c, (o, _, shape) in zip(self.carries, carried):
            nbytes = math.prod(shape) * c.array.dtype.itemsize
            h[o:o + c.array.nbytes] = c.array.reshape(-1).view(np.uint8)
            h[o + c.array.nbytes:o + nbytes] = 0
        if cuda:
            buf.copy_(host, non_blocking=True)
        from .bounds import prologue_bytes
        groups_b = [(int(s.idx.size), [_row_bytes(t) for t in s.columns],
                     1 + (s.also[0] is not None)) for s in self.scatters]
        copied = sum(n * rb if bm is None else
                     (n - int(self.scatters[c.skip].idx.size)) * rb
                     for (_, _, _, bm, n, rb), c in zip(
                         ops[len(ops) - len(self.copies):], self.copies))
        nbytes = prologue_bytes(groups_b, copied, sum(
            math.prod(shape) * dtype.itemsize for _, dtype, shape in carried))
        return Staged(host, buf, n_desc,
                      grid_x(int(desc["elems"].max()) if n_desc else 0),
                      tuple(ops), tuple(carried), self.rows, nbytes)


def grid_x(elems: int) -> int:
    """x blocks a descriptor: enough for the largest one's words,
    capped."""
    return max(1, min(MAX_GRID_X, -(-elems // BLOCK_THREADS)))


def _byte_rows(t: torch.Tensor, n: int, rb: int) -> torch.Tensor:
    return t.view(-1).view(torch.uint8).view(n, rb)


def prologue_plain(staged: Staged) -> None:
    """The kernel's function as tensor ops, over a staging buffer on the
    columns' device: each copy (rows the bitmap marks left as they
    were), then each scatter as a byte-row index_copy_ out of the
    buffer."""
    buf = staged.buf
    for op in staged.ops:
        if op[0] != "copy":
            continue
        _, dst, src, bm, n, rb = op
        d, s = _byte_rows(dst, n, rb), _byte_rows(src, n, rb)
        if bm is None:
            d.copy_(s)
            continue
        words = buf[bm:bm + 4 * -(-n // 32)].view(torch.int32).long()
        bits = (words[:, None] >> torch.arange(32, device=buf.device)) & 1
        skip = bits.reshape(-1)[:n, None] != 0
        # a select, not a masked assignment: no host sync, so a CUDA
        # graph can hold it
        d.copy_(torch.where(skip, d, s))
    for op in staged.ops:
        if op[0] != "scatter":
            continue
        _, dst, dst2, ro, io, r, rb = op
        idx = buf[io:io + 8 * r].view(torch.int64)
        rows = buf[ro:ro + r * rb].view(r, rb)
        for t in (dst, dst2):
            if t is not None:
                _byte_rows(t, t.shape[0], rb).index_copy_(0, idx, rows)


@functools.cache
def _library() -> ctypes.CDLL:
    from ._build import load_library
    lib = load_library(SOURCE)
    lib.scatter_launch.argtypes = [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p]
    lib.scatter_launch.restype = ctypes.c_int
    lib.scatter_error_name.argtypes = [ctypes.c_int]
    lib.scatter_error_name.restype = ctypes.c_char_p
    return lib


def _launch(staged: Staged) -> int:
    """Queue the kernel on the current stream over a staging buffer on
    the device -> the CUDA error code of the launch (0 = launched).
    Module-level so that a check can swap in a launch CUDA refuses."""
    with torch.cuda.device(staged.buf.device):
        stream = torch.cuda.current_stream().cuda_stream
        return _library().scatter_launch(staged.grid_x, staged.n_desc,
                                         staged.buf.data_ptr(), stream)


def launch_staged(staged: Staged) -> None:
    """Launch the kernel over a staging buffer already on the card (no
    synchronise); raises if the launch is refused."""
    err = _launch(staged)
    if err != 0:
        name = _library().scatter_error_name(err).decode()
        raise RuntimeError(
            f"scatter kernel launch failed: CUDA error {err} ({name})")
    launch_staged.launches += 1
    launch_staged.rows += staged.rows


def apply_staged(staged: Staged) -> None:
    """Run a staged prologue: the plain version on CPU tensors, the
    kernel on CUDA tensors. Nothing to do without a descriptor."""
    if not staged.n_desc:
        return
    if staged.buf.device.type == "cpu":
        prologue_plain(staged)
        return
    if staged.buf.device.type != "cuda":
        raise ValueError(f"scatter kernel runs on cuda, not "
                         f"{staged.buf.device}")
    launch_staged(staged)


def scatter_rows(columns: Sequence[torch.Tensor], idx: np.ndarray,
                 rows: Sequence[np.ndarray]) -> int:
    """One table's scatter alone: write `rows` into rows `idx` of every
    column, in place -> the bytes the journal says must move (the int64
    indices and the rows: what the JAX engine's upload_stats counts,
    without its pad)."""
    pro = Prologue()
    pro.scatter(columns, idx, rows)
    moved = int(idx.nbytes) + sum(int(a.nbytes) for a in pro.scatters[0].rows)
    if idx.size:
        apply_staged(pro.stage(columns[0].device))
    return moved


# kernel launches since the count was last set to 0, and the rows they
# scattered
launch_staged.launches = 0
launch_staged.rows = 0
