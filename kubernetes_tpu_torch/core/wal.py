"""Write-ahead log + snapshot recovery for the control-plane store.

Reference: etcd's raft-backed WAL + snapshot files are what make the
reference's control plane survive an apiserver (or etcd) process death
(pkg/storage/etcd sits on etcd's wal/ and snap/ directories). In this
single-process reproduction the Store IS etcd, so durability lives here:
the two-phase commit already produces a totally-ordered ledger stream,
and this module appends one record per committed revision — TTL
expiries included, since the store emits those as first-class DELETED
ledger events — to a segmented, checksummed log with periodic snapshot
compaction. `Store.recover(dir)` / `NativeStore.recover(dir)` replay
snapshot + tail back into a live store, bit-identically to the
pre-crash ledger prefix (a torn final record is truncated, not fatal).

Divergence (DIVERGENCES.md #24): etcd's log is raft-REPLICATED; this is
a single-node WAL — durability against process death without
replication. The record/segment/snapshot layout is deliberately
etcd-shaped so a replicated backend can adopt the same format.

On-disk layout (everything under one directory):

  wal-<first_rev:020d>.seg   frames: <u32 len><u32 crc32>payload, where
                             payload is the JSON array
                             [rev, etype, key, expiry|null, obj_wire]
                             or, for a multi-key transaction, one frame
                             [first_rev, "TXN", [records...]] (see TXN)
  snap-<rev:020d>.json       full store state at rev: entries
                             [[key, mod_rev, expiry|null, obj_wire]...]
                             plus the seg_writes / ttl_segs bookkeeping
                             the apiserver's LIST byte caches key on

Segments are named by their first record's revision and opened lazily
(commit() names the file after the first buffered record), so recovery
never leaves an empty or torn-tailed segment behind: the reader
truncates a torn final record in place and the writer always starts a
fresh segment.

fsync_policy: "always" fsyncs every commit (every ledger window pays a
disk flush — the etcd default);
"batch" flushes every commit but fsyncs at most every _BATCH_FSYNC_S
seconds (plus on rotate/snapshot/close) — crash-consistent through the
OS page cache, power-loss-consistent only up to the fsync lag.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..utils.metrics import global_metrics

_FRAME = struct.Struct("<II")          # payload length, crc32(payload)
_SEG_FMT = "wal-%020d.seg"
_SNAP_FMT = "snap-%020d.json"
_BATCH_FSYNC_S = 0.05

# Sentinel in the etype position marking a multi-record transaction
# frame: payload [first_rev, "TXN", [[rev, etype, key, expiry,
# obj_wire], ...]]. One frame is one CRC unit, so a crash mid-write
# tears the WHOLE transaction and _read_segment truncates it
# atomically — a partial txn is never replayable. read_wal expands the
# frame back into flat records, so both recover() loops (Python and
# the kvstore.cc kv_replay ABI) replay txn-bearing logs unchanged.
TXN = "TXN"

FSYNC_POLICIES = ("always", "batch")


class WalError(Exception):
    pass


class WalCorrupt(WalError):
    """A checksum/framing failure NOT attributable to a torn tail."""


def _segments(dirpath: str) -> List[Tuple[int, str]]:
    """Sorted (first_rev, path) of every WAL segment in the directory."""
    out = []
    for name in os.listdir(dirpath):
        if name.startswith("wal-") and name.endswith(".seg"):
            try:
                out.append((int(name[4:-4]), os.path.join(dirpath, name)))
            except ValueError:
                continue
    out.sort()
    return out


def _snapshots(dirpath: str) -> List[Tuple[int, str]]:
    out = []
    for name in os.listdir(dirpath):
        if name.startswith("snap-") and name.endswith(".json"):
            try:
                out.append((int(name[5:-5]), os.path.join(dirpath, name)))
            except ValueError:
                continue
    out.sort()
    return out


def record_payload(rev: int, etype: str, key: str,
                   expiry: Optional[float], obj_wire: Any) -> bytes:
    """Unframed payload bytes of one flat record. The payload/frame
    split is the parity contract with the native appender
    (kvstore.cc kv_commit_txn): Python builds the payload, whichever
    side owns the file adds the <u32 len><u32 crc32> frame — so both
    writers produce byte-identical segments from the same records."""
    return json.dumps([rev, etype, key, expiry, obj_wire],
                      separators=(",", ":")).encode()


def txn_payload(records: List[list]) -> bytes:
    """Unframed payload of a whole multi-key transaction (see TXN)."""
    return json.dumps([records[0][0], TXN, records],
                      separators=(",", ":")).encode()


def frame(payload: bytes) -> bytes:
    """<u32 len><u32 crc32(payload)> + payload — the one on-disk frame
    shape; kvstore.cc reimplements exactly this (same CRC-32/IEEE)."""
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def encode_record(rev: int, etype: str, key: str,
                  expiry: Optional[float], obj_wire: Any) -> bytes:
    return frame(record_payload(rev, etype, key, expiry, obj_wire))


def encode_txn(records: List[list]) -> bytes:
    """One frame for a whole multi-key transaction (see TXN above).
    `records` are ordinary [rev, etype, key, expiry, obj_wire] lists
    with consecutive revisions; the first one names the frame."""
    return frame(txn_payload(records))


def _read_segment(path: str, last: bool) -> Tuple[List[list], bool]:
    """-> (decoded payloads, truncated). A torn or checksum-failing
    record in the LAST segment ends replay (the crash tore the tail —
    the file is truncated to the valid prefix so the writer can resume
    cleanly); the same damage mid-chain is real corruption and raises,
    because every later record would break revision contiguity."""
    records: List[list] = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    valid_to = 0
    torn = False
    while pos < len(data):
        if pos + _FRAME.size > len(data):
            torn = True
            break
        length, crc = _FRAME.unpack_from(data, pos)
        start = pos + _FRAME.size
        end = start + length
        if end > len(data):
            torn = True
            break
        payload = data[start:end]
        if zlib.crc32(payload) != crc:
            torn = True
            break
        try:
            rec = json.loads(payload)
        except ValueError:
            torn = True
            break
        records.append(rec)
        pos = end
        valid_to = end
    if torn:
        if not last:
            raise WalCorrupt(
                f"{os.path.basename(path)}: bad record at byte {valid_to} "
                f"in a non-final segment")
        with open(path, "r+b") as f:
            f.truncate(valid_to)
    return records, torn


def read_wal_grouped(dirpath: str
                     ) -> Tuple[Optional[Dict], List[List[list]]]:
    """-> (snapshot state | None, tail record GROUPS strictly after
    it). Each group is the atomic unit one frame carried: a singleton
    for a plain record, the whole window for a TXN frame. Recovery
    backends that replay transactions as one engine window
    (NativeStore via kv_replay_txn) key off the grouping; read_wal()
    flattens it for callers that replay record-at-a-time.

    Picks the newest parseable snapshot, then replays every segment
    record with rev > snapshot rev, enforcing strict revision order.
    Records at or below the snapshot rev are skipped (a crash between
    snapshot write and segment compaction leaves such overlap behind).
    """
    snap: Optional[Dict] = None
    for rev, path in reversed(_snapshots(dirpath)):
        try:
            with open(path) as f:
                cand = json.load(f)
            if cand.get("rev") == rev:
                snap = cand
                break
        except (OSError, ValueError):
            continue  # half-written snapshot: fall back to an older one
    floor = snap["rev"] if snap else 0
    groups: List[List[list]] = []
    segs = _segments(dirpath)
    last_rev = floor
    for i, (_first, path) in enumerate(segs):
        seg_records, torn = _read_segment(path, last=(i == len(segs) - 1))
        for rec in seg_records:
            if len(rec) > 1 and rec[1] == TXN:
                # expand the txn frame; its CRC already guaranteed
                # all-or-nothing, so only intra-frame contiguity with
                # the declared first_rev is left to enforce.
                first, flat = rec[0], rec[2]
                for j, sub in enumerate(flat):
                    if sub[0] != first + j:
                        raise WalCorrupt(
                            f"txn frame at {first} not contiguous: "
                            f"record {j} has rev {sub[0]} "
                            f"({os.path.basename(path)})")
            else:
                flat = (rec,)
            group = []
            for sub in flat:
                rev = sub[0]
                if rev <= floor:
                    continue
                if rev != last_rev + 1:
                    raise WalCorrupt(
                        f"revision gap: have {last_rev}, next record {rev} "
                        f"({os.path.basename(path)})")
                group.append(sub)
                last_rev = rev
            if group:
                groups.append(group)
        if torn:
            break  # nothing after a torn tail is replayable
    return snap, groups


def read_wal(dirpath: str) -> Tuple[Optional[Dict], List[list]]:
    """Flat view of read_wal_grouped: (snapshot | None, tail records)."""
    snap, groups = read_wal_grouped(dirpath)
    return snap, [rec for group in groups for rec in group]


class WalWriter:
    """Append side of the log. NOT thread-safe on its own: the store
    calls append/commit under its ledger lock, which is exactly the
    serialization that makes append order equal revision order."""

    def __init__(self, dirpath: str, fsync_policy: str = "batch",
                 segment_records: int = 10_000,
                 snapshot_records: int = 50_000):
        if fsync_policy not in FSYNC_POLICIES:
            raise WalError(f"fsync_policy must be one of {FSYNC_POLICIES}, "
                           f"got {fsync_policy!r}")
        os.makedirs(dirpath, exist_ok=True)
        self.dir = dirpath
        self.fsync_policy = fsync_policy
        self.segment_records = segment_records
        self.snapshot_records = snapshot_records
        self._buf: List[bytes] = []
        self._buf_records = 0            # logical records (txn-expanded)
        self._buf_first_rev = 0
        self._f = None                   # current segment file object
        self._seg_count = 0              # records in the current segment
        self._since_snapshot = 0
        self._last_fsync = 0.0
        self._closed = False
        self.frames_written = 0          # frames and bytes appended by
        self.bytes_written = 0           # this writer (snapshots apart)

    # ------------------------------------------------------------ append

    def append(self, rev: int, etype: str, key: str,
               expiry: Optional[float], obj_wire: Any) -> None:
        if not self._buf:
            self._buf_first_rev = rev
        self._buf.append(encode_record(rev, etype, key, expiry, obj_wire))
        self._buf_records += 1

    def append_txn(self, records: List[list]) -> None:
        """Buffer a whole multi-key transaction as ONE frame. The
        records are [rev, etype, key, expiry, obj_wire] lists with
        consecutive revisions (the store's commit_txn window)."""
        if not records:
            return
        if not self._buf:
            self._buf_first_rev = records[0][0]
        self._buf.append(encode_txn(records))
        self._buf_records += len(records)

    def commit(self) -> int:
        """Write every buffered frame in one os.write and flush; fsync
        per policy. Returns the number of records committed."""
        if not self._buf:
            return 0
        if self._closed:
            raise WalError("WAL is closed")
        if self._f is None:
            self._f = open(os.path.join(
                self.dir, _SEG_FMT % self._buf_first_rev), "ab")
        n = self._buf_records
        blob = b"".join(self._buf)
        self._f.write(blob)
        self._f.flush()
        self.frames_written += len(self._buf)
        self.bytes_written += len(blob)
        self._buf.clear()
        self._buf_records = 0
        self._seg_count += n
        self._since_snapshot += n
        now = time.monotonic()
        if (self.fsync_policy == "always"
                or now - self._last_fsync >= _BATCH_FSYNC_S):
            os.fsync(self._f.fileno())
            self._last_fsync = now
        global_metrics.inc("wal_records_total", by=n)
        if self._seg_count >= self.segment_records:
            self._rotate()
        return n

    def _rotate(self) -> None:
        if self._f is not None:
            os.fsync(self._f.fileno())
            self._f.close()
            self._f = None
        self._seg_count = 0

    # ---------------------------------------------------------- snapshot

    @property
    def should_snapshot(self) -> bool:
        return (self.snapshot_records > 0
                and self._since_snapshot >= self.snapshot_records)

    def write_snapshot(self, state: Dict) -> None:
        """Durably write a full-state snapshot at state['rev'], then
        compact: every closed segment's records are <= that rev, so
        they (and older snapshots) are deleted. The current segment is
        rotated first so the invariant holds."""
        rev = state["rev"]
        self._rotate()
        tmp = os.path.join(self.dir, f".snap-{rev}.tmp")
        with open(tmp, "w") as f:
            json.dump(state, f, separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(self.dir, _SNAP_FMT % rev)
        os.replace(tmp, final)
        for srev, path in _snapshots(self.dir):
            if srev < rev:
                try:
                    os.unlink(path)
                except OSError:
                    pass
        for _first, path in _segments(self.dir):
            try:
                os.unlink(path)
            except OSError:
                pass
        self._since_snapshot = 0
        global_metrics.inc("wal_snapshots_total")

    def close(self) -> None:
        if self._closed:
            return
        self.commit()
        self._rotate()
        self._closed = True
