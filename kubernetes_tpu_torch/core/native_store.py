"""ctypes binding for the native C++ store (native/kvstore.cc).

Drop-in replacement for core.store.Store: same verbs, same CAS/TTL/watch
semantics, same exceptions. Objects are serialized through the Scheme
codec at the boundary — exactly the role runtime.Codec plays between the
reference's registry and etcd (etcd_helper.go stores JSON); the stored
resourceVersion is stamped from the native revision on the way out, and
a bounded (key, rev) decode cache plays the watch cache's decoded-object
role so repeated reads don't re-parse.

When to use which backend: the pure-Python Store keeps live objects and
skips serialization entirely, so for a single-process control plane it
is the faster default. NativeStore is the etcd-analogue backend — state
lives outside the Python heap behind a serialization boundary (the cost
profile the reference's apiserver actually has), reads run GIL-free
under a native mutex, and kv_wait parks watcher threads in native code.
Writes serialise on one Python lock (`_window`) around their engine
call: commit_txn and every journaled write pre-assign a window of
revisions, and no other write may land between its staging and its
commit; the unjournaled guaranteed_update and batch hold it across each
attempt's read, fn, encode and CAS, as Store.guaranteed_update holds its
lock. Pick it when fidelity to the external-store architecture
matters more than in-proc throughput, or as the base for a future
multi-process / shared-memory deployment.

The shared library is compiled on first use (g++ -O2 -shared) from
the port's own copy of the source (native/kvstore.cc) into the package's
`_build/` directory (native/build.py). A failed build raises
NativeBuildError with the compiler's output: there is no fallback to
the pure-Python Store, and every symbol the binding names must be in
the library it built.
"""

from __future__ import annotations

import ctypes
import json as _json
import os
import struct
import threading
import time as _time
from typing import Any, Callable, Iterable, List, Optional, Tuple

from . import watch as watchpkg
from .errors import AlreadyExists, Conflict, Expired, NotFound
from .scheme import Scheme, default_scheme
from .wal import record_payload, txn_payload

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "kvstore.cc")

ERR_NOT_FOUND = -1
ERR_EXISTS = -2
ERR_CONFLICT = -3
ERR_TOO_SMALL = -4
ERR_EXPIRED = -5
# kv_commit_txn only: the pre-assigned revision window raced another
# writer — restage and retry. Distinct from ERR_CONFLICT so a genuine
# CAS failure still surfaces as Conflict to the caller.
ERR_RACED = -6
# Buffer size hints come back as -(required + SIZE_HINT_BASE): a range
# disjoint from the error codes so a tiny required size can't alias them
# (kvstore.cc SIZE_HINT_BASE).
SIZE_HINT_BASE = 64
_RETRY_SLACK = 64  # extra bytes on retry; unrelated to SIZE_HINT_BASE


def _size_hint(n: int) -> Optional[int]:
    """Decode a kv_* return: buffer size to retry with, or None."""
    if n <= -SIZE_HINT_BASE:
        return (-n - SIZE_HINT_BASE) + _RETRY_SLACK
    return None

_EVENT_TYPES = {0: watchpkg.ADDED, 1: watchpkg.MODIFIED, 2: watchpkg.DELETED}

_build_lock = threading.Lock()
_lib = None


def _load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        from ..native.build import build_native
        lib = ctypes.CDLL(build_native(_SRC))
        lib.kv_open.restype = ctypes.c_void_p
        lib.kv_open.argtypes = [ctypes.c_uint64]
        lib.kv_close.argtypes = [ctypes.c_void_p]
        lib.kv_current_rev.restype = ctypes.c_uint64
        lib.kv_current_rev.argtypes = [ctypes.c_void_p]
        lib.kv_oldest_rev.restype = ctypes.c_uint64
        lib.kv_oldest_rev.argtypes = [ctypes.c_void_p]
        for fn in (lib.kv_create, lib.kv_set):
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                           ctypes.c_char_p, ctypes.c_uint64,
                           ctypes.c_double]
        lib.kv_update.restype = ctypes.c_int64
        lib.kv_update.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_char_p, ctypes.c_uint64,
                                  ctypes.c_uint64]
        lib.kv_delete.restype = ctypes.c_int64
        lib.kv_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_uint64]
        lib.kv_get.restype = ctypes.c_int64
        lib.kv_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_char_p, ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_uint64)]
        lib.kv_list.restype = ctypes.c_int64
        lib.kv_list.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_char_p, ctypes.c_int64]
        lib.kv_batch.restype = ctypes.c_int64
        lib.kv_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.kv_create_batch.restype = ctypes.c_int64
        lib.kv_create_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_double)]
        lib.kv_events.restype = ctypes.c_int64
        lib.kv_events.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                  ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_int64]
        lib.kv_wait.restype = ctypes.c_uint64
        lib.kv_wait.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                ctypes.c_double]
        # WAL recovery (kv_restore / kv_restore_seal / kv_replay, and
        # kv_replay_txn: a TXN frame recovers as one engine lock window,
        # the atomic unit it was on disk)
        lib.kv_restore.restype = ctypes.c_int64
        lib.kv_restore.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_char_p, ctypes.c_uint64,
                                   ctypes.c_uint64, ctypes.c_double]
        lib.kv_restore_seal.restype = None
        lib.kv_restore_seal.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.kv_replay.restype = ctypes.c_int64
        lib.kv_replay.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                  ctypes.c_uint8, ctypes.c_char_p,
                                  ctypes.c_char_p, ctypes.c_uint64,
                                  ctypes.c_uint64, ctypes.c_double]
        lib.kv_replay_txn.restype = ctypes.c_int64
        lib.kv_replay_txn.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_double)]
        # the native commit path: kv_commit_txn, the publish ring and
        # the WAL appender
        lib.kv_commit_txn.restype = ctypes.c_int64
        lib.kv_commit_txn.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.kv_publish_start.restype = ctypes.c_int64
        lib.kv_publish_start.argtypes = [ctypes.c_void_p]
        lib.kv_publish_flush.restype = ctypes.c_uint64
        lib.kv_publish_flush.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.kv_shutdown.restype = None
        lib.kv_shutdown.argtypes = [ctypes.c_void_p]
        lib.kv_wal_attach.restype = ctypes.c_int64
        lib.kv_wal_attach.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_int, ctypes.c_uint64]
        lib.kv_get_ex.restype = ctypes.c_int64
        lib.kv_get_ex.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_uint64),
                                  ctypes.POINTER(ctypes.c_double)]
        lib.kv_stats.restype = None
        lib.kv_stats.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_uint64)]
        _lib = lib
        return lib


class NativeStore:
    """core.store.Store API over the C++ engine."""

    def __init__(self, window: int = 100_000,
                 scheme: Scheme = default_scheme,
                 decode_cache_size: int = 200_000,
                 wal_dir: Optional[str] = None,
                 fsync_policy: str = "batch",
                 segment_records: int = 10_000):
        self._lib = _load_library()
        self._h = self._lib.kv_open(window)
        self.scheme = scheme
        self._watch_threads: List[threading.Thread] = []
        self._watchers: List[Any] = []
        # worker fan-out shards (attach_fanout_shard); copy-on-write
        self._shards: List["_NativeShard"] = []
        self._shards_lock = threading.Lock()
        self._closed = False
        self._wal_on = False
        # Writes that pre-assign their revision window (every journaled
        # write, and commit_txn on the native path) stage and commit
        # under this lock, and every other write takes it around its
        # engine call. Without it, any write landing between a
        # window's staging and its commit claims the window: under the
        # kubemark benchmark's 30 writers a journaled create_batch ran
        # out of retries (ERR_RACED ten times running) and raised
        # Conflict, and in the split deployment the fleet's status
        # writes kept a bind tile's commit_txn restaging until it gave
        # up. The lock leaves ERR_RACED to the engine's own expiry
        # commits; staging runs under the GIL either way.
        self._window = threading.RLock()
        # the native commit path: events go to the ring publisher, and
        # commit_txn (every journaled write too) commits a pre-assigned
        # window through kv_commit_txn
        self._lib.kv_publish_start(self._h)
        if wal_dir is not None:
            from .wal import FSYNC_POLICIES, WalError
            if fsync_policy not in FSYNC_POLICIES:
                raise WalError(
                    f"fsync_policy must be one of {FSYNC_POLICIES}, "
                    f"got {fsync_policy!r}")
            os.makedirs(wal_dir, exist_ok=True)
            self._lib.kv_wal_attach(
                self._h, wal_dir.encode(),
                1 if fsync_policy == "always" else 0, segment_records)
            self._wal_on = True
        # (key, rev) -> decoded object. Plays the watch cache's decoded-
        # object role in front of "etcd" (cacher.go): objects are frozen
        # by the store contract, so sharing decoded instances is safe —
        # and writers hand their object over, so writes cache without
        # ever decoding.
        from collections import OrderedDict
        self._decoded: "OrderedDict[Tuple[str, int], Any]" = OrderedDict()
        self._decoded_cap = decode_cache_size
        self._cache_lock = threading.Lock()

    def __del__(self):
        try:
            if self._h:
                h, self._h = self._h, None
                self._closed = True
                self._lib.kv_close(h)
        except Exception:
            pass

    # -------------------------------------------------------- lifecycle

    def close(self, timeout: float = 2.0) -> None:
        """Stop the store the way a process kill would look to its
        clients: wake every watcher thread parked in kv_wait
        (kv_shutdown drains the publish ring, seals the WAL and breaks
        the native wait), stop the delivered watchers so consumers
        blocked in next() return, and join the pump threads. The
        engine handle stays alive until __del__ so a straggler pump
        can never touch freed memory."""
        if self._closed:
            return
        self._closed = True
        self._lib.kv_shutdown(self._h)
        for sh in list(self._shards):
            try:
                sh.stop(timeout=timeout)
            except Exception:
                pass
        for w in self._watchers:
            try:
                w.stop()
            except Exception:
                pass
        for t in self._watch_threads:
            t.join(timeout=timeout)

    # the apiserver restart path calls stop() on whatever store it has
    stop = close

    # --------------------------------------------------------- serde

    def _encode(self, obj: Any) -> bytes:
        return self.scheme.encode(obj).encode()

    def _stamp(self, obj: Any, rev: int) -> Any:
        from dataclasses import replace
        return replace(obj, metadata=replace(obj.metadata,
                                             resource_version=str(rev)))

    def _cache_put(self, key: str, rev: int, obj: Any) -> None:
        with self._cache_lock:
            self._decoded[(key, rev)] = obj
            while len(self._decoded) > self._decoded_cap:
                self._decoded.popitem(last=False)

    def _decode(self, raw: bytes, rev: int, key: str = "") -> Any:
        if key:
            with self._cache_lock:
                hit = self._decoded.get((key, rev))
            if hit is not None:
                return hit
        obj = self._stamp(self.scheme.decode(raw.decode()), rev)
        if key:
            self._cache_put(key, rev, obj)
        return obj

    @staticmethod
    def _key_name(key: str) -> Tuple[str, str]:
        kind = key.split("/")[2] if key.count("/") >= 2 else ""
        return kind, key.rsplit("/", 1)[-1]

    # --------------------------------------------------------- verbs

    @property
    def current_revision(self) -> int:
        return int(self._lib.kv_current_rev(self._h))

    # ------------------------------------------- native commit path

    def _kv_commit(self, first_rev: int, staged: List[tuple],
                   payloads: List[bytes]) -> int:
        """One kv_commit_txn call. staged entries are
        (type_code, key, val_bytes, expect_rev, expiry_abs); payloads
        are unframed WAL payload bytes (the engine frames them)."""
        n = len(staged)
        types = (ctypes.c_uint8 * n)(*[s[0] for s in staged])
        keys = (ctypes.c_char_p * n)(*[s[1].encode() for s in staged])
        vals = (ctypes.c_char_p * n)(*[s[2] for s in staged])
        val_lens = (ctypes.c_uint64 * n)(*[len(s[2]) for s in staged])
        expects = (ctypes.c_uint64 * n)(*[s[3] for s in staged])
        expiries = (ctypes.c_double * n)(
            *[float(s[4] or 0.0) for s in staged])
        nf = len(payloads)
        frames = (ctypes.c_char_p * nf)(*payloads) if nf else None
        frame_lens = ((ctypes.c_uint64 * nf)(*[len(p) for p in payloads])
                      if nf else None)
        return int(self._lib.kv_commit_txn(
            self._h, n, first_rev, types, keys, vals, val_lens,
            expects, expiries, nf, frames, frame_lens))

    def _txn_commit_native(self, ops, flat: bool) -> List[Any]:
        """Shared staging loop for commit_txn (one TXN frame) and the
        journaled batch() (flat frames): pre-assign the revision
        window, run the update fns against it, stamp + encode once,
        build the WAL payload(s) through core/wal.py's codec, and
        commit through kv_commit_txn — ledger mutation, WAL framing
        and the publish handoff all native. ERR_RACED (another writer
        claimed the window) and ERR_CONFLICT (a staged key moved)
        restage the whole tile, mirroring batch()'s retry contract."""
        if not ops:
            return []
        modified = watchpkg.MODIFIED
        with self._window:
            for _ in range(10):
                first = self.current_revision + 1
                rev = first - 1
                staged: List[tuple] = []
                records: List[list] = []
                outs: List[Tuple[str, Any]] = []
                for key, fn in ops:
                    raw, mod_rev, expiry = self._get_raw_ex(key)
                    rev += 1
                    cur = self._decode(raw, mod_rev, key)
                    if getattr(fn, "wants_rv", False):
                        new_obj = fn(cur, str(rev))
                    else:
                        new_obj = self._stamp(fn(cur), rev)
                    wire = self.scheme.encode_dict(new_obj)
                    val = _json.dumps(wire).encode()
                    staged.append((1, key, val, mod_rev, expiry))
                    if self._wal_on:
                        records.append([rev, modified, key,
                                        expiry if expiry else None, wire])
                    outs.append((key, new_obj))
                if self._wal_on:
                    payloads = ([record_payload(*r) for r in records]
                                if flat else [txn_payload(records)])
                else:
                    payloads = []
                r = self._kv_commit(first, staged, payloads)
                if r in (ERR_RACED, ERR_CONFLICT, ERR_NOT_FOUND):
                    # raced (window claimed / key moved / key vanished):
                    # restage — a vanished key raises NotFound with its
                    # precise name from the next _get_raw_ex probe
                    continue
                out = []
                for i, (key, obj) in enumerate(outs):
                    self._cache_put(key, first + i, obj)
                    out.append(obj)
                return out
            raise Conflict("commit_txn: too many retries")

    def publish_stats(self) -> dict:
        """Engine-side ledger/publish counters (kv_stats): the native
        commit-path split the Python sampler cannot observe."""
        out = (ctypes.c_uint64 * 8)()
        self._lib.kv_stats(self._h, out)
        return {"commits": int(out[0]), "ledger_ns": int(out[1]),
                "published_batches": int(out[2]),
                "publish_ns": int(out[3]), "wal_frames": int(out[4]),
                "wal_bytes": int(out[5]), "revision": int(out[6]),
                "published_rev": int(out[7])}

    def publish_flush(self, timeout: float = 5.0) -> int:
        """Block until the native publisher has drained the ring (the
        committer's drain barrier: 'drained' must keep meaning
        'visible to watchers'). Returns the watch-visible revision."""
        return int(self._lib.kv_publish_flush(self._h, float(timeout)))

    # ----------------------------------------------------- durability

    @classmethod
    def recover(cls, wal_dir: str, window: int = 100_000,
                scheme: Scheme = default_scheme) -> "NativeStore":
        """Rebuild a NativeStore from a WAL directory (core/wal.py
        layout, as written by the Python Store's ledger hook): snapshot
        entries restore with their original mod_revs and absolute
        expiries (kv_restore, no history), the revision counter seals
        at the snapshot point (kv_restore_seal — revisions at or below
        it are not replayable, the watch-window contract), and the
        record tail replays at its exact revisions (kv_replay). Same
        recovered-prefix contract as Store.recover: same revision,
        same live object set, expired keys never resurrected. This is
        also the migration path from the in-proc ledger onto the
        native engine: capture with one backend, recover into the
        other."""
        import time as _time

        from ..utils.metrics import global_metrics
        from .wal import WalError, read_wal_grouped

        t0 = _time.monotonic()
        lib = _load_library()
        snap, groups = read_wal_grouped(wal_dir)
        st = cls(window=window, scheme=scheme)
        etype_code = {v: k for k, v in _EVENT_TYPES.items()}
        if snap is not None:
            for key, mod_rev, expiry, wire in snap["entries"]:
                raw = _json.dumps(wire).encode()
                lib.kv_restore(st._h, key.encode(), raw, len(raw),
                               int(mod_rev), float(expiry or 0))
            lib.kv_restore_seal(st._h, int(snap["rev"]))
        n_records = 0
        for group in groups:
            n_records += len(group)
            if len(group) > 1:
                # a TXN frame replays as ONE engine lock window — the
                # same atomic unit it was on disk and at commit time
                n = len(group)
                prepared = []
                for rev, etype, key, expiry, wire in group:
                    raw = _json.dumps(wire).encode()
                    obj_rev = int((wire.get("metadata") or {})
                                  .get("resourceVersion") or rev)
                    prepared.append((rev, etype_code[etype], key.encode(),
                                     raw, obj_rev, float(expiry or 0)))
                revs = (ctypes.c_uint64 * n)(*[p[0] for p in prepared])
                types = (ctypes.c_uint8 * n)(*[p[1] for p in prepared])
                keys = (ctypes.c_char_p * n)(*[p[2] for p in prepared])
                vals = (ctypes.c_char_p * n)(*[p[3] for p in prepared])
                val_lens = (ctypes.c_uint64 * n)(
                    *[len(p[3]) for p in prepared])
                obj_revs = (ctypes.c_uint64 * n)(
                    *[p[4] for p in prepared])
                expiries = (ctypes.c_double * n)(
                    *[p[5] for p in prepared])
                last = group[-1][0]
                if lib.kv_replay_txn(st._h, n, revs, types, keys, vals,
                                     val_lens, obj_revs,
                                     expiries) != last:
                    raise WalError(
                        f"txn replay of revisions "
                        f"{group[0][0]}..{last} rejected "
                        f"(engine at {st.current_revision})")
                continue
            for rev, etype, key, expiry, wire in group:
                raw = _json.dumps(wire).encode()
                obj_rev = int((wire.get("metadata") or {})
                              .get("resourceVersion") or rev)
                if lib.kv_replay(st._h, rev, etype_code[etype],
                                 key.encode(), raw, len(raw), obj_rev,
                                 float(expiry or 0)) != rev:
                    raise WalError(f"replay of revision {rev} rejected "
                                   f"(engine at {st.current_revision})")
        global_metrics.inc("wal_recoveries_total")
        st.recovery_stats = {
            "snapshot_rev": snap["rev"] if snap is not None else 0,
            "replayed_records": n_records,
            "recovered_revision": st.current_revision,
            "seconds": round(_time.monotonic() - t0, 6),
        }
        return st

    def create(self, key: str, obj: Any, ttl: Optional[float] = None) -> Any:
        if self._wal_on:
            with self._window:
                for _ in range(16):
                    rev = self.current_revision + 1
                    expiry = (_time.time() + ttl) if ttl else None
                    stamped = self._stamp(obj, rev)
                    wire = self.scheme.encode_dict(stamped)
                    val = _json.dumps(wire).encode()
                    r = self._kv_commit(
                        rev, [(0, key, val, 0, expiry)],
                        [record_payload(rev, watchpkg.ADDED, key, expiry,
                                        wire)])
                    if r == ERR_RACED:
                        continue
                    if r == ERR_EXISTS:
                        kind, name = self._key_name(key)
                        raise AlreadyExists(kind=kind, name=name)
                    self._cache_put(key, rev, stamped)
                    return stamped
                raise Conflict(f"create {key}: revision window kept racing")
        raw = self._encode(obj)
        with self._window:
            rev = self._lib.kv_create(self._h, key.encode(), raw, len(raw),
                                      float(ttl or 0))
        if rev == ERR_EXISTS:
            kind, name = self._key_name(key)
            raise AlreadyExists(kind=kind, name=name)
        out = self._stamp(obj, rev)
        self._cache_put(key, rev, out)
        return out

    def create_batch(self, entries: List[Tuple[str, Any, Optional[float]]],
                     owned_meta: bool = False) -> List[Any]:
        """Batched create in ONE engine pass (kv_create_batch):
        all-or-nothing exactly like the in-memory Store.create_batch —
        any pre-existing or intra-batch duplicate key fails the whole
        batch before anything commits — with one lock window and
        consecutive revisions C-side. owned_meta as in
        Store.create_batch: stamp the fresh caller-owned metadata in
        place instead of a replace-clone pair per object."""
        if not entries:
            return []
        if self._wal_on:
            return self._create_batch_walled(entries, owned_meta)
        encoded = [(k, self._encode(o), ttl) for k, o, ttl in entries]
        n = len(encoded)
        keys = (ctypes.c_char_p * n)(*[k.encode() for k, _v, _t in encoded])
        vals = (ctypes.c_char_p * n)(*[v for _k, v, _t in encoded])
        val_lens = (ctypes.c_uint64 * n)(
            *[len(v) for _k, v, _t in encoded])
        ttls = (ctypes.c_double * n)(
            *[float(t or 0) for _k, _v, t in encoded])
        with self._window:
            first = self._lib.kv_create_batch(self._h, n, keys, vals,
                                              val_lens, ttls)
        if first == ERR_EXISTS:
            # re-raise with the precise key for the caller's message
            for k, _v, _t in encoded:
                try:
                    self._get_raw(k)
                except NotFound:
                    continue
                kind, name = self._key_name(k)
                raise AlreadyExists(kind=kind, name=name)
            kind, name = self._key_name(encoded[0][0])
            raise AlreadyExists(kind=kind, name=name)
        out = []
        for i, (key, obj, _ttl) in enumerate(entries):
            if owned_meta:
                obj.metadata.resource_version = str(first + i)
                stamped = obj
            else:
                stamped = self._stamp(obj, first + i)
            self._cache_put(key, first + i, stamped)
            out.append(stamped)
        return out

    def _create_batch_walled(self, entries, owned_meta: bool) -> List[Any]:
        """create_batch through the native commit path: one
        kv_commit_txn window, n flat ADDED records journaled — the
        same per-record framing Store.create_batch writes."""
        with self._window:
            for _ in range(10):
                first = self.current_revision + 1
                now = _time.time()
                staged: List[tuple] = []
                payloads: List[bytes] = []
                outs: List[Tuple[str, Any]] = []
                for i, (key, obj, ttl) in enumerate(entries):
                    rev = first + i
                    expiry = (now + ttl) if ttl else None
                    if owned_meta:
                        obj.metadata.resource_version = str(rev)
                        stamped = obj
                    else:
                        stamped = self._stamp(obj, rev)
                    wire = self.scheme.encode_dict(stamped)
                    val = _json.dumps(wire).encode()
                    staged.append((0, key, val, 0, expiry))
                    payloads.append(record_payload(rev, watchpkg.ADDED, key,
                                                   expiry, wire))
                    outs.append((key, stamped))
                r = self._kv_commit(first, staged, payloads)
                if r == ERR_RACED:
                    continue
                if r == ERR_EXISTS:
                    for key, _obj, _ttl in entries:
                        try:
                            self._get_raw(key)
                        except NotFound:
                            continue
                        kind, name = self._key_name(key)
                        raise AlreadyExists(kind=kind, name=name)
                    kind, name = self._key_name(entries[0][0])
                    raise AlreadyExists(kind=kind, name=name)
                out = []
                for i, (key, obj) in enumerate(outs):
                    self._cache_put(key, first + i, obj)
                    out.append(obj)
                return out
            raise Conflict("create_batch: revision window kept racing")

    def set(self, key: str, obj: Any, ttl: Optional[float] = None) -> Any:
        if self._wal_on:
            with self._window:
                for _ in range(16):
                    rev = self.current_revision + 1
                    try:
                        self._get_raw_ex(key)
                        existed = True
                    except NotFound:
                        existed = False
                    expiry = (_time.time() + ttl) if ttl else None
                    stamped = self._stamp(obj, rev)
                    wire = self.scheme.encode_dict(stamped)
                    val = _json.dumps(wire).encode()
                    etype = (watchpkg.MODIFIED if existed
                             else watchpkg.ADDED)
                    r = self._kv_commit(
                        rev, [(1 if existed else 0, key, val, 0, expiry)],
                        [record_payload(rev, etype, key, expiry, wire)])
                    if r in (ERR_RACED, ERR_EXISTS, ERR_NOT_FOUND):
                        continue  # raced, or existence flipped: re-probe
                    self._cache_put(key, rev, stamped)
                    return stamped
                raise Conflict(f"set {key}: revision window kept racing")
        raw = self._encode(obj)
        with self._window:
            rev = self._lib.kv_set(self._h, key.encode(), raw, len(raw),
                                   float(ttl or 0))
        out = self._stamp(obj, rev)
        self._cache_put(key, rev, out)
        return out

    def update(self, key: str, obj: Any) -> Any:
        rv = obj.metadata.resource_version
        expect = int(rv) if rv else 0
        if self._wal_on:
            with self._window:
                for _ in range(16):
                    _old, mod_rev, expiry = self._get_raw_ex(key)
                    rev = self.current_revision + 1
                    stamped = self._stamp(obj, rev)
                    wire = self.scheme.encode_dict(stamped)
                    val = _json.dumps(wire).encode()
                    r = self._kv_commit(
                        rev,
                        # TTL carries over, like kv_update / Store.update
                        [(1, key, val, expect or mod_rev, expiry)],
                        [record_payload(rev, watchpkg.MODIFIED, key,
                                        expiry if expiry else None, wire)])
                    if r == ERR_RACED:
                        continue
                    if r == ERR_CONFLICT:
                        if expect:
                            raise Conflict(f"operation on {key} failed: "
                                           f"object was modified")
                        continue  # raced an unconditional update: re-read
                    if r == ERR_NOT_FOUND:
                        raise NotFound(name=key)
                    self._cache_put(key, rev, stamped)
                    return stamped
                raise Conflict(f"update {key}: revision window kept racing")
        raw = self._encode(obj)
        with self._window:
            rev = self._lib.kv_update(self._h, key.encode(), raw, len(raw),
                                      expect)
        if rev == ERR_NOT_FOUND:
            raise NotFound(name=key)
        if rev == ERR_CONFLICT:
            raise Conflict(
                f"operation on {key} failed: object was modified")
        out = self._stamp(obj, rev)
        self._cache_put(key, rev, out)
        return out

    def guaranteed_update(self, key: str, fn: Callable[[Any], Any],
                          retries: int = 10) -> Any:
        if self._wal_on:
            return self._txn_commit_native([(key, fn)], flat=True)[0]
        for _ in range(retries):
            # read, fn, encode and CAS under one hold of the window, as
            # Store.guaranteed_update holds its lock: a writer that read
            # outside it queued on the lock with a revision already stale
            with self._window:
                raw, mod_rev = self._get_raw(key)
                new_obj = fn(self._decode(raw, mod_rev, key))
                new_raw = self._encode(new_obj)
                rev = self._lib.kv_update(self._h, key.encode(), new_raw,
                                          len(new_raw), mod_rev)
                if rev == ERR_CONFLICT:
                    continue  # raced: re-read and retry (etcd_helper.go:449)
                if rev == ERR_NOT_FOUND:
                    raise NotFound(name=key)
                out = self._stamp(new_obj, rev)
                self._cache_put(key, rev, out)
                return out
        raise Conflict(f"guaranteed_update on {key}: too many retries")

    def delete(self, key: str, expect_rv: Optional[str] = None) -> Any:
        while True:
            raw, mod_rev = self._get_raw(key)
            if expect_rv and int(expect_rv) != mod_rev:
                raise Conflict(f"delete {key}: revision mismatch")
            if self._wal_on:
                wire = _json.loads(raw)
                with self._window:
                    rev = self.current_revision + 1
                    r = self._kv_commit(
                        rev,
                        [(2, key, raw,
                          mod_rev if not expect_rv else int(expect_rv),
                          0.0)],
                        [record_payload(rev, watchpkg.DELETED, key, None,
                                        wire)])
                if r == ERR_RACED:
                    continue
                if r == ERR_NOT_FOUND:
                    raise NotFound(name=key)
                if r == ERR_CONFLICT:
                    if expect_rv:
                        raise Conflict(f"delete {key}: revision mismatch")
                    continue  # raced an unconditional delete: re-read
                return self._decode(raw, mod_rev, key)
            with self._window:
                rev = self._lib.kv_delete(self._h, key.encode(),
                                          mod_rev if not expect_rv
                                          else int(expect_rv))
            if rev == ERR_NOT_FOUND:
                raise NotFound(name=key)
            if rev == ERR_CONFLICT:
                continue  # raced an unconditional delete: re-read
            return self._decode(raw, mod_rev, key)

    def batch(self, ops: Iterable[Tuple[str, Callable[[Any], Any]]]
              ) -> List[Any]:
        ops = list(ops)
        if self._wal_on:
            # journaled stores route the chunked control arm through
            # the commit path too (flat frames, exactly the per-record
            # framing Store.batch journals) — kv_batch has no WAL hook
            return self._txn_commit_native(ops, flat=True)
        for _ in range(10):
            # staging and kv_batch under one hold of the window, as in
            # guaranteed_update
            with self._window:
                staged: List[Tuple[str, Any, bytes, int]] = []
                for key, fn in ops:
                    raw, mod_rev = self._get_raw(key)
                    new_obj = fn(self._decode(raw, mod_rev, key))
                    staged.append((key, new_obj, self._encode(new_obj),
                                   mod_rev))
                n = len(staged)
                keys = (ctypes.c_char_p * n)(
                    *[s[0].encode() for s in staged])
                vals = (ctypes.c_char_p * n)(*[s[2] for s in staged])
                val_lens = (ctypes.c_uint64 * n)(
                    *[len(s[2]) for s in staged])
                expects = (ctypes.c_uint64 * n)(*[s[3] for s in staged])
                first = self._lib.kv_batch(self._h, n, keys, vals, val_lens,
                                           expects)
                if first == ERR_CONFLICT:
                    continue  # some key raced: restage the whole tile
                if first == ERR_NOT_FOUND:
                    raise NotFound(name="batch")
                out = []
                for i, (key, new_obj, _raw, _mr) in enumerate(staged):
                    stamped = self._stamp(new_obj, first + i)
                    self._cache_put(key, first + i, stamped)
                    out.append(stamped)
                return out
        raise Conflict("batch: too many retries")

    def commit_txn(self, ops: Iterable[Tuple[str, Callable[[Any], Any]]]
                   ) -> List[Any]:
        """Multi-key transaction through the native commit path
        (kv_commit_txn): Python pre-assigns the revision window and
        stages the encoded batch; the engine validates the window,
        applies the whole op list under one mutex window with
        consecutive revisions (all-or-nothing CAS), appends the WAL
        TXN frame when journaling, and hands the ordered event batch
        to the native publisher ring — ledger + publish off the GIL."""
        return self._txn_commit_native(list(ops), flat=False)

    # --------------------------------------------------------- reads

    def _get_raw(self, key: str, initial: int = 1 << 16) -> Tuple[bytes, int]:
        size = initial
        while True:
            buf = ctypes.create_string_buffer(size)
            mod_rev = ctypes.c_uint64()
            n = self._lib.kv_get(self._h, key.encode(), buf, size,
                                 ctypes.byref(mod_rev))
            if n == ERR_NOT_FOUND:
                raise NotFound(name=key)
            if n == ERR_TOO_SMALL:
                size *= 4
                continue
            return buf.raw[:n], int(mod_rev.value)

    def _get_raw_ex(self, key: str, initial: int = 1 << 16
                    ) -> Tuple[bytes, int, float]:
        """_get_raw plus the entry's absolute expiry (kv_get_ex), so
        the commit path can carry TTLs over exactly like Store.update."""
        size = initial
        while True:
            buf = ctypes.create_string_buffer(size)
            mod_rev = ctypes.c_uint64()
            expiry = ctypes.c_double()
            n = self._lib.kv_get_ex(self._h, key.encode(), buf, size,
                                    ctypes.byref(mod_rev),
                                    ctypes.byref(expiry))
            if n == ERR_NOT_FOUND:
                raise NotFound(name=key)
            if n == ERR_TOO_SMALL:
                size *= 4
                continue
            return buf.raw[:n], int(mod_rev.value), float(expiry.value)

    def get(self, key: str) -> Any:
        raw, mod_rev = self._get_raw(key)
        return self._decode(raw, mod_rev, key)

    def list(self, prefix: str,
             predicate: Optional[Callable[[Any], bool]] = None
             ) -> Tuple[List[Any], int]:
        size = 1 << 20
        while True:
            buf = ctypes.create_string_buffer(size)
            n = self._lib.kv_list(self._h, prefix.encode(), buf, size)
            hint = _size_hint(n)
            if hint is not None:
                size = hint
                continue
            if n < 0:
                raise RuntimeError(f"kv_list failed: {n}")
            break
        data = buf.raw[:n]
        store_rev, count = struct.unpack_from("<QI", data, 0)
        pos = 12
        items = []
        for _ in range(count):
            (obj_rev,) = struct.unpack_from("<Q", data, pos)
            pos += 8
            (klen,) = struct.unpack_from("<I", data, pos)
            pos += 4 + klen
            k = data[pos - klen:pos].decode()
            (vlen,) = struct.unpack_from("<I", data, pos)
            pos += 4
            items.append(self._decode(data[pos:pos + vlen], obj_rev, k))
            pos += vlen
        if predicate is not None:
            items = [o for o in items if predicate(o)]
        items.sort(key=lambda o: (o.metadata.namespace, o.metadata.name))
        return items, int(store_rev)

    # --------------------------------------------------------- watch

    def _events_since(self, since_rev: int, prefix: str
                      ) -> List[Tuple[int, str, str, Any]]:
        size = 1 << 20
        while True:
            buf = ctypes.create_string_buffer(size)
            n = self._lib.kv_events(self._h, since_rev, prefix.encode(),
                                    buf, size)
            if n == ERR_EXPIRED:
                raise Expired(
                    f"resourceVersion {since_rev} is too old")
            hint = _size_hint(n)
            if hint is not None:
                size = hint
                continue
            if n < 0:
                raise RuntimeError(f"kv_events failed: {n}")
            break
        data = buf.raw[:n]
        (count,) = struct.unpack_from("<I", data, 0)
        pos = 4
        out = []
        for _ in range(count):
            (rev,) = struct.unpack_from("<Q", data, pos)
            pos += 8
            etype = _EVENT_TYPES[data[pos]]
            pos += 1
            (klen,) = struct.unpack_from("<I", data, pos)
            pos += 4 + klen
            k = data[pos - klen:pos].decode()
            (obj_rev,) = struct.unpack_from("<Q", data, pos)
            pos += 8
            (vlen,) = struct.unpack_from("<I", data, pos)
            pos += 4
            out.append((rev, etype, k,
                        self._decode(data[pos:pos + vlen], obj_rev, k)))
            pos += vlen
        return out

    def watch(self, prefix: str, since_rev: Optional[int] = None,
              capacity: int = 100_000,
              predicate=None,
              shard: Optional["_NativeShard"] = None) -> watchpkg.Watcher:
        if shard is not None:
            return self._watch_on_shard(prefix, since_rev, capacity,
                                        predicate, shard)
        start_rev = (self.current_revision if since_rev is None
                     else since_rev)
        # Membership snapshot for the filter seed, taken BEFORE the
        # replay read: any write landing between the two shows up in
        # replay (or the pump), so its key is excluded from the seed and
        # tracked from its events instead — never seeded stale.
        snapshot = (self.list(prefix)[0] if predicate is not None else [])
        replay = self._events_since(start_rev, prefix)  # raises Expired
        w = watchpkg.Watcher(max(capacity, len(replay) + 16))

        # Filtered-watch transition semantics (Store._filtered_event's
        # contract) without prev objects on the wire: track each key's
        # last predicate result — entering the selector surfaces as
        # ADDED, leaving it as DELETED with the current object. Keys
        # untouched by the replay are seeded exactly from the snapshot
        # (their objects haven't changed since start_rev); keys first
        # seen mid-stream with no seed resolve conservatively: a
        # leave-event delivers DELETED (suppressing it would strand
        # stale cache entries) and a matching MODIFIED delivers ADDED —
        # both are the duplicate-tolerant direction for reflectors, the
        # same bias the reference's watch cache has when it replays its
        # window as init ADDED events (pkg/storage/cacher.go).
        known: dict = {}
        if predicate is not None:
            touched = {(o.metadata.namespace, o.metadata.name)
                       for _rev, _etype, _k, o in replay}
            for obj in snapshot:
                k = (obj.metadata.namespace, obj.metadata.name)
                if k not in touched:
                    known[k] = predicate(obj)

        def mapped(etype: str, obj) -> Optional[watchpkg.Event]:
            if predicate is None:
                return watchpkg.Event(etype, obj)
            key = (obj.metadata.namespace, obj.metadata.name)
            was = known.get(key)          # True / False / None (unknown)
            if etype == watchpkg.DELETED:
                known.pop(key, None)
                return None if was is False else watchpkg.Event(etype, obj)
            match_new = predicate(obj)
            known[key] = match_new
            if match_new:
                if was is True and etype != watchpkg.ADDED:
                    return watchpkg.Event(watchpkg.MODIFIED, obj)
                return watchpkg.Event(watchpkg.ADDED, obj)
            if was is False:
                return None
            if was is None and etype == watchpkg.ADDED:
                return None               # created non-matching: never seen
            return watchpkg.Event(watchpkg.DELETED, obj)

        last = start_rev
        for rev, etype, _k, obj in replay:
            ev = mapped(etype, obj)
            if ev is not None:
                w.send(ev)
            last = rev

        def pump(last_rev: int) -> None:
            while not w.stopped:
                # kv_wait parks in native code (GIL released) and returns
                # the watch-visible revision
                seen = int(self._lib.kv_wait(self._h, last_rev, 0.5))
                if w.stopped or self._closed:
                    return
                try:
                    events = self._events_since(last_rev, prefix)
                except Expired:
                    w.fail(Expired("watch window overrun"))
                    return
                for rev, etype, _k, obj in events:
                    ev = mapped(etype, obj)
                    if ev is not None and not w.send(ev):
                        w.fail(Expired(
                            f"watch delivery queue overrun (capacity "
                            f"{w.capacity}); re-list and re-watch"))
                        return
                    last_rev = rev
                # every revision up to `seen` was in the history read
                # above, so the cursor moves past it even when none of
                # them fell under this prefix: a cursor left behind
                # makes kv_wait return at once and the pump spin,
                # holding the GIL for every poll, while the store's
                # writes go to other prefixes
                last_rev = max(last_rev, seen)

        t = threading.Thread(target=pump, args=(last,), daemon=True,
                             name="native-store-watch")
        t.start()
        self._watch_threads.append(t)
        self._watchers.append(w)
        return w

    # --------------------------------------------- worker fan-out shards

    def _build_filter(self, prefix: str, predicate):
        """Per-watcher event filter for shard delivery: the same
        filtered-watch transition closure the dedicated-pump path
        builds, seeded from a membership snapshot. Returns
        mapped(etype, obj) -> Optional[Event]. Caller must hold the
        shard lock from before the snapshot until the watcher is
        registered (the closure's `known` dict is pump-thread-only
        after that)."""
        if predicate is None:
            return lambda etype, obj: watchpkg.Event(etype, obj)
        known: dict = {}
        for obj in self.list(prefix)[0]:
            known[(obj.metadata.namespace, obj.metadata.name)] = \
                predicate(obj)

        def mapped(etype: str, obj):
            key = (obj.metadata.namespace, obj.metadata.name)
            was = known.get(key)
            if etype == watchpkg.DELETED:
                known.pop(key, None)
                return None if was is False else watchpkg.Event(etype, obj)
            match_new = predicate(obj)
            known[key] = match_new
            if match_new:
                if was is True and etype != watchpkg.ADDED:
                    return watchpkg.Event(watchpkg.MODIFIED, obj)
                return watchpkg.Event(watchpkg.ADDED, obj)
            if was is False:
                return None
            if was is None and etype == watchpkg.ADDED:
                return None
            return watchpkg.Event(watchpkg.DELETED, obj)

        return mapped

    def _watch_on_shard(self, prefix: str, since_rev: Optional[int],
                        capacity: int, predicate,
                        shard: "_NativeShard") -> watchpkg.Watcher:
        """Register a watcher on a worker shard. Under the shard lock
        its cursor is frozen (the pump advances it only while holding
        the lock), so replay-up-to-cursor + floor = max(since, cursor)
        is exactly-once across the replay->live handoff: events at
        rev <= cursor come from history now, events above arrive on
        the shard pump. Predicate watchers are duplicate-tolerant in
        one direction: a key committed after the membership snapshot
        but before the cursor advances may surface once in the seed
        AND once as a live ADDED (reflector-safe; the reference's
        watch cache has the same bias replaying its window as init
        ADDED events)."""
        with shard.lock:
            cursor = shard.cursor_rev
            start_rev = cursor if since_rev is None else since_rev
            mapped = self._build_filter(prefix, predicate)
            replay = [e for e in self._events_since(start_rev, prefix)
                      if e[0] <= cursor]           # raises Expired
            w = watchpkg.Watcher(max(capacity, len(replay) + 16))
            for _rev, etype, _k, obj in replay:
                ev = mapped(etype, obj)
                if ev is not None:
                    w.send(ev)
            floor = max(start_rev, cursor)
            shard.watchers.append((prefix, mapped, w, floor))
        return w

    def attach_fanout_shard(self, name: str = "") -> "_NativeShard":
        """Create a worker delivery shard (one pump thread fanning the
        native event log out to that worker's watchers). Caller starts
        it (shard.start()) and must stop() it on teardown; close()
        sweeps stragglers."""
        sh = _NativeShard(self, name or f"shard-{len(self._shards)}")
        with self._shards_lock:
            self._shards = self._shards + [sh]
        return sh

    def detach_fanout_shard(self, shard: "_NativeShard") -> None:
        with self._shards_lock:
            self._shards = [s for s in self._shards if s is not shard]
        shard.detached = True

    def fanout_shards(self) -> List["_NativeShard"]:
        return list(self._shards)


class _NativeShard:
    """One apiserver worker's delivery partition over the native event
    log: a cursor revision plus the watchers registered through that
    worker, drained by ONE pump thread parked in kv_wait. Where the
    dedicated-pump watch() path spends a thread per watcher, a shard
    spends one thread per WORKER — the shape the 10k-watcher plane
    needs — at the cost of serializing that worker's fan-out (which is
    the point: delivery parallelism comes from adding workers).

    Lock contract: `lock` freezes (cursor_rev, watchers) for
    registration; the pump holds it across consume+fanout of a batch,
    so a watcher registering mid-batch either replays those events
    from history (cursor not yet advanced) or receives them live
    (already in the watcher list) — never both, never neither."""

    def __init__(self, store: "NativeStore", name: str):
        self._store = store
        self.name = name
        self.lock = threading.Lock()
        self.cursor_rev = store.current_revision
        # entries: (prefix, mapped, watcher, floor_rev)
        self.watchers: List[tuple] = []
        self.delivered_events = 0
        self.delivered_batches = 0
        self.detached = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def pending(self) -> int:
        return max(0, self._store.current_revision - self.cursor_rev)

    def drain(self) -> int:
        """Advance the cursor over newly-committed events and fan them
        out to this shard's watchers (prefix + floor + filter closure
        per watcher). Returns the number of events delivered. A
        watcher that can't absorb the batch takes the 410 path
        (Watcher.fail) and is dropped; a window overrun fails the
        whole shard's watchers the same way and jumps the cursor to
        head (everything between is unrecoverable from the log)."""
        delivered = 0
        with self.lock:
            try:
                events = self._store._events_since(self.cursor_rev, "")
            except Expired:
                for _p, _m, w, _f in self.watchers:
                    w.fail(Expired(
                        "watch window overrun; re-list and re-watch"))
                self.watchers = []
                self.cursor_rev = self._store.current_revision
                return 0
            if not events:
                return 0
            self.cursor_rev = events[-1][0]
            alive = []
            for prefix, mapped, w, floor in self.watchers:
                if w.stopped:
                    continue
                ok = True
                for rev, etype, key, obj in events:
                    if rev <= floor or not key.startswith(prefix):
                        continue
                    ev = mapped(etype, obj)
                    if ev is None:
                        continue
                    if not w.send(ev):
                        w.fail(Expired(
                            f"watch delivery queue overrun (capacity "
                            f"{w.capacity}); re-list and re-watch"))
                        ok = False
                        break
                    delivered += 1
                if ok:
                    alive.append((prefix, mapped, w, floor))
            self.watchers = alive
            self.delivered_batches += 1
            self.delivered_events += delivered
        return delivered

    def start(self) -> "_NativeShard":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"native-fanout-{self.name}")
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            # parks in native code (GIL released); kv_shutdown breaks it
            self._store._lib.kv_wait(
                self._store._h, self.cursor_rev, 0.5)
            if self._stop.is_set() or self._store._closed:
                return
            self.drain()

    def stop(self, timeout: float = 5.0) -> None:
        """Join the pump, 410 any still-registered watchers (a worker
        going away mid-stream must be visible — clients re-list
        against a surviving worker), detach from the store."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            self._thread = None
        with self.lock:
            for _p, _m, w, _f in self.watchers:
                w.fail(Expired(
                    "apiserver worker shutting down; "
                    "re-list and re-watch"))
            self.watchers = []
        self._store.detach_fanout_shard(self)
