"""Revisioned KV store with CAS and windowed watch — the cluster's etcd.

Reference mapping:
  - storage.Interface (pkg/storage/interfaces.go:74): Create / Set / Delete /
    Get / List / GuaranteedUpdate / Watch / WatchList — all here.
  - etcd CAS semantics (pkg/storage/etcd/etcd_helper.go:449 GuaranteedUpdate):
    optimistic-concurrency via resourceVersion; `guaranteed_update` retries
    the caller's update function on conflict.
  - watch cache (pkg/storage/cacher.go:109): a sliding in-memory window of
    (revision, event) so watchers can resume from any recent resourceVersion
    without replaying from scratch; too-old versions raise Expired (the
    HTTP layer maps this to 410 Gone, prompting a client re-list).

Being in-process (etcd is an external process in the reference), storage and
watch cache collapse into one component. Concurrency contract: stored objects
are logically FROZEN — readers get the stored object without copying
(list/watch fan-out to thousands of agents must not deep-copy per reader);
writers hand ownership of the written object to the store and must not mutate
it afterwards. Updates build new objects (dataclasses.replace or codec
round-trip), never mutate in place. This is the same contract Go client
caches impose informally.

A single global revision counter doubles as resourceVersion (stringified),
exactly like etcd's modifiedIndex in the reference.

Every commit runs in three phases (the decomposition the 5k-node profile
demanded — roughly half of each ledger-lock hold was watch fan-out, and
three committers serialize on this lock at full load):

  stage   — object construction and conflict checks; as much as the verb's
            semantics allow runs before the lock (the registry's
            _prepare_create does the heavy cloning outside it entirely)
  ledger  — revision bump + _data/_seg_keys/history/list-cache mutation;
            the ONLY phase that holds self._lock
  publish — predicate mapping (_filtered_event) + Watcher.send/send_many,
            run by the ordered publisher AFTER the ledger lock is released

The publisher is a FIFO of committed batches fed under the ledger lock (so
queue order IS revision order) and drained under a dedicated _pub_lock by
whichever committer gets there first: watchers observe events in strict
revision order no matter which thread fans them out. A watcher registering
mid-flight replays the history window only up to the last PUBLISHED
revision and carries a per-watcher floor for live delivery, so the
replay->live handoff has no duplicates and no gaps (see watch()).

Fleet serving (the multi-consumer ring): the publish queue is a RING of
sequence-numbered batches that more than one delivery shard may consume.
The default shard (shard 0) is the classic committer-drained path above —
its lock IS _pub_lock, its high-water mark IS _published_rev, byte-for-byte
the old behavior when no worker shards exist. `attach_fanout_shard()` adds
an independent consumer: its own watcher partition, its own delivery
cursor over the ring, its own pump thread — so N apiserver workers fan out
in parallel instead of queuing behind one publisher. A batch is retained
until EVERY shard's cursor passes it (trim at min-cursor); per-shard
registration freezes that shard's published_rev under its shard lock, so
the exactly-once replay->live handoff holds per worker.
"""

from __future__ import annotations

import fnmatch
import heapq
import threading
from collections import OrderedDict, deque
from dataclasses import replace
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from .. import obs
from ..utils.clock import REAL, Clock
from ..utils.metrics import (FANOUT_QUEUE_DEPTH_GAUGE, WATCH_LAG_HISTOGRAM,
                             MetricsRegistry, global_metrics)
from . import watch as watchpkg
from .errors import AlreadyExists, Conflict, Expired, NotFound
from .types import fast_replace


def _with_rv(obj: Any, rev: int) -> Any:
    meta = fast_replace(obj.metadata, resource_version=str(rev))
    return fast_replace(obj, metadata=meta)


class _DrainOverlap:
    """Witness of concurrent ring drains. On a 1-core box the 1->N
    worker wall-clock win can vanish under the GIL while the
    architecture is still correct; this counts how often two or more
    shards were mid-fanout at once, which is the gate the fan-out
    bench falls back to (PROFILE-style honesty)."""

    __slots__ = ("_mu", "_active", "max_concurrent", "entries",
                 "overlapped")

    def __init__(self):
        self._mu = threading.Lock()
        self._active = 0
        self.max_concurrent = 0
        self.entries = 0        # batches drained, all shards
        self.overlapped = 0     # drains entered while another ran

    def enter(self) -> None:
        with self._mu:
            self._active += 1
            self.entries += 1
            if self._active > 1:
                self.overlapped += 1
            if self._active > self.max_concurrent:
                self.max_concurrent = self._active

    def exit(self) -> None:
        with self._mu:
            self._active -= 1

    def snapshot(self) -> dict:
        with self._mu:
            return {"entries": self.entries,
                    "overlapped": self.overlapped,
                    "max_concurrent": self.max_concurrent,
                    "overlap_frac": (round(self.overlapped
                                           / self.entries, 4)
                                     if self.entries else 0.0)}


class FanoutShard:
    """One delivery partition of the store's publish ring.

    A shard owns a slice of the watcher population, a cursor over the
    shared ring, and (once start()ed) the pump thread that drains it —
    the unit an apiserver worker holds so N workers deliver watch
    events in parallel instead of queuing behind one publisher
    (reference: one cacher per apiserver process over one etcd,
    pkg/storage/cacher.go; ours shares one ledger in-proc).

    Locking: `lock` freezes this shard's (cursor, published_rev,
    watchers) — registration takes it, then the ledger lock, mirroring
    Store._watch_register's publish->ledger order. The pump holds it
    across consuming ONE ring entry and fans out under it, so delivery
    order per shard is revision order and a mid-flight registration's
    floor filters exactly the batches it already replayed."""

    def __init__(self, store: "Store", name: str):
        self._store = store
        self.name = name
        self.lock = threading.Lock()
        self.watchers: List[Tuple[str, Optional[Callable[[Any], bool]],
                                  "watchpkg.Watcher", int]] = []
        self.published_rev = 0   # set at attach, under the ledger lock
        self.cursor = 0          # next ring seq this shard consumes
        self.wake = threading.Event()
        self.delivered_batches = 0
        self.delivered_events = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.detached = False

    # ------------------------------------------------------- delivery

    def drain(self, max_batches: Optional[int] = None) -> int:
        """Consume ring entries at this shard's cursor; returns batches
        delivered. Runs on the pump thread (or inline from tests)."""
        store = self._store
        n = 0
        while max_batches is None or n < max_batches:
            with self.lock:
                entry = store._ring_next(self.cursor)
                if entry is None:
                    break
                seq, t_enq, items = entry
                # pending depth BEFORE consuming this entry: the
                # backlog a stalled worker shows on dashboards
                store._metrics.set_gauge(
                    FANOUT_QUEUE_DEPTH_GAUGE,
                    float(store._pub_seq - self.cursor),
                    {"shard": self.name})
                store._metrics.observe(
                    WATCH_LAG_HISTOGRAM,
                    store._clock.monotonic() - t_enq,
                    {"shard": self.name})
                store._drain_overlap.enter()
                try:
                    store._fanout(items, self.watchers)
                finally:
                    store._drain_overlap.exit()
                self.published_rev = items[-1][0]
                self.cursor = seq + 1
                self.delivered_batches += 1
                self.delivered_events += len(items)
            n += 1
        if n:
            store._ring_trim()
        return n

    def pending(self) -> int:
        """Ring batches staged but not yet delivered by this shard."""
        return max(0, self._store._pub_seq - self.cursor)

    # ------------------------------------------------------ lifecycle

    def start(self) -> "FanoutShard":
        if self._thread is not None:
            return self
        self._stop.clear()

        def pump() -> None:
            while not self._stop.is_set():
                self.wake.wait(0.2)
                self.wake.clear()   # before drain: a set during the
                self.drain()        # drain forces one more pass
            self.drain()            # deliver anything staged pre-stop

        self._thread = threading.Thread(
            target=pump, daemon=True, name=f"fanout-{self.name}")
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Join the pump, fail remaining watchers (they must re-list —
        their worker is gone), and detach from the ring so a dead
        cursor can't pin retention."""
        self._stop.set()
        self.wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            self._thread = None
        with self.lock:
            doomed = self.watchers
            self.watchers = []
        for _prefix, _pred, w, _floor in doomed:
            if not w.stopped:
                w.fail(Expired("apiserver worker shutting down; "
                               "re-list and re-watch"))
        self._store.detach_fanout_shard(self)


class Store:
    def __init__(self, window: int = 100_000, publish_inline: bool = False,
                 wal_dir: Optional[str] = None,
                 fsync_policy: str = "batch",
                 wal_segment_records: int = 10_000,
                 wal_snapshot_records: int = 50_000,
                 clock: Optional[Clock] = None,
                 metrics: Optional[MetricsRegistry] = None):
        # TTL deadlines are wall-clock (they stamp API objects and ride
        # the WAL as absolute expiries); the clock is injectable so
        # expiry behavior is testable without sleeping and so the lint
        # determinism rule has a sanctioned time source to point at
        self._clock = clock or REAL
        # the LEDGER lock: guards _rev/_data/_seg_keys/_history/list
        # caches — and nothing else. Watch fan-out runs outside it.
        self._lock = threading.RLock()
        self._rev = 0
        # key -> (object, mod_rev, expiry_ts|None); insertion-ordered so list
        # output is stable (etcd returns key order; we sort on list anyway).
        self._data: Dict[str, Tuple[Any, int, Optional[float]]] = {}
        # sliding watch window: deque of (rev, event_type, key, obj, prev_obj)
        self._history: deque = deque(maxlen=window)
        self._oldest_rev = 0  # smallest rev still replayable + its predecessor
        # (prefix, server-side predicate | None, watcher, floor): floor
        # is the registration-time delivery cutoff — the publisher skips
        # events with rev <= floor (they were replayed from history, or
        # predate a from-now watch). Guarded by _pub_lock, NOT the
        # ledger lock: only the publish phase touches watchers.
        self._watchers: List[Tuple[str, Optional[Callable[[Any], bool]],
                                   "watchpkg.Watcher", int]] = []
        # publish pipeline: a multi-consumer RING of (seq,
        # enqueue_monotonic, batch) triples — batches of (rev, key,
        # event, prev) — appended under the ledger lock (FIFO order =
        # revision order, seq contiguous) and consumed per delivery
        # shard: shard 0 is drained by committers under _pub_lock
        # exactly as before; worker shards (attach_fanout_shard) drain
        # on their own pump threads at their own cursors. An entry is
        # retained until every cursor has passed it. The enqueue stamp
        # feeds the watch publish->deliver lag histogram: how long a
        # committed event sat queued before watcher fan-out began.
        self._pub_queue: deque = deque()
        self._pub_lock = threading.Lock()
        # leaf lock guarding ring mutation vs cursor-indexed reads
        # (append runs under the ledger lock, trim/reads run under a
        # shard lock; neither store lock is ever taken under it)
        self._ring_lock = threading.Lock()
        self._pub_seq = 0      # next ring sequence number to assign
        self._pub_cursor = 0   # shard 0's cursor (next seq to consume)
        # worker delivery shards (copy-on-write list: _stage_publish
        # iterates it without a lock to wake pumps)
        self._shards: List["FanoutShard"] = []
        self._shards_lock = threading.Lock()
        # multi-consumer overlap witness: how parallel delivery
        # actually ran (the honest readout a 1-core box gates on when
        # wall-clock scaling can't show)
        self._drain_overlap = _DrainOverlap()
        self._metrics = metrics or global_metrics
        # highest revision whose events have been handed to watchers;
        # watch() replays history only up to here (the rest arrives live)
        self._published_rev = 0
        # A/B switch (bench.py --store-ab): publish while still holding
        # the ledger lock — the pre-split serialization, kept so the
        # two-phase win stays measurable end-to-end
        self._publish_inline = publish_inline
        # min-heap of (expiry, key) for TTL'd entries only, so GC cost is
        # O(expired) per write instead of a full-store scan (only events
        # carry TTLs; pods/nodes must not pay for them)
        self._expiry_heap: List[Tuple[float, str]] = []
        # list-snapshot cache (the watch cache's LIST half,
        # cacher.go:214): selector-free list() scans EVERY store entry
        # and re-sorts per call — a 5k-node LIST against a 35k-entry
        # store was most of that endpoint's warm latency. Cached sorted
        # snapshots are invalidated per write via a resource-segment
        # bucket (O(1) per write, no prefix scan).
        self._list_cache: Dict[str, List[Any]] = {}
        self._list_cache_seg: Dict[str, set] = {}
        # per-cached-prefix key -> position map: a MODIFIED write (same
        # key set, same (ns, name) sort order) PATCHES the snapshot
        # element in place instead of dropping the whole snapshot — a
        # 5k-node heartbeat sweep otherwise forces every subsequent
        # LIST into a full bucket re-scan + re-sort for a minute
        # (DENSITY.json 5000x30's GET-nodes tail)
        self._list_cache_idx: Dict[str, Dict[str, int]] = {}
        # resources that ever stored a TTL'd entry (events): their
        # lists are never cached — expiry is passive, so a snapshot
        # could serve an expired object with no write to invalidate it
        self._ttl_segs: set = set()
        # per-segment key index: list(prefix) iterates ONE resource's
        # keys instead of scanning the whole store — at north-star
        # density a nodes LIST would otherwise walk 150k pod keys per
        # call (DENSITY.json 5000x30's GET-nodes whale). dict used as
        # an ordered set; maintained at every key add/remove under the
        # store lock.
        self._seg_keys: Dict[str, Dict[str, None]] = {}
        # per-segment write counter: a LIST response is reusable
        # verbatim while its resource segment has seen no writes, even
        # as OTHER resources advance the global revision (the apiserver
        # keys whole-response byte caches on this; serving the older
        # embedded resourceVersion stays sound because no events exist
        # for this segment between the two revisions)
        self._seg_writes: Dict[str, int] = {}
        # durability (opt-in): a segmented, checksummed write-ahead log
        # hooked at the ledger stage — one record per committed
        # revision, appended under the ledger lock so append order IS
        # revision order (core/wal.py; recovery is Store.recover).
        # wal_dir=None keeps every hot path byte-identical to before.
        self._wal = None
        self._wal_scheme = None
        if wal_dir is not None:
            import os
            from .wal import WalError, WalWriter, _segments, _snapshots
            if os.path.isdir(wal_dir) and (_segments(wal_dir)
                                           or _snapshots(wal_dir)):
                raise WalError(
                    f"{wal_dir} already holds a WAL — a fresh Store "
                    f"would fork its history; use Store.recover()")
            self._wal = WalWriter(wal_dir, fsync_policy=fsync_policy,
                                  segment_records=wal_segment_records,
                                  snapshot_records=wal_snapshot_records)
            from .scheme import default_scheme
            self._wal_scheme = default_scheme

    # ------------------------------------------------------------- helpers

    @property
    def current_revision(self) -> int:
        # lock-free: a single int read is atomic under the GIL, and any
        # torn ordering a caller could observe is indistinguishable from
        # sampling a moment earlier — revision reads must not queue
        # behind a committer's ledger window
        return self._rev

    def _bump(self) -> int:
        self._rev += 1
        return self._rev

    def _expired(self, entry, now: float) -> bool:
        return entry[2] is not None and entry[2] <= now

    @staticmethod
    def _seg(key: str) -> str:
        """'/registry/<resource>/' segment of a key — the invalidation
        bucket for cached list snapshots."""
        i = key.find("/", 10)  # first slash after "/registry/"
        return key[:i + 1] if i > 0 else key

    def _index_add(self, key: str) -> None:
        self._seg_keys.setdefault(self._seg(key), {})[key] = None

    def _index_del(self, key: str) -> None:
        seg = self._seg_keys.get(self._seg(key))
        if seg is not None:
            seg.pop(key, None)

    def _invalidate_lists(self, key: str) -> None:
        """Drop cached list snapshots for the written key's resource
        (caller holds the lock)."""
        if not self._list_cache:
            return
        for p in self._list_cache_seg.pop(self._seg(key), ()):
            self._list_cache.pop(p, None)
            self._list_cache_idx.pop(p, None)

    def _patch_lists(self, key: str, obj: Any) -> None:
        """A value-only write (MODIFIED: key set and sort order
        unchanged) swaps the object into any cached snapshot covering
        it; snapshots that predate the key fall back to invalidation.
        Safe against outstanding readers: list() hands out COPIES, so
        an in-place element swap never mutates a caller's list."""
        if not self._list_cache:
            return
        seg = self._seg(key)
        prefixes = self._list_cache_seg.get(seg)
        if not prefixes:
            return
        drop = []
        for p in prefixes:
            if not key.startswith(p):
                continue
            pos = self._list_cache_idx.get(p, {}).get(key)
            if pos is None:
                drop.append(p)
                continue
            self._list_cache[p][pos] = obj
        for p in drop:
            self._list_cache.pop(p, None)
            self._list_cache_idx.pop(p, None)
            prefixes.discard(p)

    def write_version(self, prefix: str) -> int:
        """Writes ever committed under the prefix's resource segment —
        the validity token for cached LIST response bytes. Lock-free:
        one GIL-atomic dict read, so the apiserver's byte-cache hit
        path (the DENSITY GET-/nodes whale) never queues behind a
        committer. A racing write can only make the read conservative
        (the caller rebuilds a response it could have reused)."""
        return self._seg_writes.get(self._seg(prefix), 0)

    def watch_floor(self) -> int:
        """Smallest resourceVersion a watch can still start from without
        410 Expired. Cached LIST bytes embedding an older rev must be
        rebuilt, or a write-quiet resource's list->watch loop livelocks
        once busier segments roll the shared history window past it.
        Lock-free for the same reason as write_version: the int only
        grows, so a stale read is again the conservative direction."""
        return self._oldest_rev

    def _record(self, rev: int, etype: str, key: str, obj: Any,
                prev: Any) -> watchpkg.Event:
        """History-window bookkeeping for one committed write."""
        seg = self._seg(key)
        self._seg_writes[seg] = self._seg_writes.get(seg, 0) + 1
        if etype == watchpkg.MODIFIED:
            self._patch_lists(key, obj)
        else:
            self._invalidate_lists(key)
        if len(self._history) == self._history.maxlen:
            self._oldest_rev = self._history[0][0]
        self._history.append((rev, etype, key, obj, prev))
        if self._wal is not None:
            self._wal_append(rev, etype, key, obj)
        return watchpkg.Event(etype, obj)

    def _wal_append(self, rev: int, etype: str, key: str, obj: Any) -> None:
        """Buffer one ledger record (caller holds the ledger lock).
        The entry's absolute expiry rides along so recovery restores
        TTL deadlines instead of resurrecting expired keys; for a
        DELETED record the entry is already gone and expiry is moot."""
        entry = self._data.get(key)
        self._wal.append(rev, etype, key,
                         entry[2] if entry is not None else None,
                         self._wal_scheme.encode_dict(obj))

    def _wal_sync(self) -> None:
        """Flush buffered WAL records for the commit that just ran
        (caller still holds the ledger lock — append order stays
        revision order) and compact when the snapshot interval is due.
        The snapshot runs under the lock too: commits stall for its
        duration, which is the price of a consistent cut."""
        w = self._wal
        if w is None:
            return
        w.commit()
        if w.should_snapshot:
            w.write_snapshot(self._snapshot_state())

    def _snapshot_state(self) -> dict:
        """Full store state for a WAL snapshot (caller holds the ledger
        lock): the live entries plus the bookkeeping recovery must
        rebuild bit-identically — per-segment write counters (the LIST
        byte-cache validity tokens) and the TTL'd-segment set."""
        enc = self._wal_scheme.encode_dict
        return {
            "rev": self._rev,
            "entries": [[k, mod_rev, expiry, enc(obj)]
                        for k, (obj, mod_rev, expiry) in self._data.items()],
            "seg_writes": dict(self._seg_writes),
            "ttl_segs": sorted(self._ttl_segs),
        }

    @staticmethod
    def _filtered_event(ev: watchpkg.Event, prev: Any,
                        pred: Callable[[Any], bool]
                        ) -> Optional[watchpkg.Event]:
        """Map one committed event through a watch predicate with the
        reference's filtered-watch transition semantics
        (pkg/storage/etcd/etcd_watcher.go sendModify): an object
        entering the selector surfaces as ADDED, one leaving it as
        DELETED (carrying the current object), and non-matching events
        are suppressed entirely — the watcher's queue never sees them."""
        if ev.type != watchpkg.MODIFIED:
            return ev if pred(ev.object) else None
        match_new = pred(ev.object)
        match_old = prev is not None and pred(prev)
        if match_new:
            return ev if match_old else watchpkg.Event(watchpkg.ADDED,
                                                       ev.object)
        if match_old:
            return watchpkg.Event(watchpkg.DELETED, ev.object)
        return None

    def _fanout(self, items: List[Tuple[int, str, watchpkg.Event, Any]],
                watchers: Optional[list] = None) -> None:
        """Publish phase: deliver one committed batch to watchers — one
        send per watcher when the batch has more than one event — and
        sweep the dead. Runs under the owning shard's lock (never the
        ledger lock): default shard 0 passes _watchers under _pub_lock,
        a worker FanoutShard passes its own partition under its own
        lock — in both cases that lock's holder is the only
        reader/writer of the list, which is what keeps delivery in
        revision order per shard across committer threads.

        Per-watcher floors: an event with rev <= floor was already
        replayed to that watcher from history at registration time (or
        predates a from-now watch) and must not be delivered again.

        For multi-event batches, items is the OUTER loop: every
        watcher's predicate sees one object back-to-back, so the
        registry's (id, rv)-keyed fields memo hits across watchers
        (three pod watchers used to recompute the fields map 3x per
        event on a 30k-binding tile)."""
        if not items:
            return
        if watchers is None:
            watchers = self._watchers
        dead = []
        if len(items) == 1:
            rev, key, ev, prev = items[0]
            for i, (prefix, pred, w, floor) in enumerate(watchers):
                if w.stopped:
                    dead.append(i)
                    continue
                if rev <= floor or not key.startswith(prefix):
                    continue
                mapped = (ev if pred is None
                          else self._filtered_event(ev, prev, pred))
                if mapped is None:
                    continue
                if not w.send(mapped):
                    w.fail(Expired("watch delivery queue overrun "
                                   f"(capacity {w.capacity}); re-list "
                                   "and re-watch"))
                    dead.append(i)
        else:
            per_w: List[Optional[list]] = [None] * len(watchers)
            for i, (_prefix, _pred, w, _floor) in enumerate(watchers):
                if w.stopped:
                    dead.append(i)
                else:
                    per_w[i] = []
            # a commit batch is almost always one resource segment
            # (a bind tile, a status tile, a create storm): resolve the
            # watcher set ONCE against the shared segment instead of
            # testing every watcher's prefix against every key — the
            # per-(event x watcher) startswith was ~a third of fan-out
            # at 30k-pod tiles
            seg0 = self._seg(items[0][1])
            if all(k.startswith(seg0) for _r, k, _e, _p in items):
                active = [(i, prefix, pred, floor)
                          for i, (prefix, pred, _w, floor)
                          in enumerate(watchers)
                          if per_w[i] is not None
                          and (prefix.startswith(seg0)
                               or seg0.startswith(prefix))]
                for rev, key, ev, prev in items:
                    for i, prefix, pred, floor in active:
                        if rev <= floor:
                            continue
                        if len(prefix) > len(seg0) \
                                and not key.startswith(prefix):
                            continue
                        if pred is None:
                            per_w[i].append(ev)
                        else:
                            mapped = self._filtered_event(ev, prev, pred)
                            if mapped is not None:
                                per_w[i].append(mapped)
            else:
                for rev, key, ev, prev in items:
                    for i, (prefix, pred, _w, floor) in enumerate(watchers):
                        evs = per_w[i]
                        if evs is None or rev <= floor \
                                or not key.startswith(prefix):
                            continue
                        if pred is None:
                            evs.append(ev)
                        else:
                            mapped = self._filtered_event(ev, prev, pred)
                            if mapped is not None:
                                evs.append(mapped)
            for i, (_prefix, _pred, w, _floor) in enumerate(watchers):
                evs = per_w[i]
                if not evs:
                    continue
                ok = (w.send(evs[0]) if len(evs) == 1
                      else w.send_many(evs, owned=True))
                if not ok:
                    # the laggard path: a silent stop() here is
                    # indistinguishable from a clean close, so the
                    # client would never re-list — fail() delivers the
                    # cacher's 410-Gone ERROR past the bound instead
                    w.fail(Expired("watch delivery queue overrun "
                                   f"(capacity {w.capacity}); re-list "
                                   "and re-watch"))
                    dead.append(i)
        # dead may interleave stopped-sweep and failed-send indices:
        # delete in strictly descending order
        for i in sorted(dead, reverse=True):
            del watchers[i]

    def _stage_publish(self, items: List[Tuple[int, str, watchpkg.Event,
                                               Any]]) -> None:
        """Hand one committed batch to the ring (caller holds the
        ledger lock, so append order is revision order) — the caller
        MUST call _drain_publish() after releasing the lock. Worker
        shard pumps are woken here; they drain at their own cursors."""
        if items:
            with self._ring_lock:
                self._pub_queue.append(
                    (self._pub_seq, self._clock.monotonic(), items))
                self._pub_seq += 1
            for sh in self._shards:
                sh.wake.set()

    def _emit(self, rev: int, etype: str, key: str, obj: Any,
              prev: Any) -> None:
        """Ledger bookkeeping + publisher handoff for one write (caller
        holds the ledger lock and drains after releasing it)."""
        self._stage_publish(
            [(rev, key, self._record(rev, etype, key, obj, prev), prev)])

    def _ring_next(self, cursor: int) -> Optional[tuple]:
        """(seq, t_enq, items) at seq == cursor, or None when the ring
        holds nothing at or past it. Seqs are contiguous, so the entry
        sits at a computed offset from the ring head; the ring lock
        pins the head against a concurrent append/trim for the read."""
        with self._ring_lock:
            q = self._pub_queue
            if not q:
                return None
            idx = cursor - q[0][0]
            if idx >= len(q):
                return None
            return q[idx]

    def _ring_trim(self) -> None:
        """Drop ring entries every consumer has passed (min-cursor).
        Cursors only grow, so a racy read of another shard's cursor is
        conservative — an entry lives at most one round longer."""
        with self._ring_lock:
            q = self._pub_queue
            if not q:
                return
            low = self._pub_cursor
            for sh in self._shards:
                if sh.cursor < low:
                    low = sh.cursor
            while q and q[0][0] < low:
                q.popleft()

    def _drain_publish(self) -> None:
        """Publish every staged batch to the DEFAULT shard, in order,
        outside the ledger lock. The non-blocking acquire hands a busy
        publisher the work instead of parking this committer behind
        another thread's fan-out; the outer re-check after release
        closes the stage-after-empty window (a batch staged while the
        previous drainer was exiting is picked up here, never
        stranded). Worker shards consume the same ring on their own
        pump threads — this path neither waits for nor wakes them."""
        while self._pub_seq > self._pub_cursor:
            if not self._pub_lock.acquire(blocking=False):
                return  # the live publisher drains our batch in order
            try:
                while True:
                    entry = self._ring_next(self._pub_cursor)
                    if entry is None:
                        break
                    seq, t_enq, items = entry
                    # publish->deliver lag, observed OUTSIDE the ledger
                    # lock (metrics take their own registry lock; the
                    # histogram dual-lands via the pinned boundaries)
                    self._metrics.observe(
                        WATCH_LAG_HISTOGRAM,
                        self._clock.monotonic() - t_enq)
                    self._drain_overlap.enter()
                    try:
                        self._fanout(items)
                    finally:
                        self._drain_overlap.exit()
                    self._published_rev = items[-1][0]
                    self._pub_cursor = seq + 1
            finally:
                self._pub_lock.release()
            self._ring_trim()

    def _gc_expired(self, now: Optional[float] = None) -> None:
        """Lazily delete TTL-expired entries (reference: etcd event TTL)."""
        if not self._expiry_heap:
            return
        now = self._clock.now() if now is None else now
        while self._expiry_heap and self._expiry_heap[0][0] <= now:
            expiry, k = heapq.heappop(self._expiry_heap)
            entry = self._data.get(k)
            if entry is None or entry[2] != expiry:
                continue  # stale heap entry: key deleted or re-written
            obj, _, _ = self._data.pop(k)
            self._index_del(k)
            self._emit(self._bump(), watchpkg.DELETED, k, obj, obj)

    # ------------------------------------------------------------ writes

    def create(self, key: str, obj: Any, ttl: Optional[float] = None) -> Any:
        # every write verb shares this shape: ledger phase under the
        # lock, then the publish drain in the finally — which also
        # flushes expiry events _gc_expired queued even when the verb
        # itself raises before committing anything
        try:
            with self._lock:
                self._gc_expired()
                if key in self._data:
                    raise AlreadyExists(kind=key.split("/")[2] if key.count("/") >= 2 else "",
                                        name=key.rsplit("/", 1)[-1])
                rev = self._bump()
                obj = _with_rv(obj, rev)
                expiry = self._clock.now() + ttl if ttl else None
                self._data[key] = (obj, rev, expiry)
                self._index_add(key)
                if expiry is not None:
                    heapq.heappush(self._expiry_heap, (expiry, key))
                    self._ttl_segs.add(self._seg(key))
                self._emit(rev, watchpkg.ADDED, key, obj, None)
                self._wal_sync()
                if self._publish_inline:
                    self._drain_publish()
                return obj
        finally:
            self._drain_publish()

    def create_batch(self, entries: List[Tuple[str, Any, Optional[float]]],
                     owned_meta: bool = False) -> List[Any]:
        """Create many keys under ONE lock acquisition with one watch
        fan-out flush — the write-side analogue of batch() (the 30k-pod
        create storm was paying one lock + one per-watcher send per pod;
        ref: GuaranteedUpdate batching rationale, etcd_helper.go:449).
        All-or-nothing: any pre-existing key fails the whole batch
        before anything commits, so callers can retry object-by-object
        to surface the precise conflict.

        owned_meta=True: the caller guarantees every object AND its
        .metadata were freshly allocated for this call and no other
        reference sees them (the registry's _prepare_create contract) —
        the revision is then stamped in place instead of through two
        clone passes per object, which is most of what the create storm
        used to do under the store lock (PROFILE_e2e.md)."""
        tr = obs.tracer()
        t0 = tr.clock.monotonic() if tr.enabled else 0.0
        t1 = None
        try:
            with self._lock:
                self._gc_expired()
                now = self._clock.now()
                seen = set()
                for key, _obj, _ttl in entries:
                    if key in self._data or key in seen:
                        raise AlreadyExists(
                            kind=key.split("/")[2] if key.count("/") >= 2 else "",
                            name=key.rsplit("/", 1)[-1])
                    seen.add(key)
                out = []
                batch_events: List[Tuple[int, str, watchpkg.Event, Any]] = []
                for key, obj, ttl in entries:
                    rev = self._bump()
                    if owned_meta:
                        obj.metadata.resource_version = str(rev)
                    else:
                        obj = _with_rv(obj, rev)
                    expiry = now + ttl if ttl else None
                    self._data[key] = (obj, rev, expiry)
                    self._index_add(key)
                    if expiry is not None:
                        heapq.heappush(self._expiry_heap, (expiry, key))
                        self._ttl_segs.add(self._seg(key))
                    batch_events.append(
                        (rev, key,
                         self._record(rev, watchpkg.ADDED, key, obj, None),
                         None))
                    out.append(obj)
                self._stage_publish(batch_events)
                self._wal_sync()
                if self._publish_inline:
                    self._drain_publish()
            if tr.enabled:
                t1 = tr.clock.monotonic()
        finally:
            self._drain_publish()
            if t1 is not None:
                ctx = obs.current()
                t2 = tr.clock.monotonic()
                tr.record("store.create_batch.ledger", t0, t1, parent=ctx,
                          attrs={"ops": len(out)})
                tr.record("store.create_batch.publish", t1, t2, parent=ctx,
                          stage="publish", attrs={"ops": len(out)})
        return out

    def set(self, key: str, obj: Any, ttl: Optional[float] = None) -> Any:
        """Unconditional write (ref: etcd_helper Set)."""
        try:
            with self._lock:
                self._gc_expired()
                rev = self._bump()
                obj = _with_rv(obj, rev)
                expiry = self._clock.now() + ttl if ttl else None
                prev = self._data.get(key)
                self._data[key] = (obj, rev, expiry)
                if prev is None:
                    self._index_add(key)
                if expiry is not None:
                    heapq.heappush(self._expiry_heap, (expiry, key))
                    self._ttl_segs.add(self._seg(key))
                etype = watchpkg.MODIFIED if prev else watchpkg.ADDED
                self._emit(rev, etype, key, obj, prev[0] if prev else None)
                self._wal_sync()
                if self._publish_inline:
                    self._drain_publish()
                return obj
        finally:
            self._drain_publish()

    def update(self, key: str, obj: Any) -> Any:
        """Conditional write: obj.metadata.resource_version must match the
        stored revision (the optimistic-concurrency check every PUT gets,
        ref: pkg/registry/generic/etcd/etcd.go:270-316)."""
        try:
            with self._lock:
                self._gc_expired()
                entry = self._data.get(key)
                if entry is None:
                    raise NotFound(name=key)
                stored, mod_rev, expiry = entry
                rv = obj.metadata.resource_version
                if rv and int(rv) != mod_rev:
                    raise Conflict(
                        f"operation on {key} failed: object was modified "
                        f"(have {rv}, current {mod_rev})")
                rev = self._bump()
                obj = _with_rv(obj, rev)
                self._data[key] = (obj, rev, expiry)
                self._emit(rev, watchpkg.MODIFIED, key, obj, stored)
                self._wal_sync()
                if self._publish_inline:
                    self._drain_publish()
                return obj
        finally:
            self._drain_publish()

    def guaranteed_update(self, key: str, fn: Callable[[Any], Any],
                          retries: int = 10,
                          ttl: Optional[float] = None) -> Any:
        """Read-modify-write loop with CAS semantics
        (ref: etcd_helper.go:449). `fn` receives the current object and
        returns the new one (never mutate the input). In-process the lock
        makes one pass sufficient, but the retry structure is kept so `fn`
        may be called outside the lock in future remote-store backends.
        ttl, when given, REFRESHES the entry's expiry (the rv-less PUT
        path for TTL'd resources extends the deadline on every write,
        matching the old get+set behavior)."""
        try:
            for _ in range(retries):
                with self._lock:
                    self._gc_expired()
                    entry = self._data.get(key)
                    if entry is None:
                        raise NotFound(name=key)
                    stored, mod_rev, expiry = entry
                    new_obj = fn(stored)
                    if self._data.get(key, (None, -1, None))[1] != mod_rev:
                        continue  # concurrent write between read and write
                    rev = self._bump()
                    new_obj = _with_rv(new_obj, rev)
                    if ttl is not None:
                        expiry = self._clock.now() + ttl
                        heapq.heappush(self._expiry_heap, (expiry, key))
                        self._ttl_segs.add(self._seg(key))
                    self._data[key] = (new_obj, rev, expiry)
                    self._emit(rev, watchpkg.MODIFIED, key, new_obj, stored)
                    self._wal_sync()
                    if self._publish_inline:
                        self._drain_publish()
                    return new_obj
            raise Conflict(f"guaranteed_update on {key}: too many retries")
        finally:
            self._drain_publish()

    def delete(self, key: str, expect_rv: Optional[str] = None) -> Any:
        try:
            with self._lock:
                self._gc_expired()
                entry = self._data.get(key)
                if entry is None:
                    raise NotFound(name=key)
                stored, mod_rev, _ = entry
                if expect_rv and int(expect_rv) != mod_rev:
                    raise Conflict(f"delete {key}: revision mismatch")
                del self._data[key]
                self._index_del(key)
                rev = self._bump()
                self._emit(rev, watchpkg.DELETED, key, stored, stored)
                self._wal_sync()
                if self._publish_inline:
                    self._drain_publish()
                return stored
        finally:
            self._drain_publish()

    def batch(self, ops: Iterable[Tuple[str, Callable[[Any], Any]]]) -> List[Any]:
        """Apply many guaranteed-updates under ONE lock acquisition with one
        revision bump per object. This is the binding-commit fast path the
        north star needs (30k CAS writes in <1s; see SURVEY.md section 7 hard
        part 2): same per-key conflict semantics as guaranteed_update, but the
        scheduler commits a whole tile of bindings per call.

        The body is deliberately flat: every per-op attribute lookup is
        hoisted and the history/list-cache bookkeeping runs batched
        (one segment invalidation, direct deque appends) — at 30k ops
        per drain this loop IS the host-side commit cost
        (PROFILE_e2e.md's bind/status whales)."""
        out = []
        tr = obs.tracer()
        t0 = tr.clock.monotonic() if tr.enabled else 0.0
        t1 = None
        try:
            with self._lock:
                self._gc_expired()
                # Two-phase: run every update function first, then commit.
                # A mid-batch failure therefore commits nothing
                # (all-or-nothing), so the scheduler always knows whether
                # a tile of bindings is durable.
                # Revisions are pre-assigned during staging (we hold the
                # lock, so rev0+1..rev0+n are ours): an update fn marked
                # `wants_rv` receives the final resourceVersion and builds
                # the stamped object in ONE construction pass instead of
                # fn's clone + a second _with_rv clone — the 30k-binding
                # tile pays 4 object clones per pod otherwise.
                rev = self._rev
                staged = []
                stage = staged.append
                data_get = self._data.get
                for key, fn in ops:
                    entry = data_get(key)
                    if entry is None:
                        raise NotFound(name=key)
                    stored, _mod_rev, expiry = entry
                    rev += 1
                    if getattr(fn, "wants_rv", False):
                        new_obj = fn(stored, str(rev))
                    else:
                        new_obj = _with_rv(fn(stored), rev)
                    stage((key, new_obj, stored, expiry, rev))
                batch_events: List[Tuple[int, str, watchpkg.Event,
                                         Any]] = []
                ev_append = batch_events.append
                out_append = out.append
                data = self._data
                hist = self._history
                hist_append = hist.append
                hist_max = hist.maxlen
                seg_of = self._seg
                seg_writes = self._seg_writes
                seg_writes_get = seg_writes.get
                modified = watchpkg.MODIFIED
                event = watchpkg.Event
                for key, new_obj, stored, expiry, rev in staged:
                    data[key] = (new_obj, rev, expiry)
                    # per-RECORD write token (not per batch): WAL replay
                    # rebuilds these counters one record at a time, and
                    # the recovered token must equal the live one
                    seg = seg_of(key)
                    seg_writes[seg] = seg_writes_get(seg, 0) + 1
                    if len(hist) == hist_max:
                        self._oldest_rev = hist[0][0]
                    hist_append((rev, modified, key, new_obj, stored))
                    ev_append((rev, key, event(modified, new_obj), stored))
                    out_append(new_obj)
                if staged:
                    self._rev = staged[-1][4]
                    if self._list_cache:
                        # all batch events are MODIFIED: patch snapshots
                        # in place (key set and sort order unchanged)
                        for key, new_obj, _stored, _exp, _rev in staged:
                            self._patch_lists(key, new_obj)
                    if self._wal is not None:
                        # outside the hot loop: the common case has no
                        # WAL, and with one the encode pass batches
                        enc = self._wal_scheme.encode_dict
                        for key, new_obj, _stored, expiry, rev in staged:
                            self._wal.append(rev, modified, key, expiry,
                                             enc(new_obj))
                # one send per watcher for the whole tile, not per
                # object — and the whole fan-out runs AFTER this lock
                # releases (the fan-out was ~half the measured in-lock
                # binding commit cost)
                self._stage_publish(batch_events)
                self._wal_sync()
                if self._publish_inline:
                    self._drain_publish()
            if tr.enabled:
                t1 = tr.clock.monotonic()
        finally:
            self._drain_publish()
            if t1 is not None:
                ctx = obs.current()
                t2 = tr.clock.monotonic()
                tr.record("store.batch.ledger", t0, t1, parent=ctx,
                          attrs={"ops": len(out)})
                tr.record("store.batch.publish", t1, t2, parent=ctx,
                          stage="publish", attrs={"ops": len(out)})
        return out

    def commit_txn(self, ops: Iterable[Tuple[str, Callable[[Any], Any]]]
                   ) -> List[Any]:
        """Multi-key ledger TRANSACTION: apply a whole bind/status tile
        in ONE revision window — one ledger-lock acquisition covering
        one pre-assigned _bump range, ONE WAL frame (a TXN record whose
        per-frame CRC makes a torn tail truncate the whole txn
        atomically in recover()), and one ordered publish batch through
        _pub_queue, so _published_rev jumps the entire window at once
        and a mid-txn watch() registration replays up to the previous
        batch and takes this one live — exactly-once either way.

        Same op interface and all-or-nothing NotFound/Conflict
        semantics as batch(); the difference is the caller no longer
        chunks (the per-1024-op batch() loops in the binder and the
        status pump were paying a lock acquisition, a WAL commit and a
        publish handoff per chunk — PROFILE_e2e.md's 70%
        in-lock binder). batch() is kept verbatim as the A/B control
        arm (bench.py --txn-ab)."""
        out = []
        tr = obs.tracer()
        t0 = tr.clock.monotonic() if tr.enabled else 0.0
        t1 = None
        try:
            with self._lock:
                self._gc_expired()
                # staging phase: identical to batch() — run every
                # update fn first against pre-assigned revisions, so a
                # mid-txn failure commits nothing
                rev = self._rev
                staged = []
                stage = staged.append
                data_get = self._data.get
                for key, fn in ops:
                    entry = data_get(key)
                    if entry is None:
                        raise NotFound(name=key)
                    stored, _mod_rev, expiry = entry
                    rev += 1
                    if getattr(fn, "wants_rv", False):
                        new_obj = fn(stored, str(rev))
                    else:
                        new_obj = _with_rv(fn(stored), rev)
                    stage((key, new_obj, stored, expiry, rev))
                batch_events: List[Tuple[int, str, watchpkg.Event,
                                         Any]] = []
                ev_append = batch_events.append
                out_append = out.append
                data = self._data
                hist = self._history
                hist_append = hist.append
                hist_max = hist.maxlen
                seg_of = self._seg
                seg_writes = self._seg_writes
                seg_writes_get = seg_writes.get
                modified = watchpkg.MODIFIED
                event = watchpkg.Event
                for key, new_obj, stored, expiry, rev in staged:
                    data[key] = (new_obj, rev, expiry)
                    seg = seg_of(key)
                    seg_writes[seg] = seg_writes_get(seg, 0) + 1
                    if len(hist) == hist_max:
                        self._oldest_rev = hist[0][0]
                    hist_append((rev, modified, key, new_obj, stored))
                    ev_append((rev, key, event(modified, new_obj), stored))
                    out_append(new_obj)
                if staged:
                    self._rev = staged[-1][4]
                    if self._list_cache:
                        for key, new_obj, _stored, _exp, _rev in staged:
                            self._patch_lists(key, new_obj)
                    if self._wal is not None:
                        # the one framing difference from batch(): the
                        # whole window is ONE TXN frame — one CRC unit,
                        # torn-tail truncation is all-or-nothing
                        enc = self._wal_scheme.encode_dict
                        self._wal.append_txn(
                            [[rev, modified, key, expiry, enc(new_obj)]
                             for key, new_obj, _stored, expiry, rev
                             in staged])
                self._stage_publish(batch_events)
                self._wal_sync()
                if self._publish_inline:
                    self._drain_publish()
            if tr.enabled:
                t1 = tr.clock.monotonic()
        finally:
            self._drain_publish()
            if t1 is not None:
                # span bookkeeping stays outside self._lock (the
                # lock-witness lint); under publish_inline the fan-out
                # ran inside the window, so the ledger span absorbs it
                ctx = obs.current()
                t2 = tr.clock.monotonic()
                tr.record("store.txn.ledger", t0, t1, parent=ctx,
                          attrs={"ops": len(out)})
                tr.record("store.txn.publish", t1, t2, parent=ctx,
                          stage="publish", attrs={"ops": len(out)})
        return out

    # ------------------------------------------------------------- reads

    def get(self, key: str) -> Any:
        # Lock-free point read: _data maps keys to IMMUTABLE tuples that
        # writers swap atomically under the GIL, so a dict .get observes
        # either the pre- or post-commit entry — both valid snapshots —
        # and never a torn one. GETs therefore no longer queue behind a
        # committer's ledger window (the DENSITY.json GET-/nodes p99
        # whale was reads parked on this lock during the create storm).
        entry = self._data.get(key)
        if entry is None:
            raise NotFound(name=key)
        if self._expired(entry, self._clock.now()):
            # first-class expiry: the key's death is COMMITTED to the
            # ledger (revision, DELETED event, WAL record) the moment a
            # reader observes it, not deferred to the next write — so
            # revision history, watch streams, and recovery agree on
            # when it died. Only actually-expired reads pay the lock.
            self._reap_expired()
            raise NotFound(name=key)
        return entry[0]

    def _reap_expired(self) -> None:
        """Commit pending TTL expiries from a read path: ledger phase
        under the lock, publish drain after release, WAL flush — the
        same shape as every write verb."""
        try:
            with self._lock:
                self._gc_expired()
                self._wal_sync()
        finally:
            self._drain_publish()

    def list(self, prefix: str,
             predicate: Optional[Callable[[Any], bool]] = None
             ) -> Tuple[List[Any], int]:
        """All live objects under prefix, with the store revision at read
        time (the List + resourceVersion pair reflectors rely on,
        ref: pkg/client/cache/reflector.go:225). Selector-free lists of
        resource-or-deeper prefixes serve from the snapshot cache; a
        hit is consistent at the CURRENT revision because any write
        under the prefix would have invalidated it (_record).

        Pending TTL expiries are committed first (first-class expiry:
        ledger, watch streams, and WAL record a key's death when a
        reader observes it, not at the next unrelated write); the
        lock-free heap peek keeps the no-TTL hot path unchanged."""
        heap = self._expiry_heap
        if heap and heap[0][0] <= self._clock.now():
            self._reap_expired()
        with self._lock:
            cacheable = (predicate is None and prefix.count("/") >= 3
                         and self._seg(prefix) not in self._ttl_segs)
            if cacheable:
                cached = self._list_cache.get(prefix)
                if cached is not None:
                    # copy: callers filter/mutate their result lists
                    return list(cached), self._rev
            now = self._clock.now()
            # iterate only the prefix's resource segment (the key
            # index): a nodes LIST must not walk 150k pod keys. The
            # index is sound only for resource-or-deeper /registry/
            # prefixes (every matching key then shares the prefix's
            # segment); coarser or foreign prefixes take the full scan.
            seg = self._seg(prefix)
            if prefix.startswith("/registry/") and prefix.count("/") >= 3:
                bucket = self._seg_keys.get(seg) or ()
                keys: Iterable[str] = (
                    bucket if prefix == seg
                    else [k for k in bucket if k.startswith(prefix)])
            else:
                keys = [k for k in self._data if k.startswith(prefix)]
            data = self._data
            if cacheable:
                # (key, obj) pairs survive the sort so the snapshot's
                # key->position index can be built for in-place
                # MODIFIED patching; uncacheable paths (predicates,
                # coarse prefixes, TTL segs) skip the pair overhead
                pairs = []
                for k in keys:
                    e = data[k]
                    if not self._expired(e, now):
                        pairs.append((k, e[0]))
                pairs.sort(key=lambda ko: (ko[1].metadata.namespace,
                                           ko[1].metadata.name))
                items = [o for _k, o in pairs]
                if len(self._list_cache) >= 64:
                    self._list_cache.clear()
                    self._list_cache_seg.clear()
                    self._list_cache_idx.clear()
                self._list_cache[prefix] = items
                self._list_cache_idx[prefix] = {
                    k: i for i, (k, _o) in enumerate(pairs)}
                self._list_cache_seg.setdefault(self._seg(prefix),
                                                set()).add(prefix)
                return list(items), self._rev
            items = []
            for k in keys:
                e = data[k]
                if not self._expired(e, now):
                    items.append(e[0])
            if predicate is not None:
                items = [o for o in items if predicate(o)]
            items.sort(key=lambda o: (o.metadata.namespace,
                                      o.metadata.name))
            return items, self._rev

    # ------------------------------------------------------------- watch

    def watch(self, prefix: str, since_rev: Optional[int] = None,
              capacity: int = 100_000,
              predicate: Optional[Callable[[Any], bool]] = None,
              shard: Optional["FanoutShard"] = None
              ) -> watchpkg.Watcher:
        """Stream events for keys under prefix with rev > since_rev.

        since_rev=None means "from now" (no replay). Any integer — including
        0, the revision an empty store reports to list() — replays from the
        watch window, so the list-then-watch sequence is race-free from the
        very first write. If the window no longer covers since_rev, Expired
        is raised and the client must re-list (ref: cacher.go 'too old
        resource version').

        predicate: server-side selector filter (the apiserver filters
        watches before they reach the wire; filtering here keeps
        non-matching events out of the watcher queue entirely). Events
        are mapped through the reference's filtered-watch transition
        semantics — see _filtered_event.

        shard: a FanoutShard from attach_fanout_shard() — the watcher
        joins that worker's partition and its events arrive on the
        worker's pump thread. None = the default committer-drained
        shard (every pre-existing caller).

        Mid-flight registration (commits in their publish phase): under
        the shard's lock its publisher is quiescent and its
        published_rev frozen. History is replayed only up to that
        published_rev; anything already committed to the ledger but not
        yet fanned out is delivered by the shard's drain, because this
        watcher registers (with floor = max(since_rev, published_rev))
        before the shard lock is released. Exactly-once across the
        replay->live handoff, in revision order — per shard.
        """
        try:
            return self._watch_register(prefix, since_rev, capacity,
                                        predicate, shard)
        finally:
            # batches committed while registration held the default
            # shard's lock skipped their drain (non-blocking acquire):
            # flush them even when registration raises Expired
            self._drain_publish()

    def _watch_register(self, prefix: str, since_rev: Optional[int],
                        capacity: int,
                        predicate: Optional[Callable[[Any], bool]],
                        shard: Optional["FanoutShard"] = None
                        ) -> watchpkg.Watcher:
        lock = self._pub_lock if shard is None else shard.lock
        with lock:
            with self._lock:
                replay = []
                if since_rev is None:
                    # "from now": everything already committed — even if
                    # its publish is still queued — predates this watch
                    floor = self._rev
                else:
                    if since_rev < self._oldest_rev:
                        raise Expired(
                            f"resourceVersion {since_rev} is too old "
                            f"(oldest available {self._oldest_rev})")
                    published = (self._published_rev if shard is None
                                 else shard.published_rev)
                    floor = max(since_rev, published)
                    for rev, etype, key, obj, prev in self._history:
                        if rev <= since_rev or rev > published \
                                or not key.startswith(prefix):
                            continue
                        ev = watchpkg.Event(etype, obj)
                        if predicate is not None:
                            ev = self._filtered_event(ev, prev, predicate)
                            if ev is None:
                                continue
                        replay.append(ev)
            # Size the queue to hold the whole replay: a blocking send
            # here would deadlock the store (no consumer can run until
            # we return). One send_many = one queue slot for the whole
            # replay (send_many admits an oversized batch into an empty
            # watcher).
            w = watchpkg.Watcher(max(capacity, len(replay) + 16))
            if replay:
                w.send_many(replay, owned=True)
            (self._watchers if shard is None
             else shard.watchers).append((prefix, predicate, w, floor))
        return w

    def attach_fanout_shard(self, name: str = "") -> FanoutShard:
        """Create a worker delivery shard over the publish ring. Its
        cursor starts at the ring's END and its published_rev at the
        ledger head — both snapshotted under the ledger lock, so a
        watcher registering on the fresh shard replays history up to
        exactly the point live delivery takes over (pending ring
        entries it skips are inside its replay window). Caller starts
        the pump (shard.start()) and must stop() it on teardown."""
        with self._shards_lock:
            sh = FanoutShard(self, name or f"shard-{len(self._shards)}")
            with self._lock:
                sh.cursor = self._pub_seq
                sh.published_rev = self._rev
                # copy-on-write: _stage_publish iterates lock-free
                self._shards = self._shards + [sh]
        return sh

    def detach_fanout_shard(self, shard: "FanoutShard") -> None:
        """Remove a shard from ring retention (idempotent; called by
        FanoutShard.stop)."""
        with self._shards_lock:
            self._shards = [s for s in self._shards if s is not shard]
        shard.detached = True
        self._ring_trim()

    def fanout_shards(self) -> List["FanoutShard"]:
        return list(self._shards)

    def drain_overlap(self) -> dict:
        """The multi-consumer concurrency witness (see _DrainOverlap)."""
        return self._drain_overlap.snapshot()

    def watcher_count(self) -> int:
        with self._pub_lock:
            self._watchers = [e for e in self._watchers
                              if not e[2].stopped]
            n = len(self._watchers)
        self._drain_publish()  # flush batches parked while we held the lock
        for sh in self._shards:
            with sh.lock:
                sh.watchers = [e for e in sh.watchers
                               if not e[2].stopped]
                n += len(sh.watchers)
        return n

    # -------------------------------------------------------- durability

    def wal_close(self) -> None:
        """Flush and close the WAL (clean shutdown). A crashed process
        never calls this — recovery handles the torn tail."""
        if self._wal is not None:
            with self._lock:
                self._wal.close()

    @classmethod
    def recover(cls, wal_dir: str, window: int = 100_000,
                publish_inline: bool = False,
                fsync_policy: str = "batch",
                wal_segment_records: int = 10_000,
                wal_snapshot_records: int = 50_000) -> "Store":
        """Rebuild a Store from its WAL directory: newest snapshot,
        then the record tail, applied in strict revision order — the
        pre-crash ledger prefix, bit-identically: same revision
        counter, same live entries (insertion order preserved through
        the snapshot), same history tail, same per-segment write
        tokens and key index. Expired keys are not resurrected: every
        record carries its absolute expiry, and expiries the old
        process committed are first-class DELETED records. A torn
        final record is truncated, not fatal (core/wal.py).

        The returned store has the WAL re-attached and keeps
        journaling; `recovery_stats` records what the replay did.
        """
        import time as _time
        from ..utils.metrics import global_metrics
        from .scheme import default_scheme
        from .wal import WalWriter, read_wal

        t0 = _time.monotonic()
        snap, records = read_wal(wal_dir)
        st = cls(window=window, publish_inline=publish_inline)
        decode = default_scheme.decode_dict
        if snap is not None:
            st._rev = snap["rev"]
            # revisions at or below the snapshot are no longer
            # replayable from history (same meaning as a rolled window)
            st._oldest_rev = snap["rev"]
            st._seg_writes = {k: int(v)
                              for k, v in snap["seg_writes"].items()}
            st._ttl_segs = set(snap["ttl_segs"])
            for key, mod_rev, expiry, wire in snap["entries"]:
                obj = decode(wire)
                st._data[key] = (obj, int(mod_rev), expiry)
                st._index_add(key)
                if expiry is not None:
                    heapq.heappush(st._expiry_heap, (expiry, key))
        hist = st._history
        for rev, etype, key, expiry, wire in records:
            obj = decode(wire)
            prev_entry = st._data.get(key)
            if etype == watchpkg.DELETED:
                # the record's object IS the pre-delete stored object;
                # the live _record path emits (obj=stored, prev=stored)
                if prev_entry is not None:
                    del st._data[key]
                    st._index_del(key)
                prev = obj
            else:
                st._data[key] = (obj, rev, expiry)
                st._index_add(key)
                if expiry is not None:
                    heapq.heappush(st._expiry_heap, (expiry, key))
                    st._ttl_segs.add(st._seg(key))
                prev = prev_entry[0] if prev_entry is not None else None
            seg = st._seg(key)
            st._seg_writes[seg] = st._seg_writes.get(seg, 0) + 1
            if len(hist) == hist.maxlen:
                st._oldest_rev = hist[0][0]
            hist.append((rev, etype, key, obj, prev))
            st._rev = rev
        st._published_rev = st._rev  # nothing is pending fan-out
        w = WalWriter(wal_dir, fsync_policy=fsync_policy,
                      segment_records=wal_segment_records,
                      snapshot_records=wal_snapshot_records)
        w._since_snapshot = len(records)  # resume the compaction cadence
        st._wal = w
        st._wal_scheme = default_scheme
        global_metrics.inc("wal_recoveries_total")
        st.recovery_stats = {
            "snapshot_rev": snap["rev"] if snap is not None else 0,
            "replayed_records": len(records),
            "recovered_revision": st._rev,
            "seconds": round(_time.monotonic() - t0, 6),
        }
        return st
