"""Client-side caches: reflector, thread-safe store, FIFO, informer.

Reference mapping:
  - Reflector.ListAndWatch (pkg/client/cache/reflector.go:225): list, record
    resourceVersion, watch from it, re-list on 410 Expired.
  - ThreadSafeStore / cache.Store (pkg/client/cache/store.go): keyed object
    cache behind a lock; listers read it.
  - FIFO (pkg/client/cache/fifo.go:168 Pop): coalescing pop-queue of objects —
    the scheduler's pending-pod queue.
  - framework.NewInformer (pkg/controller/framework/controller.go:211):
    reflector + OnAdd/OnUpdate/OnDelete handlers.

Threading model: one reflector thread per watch; handlers run on the
reflector thread (same as the reference's single processLoop goroutine) so a
slow handler backpressures the watch, not the store.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core import labels as labelspkg
from ..core.errors import ApiError, Expired
from ..core import watch as watchpkg

logger = logging.getLogger("kubernetes_tpu_torch.cache")


def meta_namespace_key(obj: Any) -> str:
    """ns/name key (ref: cache.MetaNamespaceKeyFunc)."""
    m = obj.metadata
    return f"{m.namespace}/{m.name}" if m.namespace else m.name


class ObjectCache:
    """Thread-safe keyed object store."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._items: Dict[str, Any] = {}
        self._synced = threading.Event()

    def replace(self, items: List[Any]) -> None:
        with self._lock:
            self._items = {meta_namespace_key(o): o for o in items}
        self._synced.set()

    def add(self, obj: Any) -> None:
        with self._lock:
            self._items[meta_namespace_key(obj)] = obj

    update = add

    def delete(self, obj: Any) -> None:
        with self._lock:
            self._items.pop(meta_namespace_key(obj), None)

    def get_by_key(self, key: str) -> Optional[Any]:
        with self._lock:
            return self._items.get(key)

    def list(self, selector: Optional[labelspkg.Selector] = None) -> List[Any]:
        with self._lock:
            items = list(self._items.values())
        if selector is not None and not selector.empty():
            items = [o for o in items if selector.matches(o.metadata.labels)]
        return items

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._items.keys())

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def has_synced(self) -> bool:
        return self._synced.is_set()

    def wait_for_sync(self, timeout: float = 30.0) -> bool:
        return self._synced.wait(timeout)


class FIFO:
    """Coalescing object queue; Pop blocks (ref: fifo.go). Replace/add/update
    key by ns/name; a popped object is gone (no processing set — matches the
    reference FIFO, not DeltaFIFO).

    Pop order is priority-then-FIFO: objects carrying `spec.priority`
    (pods) pop highest-priority first, insertion order within a
    priority — the scheduler's pending queue must hand a preempting pod
    the capacity its evictions freed before any lower-priority backlog
    can steal it (the reference's priority scheduling queue; objects
    without the field all rank 0, which degenerates to plain FIFO)."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._items: Dict[str, Any] = {}
        self._queue: deque = deque()
        self._stamps: Dict[str, float] = {}
        self._closed = False
        #: queue-wait of the most recently popped object (monotonic
        #: seconds from first enqueue to pop) — the scheduler reads it
        #: right after pop() to time the pipeline's "queue" stage; a
        #: plain attribute is enough because the pending queue has one
        #: consumer (matches the reference's single scheduling loop)
        self.last_pop_wait = 0.0

    def add(self, obj: Any) -> None:
        key = meta_namespace_key(obj)
        with self._cond:
            if key not in self._items:
                self._queue.append(key)
                # first-enqueue stamp: coalesced updates keep the
                # original arrival time (the pod has been waiting since
                # it first showed up, not since its last update)
                self._stamps.setdefault(key, time.monotonic())
            self._items[key] = obj
            self._cond.notify()

    update = add

    def delete(self, obj: Any) -> None:
        with self._cond:
            key = meta_namespace_key(obj)
            self._items.pop(key, None)
            self._stamps.pop(key, None)
            # key stays in deque; pop skips dead keys (add() may re-queue the
            # same key later — pop's items-membership check dedupes)

    @staticmethod
    def _priority_of(obj: Any) -> int:
        spec = getattr(obj, "spec", None)
        return getattr(spec, "priority", 0) or 0

    def pop(self, timeout: Optional[float] = None) -> Optional[Any]:
        with self._cond:
            while True:
                # one sweep: compact dead keys out of the deque and pick
                # the highest-priority live key (first-seen wins a tie,
                # so an all-default queue pops in insertion order)
                best_key = None
                best_prio = 0
                live: deque = deque()
                while self._queue:
                    key = self._queue.popleft()
                    if key not in self._items:
                        continue  # deleted while queued
                    live.append(key)
                    prio = self._priority_of(self._items[key])
                    if best_key is None or prio > best_prio:
                        best_key, best_prio = key, prio
                self._queue = live
                if best_key is not None:
                    self._queue.remove(best_key)
                    stamp = self._stamps.pop(best_key, None)
                    self.last_pop_wait = (
                        time.monotonic() - stamp
                        if stamp is not None else 0.0)
                    return self._items.pop(best_key)
                if self._closed:
                    return None
                if not self._cond.wait(timeout):
                    return None

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def list(self) -> List[Any]:
        """Snapshot of pending objects (does not consume them)."""
        with self._cond:
            return list(self._items.values())

    def contains(self, key: str) -> bool:
        with self._cond:
            return key in self._items

    def __len__(self) -> int:
        # _items holds exactly the pending objects (popped/deleted keys are
        # removed), so this never double-counts re-added keys.
        with self._cond:
            return len(self._items)


#: Reflector re-list backoff: starts at the old fixed 50ms, doubles to
#: the cap with full jitter. 16 controllers x N informers against a
#: restarting apiserver settle at ~0.2 attempts/s per informer instead
#: of hammering it at 20/s each (the thundering-herd relist storm).
RELIST_BACKOFF_INITIAL = 0.05
RELIST_BACKOFF_MAX = 5.0
#: a list+watch session that survived this long was healthy — its
#: eventual death reconnects fast instead of inheriting stale backoff
HEALTHY_SESSION_S = 1.0


class Reflector:
    """List+watch a resource into a target (ObjectCache, FIFO, or handler
    triple). Crash-only: any watch error falls back to re-list, under
    capped jittered exponential backoff."""

    def __init__(self, client, resource: str, namespace: str = "",
                 label_selector: str = "", field_selector: str = "",
                 on_add: Optional[Callable[[Any], None]] = None,
                 on_update: Optional[Callable[[Any, Any], None]] = None,
                 on_delete: Optional[Callable[[Any], None]] = None,
                 store: Optional[Any] = None,
                 resync_period: float = 0.0,
                 backoff_initial: float = RELIST_BACKOFF_INITIAL,
                 backoff_max: float = RELIST_BACKOFF_MAX):
        self.client = client
        self.resource = resource
        self.namespace = namespace
        self.label_selector = label_selector
        self.field_selector = field_selector
        # selectors are immutable per reflector: parse once, not per event
        self._parsed_fields = None
        self._fields_fn = None
        self._field_match = None
        if field_selector:
            from ..core import fields as fieldspkg
            from .registry import (Registry, convert_field_selector,
                                   field_matcher)
            # same field-label conversion the server applies (legacy
            # aliases like spec.host rewrite; without it the client-side
            # re-check below would filter on the unconverted key and
            # drop every event the server-side selector admits)
            self._parsed_fields = convert_field_selector(
                resource, fieldspkg.parse(field_selector))
            info = Registry.info(resource)
            self._fields_fn = info.fields_fn
            # the shared matcher: compiled attribute reads for the
            # common selectors, the dict path otherwise
            self._field_match = field_matcher(info, self._parsed_fields)
        self._parsed_labels = (labelspkg.parse(label_selector)
                               if label_selector else None)
        self.store = store
        self.on_add = on_add
        self.on_update = on_update
        self.on_delete = on_delete
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._watcher: Optional[watchpkg.Watcher] = None
        self._known: Dict[str, Any] = {}
        self.last_sync_rev = 0
        self.resync_period = resync_period
        self._last_resync = 0.0
        self.backoff_initial = backoff_initial
        self.backoff_max = backoff_max
        #: observability for the fault tier: how many times the run
        #: loop recovered from a failed list/watch session
        self.reconnects = 0

    # The server-side field selector also filters here client-side because
    # watch events are not field-filtered by the in-proc store (the reference
    # filters in the apiserver; filtering at both ends is harmless).
    def _matches(self, obj: Any) -> bool:
        if self._field_match is not None and not self._field_match(obj):
            return False
        if self._parsed_labels is not None and \
                not self._parsed_labels.matches(obj.metadata.labels):
            return False
        return True

    def _list_and_watch(self) -> None:
        items, rev = self.client.list(self.resource, self.namespace,
                                      self.label_selector, self.field_selector)
        self.last_sync_rev = rev
        if self.store is not None and hasattr(self.store, "replace"):
            self.store.replace(items)
        else:
            for o in items:
                if self.store is not None:
                    self.store.add(o)
        # Diff against what we knew before this (re-)list so handlers see
        # exactly one on_add per object lifetime, on_delete for objects that
        # vanished while the watch was down, and on_update for ones that
        # changed (ref: DeltaFIFO Replace emits Sync/Delete deltas).
        new_known = {meta_namespace_key(o): o for o in items}
        for key, old in self._known.items():
            if key not in new_known:
                if self.store is not None and not hasattr(self.store, "replace"):
                    self.store.delete(old)
                if self.on_delete:
                    self.on_delete(old)
        for key, obj in new_known.items():
            old = self._known.get(key)
            if old is None:
                if self.on_add:
                    self.on_add(obj)
            elif old.metadata.resource_version != obj.metadata.resource_version:
                if self.on_update:
                    self.on_update(old, obj)
        self._known = prev = new_known  # aliased: the watch loop mutates it

        # selectors ride to the server: the store filters watch events
        # before they ever reach this watcher's queue (the client-side
        # _matches check stays — plain Watchers from tests and fakes
        # deliver unfiltered streams)
        w = self.client.watch(self.resource, self.namespace, since_rev=rev,
                              label_selector=self.label_selector,
                              field_selector=self.field_selector)
        self._watcher = w
        self._last_resync = time.monotonic()
        while not self._stop.is_set():
            ev = w.next(timeout=1.0)
            if (self.resync_period > 0 and self.on_update is not None
                    and time.monotonic() - self._last_resync
                    >= self.resync_period):
                # periodic resync: replay the known set through
                # on_update so LEVEL-driven controllers make progress
                # whose triggering condition produced no event on their
                # watched resource (the reference's informer resync —
                # DeltaFIFO Sync deltas; framework/controller.go
                # NewInformer resyncPeriod)
                self._last_resync = time.monotonic()
                for obj in list(prev.values()):
                    self.on_update(obj, obj)
            if ev is None:
                if w.stopped:
                    if getattr(w, "failed", False):
                        # mid-stream disconnect (HTTP watcher marks it;
                        # the ERROR event may have been shed by a full
                        # queue) — surface it so the run loop logs the
                        # reconnect and backs off
                        raise ApiError(
                            f"watch stream for {self.resource} failed")
                    return  # clean stop; outer loop re-lists at once
                continue
            if ev.type == watchpkg.ERROR:
                raise ev.object if isinstance(ev.object, ApiError) \
                    else ApiError(str(ev.object))
            obj = ev.object
            try:
                self.last_sync_rev = int(obj.metadata.resource_version or 0)
            except ValueError:
                pass
            key = meta_namespace_key(obj)
            relevant = self._matches(obj)
            was = prev.get(key)
            if ev.type == watchpkg.DELETED or not relevant:
                if was is not None:
                    prev.pop(key, None)
                    if self.store is not None:
                        self.store.delete(obj)
                    if self.on_delete:
                        self.on_delete(was)
                continue
            prev[key] = obj
            if self.store is not None:
                self.store.add(obj)
            if was is None:
                if self.on_add:
                    self.on_add(obj)
            else:
                if self.on_update:
                    self.on_update(was, obj)

    def run_once(self) -> None:
        self._list_and_watch()

    def _run(self) -> None:
        import random
        rng = random.Random()
        delay = self.backoff_initial
        while not self._stop.is_set():
            started = time.monotonic()
            try:
                self._list_and_watch()
                delay = self.backoff_initial  # clean stop: healthy server
            except Expired:
                # too-old resourceVersion: the server is healthy and
                # asking for a re-list — immediate, no backoff
                delay = self.backoff_initial
                continue
            except Exception as e:
                if self._stop.is_set():
                    return
                if time.monotonic() - started >= HEALTHY_SESSION_S:
                    # the session was established and lived — this is a
                    # fresh failure, not a continuing outage
                    delay = self.backoff_initial
                self.reconnects += 1
                logger.info("reflector %s: %r; re-list in <=%.2fs",
                            self.resource, e, delay)
                # full jitter: N informers re-listing against a
                # restarting apiserver spread out instead of herding
                self._stop.wait(delay * rng.random())
                delay = min(delay * 2.0, self.backoff_max)

    def start(self) -> "Reflector":
        self._thread = threading.Thread(
            target=self._run, name=f"reflector-{self.resource}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._watcher is not None:
            self._watcher.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)


class Informer:
    """Cache + reflector + handlers (ref: framework.NewInformer)."""

    def __init__(self, client, resource: str, namespace: str = "",
                 label_selector: str = "", field_selector: str = "",
                 on_add=None, on_update=None, on_delete=None,
                 resync_period: float = 0.0):
        self.cache = ObjectCache()
        self.reflector = Reflector(
            client, resource, namespace, label_selector, field_selector,
            on_add=on_add, on_update=on_update, on_delete=on_delete,
            store=self.cache, resync_period=resync_period)

    def start(self) -> "Informer":
        self.reflector.start()
        return self

    def stop(self) -> None:
        self.reflector.stop()

    @property
    def has_synced(self) -> bool:
        return self.cache.has_synced


# ------------------------------------------------------------------ listers

class StoreToPodLister:
    """(ref: pkg/client/cache/listers.go StoreToPodLister)"""

    def __init__(self, cache: ObjectCache):
        self.cache = cache

    def list(self, selector: Optional[labelspkg.Selector] = None) -> List[Any]:
        return self.cache.list(selector)

    def exists(self, pod: Any) -> bool:
        return self.cache.get_by_key(meta_namespace_key(pod)) is not None


class StoreToNodeLister:
    def __init__(self, cache: ObjectCache):
        self.cache = cache

    def list(self) -> List[Any]:
        return self.cache.list()


class StoreToServiceLister:
    """get_pod_services: services whose selector matches the pod's labels
    (ref: listers.go GetPodServices — empty-selector services match nothing
    there; we mirror that)."""

    def __init__(self, cache: ObjectCache):
        self.cache = cache

    def list(self) -> List[Any]:
        return self.cache.list()

    def get_pod_services(self, pod: Any) -> List[Any]:
        out = []
        for svc in self.cache.list():
            if svc.metadata.namespace != pod.metadata.namespace:
                continue
            sel = svc.spec.selector
            if not sel:
                continue
            if labelspkg.selector_from_set(sel).matches(pod.metadata.labels):
                out.append(svc)
        return out


class StoreToReplicationControllerLister:
    def __init__(self, cache: ObjectCache):
        self.cache = cache

    def list(self) -> List[Any]:
        return self.cache.list()

    def get_pod_controllers(self, pod: Any) -> List[Any]:
        out = []
        for rc in self.cache.list():
            if rc.metadata.namespace != pod.metadata.namespace:
                continue
            sel = rc.spec.selector
            if not sel:
                continue
            if labelspkg.selector_from_set(sel).matches(pod.metadata.labels):
                out.append(rc)
        return out
