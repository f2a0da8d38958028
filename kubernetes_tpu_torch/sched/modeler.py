"""System modeler: assumed-pod accounting between bind and watch confirm.

Reference: plugin/pkg/scheduler/modeler.go:87-197 SimpleModeler — a 30s-TTL
store of pods we've bound but whose binding the watch hasn't confirmed yet,
merged into the PodLister the algorithm sees so in-flight bindings count
against node capacity. LockedAction serializes bind vs forget (:47-56).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..core import labels as labelspkg
from ..core import types as api
from ..api.cache import meta_namespace_key

ASSUMED_POD_TTL = 30.0  # ref: modeler.go:108


class _TTLStore:
    """TTL-expiring keyed store (ref: cache.NewTTLStore)."""

    def __init__(self, ttl: float, clock=time):
        self.ttl = ttl
        self._clock = clock
        self._items: Dict[str, Tuple[api.Pod, float]] = {}

    def add(self, pod: api.Pod) -> None:
        self._items[meta_namespace_key(pod)] = (pod, self._clock.time())

    def delete_key(self, key: str) -> None:
        self._items.pop(key, None)

    def list(self) -> List[api.Pod]:
        now = self._clock.time()
        dead = [k for k, (_, ts) in self._items.items()
                if now - ts > self.ttl]
        for k in dead:
            del self._items[k]
        return [p for p, _ in self._items.values()]


class SimpleModeler:
    """(ref: modeler.go:87 SimpleModeler)

    queued_pods / scheduled_pods: listers with list(selector) + exists(pod).
    The merged pod lister = scheduled pods + still-assumed pods; a pod that
    has shown up in either underlying lister stops being assumed.
    """

    def __init__(self, queued_pods, scheduled_pods,
                 ttl: float = ASSUMED_POD_TTL, clock=time):
        self.queued_pods = queued_pods
        self.scheduled_pods = scheduled_pods
        self._assumed = _TTLStore(ttl, clock)
        self._lock = threading.RLock()
        self._clock = clock
        # forget tombstones, keyed (ns/name, uid): a confirm-reflector
        # forget that races AHEAD of the committer's assume must win, or
        # a pod deleted right after confirmation would sit assumed (and
        # consume phantom capacity) until the TTL. uid-scoped so a
        # recreated same-name pod assumes normally. Expiry rides an
        # insertion-ordered deque so GC is O(expired) per forget — a
        # full-dict rebuild was O(n^2) across a 30k-pod confirm storm.
        self._forgotten: Dict[Tuple[str, str], float] = {}
        self._forgotten_order: deque = deque()

    def locked_action(self, fn):
        """(ref: modeler.go:47 actionLocker.LockedAction)"""
        with self._lock:
            return fn()

    def _gc_tombstones(self, now: float) -> None:
        ttl = self._assumed.ttl
        order = self._forgotten_order
        while order and now - order[0][0] > ttl:
            ts, key = order.popleft()
            if self._forgotten.get(key) == ts:
                del self._forgotten[key]

    def _tombstoned(self, pod: api.Pod, now: float) -> bool:
        ts = self._forgotten.get(
            (meta_namespace_key(pod), pod.metadata.uid))
        return ts is not None and now - ts <= self._assumed.ttl

    def assume_pod(self, pod: api.Pod) -> None:
        with self._lock:
            if not self._tombstoned(pod, self._clock.time()):
                self._assumed.add(pod)

    def assume_pods(self, pods: List[api.Pod]) -> None:
        """One lock acquisition for a whole committed tile (the per-pod
        variant made the binder hold/drop the lock 8192 times per tile
        while the confirm reflector's forgets queued behind it)."""
        with self._lock:
            now = self._clock.time()
            for pod in pods:
                if not self._tombstoned(pod, now):
                    self._assumed.add(pod)

    def forget_pod(self, pod: api.Pod) -> None:
        with self._lock:
            now = self._clock.time()
            key = (meta_namespace_key(pod), pod.metadata.uid)
            self._forgotten[key] = now
            self._forgotten_order.append((now, key))
            self._gc_tombstones(now)
            self._assumed.delete_key(meta_namespace_key(pod))

    def forget_pod_by_key(self, key: str) -> None:
        with self._lock:
            self._assumed.delete_key(key)

    # -- the merged lister the algorithm sees (ref: modeler.go listPods) --

    def list(self, selector: Optional[labelspkg.Selector] = None
             ) -> List[api.Pod]:
        with self._lock:
            for pod in self._assumed.list():
                if self.queued_pods.exists(pod) or \
                        self.scheduled_pods.exists(pod):
                    self._assumed.delete_key(meta_namespace_key(pod))
            scheduled = self.scheduled_pods.list(selector)
            assumed = self._assumed.list()
            if selector is not None and not selector.empty():
                assumed = [p for p in assumed
                           if selector.matches(p.metadata.labels)]
            seen = {meta_namespace_key(p) for p in scheduled}
            merged = scheduled + [p for p in assumed
                                  if meta_namespace_key(p) not in seen]
            return merged

    def exists(self, pod: api.Pod) -> bool:
        key = meta_namespace_key(pod)
        return any(meta_namespace_key(p) == key for p in self.list())

    def pod_lister(self) -> "SimpleModeler":
        return self
