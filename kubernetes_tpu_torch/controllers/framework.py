"""Shared controller machinery: expectations, worker pools, pod filters.

Reference: pkg/controller/controller_utils.go — ControllerExpectations
(:98-190), ActivePods delete-preference sort (:377-398),
FilterActivePods (:400-410)."""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence

from ..core import types as api
from ..utils.clock import Clock, RealClock
from ..utils.workqueue import WorkQueue

EXPECTATIONS_TIMEOUT = 5 * 60.0  # controller_utils.go ExpectationsTimeout


class _Expectation:
    __slots__ = ("add", "dels", "timestamp")

    def __init__(self, add: int, dels: int, timestamp: float):
        self.add = add
        self.dels = dels
        self.timestamp = timestamp

    def fulfilled(self) -> bool:
        return self.add <= 0 and self.dels <= 0


class ControllerExpectations:
    """Tracks in-flight creates/deletes per controller so a sync doesn't
    act on a stale cache (controller_utils.go:98-190). Semantics kept:
    absent or expired expectations mean "sync away" (SatisfiedExpectations
    returns true when no record exists, :135-156)."""

    def __init__(self, clock: Optional[Clock] = None):
        self.clock = clock or RealClock()
        self._store: Dict[str, _Expectation] = {}
        self._lock = threading.Lock()

    def satisfied(self, key: str) -> bool:
        with self._lock:
            exp = self._store.get(key)
            if exp is None:
                return True
            if self.clock.now() - exp.timestamp > EXPECTATIONS_TIMEOUT:
                return True
            return exp.fulfilled()

    def set(self, key: str, add: int, dels: int) -> None:
        with self._lock:
            self._store[key] = _Expectation(add, dels, self.clock.now())

    def expect_creations(self, key: str, adds: int) -> None:
        self.set(key, adds, 0)

    def expect_deletions(self, key: str, dels: int) -> None:
        self.set(key, 0, dels)

    def creation_observed(self, key: str) -> None:
        self._lower(key, add=1)

    def deletion_observed(self, key: str) -> None:
        self._lower(key, dels=1)

    def _lower(self, key: str, add: int = 0, dels: int = 0) -> None:
        with self._lock:
            exp = self._store.get(key)
            if exp is not None:
                exp.add -= add
                exp.dels -= dels

    def delete(self, key: str) -> None:
        with self._lock:
            self._store.pop(key, None)


class QueueWorkers:
    """N worker threads draining a WorkQueue into a sync handler — the
    reference's `go util.Until(rm.worker, ...)` loop
    (replication_controller.go:322-336). The queue guarantees one key is
    never processed concurrently. A sync that raises is requeued with
    per-key exponential backoff (no informer resync exists to re-drive a
    dropped key)."""

    def __init__(self, sync: Callable[[str], None], workers: int = 5,
                 name: str = "controller",
                 retry_initial: float = 0.05, retry_max: float = 5.0):
        self.queue = WorkQueue()
        self.sync = sync
        self.workers = workers
        self.name = name
        self.retry_initial = retry_initial
        self.retry_max = retry_max
        self._retry_delay: Dict[str, float] = {}
        self._threads: List[threading.Thread] = []

    def enqueue(self, key: str) -> None:
        self.queue.add(key)

    def start(self) -> "QueueWorkers":
        for i in range(self.workers):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"{self.name}-{i}")
            t.start()
            self._threads.append(t)
        return self

    def _retry_later(self, key: str) -> None:
        delay = self._retry_delay.get(key, self.retry_initial)
        self._retry_delay[key] = min(delay * 2, self.retry_max)
        timer = threading.Timer(delay, lambda: self.queue.add(key))
        timer.daemon = True
        timer.start()

    def _worker(self) -> None:
        while True:
            key = self.queue.get()
            if key is None:
                return
            try:
                self.sync(key)
                self._retry_delay.pop(key, None)
            except Exception:
                self._retry_later(key)
            finally:
                self.queue.done(key)

    def stop(self) -> None:
        self.queue.shutdown()


def filter_active_pods(pods: Sequence[api.Pod]) -> List[api.Pod]:
    """(controller_utils.go:400 FilterActivePods)"""
    return [p for p in pods
            if p.status.phase not in ("Succeeded", "Failed")
            and p.metadata.deletion_timestamp is None]


def is_pod_ready(pod: api.Pod) -> bool:
    return any(c.type == "Ready" and c.status == "True"
               for c in pod.status.conditions)


_PHASE_RANK = {"Pending": 0, "Unknown": 1, "Running": 2}


def active_pods_sort_key(pod: api.Pod):
    """Delete-preference order: unassigned < assigned, Pending < Unknown
    < Running, not-ready < ready (controller_utils.go:383-398)."""
    return (0 if not pod.spec.node_name else 1,
            _PHASE_RANK.get(pod.status.phase, 1),
            1 if is_pod_ready(pod) else 0)
