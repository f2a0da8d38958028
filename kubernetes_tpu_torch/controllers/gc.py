"""Terminated-pod garbage collector.

Reference: pkg/controller/gc/gc_controller.go — every gcCheckPeriod (20s)
list terminated pods (phase not Pending/Running/Unknown, via the negated
field selector :119-125); when the count exceeds the threshold, delete the
oldest by creationTimestamp (name as tie-break) down to the threshold
(:90-117). Threshold <= 0 disables GC (controllermanager
--terminated-pod-gc-threshold, default 12500)."""

from __future__ import annotations

import threading
from typing import Optional

from ..core.errors import NotFound
from ..utils.clock import Clock, RealClock

GC_CHECK_PERIOD = 20.0  # gc_controller.go:40
TERMINATED_SELECTOR = ("status.phase!=Pending,status.phase!=Running,"
                       "status.phase!=Unknown")  # :119-125


class PodGCController:
    def __init__(self, client, threshold: int = 12500,
                 check_period: float = GC_CHECK_PERIOD,
                 clock: Optional[Clock] = None):
        self.client = client
        self.threshold = threshold
        self.check_period = check_period
        self.clock = clock or RealClock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def gc_once(self) -> int:
        """Returns the number of pods deleted."""
        if self.threshold <= 0:
            return 0
        try:
            terminated, _ = self.client.list(
                "pods", field_selector=TERMINATED_SELECTOR)
        except Exception:
            return 0
        delete_count = len(terminated) - self.threshold
        if delete_count <= 0:
            return 0
        terminated.sort(key=lambda p: (p.metadata.creation_timestamp,
                                       p.metadata.name))
        deleted = 0
        for pod in terminated[:delete_count]:
            try:
                self.client.delete("pods", pod.metadata.name,
                                   pod.metadata.namespace)
                deleted += 1
            except NotFound:
                pass
            except Exception:
                pass  # transient; the pod is still terminated next tick
        return deleted

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.gc_once()
            except Exception:
                pass  # never let the gc thread die (util.Until semantics)
            self._stop.wait(self.check_period)

    def run(self) -> "PodGCController":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="pod-gc")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
