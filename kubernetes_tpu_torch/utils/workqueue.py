"""Deduplicating work queue (ref: pkg/util/workqueue): an item added while
queued is coalesced; an item added while being processed is re-queued when
done — the invariant controllers rely on to never process one key
concurrently."""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Optional, Set


class WorkQueue:
    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._dirty: Set[Any] = set()
        self._processing: Set[Any] = set()
        self._shutdown = False

    def add(self, item: Any) -> None:
        with self._cond:
            if self._shutdown or item in self._dirty:
                return
            self._dirty.add(item)
            if item not in self._processing:
                self._queue.append(item)
                self._cond.notify()

    def get(self, timeout: Optional[float] = None) -> Optional[Any]:
        """Blocks for the next item; None on shutdown or timeout."""
        with self._cond:
            while not self._queue and not self._shutdown:
                if not self._cond.wait(timeout):
                    return None
            if not self._queue:
                return None
            item = self._queue.popleft()
            self._processing.add(item)
            self._dirty.discard(item)
            return item

    def done(self, item: Any) -> None:
        with self._cond:
            self._processing.discard(item)
            if item in self._dirty and not self._shutdown:
                self._queue.append(item)
                self._cond.notify()

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._cond:
            return len(self._queue)
