"""Watch primitives: typed event stream with bounded-queue fan-out.

Reference: pkg/watch (Interface, Event, Mux/Broadcaster). A watcher is an
iterator of (event_type, object); the broadcaster fans a stream out to many
watchers, dropping slow ones rather than blocking the writer (the reference's
Mux uses a full-channel policy; we mirror "stop the laggard" which is also
what the apiserver Cacher does).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Iterator, List, Optional

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"
ERROR = "ERROR"


@dataclass(frozen=True)
class Event:
    type: str
    object: Any


class Watcher:
    """A single watch stream. Iterate to receive events; `stop()` ends it.

    One condition variable guards the queue AND the event-capacity
    counter: the store's fan-out calls send() once per watcher per write,
    so the previous two-lock layout (reserve lock + queue.Queue's mutex)
    paid double under the 30-writer benchmark load."""

    def __init__(self, capacity: int = 1000):
        self.capacity = capacity
        self._cond = threading.Condition()
        # items are Event or List[Event] (a batched send occupies one
        # slot but counts as len(events) toward capacity, so laggard
        # detection and the memory bound survive send_many)
        self._dq: deque = deque()
        self._count = 0
        self._stopped = threading.Event()
        # consumer-side buffer for batched sends; consumer-thread only
        self._pending: "deque[Event]" = deque()

    def send(self, event: Event) -> bool:
        """Enqueue an event without blocking. Returns False if the watcher is
        stopped or its queue is full (laggard — callers drop such watchers)."""
        if self._stopped.is_set():
            return False
        with self._cond:
            if self._count + 1 > self.capacity and self._count > 0:
                return False
            self._count += 1
            self._dq.append(event)
            self._cond.notify()
        return True

    def send_many(self, events: List[Event], owned: bool = False) -> bool:
        """Enqueue a batch as ONE queue slot — the store's tile-commit
        fan-out (30k bindings = a handful of puts per watcher instead of
        30k lock/notify cycles each). Consumers unwrap transparently.
        A single batch larger than capacity is admitted into an EMPTY
        watcher (it isn't lagging — the commit is just big); a watcher
        already holding events gets the strict bound.

        owned=True: the caller hands the list over and never touches it
        again (the store's publisher builds one fresh list per watcher
        per batch) — skip the defensive copy."""
        if not events:
            return True
        if self._stopped.is_set():
            return False
        n = len(events)
        with self._cond:
            if self._count + n > self.capacity and self._count > 0:
                return False
            self._count += n
            self._dq.append(events if owned else list(events))
            self._cond.notify()
        return True

    def fail(self, err: Any) -> None:
        """Terminate the stream with a visible ERROR event, then stop.

        The laggard path (the cacher's 410-Gone semantics,
        pkg/storage/cacher.go terminateAllWatchers): a watcher whose
        queue overran gets ONE final ERROR carrying the ApiError — past
        the capacity bound, deliberately, because the bound exists to
        limit data events, and a silent stop() here looks identical to
        a clean server-side close, so the client would never know to
        re-list. Consumers drain the backlog, see the ERROR, and
        recover via list + re-watch. Idempotent after stop()."""
        if self._stopped.is_set():
            return
        with self._cond:
            if self._stopped.is_set():
                return
            self._count += 1
            self._dq.append(Event(ERROR, err))
            self._cond.notify()
        self.stop()

    def stop(self) -> None:
        if self._stopped.is_set():
            return
        self._stopped.set()
        with self._cond:
            self._cond.notify_all()

    @property
    def stopped(self) -> bool:
        return self._stopped.is_set()

    def _take(self) -> Any:
        """Pop one queued item under the lock (caller holds _cond)."""
        item = self._dq.popleft()
        self._count -= len(item) if isinstance(item, list) else 1
        return item

    def __iter__(self) -> Iterator[Event]:
        while True:
            while self._pending:
                yield self._pending.popleft()
            with self._cond:
                while not self._dq:
                    if self._stopped.is_set():
                        # drain-then-stop: queued events were delivered
                        # above; nothing arrives after stop()
                        return
                    self._cond.wait()
                item = self._take()
            if isinstance(item, list):
                self._pending.extend(item)
            else:
                yield item

    def take_all(self) -> List[Event]:
        """Drain everything queued right now, without blocking — one
        lock hold for the whole backlog. The consumer-side counterpart
        of send_many: a 10k-watcher fan-out bench popping events one
        next() at a time would spend its wall-clock on lock churn
        instead of delivery."""
        out: List[Event] = list(self._pending)
        self._pending.clear()
        with self._cond:
            while self._dq:
                item = self._take()
                if isinstance(item, list):
                    out.extend(item)
                else:
                    out.append(item)
        return out

    def next(self, timeout: Optional[float] = None) -> Optional[Event]:
        """Blocking pop with timeout; None on timeout or stop."""
        if self._pending:
            return self._pending.popleft()
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cond:
            while not self._dq:
                if self._stopped.is_set():
                    return None
                if deadline is None:
                    self._cond.wait()
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    return None
            item = self._take()
        if isinstance(item, list):
            self._pending.extend(item)
            return self._pending.popleft()
        return item


class Broadcaster:
    """Fan one event stream out to many watchers (ref: pkg/watch/mux.go)."""

    def __init__(self, queue_len: int = 1000):
        self._watchers: List[Watcher] = []
        self._lock = threading.Lock()
        self._queue_len = queue_len

    def watch(self) -> Watcher:
        w = Watcher(self._queue_len)
        with self._lock:
            self._watchers.append(w)
        return w

    def action(self, event_type: str, obj: Any) -> None:
        ev = Event(event_type, obj)
        with self._lock:
            alive = []
            for w in self._watchers:
                if w.stopped:
                    continue
                if w.send(ev):
                    alive.append(w)
                else:
                    w.stop()  # drop the laggard
            self._watchers = alive

    def shutdown(self) -> None:
        with self._lock:
            for w in self._watchers:
                w.stop()
            self._watchers = []
