"""Event recording: broadcaster, recorder, and correlation (dedup/aggregation).

Reference: pkg/client/record/event.go (EventBroadcaster :80-105, recordToSink
retry loop :105-160) and pkg/client/record/events_cache.go (EventAggregator
:69-92, eventLogger dedup). Behavior kept:

- Events are fire-and-forget from the caller's perspective; a broadcaster
  fans them out to sinks on background threads.
- Aggregation: events identical except for message, seen more than
  ``aggregate_max_events`` (10) times inside ``aggregate_interval`` (600s),
  collapse into one event whose message is the aggregate marker
  (events_cache.go:99 EventAggregatorByReasonMessageFunc).
- Dedup: an event with an already-seen key increments ``count`` and bumps
  ``last_timestamp`` on the server copy instead of creating a new object
  (events_cache.go eventObserve / the update branch of recordToSink).
- Sink errors retry up to ``max_tries`` with a sleep between tries
  (event.go:105-130, maxTriesPerEvent=12); we keep the structure with a
  smaller default so tests stay fast.
"""

from __future__ import annotations

import itertools
import queue
import threading
from collections import OrderedDict
from dataclasses import replace
from typing import Callable, List, Optional, Tuple

from ..core import types as api
from ..core.errors import AlreadyExists
from ..utils.clock import Clock, RealClock

MAX_LRU_CACHE_ENTRIES = 4096  # events_cache.go:37
DEFAULT_AGGREGATE_MAX_EVENTS = 10  # events_cache.go:41
DEFAULT_AGGREGATE_INTERVAL_SECONDS = 600  # events_cache.go:42


def _ref_key(ref: api.ObjectReference) -> str:
    return "".join([ref.kind, ref.namespace, ref.name, ref.uid,
                    ref.api_version])


def get_event_key(event: api.Event) -> str:
    """Full dedup key incl. message (events_cache.go:46 getEventKey)."""
    return "".join([event.source.component, event.source.host,
                    _ref_key(event.involved_object), event.type,
                    event.reason, event.message])


def aggregate_key(event: api.Event) -> Tuple[str, str]:
    """(group key w/o message, local key = message)
    (events_cache.go:77 EventAggregatorByReasonFunc)."""
    return ("".join([event.source.component, event.source.host,
                     _ref_key(event.involved_object), event.type,
                     event.reason]),
            event.message)


class _LRU:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            if key not in self._d:
                return None
            self._d.move_to_end(key)
            return self._d[key]

    def put(self, key, value):
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)


class EventAggregator:
    """Collapses event floods that differ only in message
    (events_cache.go:103 EventAggregator.EventAggregate)."""

    def __init__(self, clock: Clock,
                 max_events: int = DEFAULT_AGGREGATE_MAX_EVENTS,
                 max_interval: float = DEFAULT_AGGREGATE_INTERVAL_SECONDS,
                 capacity: int = MAX_LRU_CACHE_ENTRIES):
        self.clock = clock
        self.max_events = max_events
        self.max_interval = max_interval
        self._cache = _LRU(capacity)

    def aggregate(self, event: api.Event) -> api.Event:
        group, local = aggregate_key(event)
        now = self.clock.now()
        record = self._cache.get(group)
        if record is None or now - record["last"] > self.max_interval:
            record = {"keys": set(), "last": now}
        record["keys"].add(local)
        record["last"] = now
        self._cache.put(group, record)
        if len(record["keys"]) < self.max_events:
            return event
        # similar-but-distinct flood: collapse message
        return replace(event,
                       message="(events with common reason combined)")


class EventLogger:
    """Observed-event state: returns (event, is_update) where an update
    carries the accumulated count / first_timestamp
    (events_cache.go eventLogger.eventObserve)."""

    def __init__(self, capacity: int = MAX_LRU_CACHE_ENTRIES):
        self._cache = _LRU(capacity)

    def observe(self, event: api.Event) -> Tuple[api.Event, bool]:
        key = get_event_key(event)
        prior = self._cache.get(key)
        if prior is not None:
            event = replace(
                event,
                metadata=replace(event.metadata,
                                 name=prior["name"],
                                 resource_version=prior["resource_version"]),
                first_timestamp=prior["first_timestamp"],
                count=prior["count"] + 1)
            self._cache.put(key, self._state(event))
            return event, True
        self._cache.put(key, self._state(event))
        return event, False

    def update_state(self, event: api.Event) -> None:
        """Record the server-assigned name/resourceVersion after a write
        (event.go updates the cache from the sink response)."""
        self._cache.put(get_event_key(event), self._state(event))

    @staticmethod
    def _state(event: api.Event) -> dict:
        return {"name": event.metadata.name,
                "resource_version": event.metadata.resource_version,
                "first_timestamp": event.first_timestamp,
                "count": event.count}


class EventCorrelator:
    """filter -> aggregate -> dedup pipeline
    (events_cache.go EventCorrelator)."""

    def __init__(self, clock: Clock,
                 filter_func: Optional[Callable[[api.Event], bool]] = None):
        self.filter_func = filter_func or (lambda e: False)
        self.aggregator = EventAggregator(clock)
        self.logger = EventLogger()

    def correlate(self, event: api.Event) -> Tuple[Optional[api.Event], bool]:
        if self.filter_func(event):
            return None, False
        return self.logger.observe(self.aggregator.aggregate(event))


class EventSink:
    """Where correlated events land (event.go EventSink: Create/Update)."""

    def create(self, event: api.Event) -> api.Event:
        raise NotImplementedError

    def update(self, event: api.Event) -> api.Event:
        raise NotImplementedError


class ClientEventSink(EventSink):
    def __init__(self, client):
        self.client = client

    def create(self, event):
        return self.client.create("events", event,
                                  event.metadata.namespace or "default")

    def update(self, event):
        return self.client.update("events", event,
                                  event.metadata.namespace or "default")


class EventBroadcaster:
    """Fan events out to sinks + local watchers
    (event.go:80 NewBroadcaster over watch.Broadcaster)."""

    def __init__(self, clock: Optional[Clock] = None,
                 max_tries: int = 3, sleep_between_tries: float = 1.0,
                 queue_size: int = 1000):
        self.clock = clock or RealClock()
        self.max_tries = max_tries
        self.sleep_between_tries = sleep_between_tries
        self.queue_size = queue_size
        # one queue per sink so every sink sees every event
        self._queues: List["queue.Queue"] = []
        self._watchers: List[Callable[[api.Event], None]] = []
        self._threads: List[threading.Thread] = []
        self._stopped = threading.Event()

    # -- recording side ---------------------------------------------------

    def new_recorder(self, source: api.EventSource) -> "EventRecorder":
        return EventRecorder(self, source, self.clock)

    def _publish(self, event: api.Event) -> None:
        for fn in list(self._watchers):
            try:
                fn(event)
            except Exception:
                pass
        for q in list(self._queues):
            try:
                q.put_nowait(event)
            except queue.Full:  # drop, don't block the caller (event.go mux)
                pass

    # -- consuming side ---------------------------------------------------

    def start_event_watcher(self,
                            fn: Callable[[api.Event], None]) -> None:
        self._watchers.append(fn)

    def start_recording_to_sink(self, sink: EventSink) -> "EventBroadcaster":
        correlator = EventCorrelator(self.clock)
        q: "queue.Queue" = queue.Queue(maxsize=self.queue_size)
        self._queues.append(q)
        t = threading.Thread(target=self._drain, args=(q, sink, correlator),
                             daemon=True, name="event-broadcaster")
        t.start()
        self._threads.append(t)
        return self

    def _drain(self, q: "queue.Queue", sink: EventSink,
               correlator: EventCorrelator) -> None:
        while True:
            event = q.get()
            if event is None or self._stopped.is_set():
                return
            self._record_one(sink, correlator, event)

    def _record_one(self, sink: EventSink, correlator: EventCorrelator,
                    event: api.Event) -> None:
        correlated, is_update = correlator.correlate(event)
        if correlated is None:
            return
        for attempt in range(self.max_tries):
            try:
                if is_update and correlated.metadata.resource_version:
                    try:
                        written = sink.update(correlated)
                    except AlreadyExists:
                        raise  # let the outer replay guard settle it
                    except Exception:
                        # server copy expired (events have a TTL) or CAS
                        # conflict: fall back to create with a cleared
                        # resourceVersion (event.go recordEvent NotFound path)
                        correlated = replace(
                            correlated,
                            metadata=replace(correlated.metadata,
                                             resource_version=""))
                        written = sink.create(correlated)
                else:
                    written = sink.create(correlated)
                correlator.logger.update_state(written)
                return
            except AlreadyExists:
                # event names are unique per occurrence, so the only
                # way the name exists is that an earlier attempt's
                # create committed and the response was lost — the
                # event is recorded; replaying would duplicate it
                return
            except Exception:
                if attempt + 1 >= self.max_tries:
                    return
                self.clock.sleep(self.sleep_between_tries)

    def flush(self, timeout: float = 5.0) -> None:
        """Wait for the queues to drain (tests)."""
        deadline = self.clock.now() + timeout
        while (any(not q.empty() for q in self._queues)
               and self.clock.now() < deadline):
            self.clock.sleep(0.01)

    def shutdown(self) -> None:
        self._stopped.set()
        for q in list(self._queues):
            try:
                q.put_nowait(None)
            except queue.Full:
                pass


class EventRecorder:
    """(event.go recorderImpl.Event/Eventf)"""

    _seq = itertools.count()  # disambiguates same-instant events

    def __init__(self, broadcaster: EventBroadcaster,
                 source: api.EventSource, clock: Clock):
        self._broadcaster = broadcaster
        self.source = source
        self.clock = clock

    def event(self, obj, event_type: str, reason: str,
              message: str) -> None:
        ref = object_reference(obj)
        ts = api.now_rfc3339()
        self._broadcaster._publish(api.Event(
            metadata=api.ObjectMeta(
                # name pattern: <involved>.<unique> (event.go makeEvent);
                # a process-wide counter keeps names unique within one
                # clock tick (coarse clocks / FakeClock)
                name=(f"{ref.name}.{int(self.clock.now() * 1e9):x}"
                      f".{next(self._seq):x}"),
                namespace=ref.namespace or "default"),
            involved_object=ref,
            reason=reason, message=message,
            source=self.source,
            first_timestamp=ts, last_timestamp=ts,
            count=1, type=event_type))

    def eventf(self, obj, event_type: str, reason: str,
               fmt: str, *args) -> None:
        self.event(obj, event_type, reason, fmt % args if args else fmt)


class FakeRecorder:
    """(event.go FakeRecorder) — collects 'Reason Message' strings."""

    def __init__(self):
        self.events: List[str] = []

    def event(self, obj, event_type, reason, message):
        self.events.append(f"{event_type} {reason} {message}")

    def eventf(self, obj, event_type, reason, fmt, *args):
        self.event(obj, event_type, reason, fmt % args if args else fmt)


def object_reference(obj) -> api.ObjectReference:
    """(pkg/api/ref.go GetReference, simplified: our objects always carry
    kind via type name)"""
    if isinstance(obj, api.ObjectReference):
        return obj
    meta = getattr(obj, "metadata", None) or api.ObjectMeta()
    return api.ObjectReference(
        kind=type(obj).__name__, namespace=meta.namespace,
        name=meta.name, uid=meta.uid, api_version="v1")
