"""Causal pod-lifecycle tracing: the observability layer.

The reference's story here is glog + pprof + per-binary /metrics
(pkg/util/trace.go, hack/grab-profiles.sh); none of it can answer
*where a pod's wall-clock goes* between create and kubelet confirm.
This package is that answer as a layer: W3C-style `traceparent`
propagation through the whole control plane (HttpClient injects,
ApiServer extracts, objects carry it as an annotation through the
store and every watch stream), a span recorder whose IDs are a pure
function of `(seed, counter)` and whose timestamps ride the injectable
utils/clock.Clock — so under the determinism contract a
same-seed run exports byte-identical trace-event JSON — and a
pod-lifecycle stage model (utils/metrics.OBS_STAGES) recorded as
`pod_e2e_stage_seconds{stage=...}` summaries.

Propagation model: within a thread, context is an explicit stack
(`use(span)` / `current()`); across queues and processes it travels
with the data — the `traceparent` header on HTTP requests, the
trace.kubernetes.io/traceparent annotation on objects (stamped at
create admission, carried by the store, the WAL, every watch replay
and every wire serialization for free). Tile-granular spans (a 30k-pod
bind commits as one span) adopt the first pod's context as an
exemplar parent and record the pod count, the OpenTelemetry-exemplar
compromise to a span with 30k parents.

Disabled tracing is a few attribute reads per call site: `start_span`
returns a shared no-op span and `end` returns immediately — the
bench's tracing-off arm gates the overhead at <5% e2e throughput.

Sibling modules (imported directly, not re-exported here, to keep
this package's import graph flat): `obs.metricsplane` is the fleet
metrics plane — deterministic scraper, merged pinned-bucket
histograms, SLO burn-rate alerting over the exported time-series —
and `obs.flightrec` is the flight recorder that snapshots series
tail + span buffer + lock-witness graph + chaos position into a
post-mortem bundle the instant something trips.
"""

from __future__ import annotations

import hashlib
import json
import threading
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional

from ..utils.clock import REAL, Clock
from ..utils.metrics import (OBS_STAGE_SUMMARY, OBS_STAGES, MetricsRegistry,
                             global_metrics)
from .export import critical_path, to_trace_events
from .propagate import (TRACEPARENT_ANNOTATION, ctx_of, format_traceparent,
                        parse_traceparent)

__all__ = [
    "Span", "SpanContext", "Tracer", "tracer", "configure", "set_tracer",
    "current", "use", "format_traceparent", "parse_traceparent",
    "TRACEPARENT_ANNOTATION", "ctx_of", "to_trace_events", "critical_path",
    "OBS_STAGES", "OBS_STAGE_SUMMARY", "NOOP",
]


class SpanContext(NamedTuple):
    """The propagated identity of a span: what a traceparent header or
    an object annotation carries."""
    trace_id: str  # 32 hex chars
    span_id: str   # 16 hex chars


class Span:
    """One timed operation. Mutable until `Tracer.end` seals it; the
    recorder owns the buffer, a Span is just the handle call sites
    hold while the operation runs."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "end", "stage", "status", "attrs", "steps")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: str, start: float,
                 stage: Optional[str] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end: Optional[float] = None
        self.stage = stage
        self.status = "ok"
        self.attrs: Dict[str, Any] = attrs or {}
        #: (timestamp, message) step marks — the utils/trace.Trace
        #: over-threshold logging view reads these
        self.steps: List[tuple] = []

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    @property
    def duration(self) -> float:
        return (self.end - self.start) if self.end is not None else 0.0

    def to_dict(self) -> dict:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "start": self.start, "end": self.end, "stage": self.stage,
                "status": self.status, "attrs": self.attrs,
                "steps": [list(s) for s in self.steps]}


class _NoopSpan(Span):
    """The disabled-tracer span: one shared instance, every mutation a
    no-op, so call sites never branch on enablement themselves."""

    def __init__(self):
        super().__init__("noop", "0" * 32, "0" * 16, "", 0.0)


NOOP = _NoopSpan()


class Tracer:
    """Deterministic span recorder.

    IDs: span n of a tracer is sha256(f"{seed}:{n}") — trace_id is the
    first 16 bytes, span_id the next 8 — the same (seed, stream-name)
    string-seeding convention chaos.FaultPlan uses, with no RNG at all
    (the determinism lint bans process RNG in this package).
    Timestamps: every read goes through the injected Clock's monotonic
    axis, so a FakeClock harness replays traces bit-for-bit.

    The buffer is a bounded deque (oldest spans fall off); `end`
    additionally feeds stage-tagged spans into the
    pod_e2e_stage_seconds{stage=...} summary of the metrics registry.
    """

    def __init__(self, seed: int = 0, clock: Optional[Clock] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 enabled: bool = True, capacity: int = 200_000):
        self.seed = seed
        self.clock = clock or REAL
        self.metrics = metrics or global_metrics
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counter = 0
        self._spans: deque = deque(maxlen=capacity)

    # ------------------------------------------------------------- ids

    def _next_ids(self) -> tuple:
        with self._lock:
            n = self._counter
            self._counter += 1
        h = hashlib.sha256(f"{self.seed}:{n}".encode()).hexdigest()
        return h[:32], h[32:48]

    # ----------------------------------------------------------- record

    def start_span(self, name: str, parent: Any = None,
                   stage: Optional[str] = None,
                   attrs: Optional[Dict[str, Any]] = None,
                   start: Optional[float] = None) -> Span:
        """parent: a Span, a SpanContext, or None (starts a new trace).
        start: explicit monotonic timestamp (defaults to a clock read)."""
        if not self.enabled:
            return NOOP
        trace_id, span_id = self._next_ids()
        parent_id = ""
        if parent is not None:
            trace_id = parent.trace_id
            parent_id = parent.span_id
        return Span(name, trace_id, span_id, parent_id,
                    self.clock.monotonic() if start is None else start,
                    stage=stage, attrs=attrs)

    def end(self, span: Span, status: str = "ok",
            end: Optional[float] = None) -> None:
        if span is NOOP or not self.enabled:
            return
        span.end = self.clock.monotonic() if end is None else end
        span.status = status
        with self._lock:
            self._spans.append(span)
        if span.stage is not None:
            self.metrics.observe(OBS_STAGE_SUMMARY, span.end - span.start,
                                 {"stage": span.stage})

    def span(self, name: str, parent: Any = None,
             stage: Optional[str] = None,
             attrs: Optional[Dict[str, Any]] = None):
        """Context manager: start_span / end with error status on
        exception, and the span installed as the current context."""
        return _SpanScope(self, name, parent, stage, attrs)

    def record(self, name: str, start: float, end: float,
               parent: Any = None, stage: Optional[str] = None,
               attrs: Optional[Dict[str, Any]] = None) -> Span:
        """Record an already-timed interval (call sites that measured
        with their own clock reads — the scheduler's tile timings)."""
        if not self.enabled:
            return NOOP
        s = self.start_span(name, parent=parent, stage=stage, attrs=attrs,
                            start=start)
        self.end(s, end=end)
        return s

    def step(self, span: Span, msg: str) -> None:
        if span is NOOP or not self.enabled:
            return
        span.steps.append((self.clock.monotonic(), msg))

    # ------------------------------------------------------------- read

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def reset(self) -> None:
        """Drop recorded spans AND rewind the id counter — two runs
        separated by reset() draw identical id sequences."""
        with self._lock:
            self._spans.clear()
            self._counter = 0

    def trace_events(self) -> List[dict]:
        return to_trace_events([s.to_dict() for s in self.spans()])

    def export_json(self) -> str:
        """Deterministic Chrome/Perfetto trace-event JSON: stable sort,
        sorted keys, no whitespace — the byte-identical same-seed
        contract the soak gate asserts."""
        return json.dumps(self.trace_events(), sort_keys=True,
                          separators=(",", ":"))


class _SpanScope:
    def __init__(self, tracer: Tracer, name: str, parent: Any,
                 stage: Optional[str], attrs: Optional[dict]):
        self._tracer = tracer
        self._args = (name, parent, stage, attrs)
        self.span: Span = NOOP

    def __enter__(self) -> Span:
        name, parent, stage, attrs = self._args
        if parent is None:
            parent = current()
        self.span = self._tracer.start_span(name, parent=parent,
                                            stage=stage, attrs=attrs)
        _push(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> None:
        _pop(self.span)
        self._tracer.end(self.span,
                         status="error" if exc_type is not None else "ok")


# -------------------------------------------------- thread-local context

_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _push(span: Span) -> None:
    if span is not NOOP:
        _stack().append(span)


def _pop(span: Span) -> None:
    st = _stack()
    if span is not NOOP and st and st[-1] is span:
        st.pop()


def current() -> Optional[SpanContext]:
    """The active span context on THIS thread (explicit-stack model:
    queues and processes carry context with the data, not the thread)."""
    st = getattr(_tls, "stack", None)
    if not st:
        return None
    return st[-1].context


class use:
    """Install a span (or bare SpanContext) as the current context for
    a block — the apiserver wraps routing in one so registry/store
    spans nest under the server span."""

    def __init__(self, span_or_ctx: Any):
        if isinstance(span_or_ctx, SpanContext):
            # promote to a Span-shaped holder for the stack
            span = Span("ctx", span_or_ctx.trace_id, span_or_ctx.span_id,
                        "", 0.0)
        else:
            span = span_or_ctx
        self._span = span

    def __enter__(self):
        _push(self._span)
        return self._span

    def __exit__(self, *exc) -> None:
        _pop(self._span)


# --------------------------------------------------------- global tracer

#: the process-wide tracer, like utils.metrics.global_metrics: every
#: layer records into it unless handed its own. Replace with
#: configure() (harnesses) or set_tracer() (tests restoring in finally).
_global_tracer = Tracer()


def tracer() -> Tracer:
    return _global_tracer


def configure(seed: int = 0, clock: Optional[Clock] = None,
              metrics: Optional[MetricsRegistry] = None,
              enabled: bool = True, capacity: int = 200_000) -> Tracer:
    """Replace the global tracer (bench/soak harnesses pin seed+clock
    here before driving traffic). Returns the new tracer."""
    global _global_tracer
    _global_tracer = Tracer(seed=seed, clock=clock, metrics=metrics,
                            enabled=enabled, capacity=capacity)
    return _global_tracer


def set_tracer(t: Tracer) -> Tracer:
    """Swap the global tracer, returning the previous one (tests)."""
    global _global_tracer
    prev = _global_tracer
    _global_tracer = t
    return prev
