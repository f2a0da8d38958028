"""Trace-context propagation codecs.

Two carriers, one context shape:

- the W3C `traceparent` HTTP header (`00-<32hex>-<16hex>-<2hex>`) —
  HttpClient injects one per request ATTEMPT (fresh span id, shared
  trace id, so a retry storm reads as sibling attempts of one trace),
  ApiServer extracts it into the server span;
- the trace.kubernetes.io/traceparent object annotation — stamped at
  create admission, it rides the object through the store, the WAL,
  every watch replay/live delivery and every wire serialization, which
  is how the scheduler's informer links a tile back to the creates
  that fed it without the Event type growing a side channel.
"""

from __future__ import annotations

from typing import Any, Optional

#: object-annotation carrier of the create-time trace context
TRACEPARENT_ANNOTATION = "trace.kubernetes.io/traceparent"

_VERSION = "00"
_FLAGS = "01"  # sampled

_HEX = set("0123456789abcdef")


def format_traceparent(ctx: Any) -> str:
    """ctx: anything with trace_id/span_id (Span or SpanContext)."""
    return f"{_VERSION}-{ctx.trace_id}-{ctx.span_id}-{_FLAGS}"


def parse_traceparent(value: Optional[str]):
    """-> SpanContext, or None for anything malformed (an unparseable
    header starts a fresh trace rather than failing the request —
    the W3C processing model's tolerant-reader posture)."""
    from . import SpanContext
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, _flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    if not (set(version) <= _HEX and set(trace_id) <= _HEX
            and set(span_id) <= _HEX):
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id)


def ctx_of(obj: Any):
    """The create-time trace context an API object carries, or None.
    Reads metadata.annotations[TRACEPARENT_ANNOTATION]."""
    meta = getattr(obj, "metadata", None)
    ann = getattr(meta, "annotations", None)
    if not ann:
        return None
    return parse_traceparent(ann.get(TRACEPARENT_ANNOTATION))
