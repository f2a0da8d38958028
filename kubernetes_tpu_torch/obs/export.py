"""Span-dump analysis and Chrome/Perfetto trace-event export.

The export target is the trace-event JSON format both chrome://tracing
and ui.perfetto.dev open directly — the same viewer that reads the
jax-profiler's XPlane dumps, so a scheduling trace and a device
profile sit side by side. Everything here is a pure function of the
span dicts (Span.to_dict shape): no clock reads, no RNG, no ambient
state — determinism of the export reduces to determinism of the spans.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..utils.metrics import OBS_STAGES

#: trace-event "thread" rows: one per lifecycle stage plus a catch-all
#: track 1 for unstaged spans — fixed ids, so the export never depends
#: on real thread identity (which no two runs share)
_UNSTAGED_TID = 1
_STAGE_TID = {stage: i + 2 for i, stage in enumerate(OBS_STAGES)}


def _tid(stage: Optional[str]) -> int:
    return _STAGE_TID.get(stage or "", _UNSTAGED_TID)


def to_trace_events(spans: List[dict]) -> List[dict]:
    """Span dicts -> trace-event dicts ("X" complete events on stage
    tracks, preceded by "M" thread-name metadata). Stable sort by
    (ts, trace_id, span_id): concurrent spans order by identity, not
    by buffer arrival, so same-seed runs serialize identically."""
    out: List[dict] = [
        {"ph": "M", "pid": 1, "tid": _UNSTAGED_TID,
         "name": "thread_name", "args": {"name": "spans"}}]
    for stage in OBS_STAGES:
        out.append({"ph": "M", "pid": 1, "tid": _STAGE_TID[stage],
                    "name": "thread_name", "args": {"name": stage}})
    events = []
    for s in spans:
        if s.get("end") is None:
            continue
        args = {"trace_id": s["trace_id"], "span_id": s["span_id"],
                "parent_id": s["parent_id"], "status": s["status"]}
        for k, v in (s.get("attrs") or {}).items():
            args[str(k)] = v
        steps = s.get("steps") or []
        if steps:
            args["steps"] = [[int(t * 1e6), msg] for t, msg in steps]
        events.append({
            "ph": "X", "pid": 1, "tid": _tid(s.get("stage")),
            "name": s["name"], "cat": s.get("stage") or "span",
            "ts": int(s["start"] * 1e6),
            "dur": int((s["end"] - s["start"]) * 1e6),
            "args": args})
    events.sort(key=lambda e: (e["ts"], e["args"]["trace_id"],
                               e["args"]["span_id"]))
    out.extend(events)
    return out


def stage_totals(spans: List[dict]) -> Dict[str, dict]:
    """-> {stage: {count, total_seconds}} over finished staged spans —
    the numerator of the bench's stage-coverage gate."""
    out: Dict[str, dict] = {}
    for s in spans:
        stage = s.get("stage")
        if stage is None or s.get("end") is None:
            continue
        acc = out.setdefault(stage, {"count": 0, "total_seconds": 0.0})
        acc["count"] += 1
        acc["total_seconds"] += s["end"] - s["start"]
    return out


def critical_path(spans: List[dict], trace_id: str) -> List[dict]:
    """The latest-finisher chain of one trace: from the root span,
    repeatedly descend into the child that ended last — the chain a
    'why was this pod slow' investigation walks. Returns span dicts
    root-first; [] for an unknown trace."""
    members = [s for s in spans
               if s["trace_id"] == trace_id and s.get("end") is not None]
    if not members:
        return []
    by_id = {s["span_id"]: s for s in members}
    children: Dict[str, List[dict]] = {}
    roots = []
    for s in members:
        parent = s["parent_id"]
        if parent and parent in by_id:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)
    if not roots:
        return []
    path = [max(roots, key=lambda s: (s["end"], s["span_id"]))]
    while True:
        kids = children.get(path[-1]["span_id"])
        if not kids:
            return path
        path.append(max(kids, key=lambda s: (s["end"], s["span_id"])))
