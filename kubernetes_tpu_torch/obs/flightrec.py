"""Flight recorder: one post-mortem bundle per triggering event.

When something goes wrong mid-soak — an SLO burn-rate alert trips, the
runtime lock witness sees an inversion, a chaos plan kills a process —
the most valuable artifacts are the ones that exist RIGHT THEN: the
tail of the fleet time-series, the tracer's span buffer, the witness
graph, and where in its plan the chaos was. By the time the run ends
they are diluted or gone. dump() snapshots all of them into one
directory the way a crashed airliner's recorder is read back:

    <dir>/bundle-0003-slo-crowd-bind-availability/
        meta.json     trigger, sequence number, clock reads, extras
        series.json   fleet time-series tail (FleetScraper.tail)
        trace.json    span dump (obs.Tracer.export_json format)
        witness.json  lock-order graph + inversions (LockWitness.report)
        chaos.json    chaos-plan position (CrashChaos.trace, ...)

Every file is sorted + compact (byte-stable under FakeClock), and
every section is optional — the recorder writes what it was handed.
tools/obs_report.py renders bundles alongside the series report.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Dict, List, Optional

from ..utils.clock import REAL, Clock


def _slug(text: str) -> str:
    return re.sub(r"[^a-zA-Z0-9]+", "-", text).strip("-").lower()[:60]


def _dump_json(path: str, doc: Any) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, sort_keys=True, separators=(",", ":"))


class FlightRecorder:
    """Bounded post-mortem bundle writer. `capacity` caps the number
    of bundles per run (a flapping alert must not fill the disk);
    once full, further dumps are counted but dropped."""

    def __init__(self, directory: str, clock: Optional[Clock] = None,
                 capacity: int = 16, series_tail: int = 120):
        self.directory = directory
        self.clock = clock or REAL
        self.capacity = capacity
        self.series_tail = series_tail
        self.dropped = 0
        self._seq = 0
        self._lock = threading.Lock()
        self.bundles: List[str] = []

    def dump(self, reason: str,
             scraper: Any = None,
             tracer: Any = None,
             witness: Any = None,
             chaos: Any = None,
             extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Write one bundle; returns its path (None when over
        capacity). Never raises on a partially-available world — a
        recorder that crashes the thing it is recording is worse
        than no recorder."""
        with self._lock:
            if self._seq >= self.capacity:
                self.dropped += 1
                return None
            seq = self._seq
            self._seq += 1
        bundle = os.path.join(self.directory,
                              f"bundle-{seq:04d}-{_slug(reason)}")
        os.makedirs(bundle, exist_ok=True)

        _dump_json(os.path.join(bundle, "meta.json"), {
            "reason": reason,
            "seq": seq,
            "monotonic": self.clock.monotonic(),
            "wall": self.clock.now(),
            "extra": extra or {},
        })
        if scraper is not None:
            try:
                _dump_json(os.path.join(bundle, "series.json"),
                           scraper.tail(self.series_tail))
            except Exception:
                pass
        if tracer is not None:
            try:
                with open(os.path.join(bundle, "trace.json"), "w",
                          encoding="utf-8") as f:
                    f.write(tracer.export_json())
            except Exception:
                pass
        if witness is not None:
            try:
                _dump_json(os.path.join(bundle, "witness.json"),
                           witness.report())
            except Exception:
                pass
        if chaos is not None:
            try:
                pos = (chaos.trace() if hasattr(chaos, "trace")
                       else chaos if isinstance(chaos, dict)
                       else {"repr": repr(chaos)})
                _dump_json(os.path.join(bundle, "chaos.json"), pos)
            except Exception:
                pass
        with self._lock:
            self.bundles.append(bundle)
        return bundle
