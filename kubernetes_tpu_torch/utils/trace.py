"""Over-threshold span logger (ref: pkg/util/trace.go:17-60): record
named steps; log the whole span only if it exceeded a threshold, the
way the reference wraps REST handlers (resthandler.go) and etcd calls
(etcd_helper.go).

Since the obs layer landed this is a VIEW, not a recorder: a Trace
opens a real obs span (so its interval and step marks reach the span
buffer, the Perfetto export, and any stage summaries like every other
span) and keeps only the glog-style formatting here. Time comes from
the tracer's injectable utils/clock.Clock — never a hardwired
time.monotonic() — so harnesses driving a FakeClock replay the
threshold decision too.
"""

from __future__ import annotations

import logging
from typing import List, Tuple

logger = logging.getLogger("kubernetes_tpu_torch.trace")


class Trace:
    def __init__(self, name: str):
        # local import: utils is a leaf package obs itself imports
        from .. import obs
        self._tracer = obs.tracer()
        self._span = self._tracer.start_span(name, parent=obs.current())
        self.name = name
        self.start = (self._tracer.clock.monotonic()
                      if self._span is obs.NOOP else self._span.start)

    @property
    def steps(self) -> List[Tuple[float, str]]:
        return list(self._span.steps)

    def step(self, msg: str) -> None:
        self._tracer.step(self._span, msg)

    def total_seconds(self) -> float:
        return self._tracer.clock.monotonic() - self.start

    def finish(self) -> None:
        """Seal the underlying span (idempotent via the end guard)."""
        if self._span.end is None:
            self._tracer.end(self._span)

    def log_if_long(self, threshold_seconds: float) -> None:
        long = self.total_seconds() >= threshold_seconds
        self.finish()
        if long:
            self.log()

    def log(self) -> None:
        total = self.total_seconds()
        lines = [f'Trace "{self.name}" (total {total*1000:.1f}ms):']
        prev = self.start
        for ts, msg in self._span.steps:
            lines.append(f"  [{(ts - prev)*1000:8.1f}ms] {msg}")
            prev = ts
        logger.info("\n".join(lines))
