"""Per-entry exponential backoff (ref: plugin/pkg/scheduler/factory/
factory.go:376-452 podBackoff — 1s doubling to 60s, garbage-collected)."""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from .clock import Clock, RealClock


class Backoff:
    def __init__(self, initial: float = 1.0, max_duration: float = 60.0,
                 clock: Optional[Clock] = None):
        self.initial = initial
        self.max = max_duration
        self.clock = clock or RealClock()
        self._lock = threading.Lock()
        # id -> (current_backoff_seconds, last_update_ts)
        self._entries: Dict[str, Tuple[float, float]] = {}

    def get(self, key: str) -> float:
        """Current backoff for key, doubling it for next time."""
        now = self.clock.now()
        with self._lock:
            duration, _ = self._entries.get(key, (self.initial, now))
            self._entries[key] = (min(duration * 2, self.max), now)
            return duration

    def wait(self, key: str) -> None:
        self.clock.sleep(self.get(key))

    def reset(self, key: str) -> None:
        with self._lock:
            self._entries.pop(key, None)

    def gc(self, max_age: float = 2 * 60.0) -> None:
        now = self.clock.now()
        with self._lock:
            stale = [k for k, (_, ts) in self._entries.items()
                     if now - ts > max_age]
            for k in stale:
                del self._entries[k]
