"""Real and fake clocks (ref: pkg/util/clock.go — the fake clock is what
makes eviction/backoff logic unit-testable without sleeping).

Two time axes: now() is WALL time (timestamps on API objects, TTL
deadlines) and monotonic() is a jump-free axis for deadlines and
leases. Leader election runs entirely on monotonic() — a backwards
wall-clock step (NTP correction, VM migration) must neither drop nor
extend leadership (tests/test_leaderelection.py pins this). FakeClock
keeps the axes separable: step() advances both, jump_wall() skews only
the wall clock, exactly the failure being regression-tested.
"""

from __future__ import annotations

import threading
import time


class Clock:
    def now(self) -> float:
        raise NotImplementedError

    def monotonic(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class RealClock(Clock):
    def now(self) -> float:
        return time.time()

    def monotonic(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


#: the process-wide real clock. Stateless, so one shared instance is
#: enough — components take `clock: Clock = REAL` and tests hand in a
#: FakeClock. Direct `time.time()` in seeded/replayed code is a lint
#: error (kubernetes_tpu/lint, "determinism" rule); this singleton is
#: the sanctioned default.
REAL = RealClock()


class FakeClock(Clock):
    def __init__(self, start: float = 0.0):
        self._now = start          # the monotonic axis
        self._wall_offset = 0.0    # wall = monotonic + offset
        self._cond = threading.Condition()

    def now(self) -> float:
        with self._cond:
            return self._now + self._wall_offset

    def monotonic(self) -> float:
        with self._cond:
            return self._now

    def sleep(self, seconds: float) -> None:
        target = self.monotonic() + seconds
        with self._cond:
            while self._now < target:
                self._cond.wait(0.01)

    def step(self, seconds: float) -> None:
        """Advance TIME (both axes) — the normal passage of seconds."""
        with self._cond:
            self._now += seconds
            self._cond.notify_all()

    def jump_wall(self, seconds: float) -> None:
        """Skew the WALL clock only (negative = backwards NTP step).
        Monotonic readers must be unaffected."""
        with self._cond:
            self._wall_offset += seconds
            self._cond.notify_all()
