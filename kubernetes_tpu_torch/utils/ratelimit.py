"""Token-bucket rate limiter (ref: pkg/util/throttle.go over juju/ratelimit;
the scheduler's --bind-pods-qps/burst and client --kube-api-qps flags feed
this, plugin/cmd/kube-scheduler/app/server.go:145)."""

from __future__ import annotations

import threading
import time
from typing import Optional

from .clock import Clock, RealClock


class TokenBucketRateLimiter:
    def __init__(self, qps: float, burst: int, clock: Optional[Clock] = None):
        if qps <= 0:
            raise ValueError("qps must be positive")
        self.qps = float(qps)
        self.burst = max(1, int(burst))
        self.clock = clock or RealClock()
        self._tokens = float(self.burst)
        self._last = self.clock.now()
        self._lock = threading.Lock()

    def _refill(self) -> None:
        now = self.clock.now()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.qps)
        self._last = now

    def try_accept(self) -> bool:
        with self._lock:
            self._refill()
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def accept(self) -> None:
        """Block until a token is available."""
        while True:
            with self._lock:
                self._refill()
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return
                wait = (1.0 - self._tokens) / self.qps
            self.clock.sleep(wait)

    def saturation(self) -> float:
        with self._lock:
            self._refill()
            return 1.0 - self._tokens / self.burst


class FakeAlwaysRateLimiter:
    def try_accept(self) -> bool:
        return True

    def accept(self) -> None:
        pass

    def saturation(self) -> float:
        return 0.0
