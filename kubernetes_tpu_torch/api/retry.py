"""Client-side resilience for the API plane: retry policy + breaker.

Reference: client-go's request retry machinery (rest/request.go
Retry-After handling, util/flowcontrol backoff), reduced to the pieces
this control plane needs — no per-request flowcontrol, one
consecutive-failure circuit breaker per client (DIVERGENCES.md).

Error classification:
  - 429/503 API responses are UNAMBIGUOUS: the server answered without
    committing the verb (the 429 shed happens before routing; a 503
    found no backend to hand the request to). Every verb retries them,
    honoring a server-sent Retry-After.
  - Connection-class failures (URLError, reset, timeout) are AMBIGUOUS:
    the request may or may not have committed server-side. Only
    idempotent requests retry — GET/LIST, DELETE carrying a uid
    precondition, PUT carrying a resourceVersion (a replayed commit
    surfaces as Conflict, a real signal callers already handle). A bare
    POST is never replayed: a duplicate create is not idempotent.

The breaker counts CONSECUTIVE connection-class failures only — any
HTTP response (even an error status) proves the server alive and
resets it. Once open, calls fast-fail without touching the socket; at
most one caller per probe interval GETs /healthz, and a healthy answer
closes the breaker.
"""

from __future__ import annotations

import http.client
import threading
from typing import Callable, Optional

from ..core.errors import ServiceUnavailable
from ..utils.clock import REAL, Clock

#: API status codes every verb may retry (see module docstring).
RETRYABLE_CODES = (429, 503)

#: ambiguous transport failures (urllib.error.URLError is an OSError;
#: socket.timeout, ConnectionError, RemoteDisconnected all land here)
CONNECTION_ERRORS = (OSError, http.client.HTTPException)


class CircuitBreaker:
    """Consecutive-failure breaker with a rate-limited /healthz probe.

    threshold <= 0 disables the breaker entirely (allow() is always
    True and failures are not counted)."""

    def __init__(self, threshold: int = 5, probe_interval: float = 1.0,
                 clock: Optional[Clock] = None):
        self.threshold = threshold
        self.probe_interval = probe_interval
        # all breaker timing is on Clock.monotonic(): probe pacing must
        # not stretch or collapse under a wall-clock step
        self.clock = clock or REAL
        self._lock = threading.Lock()
        self._failures = 0
        self._open = False
        self._next_probe = 0.0

    @property
    def open(self) -> bool:
        return self._open

    def record_failure(self) -> None:
        if self.threshold <= 0:
            return
        with self._lock:
            self._failures += 1
            if self._failures >= self.threshold and not self._open:
                self._open = True
                # probe allowed at once
                self._next_probe = self.clock.monotonic()

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._open = False

    def allow(self, probe: Optional[Callable[[], bool]] = None) -> bool:
        """True if a call may proceed. When open, at most one caller
        per probe_interval runs `probe()`; a healthy probe closes the
        breaker and admits the caller."""
        if not self._open:
            return True
        with self._lock:
            if not self._open:
                return True
            now = self.clock.monotonic()
            if now < self._next_probe:
                return False
            self._next_probe = now + self.probe_interval
        if probe is not None and probe():
            self.record_success()
            return True
        return False


class RetryPolicy:
    """Jittered exponential backoff under a per-call deadline budget.

    seed: fix the jitter stream (chaos/determinism harnesses); None
    draws from the process RNG.

    clock: a utils/clock.Clock — deadline budgets and backoff pacing
    run on its monotonic() axis, so a wall-clock step (NTP correction,
    VM migration) can neither starve a call of its budget nor grant it
    extra attempts, the same jump-immunity contract leader election
    holds (tests/test_retry.py pins it with FakeClock.jump_wall).
    sleep: overrides clock.sleep (tests that only count delays).
    """

    def __init__(self, max_attempts: int = 4,
                 initial_backoff: float = 0.05, max_backoff: float = 2.0,
                 deadline: float = 30.0, jitter: float = 0.5,
                 breaker_threshold: int = 5,
                 breaker_probe_interval: float = 1.0,
                 seed=None, sleep: Optional[Callable] = None,
                 clock: Optional[Clock] = None):
        import random
        self.max_attempts = max(1, max_attempts)
        self.initial_backoff = initial_backoff
        self.max_backoff = max_backoff
        self.deadline = deadline
        self.jitter = jitter
        self.breaker_threshold = breaker_threshold
        self.breaker_probe_interval = breaker_probe_interval
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        self.clock = clock or REAL
        self.sleep = sleep or self.clock.sleep

    @classmethod
    def disabled(cls) -> "RetryPolicy":
        """A policy that never retries and never opens the breaker."""
        return cls(max_attempts=1, breaker_threshold=0)

    def make_breaker(self) -> CircuitBreaker:
        return CircuitBreaker(self.breaker_threshold,
                              self.breaker_probe_interval, self.clock)

    def _delay(self, attempt: int,
               retry_after: Optional[float]) -> float:
        base = min(self.max_backoff,
                   self.initial_backoff * (2.0 ** (attempt - 1)))
        with self._rng_lock:
            delay = base * (1.0 + self.jitter * self._rng.random())
        if retry_after:
            # the server named a floor; jittered backoff may exceed it
            delay = max(delay, float(retry_after))
        return delay

    def call(self, fn: Callable, idempotent: bool = False,
             breaker: Optional[CircuitBreaker] = None,
             probe: Optional[Callable[[], bool]] = None):
        """Run fn() under this policy. fn must raise ApiError for HTTP
        status failures and a CONNECTION_ERRORS member for transport
        failures; anything else propagates unretried."""
        from ..core.errors import ApiError
        deadline = (self.clock.monotonic() + self.deadline
                    if self.deadline else None)
        attempt = 0
        while True:
            attempt += 1
            if breaker is not None and not breaker.allow(probe):
                raise ServiceUnavailable(
                    "circuit breaker open: apiserver unreachable "
                    "(awaiting healthy /healthz probe)")
            try:
                result = fn()
            except ApiError as e:
                # any HTTP response proves the server alive
                if breaker is not None:
                    breaker.record_success()
                if e.code not in RETRYABLE_CODES \
                        or attempt >= self.max_attempts:
                    raise
                delay = self._delay(attempt,
                                    getattr(e, "retry_after", None))
                if deadline is not None \
                        and self.clock.monotonic() + delay > deadline:
                    raise
                self.sleep(delay)
            except CONNECTION_ERRORS:
                if breaker is not None:
                    breaker.record_failure()
                if not idempotent or attempt >= self.max_attempts:
                    raise
                delay = self._delay(attempt, None)
                if deadline is not None \
                        and self.clock.monotonic() + delay > deadline:
                    raise
                self.sleep(delay)
            else:
                if breaker is not None:
                    breaker.record_success()
                return result
