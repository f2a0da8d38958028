"""Seeded, deterministic fault injection for any Client.

Determinism contract: every verb owns an independent RNG stream seeded
from `(plan.seed, verb)`, and each decision consumes a FIXED number of
draws — so the i-th call of a verb always gets the same (fault, delay)
decision for a given seed, regardless of how threads interleave calls
across verbs. `FaultPlan.schedule(verb, n)` replays the first n
decisions of a stream purely, and `ChaosClient.trace()` returns what a
live run actually drew — a run is reproducible when its trace equals
the schedule prefix (asserted by the chaos soak; see tests/test_chaos.py).

Faults fire on the REQUEST path, before the wrapped client is invoked:
an injected connection loss is a cleanly-lost request (the server never
saw it), so the soak's convergence invariants are about component
recovery, not about ambiguous-commit semantics — the retry matrix
(tests/test_retry.py) owns those.

Reference: the reference grows this as test/e2e/chaosmonkey; client-go
has no equivalent client wrapper (DIVERGENCES.md).
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..api.client import Client
from ..core.errors import ServiceUnavailable, TooManyRequests
from ..core.watch import Event, Watcher
from ..utils.clock import REAL, Clock

#: the injectable verb streams; batch/columnar variants draw from their
#: base verb's stream so a workload's fault schedule doesn't depend on
#: which transport shape (single vs batch) a component happens to use
VERBS = ("create", "get", "list", "update", "update_status", "patch",
         "delete", "watch", "bind")

_FAULT_CONNECTION = "connection"
_FAULT_429 = "429"
_FAULT_503 = "503"


@dataclass
class FaultPlan:
    """One seed, one reproducible fault schedule."""

    seed: int = 0
    #: probability an injectable call draws a fault (uniform over `faults`)
    error_rate: float = 0.0
    #: per-verb overrides of error_rate, e.g. {"watch": 0.2}
    verb_rates: Dict[str, float] = field(default_factory=dict)
    #: fault mix drawn from on a fault hit
    faults: Tuple[str, ...] = (_FAULT_CONNECTION, _FAULT_429, _FAULT_503)
    #: probability a call sleeps, and the max injected sleep (uniform)
    latency_rate: float = 0.0
    latency: float = 0.0
    #: cut every watch stream (ERROR + failed flag) after N delivered
    #: events; None = streams run until stopped or force-cut
    watch_cut_after: Optional[int] = None
    #: Retry-After seconds carried by injected 429s
    retry_after: float = 0.05

    def rate_for(self, verb: str) -> float:
        return self.verb_rates.get(verb, self.error_rate)

    def stream(self, verb: str) -> random.Random:
        # str seeding hashes via sha512 — stable across processes
        # (unlike hash(), which PYTHONHASHSEED salts)
        return random.Random(f"{self.seed}:{verb}")

    def draw(self, rng: random.Random, rate: float
             ) -> Tuple[Optional[str], float]:
        """One decision. Exactly four draws ALWAYS, so a decision is a
        pure function of (seed, verb, call index) — never of which
        branches earlier decisions took."""
        r_fault, r_pick = rng.random(), rng.random()
        r_lat, r_delay = rng.random(), rng.random()
        fault = None
        if self.faults and r_fault < rate:
            fault = self.faults[int(r_pick * len(self.faults))
                                % len(self.faults)]
        delay = 0.0
        if self.latency > 0 and r_lat < self.latency_rate:
            delay = r_delay * self.latency
        return fault, delay

    def schedule(self, verb: str, n: int) -> List[Optional[str]]:
        """The first n fault decisions of a verb's stream, replayed
        purely — what any run with this seed MUST have drawn."""
        rng = self.stream(verb)
        rate = self.rate_for(verb)
        return [self.draw(rng, rate)[0] for _ in range(n)]


class ChaosWatcher(Watcher):
    """Pass-through watcher that can be cut: after `cut_after` events
    (or a forced `cut()`), it reports an ERROR event and a `failed`
    flag — exactly the wire a mid-stream disconnect leaves behind, so
    reflectors exercise their reconnect path."""

    def __init__(self, inner: Watcher, cut_after: Optional[int] = None,
                 capacity: int = 100_000):
        super().__init__(capacity)
        self.inner = inner
        self.failed = False
        self._cut_after = cut_after
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def cut(self) -> None:
        """Force a mid-stream disconnect now."""
        self.failed = True
        self.send(Event("ERROR", ServiceUnavailable(
            "chaos: watch stream cut")))
        self.inner.stop()
        super().stop()

    def _pump(self):
        n = 0
        for ev in self.inner:
            if not self.send(ev):
                break
            n += 1
            if self._cut_after is not None and n >= self._cut_after:
                self.cut()
                return
        # propagate how the inner stream ended (an HTTP watcher's
        # failed flag must not be laundered into a clean stop)
        self.failed = self.failed or getattr(self.inner, "failed", False)
        self.inner.stop()
        super().stop()

    def stop(self) -> None:
        self.inner.stop()
        super().stop()


class ChaosClient(Client):
    """Wrap any Client with the plan's fault streams. Thread-safe; all
    non-verb capabilities delegate untouched."""

    def __init__(self, inner: Client, plan: FaultPlan,
                 clock: Optional[Clock] = None):
        self.inner = inner
        self.plan = plan
        # injected latency sleeps ride the clock so a FakeClock harness
        # can compress a latency-heavy plan without wall time passing
        self.clock = clock or REAL
        self._lock = threading.Lock()
        self._streams = {v: plan.stream(v) for v in VERBS}
        self._trace: Dict[str, List[Optional[str]]] = {v: [] for v in VERBS}
        self._watchers: List[ChaosWatcher] = []

    # ------------------------------------------------------------ controls

    def trace(self) -> Dict[str, List[Optional[str]]]:
        """Per-verb fault decisions actually drawn, in draw order."""
        with self._lock:
            return {v: list(t) for v, t in self._trace.items()}

    def cut_watches(self) -> int:
        """Force-cut every live watch stream (the 'apiserver dropped
        its connections' moment). Returns how many were cut."""
        with self._lock:
            live = [w for w in self._watchers if not w.stopped]
            self._watchers = []
        for w in live:
            w.cut()
        return len(live)

    # ------------------------------------------------------------ plumbing

    def _inject(self, verb: str) -> None:
        with self._lock:
            rng = self._streams[verb]
            fault, delay = self.plan.draw(rng, self.plan.rate_for(verb))
            self._trace[verb].append(fault)
        if delay > 0:
            self.clock.sleep(delay)
        if fault == _FAULT_429:
            err = TooManyRequests("chaos: injected 429 burst")
            err.retry_after = self.plan.retry_after
            raise err
        if fault == _FAULT_503:
            raise ServiceUnavailable("chaos: injected 503")
        if fault == _FAULT_CONNECTION:
            raise ConnectionError("chaos: injected connection loss")

    # --------------------------------------------------------------- verbs

    def create(self, resource, obj, namespace=""):
        self._inject("create")
        return self.inner.create(resource, obj, namespace)

    def create_batch(self, resource, objs, namespace=""):
        self._inject("create")
        return self.inner.create_batch(resource, objs, namespace)

    def create_from_template(self, resource, template, names, namespace=""):
        self._inject("create")
        return self.inner.create_from_template(resource, template, names,
                                               namespace)

    def get(self, resource, name, namespace=""):
        self._inject("get")
        return self.inner.get(resource, name, namespace)

    def get_scale(self, resource, name, namespace=""):
        self._inject("get")
        return self.inner.get_scale(resource, name, namespace)

    def list(self, resource, namespace="", label_selector="",
             field_selector=""):
        self._inject("list")
        return self.inner.list(resource, namespace, label_selector,
                               field_selector)

    def update(self, resource, obj, namespace=""):
        self._inject("update")
        return self.inner.update(resource, obj, namespace)

    def update_scale(self, resource, name, scale, namespace=""):
        self._inject("update")
        return self.inner.update_scale(resource, name, scale, namespace)

    def finalize_namespace(self, obj):
        self._inject("update")
        return self.inner.finalize_namespace(obj)

    def update_status(self, resource, obj, namespace=""):
        self._inject("update_status")
        return self.inner.update_status(resource, obj, namespace)

    def update_status_batch(self, resource, objs, namespace=""):
        self._inject("update_status")
        return self.inner.update_status_batch(resource, objs, namespace)

    def patch(self, resource, name, patch_body, namespace="",
              patch_type="application/strategic-merge-patch+json"):
        self._inject("patch")
        return self.inner.patch(resource, name, patch_body, namespace,
                                patch_type)

    def delete(self, resource, name, namespace="",
               grace_period_seconds=None, uid=None):
        self._inject("delete")
        return self.inner.delete(
            resource, name, namespace,
            grace_period_seconds=grace_period_seconds, uid=uid)

    def bind(self, binding, namespace=""):
        self._inject("bind")
        return self.inner.bind(binding, namespace)

    def bind_batch(self, bindings, namespace=""):
        self._inject("bind")
        return self.inner.bind_batch(bindings, namespace)

    def bind_batch_hosts(self, assignments):
        self._inject("bind")
        return self.inner.bind_batch_hosts(assignments)

    def watch(self, resource, namespace="", since_rev=None,
              label_selector="", field_selector=""):
        self._inject("watch")
        inner = self.inner.watch(resource, namespace, since_rev,
                                 label_selector, field_selector)
        w = ChaosWatcher(inner, cut_after=self.plan.watch_cut_after)
        with self._lock:
            self._watchers = [x for x in self._watchers
                              if not x.stopped] + [w]
        return w

    # -------------------------------------------- untouched capabilities

    def pod_logs(self, name, namespace="default", container="",
                 tail_lines=0, previous=False):
        return self.inner.pod_logs(name, namespace, container,
                                   tail_lines, previous)

    def pod_logs_stream(self, name, namespace="default", container=""):
        return self.inner.pod_logs_stream(name, namespace, container)

    def node_proxy(self, node_name, path):
        return self.inner.node_proxy(node_name, path)

    def __getattr__(self, name: str) -> Any:
        # transport extras (portforward_open, registry, ...) delegate;
        # __getattr__ only fires for names not found on ChaosClient
        return getattr(self.inner, name)
