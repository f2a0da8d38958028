"""Lease-based leader election over the leases resource.

Reference: the v1.1 reference elects its master through a raw
etcd compare-and-swap seam (the "master election" TODO around
cmd/kube-controller-manager); the later reference grew that seam into
client-go's tools/leaderelection over coordination/v1 Leases. This is
that design forward-ported: acquire/renew/release are CAS PUTs keyed
on the lease's resourceVersion, so two electors racing for the same
expired lease resolve to exactly one winner at the store.

Liveness is judged on each elector's LOCAL monotonic clock
(utils/clock.py monotonic()): an elector records WHEN it last saw the
lease record change (`_observed_at`) and treats the holder as live
until `observed_at + lease_duration` on that axis. The wall-clock
renewTime/acquireTime fields on the Lease are informational only — a
backwards time.time() step can neither drop nor extend leadership
(tests/test_leaderelection.py's wall-jump regression).

Fencing: `spec.lease_transitions` increments on every holder CHANGE
(never on renewal) — the term. At most one holder can exist per term,
because entering a term requires winning the CAS that increments it.
Downstream actors that must not act on behalf of a dead leader compare
terms (`elector.term`).

Metrics: `leader_transitions_total` on every acquisition,
`lease_renew_failures_total` on every failed renew attempt — both
asserted by the crash-soak gates (tests/test_chaos.py).
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Optional

from ..core import types as api
from ..core.errors import Conflict, NotFound
from .clock import Clock, RealClock
from .metrics import MetricsRegistry, global_metrics

logger = logging.getLogger(__name__)


@dataclass
class LeaderElectionConfig:
    """Timing knobs, with the reference's default proportions
    (leaderelection.go: 15s/10s/2s)."""
    lease_name: str
    identity: str
    namespace: str = "kube-system"
    #: how long a holder is presumed live after its last observed change
    lease_duration: float = 15.0
    #: a leader that cannot renew within this window of its last
    #: successful renewal steps down (must be < lease_duration, so the
    #: old leader demotes itself before a standby can win the lease)
    renew_deadline: float = 10.0
    #: how often candidates retry acquisition / leaders renew
    retry_period: float = 2.0
    clock: Clock = field(default_factory=RealClock)


class LeaderElector:
    """Acquire/renew/release a Lease via CAS; run callbacks on
    leadership transitions. One elector = one candidate process."""

    def __init__(self, client, config: LeaderElectionConfig,
                 on_started_leading: Optional[Callable[[int], None]] = None,
                 on_stopped_leading: Optional[Callable[[], None]] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.client = client
        self.config = config
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.metrics = metrics or global_metrics
        self._leading = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: fencing term of the CURRENT (or last) leadership
        self.term = 0
        # what this elector last saw on the lease record, and WHEN on
        # its local monotonic clock — the only liveness authority
        self._observed_rv = ""
        self._observed_holder = ""
        self._observed_at = 0.0

    # ------------------------------------------------------------ state

    @property
    def is_leader(self) -> bool:
        return self._leading.is_set()

    # ------------------------------------------------------- lease verbs

    def _observe(self, lease: api.Lease) -> None:
        """Track record changes; the observation clock only resets when
        the resourceVersion MOVES (a dead holder's unchanged record
        ages toward expiry no matter how often we re-read it)."""
        if lease.metadata.resource_version != self._observed_rv:
            self._observed_rv = lease.metadata.resource_version
            self._observed_holder = lease.spec.holder_identity
            self._observed_at = self.config.clock.monotonic()

    def try_acquire_or_renew(self) -> bool:
        """One CAS round: create the lease if absent, renew it if held
        by us, take it over if the holder's lease has expired on OUR
        monotonic clock. Returns True iff we hold the lease after the
        round. Any API failure or lost CAS returns False — the caller
        retries on its cadence."""
        c = self.config
        now_mono = c.clock.monotonic()
        wall = api.now_rfc3339()
        try:
            lease = self.client.get("leases", c.lease_name, c.namespace)
        except NotFound:
            fresh = api.Lease(
                metadata=api.ObjectMeta(name=c.lease_name,
                                        namespace=c.namespace),
                spec=api.LeaseSpec(
                    holder_identity=c.identity,
                    lease_duration_seconds=int(c.lease_duration),
                    acquire_time=wall, renew_time=wall,
                    lease_transitions=1))
            try:
                created = self.client.create("leases", fresh, c.namespace)
            except Exception:
                return False  # raced another creator (or API fault)
            self._observe(created)
            self.term = created.spec.lease_transitions
            return True
        except Exception:
            return False  # API fault: indistinguishable from a race
        self._observe(lease)
        held_by_us = lease.spec.holder_identity == c.identity
        if not held_by_us and lease.spec.holder_identity:
            if now_mono < self._observed_at + c.lease_duration:
                return False  # holder still presumed live
        spec_fields = dict(holder_identity=c.identity, renew_time=wall)
        if not held_by_us:
            # taking over: new term (fencing), fresh acquire stamp
            spec_fields["acquire_time"] = wall
            spec_fields["lease_transitions"] = \
                lease.spec.lease_transitions + 1
        updated = replace(lease, spec=replace(lease.spec, **spec_fields))
        try:
            # the PUT carries lease.metadata.resource_version: the
            # store's CAS picks exactly one winner among racers
            out = self.client.update("leases", updated, c.namespace)
        except Conflict:
            return False  # lost the race; re-observe next round
        except Exception:
            return False
        self._observe(out)
        self.term = out.spec.lease_transitions
        return True

    def release(self) -> None:
        """Clean handoff on voluntary shutdown: empty the holder so a
        standby acquires immediately instead of waiting out the lease.
        A crashed process never gets here — that's what expiry is for."""
        c = self.config
        try:
            lease = self.client.get("leases", c.lease_name, c.namespace)
            if lease.spec.holder_identity != c.identity:
                return
            self.client.update(
                "leases",
                replace(lease, spec=replace(lease.spec,
                                            holder_identity="")),
                c.namespace)
        except Exception:
            pass

    # -------------------------------------------------------------- run

    def run(self) -> "LeaderElector":
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"elector-{self.config.lease_name}-{self.config.identity}")
        self._thread.start()
        return self

    def stop(self, release: bool = True) -> None:
        """Voluntary shutdown: stop the loop, demote, optionally hand
        the lease off."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        if self._leading.is_set():
            self._demote()
        if release:
            self.release()

    def kill(self) -> None:
        """Simulated process death (chaos/crash.py): the loop stops and
        NO lease release happens — successors must wait out expiry and
        win the CAS, the same path a real crash leaves behind. The
        leading flag drops so a zombie component wired to is_leader
        stops acting, but on_stopped_leading does NOT run (a dead
        process runs nothing)."""
        self._stop.set()
        self._leading.clear()

    def _demote(self) -> None:
        self._leading.clear()
        if self.on_stopped_leading is not None:
            try:
                self.on_stopped_leading()
            except Exception:
                logger.exception("on_stopped_leading failed")

    def _run(self) -> None:
        c = self.config
        while not self._stop.is_set():
            # candidate phase
            while not self._stop.is_set():
                if self.try_acquire_or_renew():
                    break
                c.clock.sleep(c.retry_period)
            if self._stop.is_set():
                return
            self.metrics.inc("leader_transitions_total",
                             {"name": c.lease_name})
            self._leading.set()
            if self.on_started_leading is not None:
                try:
                    self.on_started_leading(self.term)
                except Exception:
                    logger.exception("on_started_leading failed")
            # leader phase: renew on the retry cadence; step down when
            # the last successful renewal ages past renew_deadline on
            # the monotonic clock
            last_renew = c.clock.monotonic()
            while not self._stop.is_set():
                c.clock.sleep(c.retry_period)
                if self._stop.is_set():
                    break
                if self.try_acquire_or_renew():
                    last_renew = c.clock.monotonic()
                else:
                    self.metrics.inc("lease_renew_failures_total",
                                     {"name": c.lease_name})
                    if (c.clock.monotonic() - last_renew
                            >= c.renew_deadline):
                        logger.warning(
                            "%s: lost leadership of %s (renew deadline)",
                            c.identity, c.lease_name)
                        self._demote()
                        break


def fence_lease(client, lease_name: str, identity: str,
                namespace: str = "kube-system") -> int:
    """One CAS takeover of a lease the caller has ALREADY judged
    expired on its own monotonic clock: write `identity` as holder and
    advance `lease_transitions` — the fencing term. The dead owner's
    next renew (if it resurrects) carries a stale resourceVersion and
    loses the CAS, so no action taken under the old term can land
    after this returns. Returns the new term; raises Conflict when the
    CAS loses (the holder renewed after all — NOT expired) and
    NotFound when the lease never existed.

    This is the reshard coordinator's half of the shard-lease protocol
    (sched/device/shardfail.py): shard owners run ordinary
    LeaderElectors, the coordinator fences a dead shard before
    re-sharding its slots onto the survivors."""
    lease = client.get("leases", lease_name, namespace)
    wall = api.now_rfc3339()
    updated = replace(lease, spec=replace(
        lease.spec, holder_identity=identity, acquire_time=wall,
        renew_time=wall,
        lease_transitions=lease.spec.lease_transitions + 1))
    out = client.update("leases", updated, namespace)
    return out.spec.lease_transitions
