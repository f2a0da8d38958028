"""Shard-failure tolerance for the sharded scheduling mesh.

Every mesh shard (one device slice of the node axis: block sharding
over stable slots, sched/device/mesh.py) is guarded by a LEASE riding the exact
CAS/fencing machinery HA leadership already uses
(utils/leaderelection.py over the `leases` resource): the shard's
owner runs an ordinary LeaderElector against `mesh-shard-<i>`, renewing
on its cadence; a dead host simply stops renewing. Nobody tells the
engine a host died — the engine OBSERVES it, the same way a standby
observes a dead leader: the lease record's resourceVersion stops
moving, and after `lease_duration` on the OBSERVER'S monotonic clock
the shard is expired (wall-clock jumps can neither kill nor revive a
shard, same rule as LeaderElector._observe).

Recovery is a three-step protocol, run between tiles (the scan itself
is never interrupted mid-dispatch):

  1. FENCE — the coordinator CAS-takes the dead shard's lease,
     advancing `lease_transitions` (utils/leaderelection.fence_lease).
     The term is the fencing token: a resurrecting owner's renew
     carries a stale resourceVersion and loses the CAS, so nothing it
     does under the old term can land after the fence. A fence that
     LOSES the CAS means the owner renewed after all — the shard is
     alive and drops out of the dead set.
  2. RE-SHARD — the stable slot->device mapping re-blocks onto the
     survivors: IncrementalEncoder.reshard() re-rounds capacity to a
     survivor multiple, re-journals every occupied slot, advances
     full_gen, and replaces the per-shard epoch vector; the engine
     drops its compiled programs and device mirror
     (BatchEngine.reshard). The next dispatch reseeds the mirror with
     one full sharded upload — the TableDelta journal replay
     materialized, every row landing on its new owner.
  3. DROP IN-FLIGHT — any tile dispatched against the old epoch vector
     is dropped whole and its pods requeued (sched/batch.py's
     shard-epoch fence in _finalize — the commit-time health gate at
     shard granularity). Zero bindings ever commit under a dead
     shard's stale epoch.

Metrics (pinned in utils/metrics.py SHARD_COUNTERS):
`shard_lease_transitions_total` per fence, `shard_reshards_total` per
applied re-shard, `shard_replay_rows_total` for the journal rows
rebuilt on survivors. tests/test_torch_shardfail.py gates on all three.

The port's copy of the JAX package's module: the engine's mesh is a
NodeMesh (sched/device/mesh.py), whose survivors() keeps the device
order as survivor_mesh did.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ...core.errors import Conflict, NotFound
from ...utils.clock import REAL, Clock
from ...utils.leaderelection import (LeaderElectionConfig, LeaderElector,
                                     fence_lease)
from ...utils.metrics import MetricsRegistry, global_metrics


def shard_lease_name(shard: int, prefix: str = "mesh-shard") -> str:
    return f"{prefix}-{shard}"


class ShardLeaseSet:
    """The OWNER side: one LeaderElector per mesh shard. On a real pod
    each host runs the elector for the shard(s) it owns; the single-box
    emulation runs all of them in one process and
    kills an owner by stopping its renewals — elector.kill(), the same
    no-release crash semantics the control-plane chaos uses."""

    def __init__(self, client, n_shards: int,
                 identity: str = "shard-owner",
                 prefix: str = "mesh-shard",
                 namespace: str = "kube-system",
                 lease_duration: float = 15.0,
                 renew_deadline: float = 10.0,
                 retry_period: float = 2.0,
                 clock: Optional[Clock] = None,
                 metrics: Optional[MetricsRegistry] = None):
        clock = clock or REAL
        self.namespace = namespace
        self.electors: List[LeaderElector] = [
            LeaderElector(
                client,
                LeaderElectionConfig(
                    lease_name=shard_lease_name(i, prefix),
                    identity=f"{identity}-{i}", namespace=namespace,
                    lease_duration=lease_duration,
                    renew_deadline=renew_deadline,
                    retry_period=retry_period, clock=clock),
                metrics=metrics)
            for i in range(n_shards)]

    def lease_names(self) -> List[str]:
        return [e.config.lease_name for e in self.electors]

    def acquire_all(self) -> bool:
        """One synchronous CAS round per shard (a deterministic caller
        drives renewal by hand instead of elector threads). True iff
        every shard's owner holds its lease after the round."""
        return all(e.try_acquire_or_renew() for e in self.electors)

    def renew(self, skip: Sequence[int] = ()) -> None:
        """Renew every live owner's lease; `skip` shards are dead hosts
        whose renewals simply never happen (their records age out on
        the observers' clocks)."""
        dead = set(skip)
        for i, e in enumerate(self.electors):
            if i not in dead:
                e.try_acquire_or_renew()

    def run_all(self) -> "ShardLeaseSet":
        for e in self.electors:
            e.run()
        return self

    def kill(self, shard: int) -> None:
        """Crash shard `shard`'s owner: renewals stop, NO release — the
        observers must wait out expiry, exactly like a real dead host."""
        self.electors[shard].kill()

    def stop(self) -> None:
        for e in self.electors:
            e.stop(release=False)


class ShardLeaseMonitor:
    """The OBSERVER side: the scheduling engine's view of the shard
    leases. poll() re-reads each lease and applies LeaderElector's
    observation rule — the clock resets only when the resourceVersion
    MOVES — so a dead owner's frozen record ages toward expiry on THIS
    process's monotonic clock no matter how often it is re-read.
    Shards are tracked by lease name; retire() drops fenced shards so
    survivor indices stay compact (and aligned with the re-blocked
    slot->device mapping)."""

    def __init__(self, client, lease_names: Sequence[str],
                 identity: str = "reshard-coordinator",
                 namespace: str = "kube-system",
                 lease_duration: float = 15.0,
                 clock: Optional[Clock] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.client = client
        self.identity = identity
        self.namespace = namespace
        self.lease_duration = lease_duration
        self.clock = clock or REAL
        self.metrics = metrics or global_metrics
        self._names: List[str] = list(lease_names)
        self._rv = {}       # lease name -> last observed resourceVersion
        self._at = {}       # lease name -> monotonic() when rv last moved
        self._term = {}     # lease name -> last observed lease_transitions

    @property
    def n_shards(self) -> int:
        return len(self._names)

    def poll(self) -> List[int]:
        """One observation round. Returns the indices (current shard
        numbering) of shards whose lease is EXPIRED on this monitor's
        clock: observed at least once, and unmoved for lease_duration.
        A lease never yet observed (owner still starting) is not
        judged; an unreadable one keeps its last observation and ages
        toward expiry like any other silence."""
        for name in self._names:
            try:
                lease = self.client.get("leases", name, self.namespace)
            except Exception:
                continue
            rv = lease.metadata.resource_version
            if rv != self._rv.get(name):
                self._rv[name] = rv
                self._at[name] = self.clock.monotonic()
                self._term[name] = lease.spec.lease_transitions
        now = self.clock.monotonic()
        return [i for i, name in enumerate(self._names)
                if name in self._at
                and now >= self._at[name] + self.lease_duration]

    def term(self, shard: int) -> int:
        """Last observed fencing term (lease_transitions) of a shard."""
        return self._term.get(self._names[shard], 0)

    def fence(self, shard: int) -> Optional[int]:
        """CAS-take the expired shard's lease under a new term. Returns
        the advanced term, or None when the CAS loses — the owner
        renewed between poll and fence, so the shard is NOT dead and
        must stay in the mesh."""
        name = self._names[shard]
        try:
            term = fence_lease(self.client, name, self.identity,
                               self.namespace)
        except (Conflict, NotFound):
            # re-observe immediately: the renew that beat us restarts
            # the shard's liveness window
            try:
                lease = self.client.get("leases", name, self.namespace)
                self._rv[name] = lease.metadata.resource_version
                self._at[name] = self.clock.monotonic()
                self._term[name] = lease.spec.lease_transitions
            except Exception:
                pass
            return None
        except Exception:
            return None
        self.metrics.inc("shard_lease_transitions_total", {"lease": name})
        self._term[name] = term
        return term

    def retire(self, shards: Sequence[int]) -> None:
        """Drop fenced shards from the watch set; the survivors compact
        in order, matching the re-blocked slot->device mapping."""
        gone = set(shards)
        self._names = [n for i, n in enumerate(self._names)
                       if i not in gone]


@dataclass
class ShardReshard:
    """One applied survivor re-shard, for gates and reports."""
    dead: Tuple[int, ...]           # shard indices, pre-reshard numbering
    dead_leases: Tuple[str, ...]
    fence_terms: Tuple[int, ...]    # advanced lease_transitions per fence
    survivors: int                  # shard count after the re-shard
    replay_rows: int                # journal rows rebuilt on survivors
    shard_epochs: Tuple[int, ...]   # encoder epoch vector after


def survivor_mesh(mesh, dead: Sequence[int]):
    """The mesh minus the dead shards' devices, order preserved (block
    shard s of the new mesh = the s'th surviving device); None when no
    shard survives."""
    return mesh.survivors(dead)


def reshard_survivors(dead: Sequence[int], monitor: ShardLeaseMonitor,
                      encoder=None, engine=None,
                      metrics: Optional[MetricsRegistry] = None
                      ) -> Optional[ShardReshard]:
    """The coordinator: fence the dead shards, then re-shard the slot
    mapping onto the survivors. Shards whose fence CAS loses (owner
    renewed after all) drop out; if none remain, no re-shard happens
    and None returns. Otherwise the encoder re-journals and re-epochs
    (journal replay from full_gen lands every occupied row on its new
    owner at the next dispatch), the engine rebuilds over the survivor
    mesh, and the fenced shards retire from the monitor."""
    metrics = metrics or global_metrics
    fenced: List[int] = []
    terms: List[int] = []
    for s in dead:
        term = monitor.fence(s)
        if term is not None:
            fenced.append(s)
            terms.append(term)
    if not fenced:
        return None
    names = tuple(monitor._names[s] for s in fenced)
    new_mesh = None
    survivors = max(1, monitor.n_shards - len(fenced))
    if engine is not None and engine.mesh is not None:
        new_mesh = survivor_mesh(engine.mesh, fenced)
        survivors = 1 if new_mesh is None else new_mesh.size
    replay = 0
    epochs: Tuple[int, ...] = ()
    if encoder is not None:
        replay = encoder.reshard(survivors)
        epochs = encoder.shard_epochs()
    if engine is not None:
        engine.reshard(new_mesh)
    monitor.retire(fenced)
    metrics.inc("shard_reshards_total")
    metrics.inc("shard_replay_rows_total", by=replay)
    return ShardReshard(dead=tuple(fenced), dead_leases=names,
                        fence_terms=tuple(terms), survivors=survivors,
                        replay_rows=replay, shard_epochs=epochs)
