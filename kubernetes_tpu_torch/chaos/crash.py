"""Seeded control-plane process-crash injection.

Determinism contract — the same fixed-draw discipline as `FaultPlan`
(injector.py) and `NodeFaultPlan` (nodes.py): every crash target owns
an independent RNG stream seeded from `(plan.seed, target)`, and its
kill point is ONE uniform draw mapped into the plan's progress window,
so WHERE each process dies is a pure function of (seed, target,
workload size) — independent of thread interleaving or how many draws
other streams consumed. `schedule(total)` replays what any live run
with this seed MUST select; `CrashChaos.trace()` records what a run
actually applied, and the crash soak gates on the two being equal
(tests/test_chaos.py), bit-reproducibly across invocations.

Progress is measured in BOUND PODS, not wall time: "kill the apiserver
after the 11th binding" replays exactly, where "kill at t=3.2s" never
would. The crash soak (the JAX package's kubemark/crash_soak.py; the
port's waits for the HTTP plane) applies each kill as the bound count
crosses its point:

  apiserver            mid-commit-storm; the WAL-backed store recovers
                       (Store.recover) and a fresh server takes the
                       same port — watchers re-list, fleet reconverges
  scheduler            the ACTIVE elector's process dies mid-batch; the
                       standby waits out the lease and binds the
                       remainder (zero duplicate bindings via CAS)
  controller-manager   the active manager dies; the standby resumes
                       replication/eviction under a new fencing term

Reference: the reference grows this as test/e2e/chaosmonkey's
component killer; v1.1 has no equivalent — see DIVERGENCES.md.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Tuple

#: the crashable control-plane processes, in no particular order — the
#: ORDER kills fire in comes from each target's drawn point
TARGETS = ("apiserver", "scheduler", "controller-manager")


@dataclass
class CrashPlan:
    """One seed, one reproducible crash schedule."""

    seed: int = 0
    targets: Tuple[str, ...] = TARGETS
    #: each kill point lands in [window[0], window[1]) of the workload
    window: Tuple[float, float] = (0.25, 0.8)

    def stream(self, target: str) -> random.Random:
        # str seeding hashes via sha512 — stable across processes
        # (same rule as FaultPlan.stream / NodeFaultPlan.stream)
        return random.Random(f"{self.seed}:crash:{target}")

    def fraction(self, target: str) -> float:
        """The target's kill point as a workload fraction: exactly ONE
        draw from its stream, always."""
        lo, hi = self.window
        return lo + self.stream(target).random() * (hi - lo)

    def kill_point(self, target: str, total: int) -> int:
        """Bound-pod count at which the target dies. Clamped inside
        (0, total) so every kill observably interrupts the run."""
        return min(max(int(self.fraction(target) * total), 1), total - 1)

    def schedule(self, total: int) -> Dict[str, int]:
        """What a live run with this seed MUST select — the pure replay
        the reproducibility gate compares a trace against."""
        return {t: self.kill_point(t, total) for t in self.targets}

    def order(self, total: int) -> List[Tuple[int, str]]:
        """Kill events sorted by firing point (ties broken by target
        name, deterministically)."""
        return sorted((p, t) for t, p in self.schedule(total).items())


class CrashChaos:
    """Apply a CrashPlan, recording a trace of what actually fired."""

    def __init__(self, plan: CrashPlan, total: int):
        self.plan = plan
        self.total = total
        self._trace: Dict[str, int] = {}

    def pending(self) -> List[Tuple[int, str]]:
        """Kill events not yet applied, in firing order."""
        return [(p, t) for p, t in self.plan.order(self.total)
                if t not in self._trace]

    def record(self, target: str, point: int) -> None:
        self._trace[target] = point

    def trace(self) -> Dict[str, int]:
        """Kill points actually applied — a run is reproducible when
        this equals plan.schedule(total) for every fired target."""
        return dict(self._trace)


@dataclass
class ShardKillPlan:
    """Seeded MESH-shard kill schedule: which shard owners die, and at
    which bound-pod count — the data-plane sibling of CrashPlan's
    control-plane kills, under the identical determinism contract.

    Each shard owns an independent stream seeded from
    `(seed, "shard", index)`, and that stream is drawn from exactly
    ONCE; the single uniform serves both decisions. Victim selection:
    the `kills` shards with the SMALLEST draws (ties by index) die —
    every shard's fate is a pure function of (seed, n_shards, kills),
    independent of interleaving. Kill point: the victim's same draw
    maps into the progress window, measured in BOUND PODS like every
    other plan (replays exactly; wall time never would).
    `schedule(total)` is the pure replay the shard-kill soak
    (kubemark/shard_soak.py) gates a live trace against."""

    seed: int = 0
    n_shards: int = 4
    kills: int = 1
    #: each kill point lands in [window[0], window[1]) of the workload
    window: Tuple[float, float] = (0.25, 0.8)

    def stream(self, shard: int) -> random.Random:
        # str seeding hashes via sha512 — stable across processes
        return random.Random(f"{self.seed}:shard:{shard}")

    def draw(self, shard: int) -> float:
        """The shard's ONE uniform draw, always."""
        return self.stream(shard).random()

    def victims(self) -> Tuple[int, ...]:
        """The shards that die: smallest draws first, ties by index,
        ascending shard order in the result."""
        k = max(0, min(self.kills, self.n_shards - 1))
        ranked = sorted(range(self.n_shards),
                        key=lambda s: (self.draw(s), s))
        return tuple(sorted(ranked[:k]))

    def fraction(self, shard: int) -> float:
        lo, hi = self.window
        return lo + self.draw(shard) * (hi - lo)

    def kill_point(self, shard: int, total: int) -> int:
        """Bound-pod count at which the shard's owner dies. Clamped
        inside (0, total) so the kill observably interrupts the run."""
        return min(max(int(self.fraction(shard) * total), 1), total - 1)

    def schedule(self, total: int) -> Dict[int, int]:
        """What a live run with this seed MUST select."""
        return {s: self.kill_point(s, total) for s in self.victims()}

    def order(self, total: int) -> List[Tuple[int, int]]:
        """Kill events sorted by firing point (ties by shard index)."""
        return sorted((p, s) for s, p in self.schedule(total).items())


class ShardKillChaos:
    """Apply a ShardKillPlan, recording a trace of what actually fired
    — same reproducibility gate shape as CrashChaos."""

    def __init__(self, plan: ShardKillPlan, total: int):
        self.plan = plan
        self.total = total
        self._trace: Dict[int, int] = {}

    def pending(self) -> List[Tuple[int, int]]:
        """Kill events not yet applied, in firing order."""
        return [(p, s) for p, s in self.plan.order(self.total)
                if s not in self._trace]

    def record(self, shard: int, point: int) -> None:
        self._trace[shard] = point

    def trace(self) -> Dict[int, int]:
        """Kill points actually applied — reproducible when equal to
        plan.schedule(total) for every fired shard."""
        return dict(self._trace)
