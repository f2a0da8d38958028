"""Seeded node-fault injection: kill / heartbeat-freeze / flap plans
driving a HollowFleet.

Determinism contract — the same fixed-draw discipline as `FaultPlan`
(injector.py): every fault class owns an independent RNG stream seeded
from `(plan.seed, purpose)`, and victim selection is ONE `sample` draw
over the SORTED node-name list, so the set of nodes a plan kills,
freezes or flaps is a pure function of (seed, node names, fraction) —
independent of thread interleaving, registration order, or how many
times other streams were consumed. `schedule(names)` replays what any
live run with this seed MUST have drawn; `NodeChaos.trace()` returns
what a run actually did, and the node-kill soak gates on the two being
equal (tests/test_chaos.py).

The flap schedule's TIMING is wall-clock (a background toggler), like
every other latency in the harness; the determinism contract covers
victim selection, not toggle phase.

Reference: the reference grows this as test/e2e/chaosmonkey's node
killer (ChaosMonkey + e2e framework's RestartNodes); v1.1 has no
equivalent — see DIVERGENCES.md.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional


@dataclass
class NodeFaultPlan:
    """One seed, one reproducible node-fault schedule."""

    seed: int = 0
    #: fraction of the fleet hard-killed (heartbeats + pod confirms stop)
    kill_fraction: float = 0.0
    #: fraction whose heartbeats freeze (partition sim; kubelet alive)
    freeze_fraction: float = 0.0
    #: fraction that flaps Ready<->NotReady while flapping runs
    flap_fraction: float = 0.0
    #: seconds between flap toggles
    flap_period: float = 0.5

    def stream(self, purpose: str) -> random.Random:
        # str seeding hashes via sha512 — stable across processes
        # (same rule as FaultPlan.stream)
        return random.Random(f"{self.seed}:node:{purpose}")

    def _pick(self, purpose: str, names: Iterable[str],
              fraction: float) -> List[str]:
        """Deterministic victims: one sample draw over sorted names."""
        pool = sorted(names)
        k = int(len(pool) * fraction)
        if k <= 0:
            return []
        return sorted(self.stream(purpose).sample(pool, k))

    def kill_set(self, names: Iterable[str]) -> List[str]:
        return self._pick("kill", names, self.kill_fraction)

    def freeze_set(self, names: Iterable[str]) -> List[str]:
        return self._pick("freeze", names, self.freeze_fraction)

    def flap_set(self, names: Iterable[str]) -> List[str]:
        return self._pick("flap", names, self.flap_fraction)

    def schedule(self, names: Iterable[str]) -> Dict[str, List[str]]:
        """What a live run with this seed MUST select — the pure replay
        the reproducibility gate compares a trace against."""
        names = list(names)
        return {"kill": self.kill_set(names),
                "freeze": self.freeze_set(names),
                "flap": self.flap_set(names)}


class NodeChaos:
    """Drive a HollowFleet from a NodeFaultPlan, recording a trace."""

    def __init__(self, fleet, plan: NodeFaultPlan):
        self.fleet = fleet
        self.plan = plan
        self._trace: Dict[str, List[str]] = {"kill": [], "freeze": [],
                                             "flap": []}
        self._flap_stop = threading.Event()
        self._flap_thread: Optional[threading.Thread] = None

    def trace(self) -> Dict[str, List[str]]:
        """Victim sets actually applied — a run is reproducible when
        this equals plan.schedule(fleet.node_names()) for every fault
        class the run triggered."""
        return {k: list(v) for k, v in self._trace.items()}

    def kill(self) -> List[str]:
        """Hard-kill the plan's kill set; returns the victims."""
        victims = self.plan.kill_set(self.fleet.node_names())
        self._trace["kill"] = self.fleet.kill_nodes(victims)
        return self._trace["kill"]

    def freeze(self) -> List[str]:
        """Freeze the plan's freeze set's heartbeats (partition sim)."""
        victims = self.plan.freeze_set(self.fleet.node_names())
        self.fleet.freeze_heartbeats(victims)
        self._trace["freeze"] = victims
        return victims

    def thaw(self) -> None:
        """End the partition: frozen heartbeats resume."""
        self.fleet.thaw_heartbeats(self._trace["freeze"])

    def start_flapping(self) -> List[str]:
        """Background toggler: the plan's flap set bounces
        Ready<->NotReady every flap_period (heartbeats keep flowing —
        the controller sees honest, rapid condition flips)."""
        victims = self.plan.flap_set(self.fleet.node_names())
        self._trace["flap"] = victims
        if not victims:
            return victims

        def toggle():
            down = False
            while not self._flap_stop.wait(self.plan.flap_period):
                down = not down
                self.fleet.set_not_ready(victims, down)

        self._flap_thread = threading.Thread(target=toggle, daemon=True,
                                             name="node-chaos-flap")
        self._flap_thread.start()
        return victims

    def stop_flapping(self) -> None:
        self._flap_stop.set()
        if self._flap_thread is not None:
            self._flap_thread.join(timeout=5)
        if self._trace["flap"]:
            self.fleet.set_not_ready(self._trace["flap"], False)

    def stop(self) -> None:
        self.stop_flapping()
