"""Shard-kill soak: the mesh shard-failure acceptance harness.

Stands up the sharded scheduling pipeline on a node-axis mesh — one
IncrementalEncoder + BatchEngine over NodeMesh([device] * D), one shard lease
per device riding the LeaderElector CAS machinery, a ShardLeaseMonitor
as the engine's observer — then kills a SEEDED shard owner mid-tile
(chaos.ShardKillPlan, the same fixed-draw `schedule()==trace()`
contract as CrashPlan) and drives the full recovery protocol
(sched/device/shardfail.py):

  owner killed (renewals stop, no release) -> a tile dispatches
  against the doomed epoch vector and HOLDS in flight -> the lease
  record ages out on the monitor's FakeClock -> fence (CAS takeover,
  lease_transitions advances) -> survivor re-shard (encoder
  re-journals + re-epochs, engine rebuilds over the survivor mesh)
  -> the in-flight tile trips the shard-epoch fence, drops whole, its
  pods requeue head-of-line (the production FIFO's immediate re-add)
  -> the journal replay lands every row on its new owner at the next
  dispatch -> the remainder schedules on the survivors.

Gates (the shard-failure acceptance bar): lease expiry detected; slot
mapping re-sharded onto the survivors; journal replayed from full_gen
(every occupied row, materialized as the first post-reshard full
reseed); final bindings BIT-EXACT vs an unfailed run of the surviving
shape; zero duplicate bindings; zero bindings attributed to the dead
shard's stale epoch; `schedule()==trace()` seed replay. Any gate
violation fires a FlightRecorder bundle (obs/flightrec.py).

Everything runs in one process under a FakeClock — deterministic by
construction. DIVERGENCES #34 records what real-pod behavior this
emulation stands in for.

The port's copy: the mesh is NodeMesh([device] * D) — on the card the
sharded K1 runs every shard in one launch, K7 inside it; on the CPU
(device="cpu", as the tests pass) its plain twin runs shard by shard.
Every shard lives on the one device, so any D runs. A tile's assignment
comes to the host once, when the tile lands (_Pipeline.finalize), so
the tile dispatched before the lease expires is still in flight then.
"""

from __future__ import annotations

import json
import random
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from ..api.client import InProcClient
from ..api.registry import Registry
from ..chaos.crash import ShardKillChaos, ShardKillPlan
from ..core import types as api
from ..core.quantity import Quantity
from ..obs.flightrec import FlightRecorder
from ..sched.device import BatchEngine, NodeMesh
from ..sched.device.engine import resolve_device
from ..sched.device.incremental import IncrementalEncoder
from ..sched.device.shardfail import (ShardLeaseMonitor, ShardLeaseSet,
                                      reshard_survivors)
from ..utils.clock import FakeClock
from ..utils.metrics import MetricsRegistry

_MI = 1024 * 1024


def _soak_nodes(n: int) -> List[api.Node]:
    return [
        api.Node(
            metadata=api.ObjectMeta(
                name=f"shard-node-{i:03d}",
                labels={"zone": "a" if i % 2 else "b"}),
            status=api.NodeStatus(capacity={
                "cpu": Quantity(16000),
                "memory": Quantity(64 * 1024 * _MI * 1000),
                "pods": Quantity(110 * 1000)}))
        for i in range(n)]


def _soak_pods(n: int, seed: int) -> List[api.Pod]:
    rng = random.Random(f"{seed}:shard-soak:pods")
    return [
        api.Pod(
            metadata=api.ObjectMeta(name=f"shard-pod-{j:04d}",
                                    namespace="default",
                                    labels={"app": "shard-soak"}),
            spec=api.PodSpec(containers=[api.Container(
                name="c", image="img",
                resources=api.ResourceRequirements(requests={
                    "cpu": Quantity(rng.choice([100, 250, 500])),
                    "memory": Quantity(
                        rng.choice([64, 128, 256]) * _MI * 1000)}))]),
            status=api.PodStatus(phase="Pending"))
        for j in range(n)]


class _Pipeline:
    """Minimal deterministic tile pipeline over (encoder, engine):
    encode -> dispatch -> commit, with an explicit in-flight slot so a
    kill can land while a tile is genuinely mid-flight. Commits enforce
    the shard-epoch fence exactly like sched/batch.py _finalize."""

    def __init__(self, encoder: IncrementalEncoder, engine: BatchEngine,
                 tile: int):
        self.enc = encoder
        self.engine = engine
        self.tile = tile
        self.bound: Dict[str, str] = {}
        self.duplicates = 0
        self.stale_epoch_bindings = 0
        self.stale_epoch_drops = 0
        # (pods, EncodeResult, PendingAssignment)
        self.inflight = None

    def dispatch(self, pods: List[api.Pod]) -> None:
        assert self.inflight is None
        enc = self.enc.encode_tile(pods, [], [], pad_to=self.tile)
        assigned, _carry = self.engine.run_chunked(enc, self.tile,
                                                   block=False)
        self.inflight = (pods, enc, assigned)

    def finalize(self) -> List[api.Pod]:
        """Land the in-flight tile. Returns the pods to requeue
        head-of-line when the shard-epoch fence dropped it (empty on a
        normal commit)."""
        pods, enc, assigned = self.inflight
        self.inflight = None
        if enc.delta.shard_epochs != self.enc.shard_epochs():
            # the fence: dispatched against a dead shard's epoch
            self.stale_epoch_drops += 1
            return pods
        idx = assigned.result()[: enc.n_pods]  # the tile's one host read
        for j, pod in enumerate(pods):
            i = int(idx[j])
            if i < 0:
                continue
            if enc.delta.shard_epochs != self.enc.shard_epochs():
                self.stale_epoch_bindings += 1
                continue
            name = pod.metadata.name
            if name in self.bound:
                self.duplicates += 1
            else:
                self.bound[name] = enc.node_names[i]
        self.enc.assume_assigned(enc, pods, idx)
        return []


def _run_clean(devices, n_shards: int, nodes: List[api.Node],
               pods: List[api.Pod], tile: int,
               node_capacity: int) -> Dict[str, str]:
    """The unfailed reference at the surviving shape: same workload,
    same tile order, fresh encoder/engine over the survivor devices."""
    enc = IncrementalEncoder(node_capacity=node_capacity,
                             mesh_devices=n_shards)
    for node in nodes:
        enc.on_node_add(node)
    engine = BatchEngine(mesh=NodeMesh(devices))
    pipe = _Pipeline(enc, engine, tile)
    pending = list(pods)
    while pending:
        pipe.dispatch(pending[:tile])
        pending = pending[tile:]
        requeue = pipe.finalize()
        assert not requeue  # no chaos: nothing ever drops
    return pipe.bound


@dataclass
class ShardSoakResult:
    converged: bool = False
    detail: str = ""
    n_shards: int = 0
    survivors: int = 0
    n_nodes: int = 0
    n_pods: int = 0
    tile: int = 0
    seed: int = 0
    victims: List[int] = field(default_factory=list)
    #: shard -> bound-pod count at kill (the applied trace)
    trace: Dict[int, int] = field(default_factory=dict)
    schedule_replayed: bool = False
    lease_expiry_detected: bool = False
    fence_terms: List[int] = field(default_factory=list)
    reshards: int = 0
    replay_rows: int = 0
    journal_replayed: bool = False
    stale_epoch_drops: int = 0
    stale_epoch_bindings: int = 0
    duplicate_bindings: int = 0
    bound: int = 0
    parity_ok: bool = False
    flight_bundle: str = ""

    def as_dict(self) -> dict:
        return asdict(self)


def run_shard_kill_soak(n_shards: int = 4, n_nodes: int = 8,
                        n_pods: int = 48, tile: int = 8, seed: int = 0,
                        node_capacity: int = 64,
                        lease_duration: float = 3.0,
                        renew_period: float = 1.0,
                        flight_dir: Optional[str] = None,
                        metrics: Optional[MetricsRegistry] = None,
                        device=None) -> ShardSoakResult:
    """One deterministic shard-kill run; see the module docstring for
    the protocol. The mesh is NodeMesh([device] * n_shards); device
    None is the CUDA device and raises without one."""
    devs = [resolve_device(device)] * n_shards
    metrics = metrics or MetricsRegistry()
    res = ShardSoakResult(n_shards=n_shards, n_nodes=n_nodes,
                          n_pods=n_pods, tile=tile, seed=seed)

    clock = FakeClock()
    client = InProcClient(Registry())
    leases = ShardLeaseSet(client, n_shards, clock=clock,
                           lease_duration=lease_duration,
                           renew_deadline=lease_duration * 0.7,
                           retry_period=renew_period, metrics=metrics)
    if not leases.acquire_all():
        res.detail = "shard owners failed to acquire their leases"
        return res
    monitor = ShardLeaseMonitor(client, leases.lease_names(),
                                clock=clock,
                                lease_duration=lease_duration,
                                metrics=metrics)
    monitor.poll()  # baseline observation of every live lease

    nodes = _soak_nodes(n_nodes)
    pods = _soak_pods(n_pods, seed)
    encoder = IncrementalEncoder(node_capacity=node_capacity,
                                 mesh_devices=n_shards)
    for node in nodes:
        encoder.on_node_add(node)
    engine = BatchEngine(mesh=NodeMesh(devs))
    pipe = _Pipeline(encoder, engine, tile)

    plan = ShardKillPlan(seed=seed, n_shards=n_shards, kills=1)
    chaos = ShardKillChaos(plan, total=n_pods)
    res.victims = list(plan.victims())
    killed: set = set()

    def upkeep() -> List[int]:
        """One lease round: live owners renew, time advances, the
        monitor observes. Returns newly-expired shard indices."""
        leases.renew(skip=killed)
        clock.step(renew_period)
        return monitor.poll()

    pending = list(pods)
    reshard = None
    pre_reshard_full_tiles = 0
    # ---- phase 1: steady state up to the seeded kill point ----------
    while pending and chaos.pending():
        pipe.dispatch(pending[:tile])
        pending = pending[tile:]
        pending = pipe.finalize() + pending
        expired = upkeep()
        assert not expired, f"spurious expiry {expired} before the kill"
        point, victim = chaos.pending()[0]
        if len(pipe.bound) >= point:
            leases.kill(victim)
            killed.add(victim)
            chaos.record(victim, point)
    res.trace = chaos.trace()
    res.schedule_replayed = (res.trace == plan.schedule(n_pods)
                             and set(res.trace) == set(plan.victims()))
    if not killed:
        res.detail = "workload ended before any kill point"
        return res

    # ---- phase 2: a tile holds mid-flight while the lease ages out --
    if pending:
        pipe.dispatch(pending[:tile])
        pending = pending[tile:]
    dead: List[int] = []
    for _ in range(int(lease_duration / renew_period) + 2):
        dead = upkeep()
        if dead:
            break
    res.lease_expiry_detected = sorted(dead) == sorted(killed)
    if dead:
        pre_reshard_full_tiles = engine.upload_stats["full_tiles"]
        reshard = reshard_survivors(dead, monitor, encoder=encoder,
                                    engine=engine, metrics=metrics)
    if reshard is not None:
        res.fence_terms = list(reshard.fence_terms)
        res.survivors = reshard.survivors
        res.replay_rows = reshard.replay_rows
    res.reshards = int(metrics.counter("shard_reshards_total") or 0)
    if pipe.inflight is not None:
        pending = pipe.finalize() + pending  # the fence drops it whole

    # ---- phase 3: drain the remainder on the survivor mesh ----------
    while pending:
        pipe.dispatch(pending[:tile])
        pending = pending[tile:]
        pending = pipe.finalize() + pending
        upkeep()

    res.stale_epoch_drops = pipe.stale_epoch_drops
    res.stale_epoch_bindings = pipe.stale_epoch_bindings
    res.duplicate_bindings = pipe.duplicates
    res.bound = len(pipe.bound)
    # the replay materialized: every occupied row re-journaled, and the
    # first post-reshard dispatch reseeded the mirror via a full upload
    res.journal_replayed = (
        reshard is not None and res.replay_rows == n_nodes
        and engine.upload_stats["full_tiles"] > pre_reshard_full_tiles
        and int(metrics.counter("shard_replay_rows_total") or 0)
        == res.replay_rows)

    # ---- parity: bit-exact vs an unfailed run of the surviving shape
    surviving = [d for i, d in enumerate(devs) if i not in killed]
    clean = _run_clean(surviving, len(surviving), nodes, pods, tile,
                       node_capacity)
    res.parity_ok = pipe.bound == clean

    res.converged = (res.schedule_replayed and res.lease_expiry_detected
                     and reshard is not None
                     and res.journal_replayed
                     and res.stale_epoch_drops >= 1
                     and res.stale_epoch_bindings == 0
                     and res.duplicate_bindings == 0
                     and res.bound == n_pods
                     and res.parity_ok)
    if not res.converged:
        res.detail = res.detail or "shard-parity gate violated"
        if flight_dir:
            rec = FlightRecorder(flight_dir, clock=clock)
            bundle = rec.dump("shard-parity-gate", chaos=chaos,
                              extra=res.as_dict())
            res.flight_bundle = bundle or ""
    return res


def main() -> int:
    """JSON entry: one soak at the default shape, on the card (`--cpu`:
    on the CPU); exit 0 when it converged."""
    import argparse

    from ..utils.platform import pick_device
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true",
                    help="run the mesh on the CPU (default: the CUDA "
                         "device, which must be present)")
    args = ap.parse_args()
    result = run_shard_kill_soak(device=pick_device(args.cpu))
    print(json.dumps(result.as_dict(), sort_keys=True))
    return 0 if result.converged else 1


if __name__ == "__main__":
    raise SystemExit(main())
