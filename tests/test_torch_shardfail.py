"""The port's shard-failure tolerance (kubernetes_tpu_torch/sched/device/
shardfail.py over utils/leaderelection.py): the counterparts of the JAX
package's test_shard_failure.py gates (the lease expiry, fence and
resurrection machinery under a FakeClock, the encoder's re-journal, the
survivor mesh, the coordinator end to end, the engine cache's epoch
fence and the detached-encoder rule) against a NodeMesh of CPU shards,
plus the batch loop's between-tile check and the survivor drill that
chip_smoke runs on the card. The seeded kill plan and the soak stay
with the JAX package (its chaos module is not ported)."""

import numpy as np
import pytest

from kubernetes_tpu.api.client import InProcClient as JaxClient
from kubernetes_tpu.api.registry import Registry as JaxRegistry
from kubernetes_tpu.sched.device.shardfail import \
    ShardLeaseMonitor as JaxMonitor
from kubernetes_tpu.sched.device.shardfail import ShardLeaseSet as JaxLeases
from kubernetes_tpu.utils.clock import FakeClock as JaxClock
from kubernetes_tpu.utils.metrics import MetricsRegistry as JaxMetrics
from kubernetes_tpu_torch.api.client import InProcClient
from kubernetes_tpu_torch.api.registry import Registry
from kubernetes_tpu_torch.kubemark.fixtures import shard_survivor_drill
from kubernetes_tpu_torch.sched.batch import (BatchScheduler,
                                              BatchSchedulerConfig)
from kubernetes_tpu_torch.sched.device import BatchEngine, NodeMesh
from kubernetes_tpu_torch.sched.device.incremental import IncrementalEncoder
from kubernetes_tpu_torch.sched.device.shardfail import (ShardLeaseMonitor,
                                                         ShardLeaseSet,
                                                         reshard_survivors,
                                                         shard_lease_name,
                                                         survivor_mesh)
from kubernetes_tpu_torch.sched.factory import ConfigFactory
from kubernetes_tpu_torch.utils.clock import FakeClock
from kubernetes_tpu_torch.utils.metrics import SHARD_COUNTERS, MetricsRegistry

from test_shard_failure import mk_node, mk_pod
from test_torch_encode import cross

pytestmark = pytest.mark.multihost


def port_node(name, **kw):
    return cross([mk_node(name, **kw)])[0]


def port_pod(name, **kw):
    return cross([mk_pod(name, **kw)])[0]


def expire(leases, monitor, clock, dead_shard):
    """Renew every other owner and step the clock 1 s at a time until
    the monitor reports an expiry -> the expired shards."""
    dead = []
    for _ in range(5):
        leases.renew(skip=[dead_shard])
        clock.step(1.0)
        dead = monitor.poll()
        if dead:
            break
    return dead


def lease_set(pkg, n, metrics):
    if pkg == "jax":
        clock, client = JaxClock(), JaxClient(JaxRegistry())
        leases = JaxLeases(client, n, clock=clock, lease_duration=3.0,
                           renew_deadline=2.0, retry_period=1.0,
                           metrics=metrics)
        monitor_cls = JaxMonitor
    else:
        clock, client = FakeClock(), InProcClient(Registry())
        leases = ShardLeaseSet(client, n, clock=clock, lease_duration=3.0,
                               renew_deadline=2.0, retry_period=1.0,
                               metrics=metrics)
        monitor_cls = ShardLeaseMonitor
    assert leases.acquire_all()
    monitor = monitor_cls(client, leases.lease_names(), clock=clock,
                          lease_duration=3.0, metrics=metrics)
    return clock, client, leases, monitor


# -------------------------------------------------------------- leases


def test_shard_lease_expiry_fence_and_resurrection_loses():
    """test_shard_failure.py:108."""
    metrics = MetricsRegistry()
    clock, _, leases, monitor = lease_set("port", 3, metrics)
    assert monitor.poll() == []
    leases.kill(1)
    assert expire(leases, monitor, clock, 1) == [1]
    base = monitor.term(1)
    term = monitor.fence(1)
    assert term == base + 1
    assert metrics.counter("shard_lease_transitions_total",
                           {"lease": shard_lease_name(1)}) == 1.0
    assert leases.electors[1].try_acquire_or_renew() is False
    monitor.retire([1])
    assert monitor.n_shards == 2
    assert monitor.poll() == []


@pytest.mark.parametrize("dead_shard", [0, 2, 3])
def test_expiry_and_fence_terms_match_jax(dead_shard):
    """Both packages' lease sets and monitors, one script: the same
    shard expires at the same step, the fence advances the same term,
    and the counters move alike."""
    seen = {}
    for pkg in ("jax", "port"):
        metrics = JaxMetrics() if pkg == "jax" else MetricsRegistry()
        clock, _, leases, monitor = lease_set(pkg, 4, metrics)
        monitor.poll()
        leases.kill(dead_shard)
        steps, dead = 0, []
        while not dead and steps < 6:
            leases.renew(skip=[dead_shard])
            clock.step(1.0)
            steps += 1
            dead = monitor.poll()
        term = monitor.fence(dead_shard)
        seen[pkg] = (dead, steps, term, metrics.counter(
            "shard_lease_transitions_total",
            {"lease": leases.lease_names()[dead_shard]}),
            leases.electors[dead_shard].try_acquire_or_renew())
    assert seen["jax"] == seen["port"]
    assert seen["port"][0] == [dead_shard]


def test_fence_on_missing_lease_returns_none():
    """test_shard_failure.py:153."""
    monitor = ShardLeaseMonitor(InProcClient(Registry()), ["mesh-shard-0"],
                                clock=FakeClock(), lease_duration=3.0,
                                metrics=MetricsRegistry())
    assert monitor.fence(0) is None


# ------------------------------------------------------------- reshard


def test_reshard_rejournals_every_occupied_slot():
    """test_shard_failure.py:165, the tile scheduled on a 4-shard CPU
    mesh."""
    inc = IncrementalEncoder(node_capacity=8, mesh_devices=4)
    for i in range(8):
        inc.on_node_add(port_node(f"n-{i}"))
    pods = [port_pod(f"p-{j}") for j in range(4)]
    enc = inc.encode_tile(pods, [], [])
    engine = BatchEngine(mesh=NodeMesh(["cpu"] * 4))
    inc.assume_assigned(enc, pods, engine.run_chunked(enc, 8)[0])
    pre = inc.encode_tile([], [], [])
    pre_gen = pre.delta.table_gen
    old_epochs = inc.shard_epochs()
    assert len(old_epochs) == 4
    assert inc.reshard(3) == 8
    assert inc.mesh_devices == 3 and inc.n_cap % 3 == 0
    epochs = inc.shard_epochs()
    assert len(epochs) == 3 and min(epochs) > max(old_epochs)
    post = inc.encode_tile([], [], [])
    assert post.delta.shard_epochs == epochs
    assert set(post.delta.replay_slots(pre_gen).tolist()) >= set(range(8))


def test_survivor_mesh_preserves_device_order():
    """test_shard_failure.py:199."""
    devs = ["cpu:0", "cpu:1", "cpu:2", "cpu:3"]
    sm = survivor_mesh(NodeMesh(devs), [1])
    assert [str(d) for d in sm.devices] == ["cpu:0", "cpu:2", "cpu:3"]
    assert survivor_mesh(NodeMesh(devs), [0, 1, 2, 3]) is None


def test_reshard_survivors_end_to_end_over_leases():
    """test_shard_failure.py:209: expired shard -> fence -> encoder
    re-journal -> engine rebuild -> monitor retire; the survivor mesh
    schedules from one full upload."""
    metrics = MetricsRegistry()
    n = 4
    clock, _, leases, monitor = lease_set("port", n, metrics)
    monitor.poll()
    inc = IncrementalEncoder(node_capacity=8, mesh_devices=n)
    for i in range(8):
        inc.on_node_add(port_node(f"n-{i}"))
    engine = BatchEngine(mesh=NodeMesh(["cpu"] * n))
    leases.kill(2)
    dead = expire(leases, monitor, clock, 2)
    assert dead == [2]
    res = reshard_survivors(dead, monitor, encoder=inc, engine=engine,
                            metrics=metrics)
    assert res is not None and res.dead == (2,)
    assert res.survivors == 3 and res.replay_rows == 8
    assert res.shard_epochs == inc.shard_epochs()
    assert engine.mesh is not None and engine.mesh.size == 3
    assert monitor.n_shards == 3
    assert metrics.counter("shard_reshards_total") == 1.0
    assert metrics.counter("shard_replay_rows_total") == 8.0
    pods = [port_pod(f"p-{j}") for j in range(4)]
    enc = inc.encode_tile(pods, [], [], pad_to=4)
    assigned, _ = engine.run_chunked(enc, 4)
    assert int((assigned[:4] >= 0).sum()) == 4
    assert engine.upload_stats["full_tiles"] >= 1


def test_reshard_survivors_without_a_live_fence_does_nothing():
    """An owner that renews between the poll and the fence wins the
    CAS: no re-shard, no counter."""
    metrics = MetricsRegistry()
    clock, _, leases, monitor = lease_set("port", 2, metrics)
    monitor.poll()
    engine = BatchEngine(mesh=NodeMesh(["cpu"] * 2))
    leases.kill(1)
    assert expire(leases, monitor, clock, 1) == [1]
    monitor.fence = lambda shard: None
    assert reshard_survivors([1], monitor, engine=engine,
                             metrics=metrics) is None
    assert engine.n_shards == 2
    assert metrics.counter("shard_reshards_total") == 0.0


def test_shard_counters_pinned():
    """test_shard_failure.py:265."""
    assert SHARD_COUNTERS == ("shard_lease_transitions_total",
                              "shard_reshards_total",
                              "shard_replay_rows_total")


# --------------------------------------------------------- epoch fence


def test_table_cache_misses_after_reshard_same_encoder():
    """test_shard_failure.py:274."""
    inc = IncrementalEncoder(node_capacity=16, mesh_devices=1)
    for i in range(16):
        inc.on_node_add(port_node(f"n-{i:03d}"))
    engine = BatchEngine(device="cpu")
    pods = [port_pod(f"p-{j}") for j in range(8)]
    enc1 = inc.encode_tile(pods, [], [])
    engine.run_chunked(enc1, 8)
    full_before = engine.upload_stats["full_tiles"]
    inc.reshard(1)
    enc2 = inc.encode_tile(pods, [], [])
    assert enc2.delta.shard_epochs != enc1.delta.shard_epochs
    a2, _ = engine.run_chunked(enc2, 8)
    assert engine.upload_stats["full_tiles"] > full_before
    ref, _ = BatchEngine(device="cpu").run_chunked(enc2, 8)
    assert np.array_equal(a2, ref)


def test_detached_encoder_epochs_incomparable_to_successor():
    """test_shard_failure.py:297."""
    def fresh():
        inc = IncrementalEncoder(node_capacity=16, mesh_devices=1)
        for i in range(16):
            inc.on_node_add(port_node(f"n-{i:03d}"))
        return inc

    engine = BatchEngine(device="cpu")
    pods = [port_pod(f"p-{j}") for j in range(8)]
    inc_a = fresh()
    enc_a = inc_a.encode_tile(pods, [], [])
    a_first, _ = engine.run_chunked(enc_a, 8)
    inc_a.assume_assigned(enc_a, pods, a_first)
    engine.run_chunked(inc_a.encode_tile(pods, [], []), 8)
    inc_a.detach()
    inc_b = fresh()
    assert inc_a.shard_epochs() == inc_b.shard_epochs()
    assert enc_a.delta.encoder_id != inc_b.encoder_id
    enc_b = inc_b.encode_tile(pods, [], [])
    a_b, _ = engine.run_chunked(enc_b, 8)
    ref, _ = BatchEngine(device="cpu").run_chunked(enc_b, 8)
    assert np.array_equal(a_b, ref)

    def fenced(delta, live):
        return (delta.encoder_id == live.encoder_id
                and live.shard_epochs() != delta.shard_epochs)

    assert not fenced(enc_a.delta, inc_b)
    inc_b.reshard(1)
    assert fenced(enc_b.delta, inc_b)
    assert not fenced(enc_a.delta, inc_b)


# ------------------------------------------------------- the batch loop


def test_check_shards_fences_reshards_and_requeues():
    """The loop's between-tile poll: an expired shard fences, re-shards
    the engine and the encoder onto the survivors, and requeues the
    in-flight tile under `shard-<k>`; the counters move as in JAX."""
    metrics = MetricsRegistry()
    clock, client, leases, monitor = lease_set("port", 4, metrics)
    monitor.poll()
    factory = ConfigFactory(client, rate_limit=False)
    engine = BatchEngine(mesh=NodeMesh(["cpu"] * 4))
    config = factory.create_batch(engine=engine, shard_monitor=monitor,
                                  metrics=metrics)
    sched = BatchScheduler(config)
    sched._inc = IncrementalEncoder(node_capacity=8, mesh_devices=4)
    for i in range(8):
        sched._inc.on_node_add(port_node(f"n-{i}"))

    class Tile:
        pods = [port_pod(f"q-{j}") for j in range(3)]
        landed = __import__("threading").Event()

    sched._prev = Tile
    requeued = []
    sched._requeue = lambda pod, reason, msg: requeued.append(
        (pod.metadata.name, reason))
    sched._check_shards()                 # nothing expired yet
    assert sched._prev is Tile and engine.n_shards == 4
    leases.kill(3)
    for _ in range(5):
        leases.renew(skip=[3])
        clock.step(1.0)
    sched._check_shards()
    assert engine.n_shards == 3 and sched._inc.mesh_devices == 3
    assert sched._prev is None and Tile.landed.is_set()
    assert requeued == [(f"q-{j}", "shard-3") for j in range(3)]
    assert metrics.counter("shard_reshards_total") == 1.0
    assert metrics.counter("shard_replay_rows_total") == 8.0
    assert metrics.counter("shard_lease_transitions_total",
                           {"lease": shard_lease_name(3)}) == 1.0


def test_config_binds_mesh_and_monitor():
    factory = ConfigFactory(InProcClient(Registry()), rate_limit=False)
    monitor = ShardLeaseMonitor(InProcClient(Registry()), [],
                                clock=FakeClock())
    mesh = NodeMesh(["cpu"] * 2)
    config = BatchSchedulerConfig(factory, mesh=mesh, shard_monitor=monitor)
    assert config.engine.mesh is mesh and config.shard_monitor is monitor
    # an explicit engine's own mesh wins
    own = BatchEngine(device="cpu")
    assert BatchSchedulerConfig(factory, engine=own, mesh=mesh).engine \
        is own


def test_survivor_drill():
    """The drill chip_smoke runs on the card, here over CPU shards: the
    first half of the pods bound on four shards, shard 2's owner dies,
    its lease expires while a tile of the second half is in flight, the
    loop re-shards onto three before the next dispatch and requeues that
    tile's pods under shard-2, the second half binds, and nothing
    reaches the commit path under the dead epoch."""
    got = shard_survivor_drill(n_nodes=48, n_pods=64, shards=4, dead=2,
                               device="cpu")
    assert got["first_half_bound"] and got["second_half_bound"]
    assert got["mesh_after"] == 3 and got["reshards"] == 1.0
    assert got["lease_transitions"] == 1.0 and got["replay_rows"] == 48.0
    assert got["in_flight_at_expiry"] >= 1
    assert got["requeued_in_flight"] == got["in_flight_at_expiry"]
    assert got["handed_under_dead_epoch"] == 0
