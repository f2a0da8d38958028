"""The port's incremental encoder (kubernetes_tpu_torch.sched.device.
incremental) against the JAX package's, fed the same churn streams.

Each stream replays one history of API objects (the generators of
tests/test_incremental.py: node and pod adds in shuffled order, deletes,
phase transitions, host ports, cordon flips, node-slot reclaim, the
narrowing gcd breaking) into both encoders at once, objects crossing
through the wire format. Every tile both encoders emit must be
byte-identical — the EncodeResult arrays and the TableDelta journal —
and the two engines' assignments, assumed back into both encoders,
must agree. Tolerance 0: everything here is integer or bitset."""

import numpy as np
import pytest

from kubernetes_tpu.core.quantity import Quantity
from kubernetes_tpu.sched.device import BatchEngine as JaxEngine
from kubernetes_tpu.sched.device.incremental import \
    IncrementalEncoder as JaxIncremental
from kubernetes_tpu_torch.sched.device import BatchEngine
from kubernetes_tpu_torch.sched.device.incremental import IncrementalEncoder
from kubernetes_tpu_torch.sched.device.tables import TableDelta

from test_incremental import feed, mk_node, mk_pod, mk_service
from test_torch_encode import assert_enc_equal, cross


class Twin:
    """A JAX encoder and the port's, fed the same events. Event methods
    (on_node_add, on_pod_update, assume, ...) forward to both; objects
    reach the port through the wire format."""

    def __init__(self, **kw):
        self.jax = JaxIncremental(**kw)
        self.port = IncrementalEncoder(**kw)
        self.tiles = 0

    def __getattr__(self, name):
        def call(*objs):
            getattr(self.jax, name)(*objs)
            getattr(self.port, name)(*cross(objs))
        return call

    def tile(self, pending, services=(), pad_to=0, assume=True):
        """Encode one tile in both, check them equal, run both engines,
        check the assignments equal, and assume them back into both."""
        port_pending = cross(pending)
        je = self.jax.encode_tile(pending, list(services), [], pad_to=pad_to)
        pe = self.port.encode_tile(port_pending, cross(services), [],
                                   pad_to=pad_to)
        assert_inc_equal(je, pe)
        want, _ = JaxEngine().run_chunked(je, 64)
        got, _ = BatchEngine(device="cpu").run_chunked(pe, 64)
        assert np.array_equal(np.asarray(want), got)
        if assume:
            self.jax.assume_assigned(je, pending, np.asarray(want))
            self.port.assume_assigned(pe, port_pending, got)
            assert self.jax.state_epoch == self.port.state_epoch
        self.tiles += 1
        return pe, got


def assert_inc_equal(want, got):
    """EncodeResult arrays, the incremental fields and the TableDelta
    journal byte-identical (encoder_id names an instance, so it only
    has to be the port encoder's own)."""
    assert_enc_equal(want, got)
    assert got.state_epoch == want.state_epoch
    assert len(got.tile_groups or []) == len(want.tile_groups or [])
    wd, gd = want.delta, got.delta
    assert isinstance(gd, TableDelta)
    assert (gd.table_gen, gd.full_gen, gd.shard_epochs) == \
        (wd.table_gen, wd.full_gen, wd.shard_epochs)
    for f in ("node_dirty_gen", "state_dirty_gen"):
        a, b = getattr(wd, f), getattr(gd, f)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), f
        assert a.tobytes() == b.tobytes(), f
    assert np.array_equal(gd.replay_slots(0), wd.replay_slots(0))


def stream_basic(t):
    nodes = [mk_node(f"n-{i:02d}", labels={"zone": "a" if i % 2 else "b"})
             for i in range(10)]
    existing = [mk_pod(f"e-{j}", node=f"n-{j % 10:02d}",
                       cpu=200 + 100 * (j % 3),
                       labels={"app": "web"} if j % 2 else {})
                for j in range(25)]
    feed(t, nodes, existing)
    services = [mk_service("web", {"app": "web"})]
    t.tile([mk_pod(f"p-{k}", labels={"app": "web"}, phase="Pending")
            for k in range(12)], services)
    t.tile([mk_pod(f"q-{k}", phase="Pending") for k in range(5)], pad_to=64)


def stream_phases_and_ports(t):
    nodes = [mk_node(f"n-{i:02d}") for i in range(6)]
    existing = [mk_pod(f"e-{j}", node=f"n-{j % 6:02d}",
                       phase=["Running", "Succeeded", "Failed"][j % 3],
                       host_port=9000 + (j % 2), labels={"app": "db"})
                for j in range(18)]
    feed(t, nodes, existing, seed=3)
    services = [mk_service("db", {"app": "db"})]
    # host-port collisions force spread across the remaining nodes; the
    # port-carrying assumes take the slow (epoch-bumping) path
    t.tile([mk_pod(f"p-{k}", host_port=9000, labels={"app": "db"},
                   phase="Pending") for k in range(4)], services)
    t.tile([mk_pod(f"r-{k}", host_port=9001, phase="Pending")
            for k in range(3)])


def stream_delete_and_phase_transition(t):
    nodes = [mk_node(f"n-{i:02d}", cpu=1000) for i in range(4)]
    existing = [mk_pod(f"e-{j}", node=f"n-{j % 4:02d}", cpu=300, rv=str(j))
                for j in range(8)]
    feed(t, nodes, existing)
    for j in (0, 2, 4):
        t.on_pod_delete(existing[j])
    t.on_pod_update(existing[1], mk_pod("e-1", node="n-01", cpu=300,
                                        phase="Succeeded", rv="99"))
    t.tile([mk_pod(f"p-{k}", cpu=300, phase="Pending") for k in range(6)])
    t.on_pod_delete(existing[3])
    t.tile([mk_pod(f"s-{k}", cpu=300, phase="Pending") for k in range(3)])


def stream_cordon_flip(t):
    t.on_node_add(mk_node("n-00"))
    t.on_node_add(mk_node("n-01"))
    cordoned = mk_node("n-00")
    cordoned.spec.unschedulable = True
    t.on_node_update(mk_node("n-00"), cordoned)
    pe, got = t.tile([mk_pod("p-0", phase="Pending")])
    assert pe.node_names[int(got[0])] == "n-01"
    t.on_node_update(cordoned, mk_node("n-00"))
    t.on_node_update(mk_node("n-01"), mk_node("n-01", ready=False))
    pe, got = t.tile([mk_pod("p-1", phase="Pending")])
    assert pe.node_names[int(got[0])] == "n-00"


def stream_node_slot_reclaim(t):
    gen0 = [mk_node(f"old-{i}", cpu=2000) for i in range(4)]
    pods0 = [mk_pod(f"e-{j}", node=f"old-{j % 4}", cpu=500, rv=str(j))
             for j in range(8)]
    feed(t, gen0, pods0)
    t.tile([mk_pod("p-a", cpu=400, phase="Pending")])
    for gen in range(1, 4):
        prefix = "old" if gen == 1 else f"g{gen - 1}"
        for i in range(4):
            t.on_node_delete(mk_node(f"{prefix}-{i}"))
        for i in range(4):
            t.on_node_add(mk_node(f"g{gen}-{i}", cpu=2000))
    for j in range(8):
        t.on_pod_delete(mk_pod(f"e-{j}", node=f"old-{j % 4}", cpu=500,
                               rv=str(j)))
    assert t.port.n_cap == t.jax.n_cap == 8
    t.tile([mk_pod(f"p-{k}", cpu=400, phase="Pending") for k in range(6)])


def stream_narrowing_widen(t):
    for i in range(6):
        t.on_node_add(mk_node(f"n{i}", mem=8 * 1024))
    for i in range(4):
        t.on_pod_add(mk_pod(f"e{i}", node=f"n{i % 6}", mem=512))
    pe, _ = t.tile([mk_pod(f"p{i}", mem=256, phase="Pending")
                    for i in range(8)])
    assert pe.mem_scale > 1 and pe.node_tab.mem_cap.dtype == np.int32
    odd = mk_pod("b", phase="Pending")
    odd.spec.containers[0].resources.requests["memory"] = Quantity(7 * 1000)
    pe, _ = t.tile([odd])
    assert pe.mem_scale == 1 and pe.node_tab.mem_cap.dtype == np.int64


def stream_growth_and_assume_echo(t):
    for i in range(5):
        t.on_node_add(mk_node(f"n-{i:02d}"))
        t.on_pod_add(mk_pod(f"e-{i}", node=f"n-{i:02d}", cpu=250,
                            rv=str(i)))
    t.assume(mk_pod("a-0", node="n-01", cpu=400, rv="50"))
    t.on_pod_add(mk_pod("a-0", node="n-01", cpu=400, rv="51"))
    pe, got = t.tile([mk_pod(f"p-{k}", phase="Pending") for k in range(7)])
    # the watch echo of the assumed tile: status-only, no epoch move
    epoch = t.port.state_epoch
    for k in range(7):
        t.on_pod_add(mk_pod(f"p-{k}", node=pe.node_names[int(got[k])],
                            rv=str(100 + k)))
    assert t.port.state_epoch == epoch
    t.tile([mk_pod(f"q-{k}", phase="Pending") for k in range(3)])


STREAMS = {
    "basic": stream_basic,
    "phases_and_ports": stream_phases_and_ports,
    "delete_and_phase_transition": stream_delete_and_phase_transition,
    "cordon_flip": stream_cordon_flip,
    "node_slot_reclaim": stream_node_slot_reclaim,
    "narrowing_widen": stream_narrowing_widen,
    "growth_and_assume_echo": stream_growth_and_assume_echo,
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_churn_stream_matches_jax(name):
    kw = {"node_capacity": 8} if name == "node_slot_reclaim" else {}
    if name == "growth_and_assume_echo":
        kw = {"node_capacity": 2}
    t = Twin(**kw)
    STREAMS[name](t)
    assert t.tiles >= 1
    assert t.port.encoder_id != 0 and t.port.shard_epochs() == (0,)
