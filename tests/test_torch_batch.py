"""The port's live batch pipeline (kubernetes_tpu_torch.sched.batch) on the
CPU: FIFO tile drain -> incremental encode -> chained engine runs ->
batched CAS commit, over the port's own registry, store and informers.

The gate is the JAX package's (tests/test_batch_sched.py, sharded-mesh
case): tile boundaries are invisible, so the pipeline's bindings by pod
name equal one uninterrupted engine run over the same pods in creation
order. Here they must equal four answers at once: the port's one-shot
BatchEngine.schedule, the JAX BatchScheduler on the same objects, and
the JAX one-shot engine. Objects cross between the packages only through
the wire format. Tolerance 0: bindings are names."""

import threading
import time

import numpy as np
import pytest
import torch

from kubernetes_tpu.api.client import InProcClient as JaxClient
from kubernetes_tpu.api.registry import Registry as JaxRegistry
from kubernetes_tpu.sched.batch import BatchScheduler as JaxBatchScheduler
from kubernetes_tpu.sched.device import BatchEngine as JaxEngine
from kubernetes_tpu.sched.device import ClusterSnapshot as JaxSnapshot
from kubernetes_tpu.sched.factory import ConfigFactory as JaxFactory
from kubernetes_tpu_torch.api.client import InProcClient
from kubernetes_tpu_torch.api.registry import Registry
from kubernetes_tpu_torch.core.store import Store
from kubernetes_tpu_torch.sched.batch import (BatchScheduler,
                                              BatchSchedulerConfig,
                                              _carry_compatible, _Inflight)
from kubernetes_tpu_torch.sched.device import BatchEngine, ClusterSnapshot
from kubernetes_tpu_torch.sched.device.engine import (CARRY_DTYPES,
                                                      PendingAssignment)
from kubernetes_tpu_torch.sched.device.incremental import IncrementalEncoder
from kubernetes_tpu_torch.sched.factory import ConfigFactory
from kubernetes_tpu_torch.utils.metrics import MetricsRegistry

from test_sched_e2e import pending_pod, ready_node, wait_until
from test_torch_encode import cross

N_NODES, N_PODS, TILE = 16, 200, 64


def _nodes():
    return [ready_node(f"mnode-{i:02d}") for i in range(N_NODES)]


def _pods():
    return [pending_pod(f"mpod-{i:03d}", labels={"app": "m"})
            for i in range(N_PODS)]


def _run_pipeline(registry, client, factory, make_sched, nodes, pods):
    """Nodes and every pod exist and sit in the FIFO before the
    scheduler starts, so it drains full tiles back to back (and chains
    them). -> {pod name: node name}."""
    factory.start()
    sched = None
    try:
        for n in nodes:
            client.create("nodes", n)
        assert wait_until(
            lambda: len(factory.node_lister.list()) == len(nodes),
            timeout=30)
        client.create_batch("pods", pods, "default")
        assert wait_until(lambda: len(factory.pod_queue.list()) == len(pods),
                          timeout=30)
        sched = make_sched(factory).run()
        assert wait_until(
            lambda: all(p.spec.node_name for p in client.list("pods")[0]),
            timeout=120)
        sched.drain_commits()
        return {p.metadata.name: p.spec.node_name
                for p in client.list("pods")[0]}
    finally:
        if sched is not None:
            sched.stop()
        factory.stop()


def test_pipeline_bindings_match_one_shot_and_jax():
    metrics = MetricsRegistry()
    registry = Registry()
    client = InProcClient(registry)
    port = _run_pipeline(
        registry, client, ConfigFactory(client, rate_limit=False),
        lambda f: BatchScheduler(f.create_batch(
            engine=BatchEngine(device="cpu"), tile_size=TILE,
            metrics=metrics)),
        cross(_nodes()), cross(_pods()))
    assert metrics.counter("batch_tiles_total", {"chained": "true"}) > 0
    tiles = (metrics.counter("batch_tiles_total", {"chained": "true"})
             + metrics.counter("batch_tiles_total", {"chained": "false"}))
    assert tiles >= N_PODS // TILE

    jax_registry = JaxRegistry()
    jax_client = JaxClient(jax_registry)
    jax = _run_pipeline(
        jax_registry, jax_client, JaxFactory(jax_client, rate_limit=False),
        lambda f: JaxBatchScheduler(f.create_batch(tile_size=TILE)),
        _nodes(), _pods())

    one_shot, _ = BatchEngine(device="cpu").schedule(ClusterSnapshot(
        nodes=cross(_nodes()), pending_pods=cross(_pods())))
    jax_one_shot, _ = JaxEngine().schedule(JaxSnapshot(
        nodes=_nodes(), pending_pods=_pods()))
    want = {f"mpod-{i:03d}": h for i, h in enumerate(jax_one_shot)}
    assert dict(zip(want, one_shot)) == want
    assert jax == want
    assert port == want


def test_no_fit_requeues_then_binds():
    registry = Registry()
    client = InProcClient(registry)
    factory = ConfigFactory(client, rate_limit=False).start()
    sched = BatchScheduler(factory.create_batch(
        engine=BatchEngine(device="cpu"))).run()
    try:
        client.create("nodes", cross([ready_node("tiny", cpu="100m",
                                                 mem="64Mi")])[0])
        client.create("pods", cross([pending_pod("big", cpu="2",
                                                 mem="4Gi")])[0])
        time.sleep(0.5)
        assert client.get("pods", "big").spec.node_name == ""
        client.create("nodes", cross([ready_node("roomy")])[0])
        assert wait_until(
            lambda: client.get("pods", "big").spec.node_name == "roomy",
            timeout=15)
    finally:
        sched.stop()
        factory.stop()


def test_drain_commits_barrier_rides_behind_unfinalized_tile():
    """A dispatched-but-unfinalized tile's bindings are not in the commit
    queue yet: a drain_commits barrier must wait for its landed event
    so FIFO puts it behind the bindings (the JAX package's regression,
    on the port's loop)."""
    registry = Registry()
    client = InProcClient(registry)
    factory = ConfigFactory(client, rate_limit=False).start()
    sched = BatchScheduler(factory.create_batch(
        engine=BatchEngine(device="cpu")))
    # only the committer runs: the test orders the handoff itself
    sched._commit_thread = threading.Thread(
        target=sched._commit_loop, daemon=True)
    sched._commit_thread.start()
    order = []
    sched._commit = lambda scheduled, inc_assumed: order.append("commit")
    try:
        fl = _Inflight(pods=[], enc=None, assigned=None, state=None,
                       epoch=0, flags=(False, False), t_start=0.0,
                       t_dev=0.0)
        sched._prev = fl
        drained = threading.Event()

        def drain():
            sched.drain_commits(timeout=10.0)
            order.append("drained")
            drained.set()

        t = threading.Thread(target=drain, daemon=True)
        t.start()
        assert not drained.wait(0.25)
        assert order == []
        sched._commit_q.put([("pod", "host")])
        fl.landed.set()
        assert drained.wait(5.0)
        assert order == ["commit", "drained"]
        t.join(timeout=5)
        assert not t.is_alive()
    finally:
        sched._commit_q.put(None)
        sched._commit_thread.join(timeout=5)
        factory.stop()


def _encoder(n_nodes=4):
    inc = IncrementalEncoder()
    for i in range(n_nodes):
        inc.on_node_add(cross([ready_node(f"n-{i}")])[0])
    return inc


def test_carry_compatible_for_chained_tile():
    """The chain check compares the numpy encoding with the torch carry
    through CARRY_DTYPES (uint32 bitsets ride as int32): True for the
    next tile of the same encoder, False once the layout moves."""
    inc = _encoder()
    engine = BatchEngine(device="cpu")
    pods = cross([pending_pod(f"p{i}") for i in range(3)])
    enc = inc.encode_tile(pods, [], [], pad_to=64)
    pending, state = engine.run_chunked(enc, 64, block=False)
    assert isinstance(pending, PendingAssignment) and pending.is_ready()
    nxt = inc.encode_tile(cross([pending_pod("q")]), [], [], pad_to=64)
    assert nxt.init_state.port_bits.dtype == np.uint32
    assert state.port_bits.dtype == CARRY_DTYPES[np.dtype(np.uint32)]
    assert _carry_compatible(nxt, state)
    # a wider layout (the i64 re-widen) no longer chains
    flipped = (torch.int64 if state.cpu_used.dtype == torch.int32
               else torch.int32)
    assert not _carry_compatible(
        nxt, state._replace(cpu_used=state.cpu_used.to(flipped)))
    # nor does a grown node axis
    inc.on_node_add(cross([ready_node("n-late")])[0])
    for i in range(5, 70):
        inc.on_node_add(cross([ready_node(f"n-{i}")])[0])
    grown = inc.encode_tile(cross([pending_pod("r")]), [], [], pad_to=64)
    assert not _carry_compatible(grown, state)


@pytest.mark.parametrize("option", ["mesh", "shard_monitor"])
def test_config_refuses_unported_options(option):
    """Both options were refused until the mesh was ported; now each is
    accepted and binds: `mesh=` builds the engine over it (an explicit
    engine's own mesh wins) and sizes the encoder to it, `shard_monitor=`
    is polled between tiles (tests/test_torch_shardfail.py)."""
    from kubernetes_tpu_torch.sched.device import NodeMesh
    from kubernetes_tpu_torch.sched.device.shardfail import ShardLeaseMonitor
    from kubernetes_tpu_torch.utils.clock import FakeClock
    factory = ConfigFactory(InProcClient(Registry()), rate_limit=False)
    value = (NodeMesh(["cpu"] * 4) if option == "mesh" else
             ShardLeaseMonitor(InProcClient(Registry()), ["mesh-shard-0"],
                               clock=FakeClock()))
    config = BatchSchedulerConfig(
        factory, **{option: value},
        **({} if option == "mesh" else {"device": "cpu"}))
    if option == "mesh":
        assert config.engine.mesh is value and config.engine.n_shards == 4
        assert config.shard_monitor is None
        own = BatchEngine(device="cpu")
        assert BatchSchedulerConfig(factory, engine=own,
                                    mesh=value).engine is own
    else:
        assert config.shard_monitor is value and config.engine.mesh is None
        assert config.engine.device.type == "cpu"
    sched = BatchScheduler(config)
    factory.start()
    try:
        inc = sched._incremental()
        assert inc.mesh_devices == config.engine.n_shards
    finally:
        factory.stop()


def test_store_refuses_wal_dir(tmp_path):
    with pytest.raises(NotImplementedError, match="Durable store"):
        Store(wal_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="Durable store"):
        Store.recover(str(tmp_path))


def test_default_engine_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    factory = ConfigFactory(InProcClient(Registry()), rate_limit=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        factory.create_batch()
    assert factory.create_batch(device="cpu").engine.device.type == "cpu"
