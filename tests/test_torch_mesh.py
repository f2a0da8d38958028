"""The port's node-axis mesh (kubernetes_tpu_torch/sched/device/mesh.py):
BatchEngine(mesh=NodeMesh(["cpu"] * S)) runs the sharded scan's and the
sharded victim search's plain versions shard by shard (each shard over
its block of slots, the S records a pod reduced as the kernels reduce
them, K7) and must give, bit for bit, what the JAX engine gives under
its 8-device CPU mesh, what the port's unsharded engine gives, and what
the serial oracle gives: the assignment, the final State, the victim
search's pick, kstar and score, and the batch loop's bindings. These
are the counterparts of the JAX package's mesh gates
(test_device_parity.py, test_device_policy.py, test_batch_sched.py,
test_incremental.py) at S in {1, 2, 4, 8}. Every quantity is an integer
or an f64 floor, so the tolerance is 0."""

import functools
import random
import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kubernetes_tpu.core import types as japi
from kubernetes_tpu.sched.device import BatchEngine as JaxEngine
from kubernetes_tpu.sched.device import ClusterSnapshot as JaxSnapshot
from kubernetes_tpu.sched.device.engine import _make_run
from kubernetes_tpu.sched.device.incremental import \
    IncrementalEncoder as JaxIncremental
from kubernetes_tpu.sched.preemption import \
    oracle_find_victims as jax_oracle
from kubernetes_tpu_torch.api.client import InProcClient
from kubernetes_tpu_torch.api.registry import Registry
from kubernetes_tpu_torch.kubemark import fixtures
from kubernetes_tpu_torch.sched.batch import BatchScheduler
from kubernetes_tpu_torch.sched.device import (BatchEngine,
                                               NodeMesh, filter_kernel,
                                               scan_kernel as sk,
                                               victim_kernel as vk)
from kubernetes_tpu_torch.sched.device import engine as port_engine
from kubernetes_tpu_torch.sched.device.incremental import IncrementalEncoder
from kubernetes_tpu_torch.sched.device.mesh import (NODE_REPLICATED,
                                                    NODE_SPLIT,
                                                    STATE_REPLICATED,
                                                    STATE_SPLIT,
                                                    block_view)
from kubernetes_tpu_torch.sched.factory import ConfigFactory
from kubernetes_tpu_torch.sched.preemption import oracle_find_victims

from test_affinity import with_random_affinity
from test_batch_sched import pending_pod, ready_node, wait_until
from test_device_parity import (MI, _bound_pod, _mk_inc_pods, _preemptor, bq,
                                make_node, mq, oracle_schedule, rand_cluster)
from test_device_policy import oracle_schedule_policy
from test_torch_encode import (POLICY, cross, encodings, port_policy,
                               to_port)
from test_torch_scan import LAYOUTS, SCAN_SEED, TIERS, _case, _widen

SHARDS = (1, 2, 4, 8)


def jax_mesh():
    return Mesh(np.array(jax.devices()), ("nodes",))


def cpu_mesh(s):
    return NodeMesh(["cpu"] * s)


# ------------------------------------------------------------ the mesh


def test_mesh_blocks_owner_and_survivors():
    mesh = cpu_mesh(4)
    assert mesh.size == 4 and mesh.one_device and mesh.device.type == "cpu"
    assert mesh.block(64) == 16
    assert mesh.blocks(8) == ((0, 2), (2, 4), (4, 6), (6, 8))
    assert [mesh.owner(s, 8) for s in range(8)] == [0, 0, 1, 1, 2, 2, 3, 3]
    with pytest.raises(ValueError, match="do not split"):
        mesh.block(10)
    # the survivors keep the device order (test_shard_failure.py:199)
    named = NodeMesh(["cpu:0", "cpu:1", "cpu:2", "cpu:3"])
    assert named.survivors([1]).devices == tuple(
        torch.device(d) for d in ("cpu:0", "cpu:2", "cpu:3"))
    assert named.survivors([0, 1, 2, 3]) is None
    assert mesh == cpu_mesh(4) and mesh != cpu_mesh(3)


def test_mesh_fields_written_once_cover_the_tables():
    """Every NodeConst and State field is split or replicated, once, as
    the JAX engine's _node_shardings says."""
    node = set(port_engine.NodeConst._fields)
    state = set(port_engine.State._fields)
    assert set(NODE_SPLIT) | set(NODE_REPLICATED) == node
    assert not set(NODE_SPLIT) & set(NODE_REPLICATED)
    assert set(STATE_SPLIT) | set(STATE_REPLICATED) == state
    assert not set(STATE_SPLIT) & set(STATE_REPLICATED)
    assert NODE_SPLIT["aff_dom"] == 1 and NODE_SPLIT["labels"] == 0
    assert STATE_SPLIT["spread"] == STATE_SPLIT["svc_count"] == 1
    assert sk.REPLICATED == STATE_REPLICATED


def test_mesh_refuses_mixed_devices_and_unreachable_peers():
    """A mesh is all CUDA or all CPU; the engine runs only a mesh whose
    shards share one device (the per-card placement a mesh over several
    cards needs is not written), so it refuses one over two cards."""
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        NodeMesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="no devices"):
        NodeMesh([])
    several = NodeMesh(["cuda:0", "cuda:1", "cuda:0"])
    assert not several.one_device
    with pytest.raises(NotImplementedError, match="several devices"):
        BatchEngine(mesh=several)
    with pytest.raises(ValueError, match="is not the mesh's"):
        BatchEngine(mesh=cpu_mesh(2), device="cuda")


def test_mesh_engine_rules(monkeypatch):
    """Under a mesh: the speculative engine is off, filter_masks takes
    the probe (not the filter kernel), n_shards is the mesh's size,
    reshard drops the mirror and the shard spaces, and a one-shard mesh
    runs the unsharded scan and victim search (the same function)."""
    engine = BatchEngine(mesh=cpu_mesh(4), speculative=True)
    assert engine.n_shards == 4 and not engine.speculative
    assert engine.device.type == "cpu"
    snap = rand_cluster(3, n_nodes=9, n_existing=6, n_pending=5)
    enc = port_engine.encode_snapshot(to_port(snap), node_pad_to=4)

    def no_filter(*a, **k):
        raise AssertionError("the filter kernel ran under a mesh")

    monkeypatch.setattr(filter_kernel, "filter_masks", no_filter)
    masks = engine.filter_masks(enc)
    want = BatchEngine(device="cpu").probe(enc)[0][:enc.n_pods]
    assert np.array_equal(masks, want)
    engine.run_chunked(enc, 4)
    assert engine.shard_spaces
    engine.reshard(cpu_mesh(3))
    assert engine.n_shards == 3 and not engine.shard_spaces
    assert engine._table_cache is None
    engine.reshard(None)
    assert engine.n_shards == 1

    def no_sharded(*a, **k):
        raise AssertionError("a one-shard mesh ran a sharded version")

    monkeypatch.setattr(sk, "scan_chunk_sharded", no_sharded)
    monkeypatch.setattr(vk, "victim_search_sharded", no_sharded)
    one = BatchEngine(mesh=cpu_mesh(1))
    got, _ = one.run_chunked(enc, 4)
    want, _ = BatchEngine(device="cpu").run_chunked(enc, 4)
    assert np.array_equal(got, want) and not one.shard_spaces
    table = _victim_twin(1, "port")
    res, ref = one.find_victims(table), oracle_find_victims(table)
    assert (res.pick, res.kstar, res.feasible) == \
        (ref.pick, ref.kstar, ref.feasible)
    assert np.array_equal(res.node_score, ref.node_score)


def test_shard_args_order_as_the_source():
    with open(sk.SOURCE) as f:
        body = re.search(r"enum ShardArg \{(.*?)\};", f.read(), re.S)[1]
    names = tuple(n.lower() for n in re.findall(r"\bSHARD_(\w+)", body)
                  if n != "COUNT")
    assert names == sk.SHARD_FIELDS


def test_sharded_launch_plan():
    """A cluster a shard: 16 CTAs where the card holds all S such
    clusters at once, else 8; refused where it holds fewer than S of
    every size, and where the slots do not split."""
    d = {"p": 8192, "n": 5120, "l": 1, "pw": 1, "k": 1, "g": 1, "t": 1,
         "d": 1, "s": 1, "z": 1}

    def card(held16, held8):
        return lambda code, c, t, smem: held16 if c == 16 else held8

    plan = sk.launch_plan(sk.SCAN, d, False, False, False, False,
                          max_clusters=card(8, 16), shards=8)
    assert (plan.kind, plan.cluster, plan.grid) == (sk.SHARDED, 16, 128)
    assert plan.slots == 40 and plan.threads == sk.cta_threads(40)
    plan = sk.launch_plan(sk.SCAN, d, False, False, False, False,
                          max_clusters=card(7, 16), shards=8)
    assert (plan.cluster, plan.grid) == (8, 64) and plan.slots == 80
    with pytest.raises(ValueError, match="holds 7 such clusters"):
        sk.launch_plan(sk.SCAN, d, False, False, False, False,
                       max_clusters=card(1, 7), shards=8)
    with pytest.raises(ValueError, match="do not split"):
        sk.launch_plan(sk.SCAN, {**d, "n": 5121}, False, False, False,
                       False, max_clusters=card(8, 16), shards=8)
    # the query carries the sharded instantiation's bit
    seen = []
    sk.launch_plan(sk.SCAN, d, True, True, True, True, shards=2,
                   max_clusters=lambda *a: seen.append(a) or 4)
    assert seen[0][0] == sk.variant(True, True, True, True) | sk.SHARD_CODE
    # the header, a done word a shard, and by parity a shard's candidate
    # record (three flagged words, padded to four), group-max word and
    # zone words; the source's layout
    assert sk.exchange_words(4, 3) == 16 + 4 + 8 * (4 + 1 + 3)
    src = open(sk.SOURCE).read()
    assert f"#define K7_CAND_WORDS {sk.K7_CAND_WORDS}" in src
    assert "16 + (size_t)S * (3 + 2 * K7_CAND_WORDS + 2 * (size_t)Z)" in src


# ------------------------------------------------- the plain sharded scan


def _twin_run(te, enc, shards, chunk):
    """The sharded twin over the encode in chunks, the State carried ->
    (assigned, State, the replicas read after every chunk)."""
    node, state, pods = te.device_args(enc)
    a = sk.ScanArgs.from_engine(node, sk.reciprocals(node), state, pods)
    d = a.dims()
    space = sk.ShardSpace(shards, d, torch.device("cpu"))
    outs, after = [], []
    for lo in range(0, d["p"], chunk):
        outs.append(sk.scan_chunk_sharded(
            a.pod_slice(lo, lo + chunk), te.weights, te._anti_weight,
            *te._enc_flags(enc), space))
        after.append([{f: space.replica(k, d)[f].clone()
                       for f in sk.REPLICATED} for k in range(1, shards)])
    return torch.cat(outs).numpy(), state, after


@functools.cache
def _padded_case(tier: str, layout: str):
    """test_torch_scan's case with the node axis padded to a multiple of
    8 (as the encoders pad it for a mesh) -> (port engine, its encode,
    the JAX scan's assignment and final State over the JAX encode)."""
    snap, policy = TIERS[tier](SCAN_SEED)
    jax_enc, enc = encodings(snap, policy=policy, node_pad_to=8)
    if layout == "i64":
        jax_enc, enc = _widen(jax_enc), _widen(enc)
    je = JaxEngine(policy=policy)
    run = jax.jit(_make_run(je.weights, je._anti_weight,
                            *je._enc_flags(jax_enc)))
    state, assigned = run(*je.device_args(jax_enc))
    te = BatchEngine(policy=port_policy(policy), device="cpu")
    return te, enc, np.asarray(assigned), {
        f: port_engine._host(np.asarray(getattr(state, f)))
        for f in state._fields}


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_sharded_twin_equals_jax_make_run(tier, layout, shards):
    """The sharded plain scan over the batch in chunks of 7, at every
    shard count: the assignment and every State field equal one JAX
    scan, and after every chunk each shard's copy of the replicated
    counts equals the State's."""
    te, enc, want, want_state = _padded_case(tier, layout)
    assert enc.node_tab.valid.shape[0] % shards == 0
    got, state, after = _twin_run(te, enc, shards, 7)
    assert np.array_equal(got, want[:got.shape[0]])
    for f in state._fields:
        assert np.array_equal(getattr(state, f).numpy(), want_state[f]), f
    final = {f: getattr(state, f) for f in sk.REPLICATED}
    for rep in after[-1]:
        for f in sk.REPLICATED:
            assert torch.equal(rep[f], final[f]), f


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_replicas_equal_after_every_chunk(tier, layout):
    """Four shards over chunks of 5: after each chunk every shard's copy
    of aff_count, aff_total and svc_total equals the State's (shard
    0's), which the unsharded plain scan gives at that chunk too."""
    _, _, te, enc = _case(tier, layout, SCAN_SEED)
    node, state, pods = te.device_args(enc)
    a = sk.ScanArgs.from_engine(node, sk.reciprocals(node), state, pods)
    ref = a._replace(state=port_engine._clone_state(state))
    d = a.dims()
    space = sk.ShardSpace(4, d, torch.device("cpu"))
    flags = (te.weights, te._anti_weight, *te._enc_flags(enc))
    for lo in range(0, d["p"], 5):
        got = sk.scan_chunk_sharded(a.pod_slice(lo, lo + 5), *flags, space)
        want = sk.scan_chunk_plain(ref.pod_slice(lo, lo + 5), *flags)
        assert torch.equal(got, want)
        for k in range(1, 4):
            rep = space.replica(k, d)
            for f in sk.REPLICATED:
                assert torch.equal(rep[f], getattr(a.state, f)), (k, f)
                assert torch.equal(rep[f], getattr(ref.state, f)), (k, f)


@pytest.mark.parametrize("name", fixtures.SHARD_CASES)
def test_sharded_twin_at_one_shard_is_the_plain_scan(name):
    """At S = 1 the twin is the unsharded plain scan (on the fixtures'
    seeded tables, both layouts); at S = 3 over the padded node axis it
    still is, on the real slots."""
    for case_name, case in fixtures.scan_cases(p=12, n=240).items():
        if case_name.split("/")[0] != name:
            continue
        for shards in (1, 3):
            tables = fixtures.shard_pad(fixtures.scan_tables(
                **case["tables"]), shards)
            node, state, pods = (port_engine._upload(t, torch.device("cpu"))
                                 for t in tables)
            a = sk.ScanArgs.from_engine(node, sk.reciprocals(node), state,
                                        pods)
            b = a._replace(state=port_engine._clone_state(a.state))
            flags = (case["weights"], case["anti_weight"],
                     case["has_aff"], case["has_spread"])
            space = sk.ShardSpace(shards, a.dims(), torch.device("cpu"))
            got = sk.scan_chunk_sharded_plain(a, *flags, space)
            want = sk.scan_chunk_plain(b, *flags)
            assert torch.equal(got, want), (case_name, shards)
            for f, x, y in zip(a.state._fields, a.state, b.state):
                assert torch.equal(x, y), (case_name, shards, f)


def test_shard_pad_leaves_the_real_slots_alone():
    tables = fixtures.scan_tables(SCAN_SEED, 8, 37, False, 2, 2, 2)
    node, state, pods = fixtures.shard_pad(tables, 8)
    assert node.valid.shape[0] == 40 and state.spread.shape[1] == 40
    assert not node.valid[37:].any() and (node.zone_id[37:] == -1).all()
    assert (node.aff_dom[:, 37:] == -1).all()
    assert np.array_equal(node.cpu_cap[:37], tables[0].cpu_cap)
    assert pods is tables[2]


# ------------------------------------------- the engine: JAX mesh gates


@pytest.mark.parametrize("shards", SHARDS)
def test_engine_sharded_matches_unsharded(shards):
    """test_device_parity.py:244."""
    snap = rand_cluster(7, n_nodes=13, n_existing=15, n_pending=25)
    want = JaxEngine(mesh=jax_mesh()).schedule(snap)[0]
    got = BatchEngine(mesh=cpu_mesh(shards)).schedule(to_port(snap))[0]
    assert got == want
    assert got == BatchEngine(device="cpu").schedule(to_port(snap))[0]
    assert got == oracle_schedule(snap)


def _narrowed_snapshot():
    nodes = [make_node(f"n-{i:02d}", 4000, (8 + 8 * (i % 3)) * 1024 * MI,
                       20, labels={"zone": f"z{i % 3}"})
             for i in range(16)]
    pods = [japi.Pod(
        metadata=japi.ObjectMeta(name=f"p-{j:02d}", namespace="default",
                                 labels={"app": "web"}),
        spec=japi.PodSpec(containers=[japi.Container(
            name="c", image="i",
            resources=japi.ResourceRequirements(requests={
                "cpu": mq(250), "memory": bq(256 * MI)}))]))
        for j in range(40)]
    svcs = [japi.Service(
        metadata=japi.ObjectMeta(name="web", namespace="default"),
        spec=japi.ServiceSpec(selector={"app": "web"}))]
    return JaxSnapshot(nodes=nodes, services=svcs, pending_pods=pods)


@pytest.mark.parametrize("shards", SHARDS)
def test_engine_sharded_narrowed_matches_oracle(shards):
    """test_device_parity.py:255: the i32-narrowed tables shard alike."""
    snap = _narrowed_snapshot()
    want = JaxEngine(mesh=jax_mesh()).schedule(snap)[0]
    engine = BatchEngine(mesh=cpu_mesh(shards))
    got, enc = engine.schedule(to_port(snap))
    assert enc.node_tab.mem_cap.dtype == np.int32
    assert got == want == oracle_schedule(snap)


@pytest.mark.parametrize("shards", SHARDS)
def test_engine_sharded_final_state_matches_jax_mesh(shards):
    """The final State of one run under each mesh, every tier at once
    (affinity terms, spread groups, ServiceAntiAffinity), field for
    field."""
    snap = with_random_affinity(rand_cluster(31, n_nodes=16, n_existing=12,
                                             n_pending=24), 3)
    jax_engine = JaxEngine(mesh=jax_mesh(), policy=POLICY)
    jax_enc, enc = encodings(snap, policy=POLICY, node_pad_to=8)
    want, want_state = jax_engine.run(jax_enc)
    engine = BatchEngine(mesh=cpu_mesh(shards), policy=port_policy(POLICY))
    got, state = engine.run(enc)
    assert np.array_equal(got, np.asarray(want))
    assert engine._enc_flags(enc) == (True, True)
    for f in state._fields:
        assert np.array_equal(getattr(state, f).numpy(), port_engine._host(
            np.asarray(getattr(want_state, f)))), f


def _encoder_with_nodes(pkg_encoder, shards, n=40):
    e = pkg_encoder(node_capacity=64, mesh_devices=shards)
    for i in range(n):
        node = make_node(f"n{i:03d}", 4000, 4 * 1024 * MI, 40)
        e.on_node_add(node if pkg_encoder is JaxIncremental
                      else cross([node])[0])
    return e


@pytest.mark.parametrize("shards", SHARDS)
def test_mesh_chained_pipeline_matches_single_run(shards):
    """test_device_parity.py:288: two chained 16-pod tiles over the mesh
    bind as one 32-pod run."""
    engine = BatchEngine(mesh=cpu_mesh(shards))
    inc = _encoder_with_nodes(IncrementalEncoder, shards)

    def pods(lo, n):
        return cross(_mk_inc_pods(f"c{lo}", n))

    p1, p2 = pods(0, 16), pods(16, 16)
    e1 = inc.encode_tile(p1, [], [], pad_to=16)
    a1, s1 = engine.run_chunked(e1, 16, block=False)
    e2 = inc.encode_tile(p2, [], [], pad_to=16)
    assert e2.state_epoch == e1.state_epoch and e2.mem_scale == e1.mem_scale
    a2, _ = engine.run_chunked(e2, 16, state_override=s1, block=False)
    a1, a2 = a1.result(), a2.result()
    inc.assume_assigned(e1, p1, a1)
    inc.assume_assigned(e2, p2, a2)
    fresh = _encoder_with_nodes(IncrementalEncoder, shards)
    eall = fresh.encode_tile(p1 + p2, [], [], pad_to=32)
    aall, _ = engine.run_chunked(eall, 32)
    assert np.array_equal(np.concatenate([a1[:16], a2[:16]]), aall[:32])
    assert int(inc.pod_count.sum()) == 32


def _drive(engine, inc, ticks, churn, port):
    """test_device_parity.py _drive_pipeline for either package."""
    hosts, prev, prev_epoch = [], None, -1
    for tick, pods in enumerate(ticks):
        pods = cross(pods) if port else pods
        e = inc.encode_tile(pods, [], [], pad_to=16)
        chain = prev if prev is not None \
            and e.state_epoch == prev_epoch else None
        a, s = engine.run_chunked(e, 16, state_override=chain,
                                  block=False)
        a = a.result() if port else np.asarray(a)
        hosts.append([e.node_names[i] if i >= 0 else None
                      for i in a[:len(pods)]])
        inc.assume_assigned(e, pods, a)
        prev, prev_epoch = s, e.state_epoch
        if tick in churn:
            churn[tick](inc, port)
    return hosts


def _obj(o, port):
    return cross([o])[0] if port else o


CHURN = {
    0: lambda inc, port: inc.on_node_add(
        _obj(make_node("n-new", 4000, 4 * 1024 * MI, 40), port)),
    1: lambda inc, port: inc.on_node_delete(
        _obj(make_node("n-003", 4000, 4 * 1024 * MI, 40), port)),
    2: lambda inc, port: inc.on_node_update(
        _obj(make_node("n-005", 4000, 4 * 1024 * MI, 40), port),
        _obj(japi.Node(metadata=japi.ObjectMeta(name="n-005"),
                       status=japi.NodeStatus(
                           capacity={"cpu": mq(4000),
                                     "memory": bq(4 * 1024 * MI),
                                     "pods": bq(40)},
                           conditions=[japi.NodeCondition(
                               type="Ready", status="False")])), port)),
}


@pytest.mark.parametrize("shards", SHARDS)
def test_mesh_chained_churn_parity(shards):
    """test_device_parity.py:371: node add, delete and a condition flip
    mid-carry; the port's mesh pipeline equals its single-device one and
    the JAX mesh pipeline, and runs off the mirror."""
    ticks = [_mk_inc_pods(t, 12) for t in range(5)]
    results = {}
    arms = {"port_mesh": (BatchEngine(mesh=cpu_mesh(shards)),
                          IncrementalEncoder, True),
            "port_single": (BatchEngine(device="cpu"), IncrementalEncoder,
                            True),
            "jax_mesh": (JaxEngine(mesh=jax_mesh()), JaxIncremental, False)}
    for kind, (engine, enc_cls, port) in arms.items():
        inc = enc_cls(mesh_devices=engine.n_shards)
        for i in range(21):
            inc.on_node_add(_obj(make_node(f"n-{i:03d}", 4000,
                                           4 * 1024 * MI, 40), port))
        results[kind] = _drive(engine, inc, ticks, CHURN, port)
    assert results["port_mesh"] == results["port_single"] \
        == results["jax_mesh"]
    stats = arms["port_mesh"][0].upload_stats
    assert stats["delta_tiles"] + stats["reuse_tiles"] >= 2, stats


@pytest.mark.parametrize("shards", SHARDS)
def test_mesh_capacity_growth_across_shard_boundary(shards):
    """test_device_parity.py:414: capacity growth re-lays the slot axis
    across shards; the mirror reseeds and parity holds."""
    def add_fleet(inc, lo, n, port):
        for i in range(lo, lo + n):
            inc.on_node_add(_obj(make_node(f"g-{i:03d}", 4000,
                                           4 * 1024 * MI, 40), port))

    churn = {1: lambda inc, port: add_fleet(inc, 6, 14, port)}
    ticks = [_mk_inc_pods(t, 10) for t in range(4)]
    engines = {"mesh": BatchEngine(mesh=cpu_mesh(shards)),
               "single": BatchEngine(device="cpu")}
    results, incs = {}, {}
    for kind, engine in engines.items():
        inc = IncrementalEncoder(node_capacity=shards,
                                 mesh_devices=engine.n_shards)
        add_fleet(inc, 0, 6, True)
        results[kind] = _drive(engine, inc, ticks, churn, True)
        incs[kind] = inc
    assert results["mesh"] == results["single"]
    grown = incs["mesh"]
    assert grown.n_cap > shards and grown.n_cap % shards == 0
    assert engines["mesh"].upload_stats["full_tiles"] >= 2


def test_mesh_density_parity():
    """test_device_parity.py:452 at a tier-1 size: 300 nodes and 600
    pods over chained tiles, the eight-shard mesh == one device."""
    results = {}
    for kind, engine in (("mesh", BatchEngine(mesh=cpu_mesh(8))),
                         ("single", BatchEngine(device="cpu"))):
        inc = IncrementalEncoder(mesh_devices=engine.n_shards)
        for i in range(300):
            inc.on_node_add(cross([make_node(f"d-{i:05d}", 8000,
                                             16 * 1024 * MI, 110)])[0])
        ticks = [_mk_inc_pods(f"d{t}", 150, cpu=300, mem=256)
                 for t in range(4)]
        results[kind] = _drive(engine, inc, ticks, {}, True)
    assert results["mesh"] == results["single"]
    assert sum(h is not None for t in results["mesh"] for h in t) == 600


@pytest.mark.parametrize("shards", SHARDS)
def test_policy_engine_sharded_matches_unsharded(shards):
    """test_device_policy.py:102: the zone histogram is a cross-shard
    sum."""
    from kubernetes_tpu.sched.device import DevicePolicy as JaxPolicy
    snap = rand_cluster(555, n_nodes=13, n_existing=18, n_pending=24)
    dev = JaxPolicy(anti_affinity_label="zone", anti_affinity_weight=2,
                    label_priorities=[("disk", True, 1)])
    want = JaxEngine(mesh=jax_mesh(), policy=dev).schedule(snap)[0]
    got = BatchEngine(mesh=cpu_mesh(shards),
                      policy=port_policy(dev)).schedule(to_port(snap))[0]
    assert got == want
    assert got == BatchEngine(device="cpu", policy=port_policy(dev)
                              ).schedule(to_port(snap))[0]
    assert got == oracle_schedule_policy(snap, dev)


@pytest.mark.parametrize("shards", SHARDS)
def test_affinity_engine_sharded_matches_jax_mesh(shards):
    """Inter-pod affinity: the term counts are replicated, every shard
    committing the same update into its own copy."""
    snap = with_random_affinity(rand_cluster(77, n_nodes=12, n_existing=10,
                                             n_pending=30), 5)
    want = JaxEngine(mesh=jax_mesh()).schedule(snap)[0]
    got = BatchEngine(mesh=cpu_mesh(shards)).schedule(to_port(snap))[0]
    assert got == want == BatchEngine(device="cpu").schedule(
        to_port(snap))[0]


@pytest.mark.parametrize("shards", SHARDS)
def test_mesh_capacity_rounds_to_device_multiple(shards):
    """test_incremental.py:486 for the port's encoder: capacity rounds up
    to a multiple of the shards at construction and across growth."""
    for n_nodes in (5, 13):
        inc = IncrementalEncoder(node_capacity=n_nodes, mesh_devices=shards)
        assert inc.n_cap % shards == 0 and inc.n_cap >= n_nodes
        for i in range(n_nodes + inc.n_cap):
            inc.on_node_add(cross([make_node(f"r-{i:03d}", 4000,
                                             1024 * MI, 8)])[0])
        assert inc.n_cap % shards == 0
        enc = inc.encode_tile(cross(_mk_inc_pods("r", 1)), [], [])
        assert enc.node_tab.valid.shape[0] % shards == 0


# ------------------------------------------------ the victim search


def _victim_twin(shards, pkg):
    inc = (JaxIncremental if pkg == "jax" else IncrementalEncoder)(
        mesh_devices=shards)
    nodes = [make_node(f"n{i:03d}", 4000, 1024 * MI, 8) for i in range(21)]
    rng = random.Random(13)
    pods, k = [], 0
    for i in range(21):
        for _ in range(rng.randrange(1, 5)):
            pods.append(_bound_pod(f"m{k:03d}", f"n{i:03d}",
                                   rng.choice([-100, -50, 0, 50]),
                                   rng.choice([400, 800, 900]), 64))
            k += 1
    if pkg == "port":
        nodes, pods = cross(nodes), cross(pods)
    for n in nodes:
        inc.on_node_add(n)
    for p in pods:
        inc.on_pod_add(p)
    pod = _preemptor(prio=100, cpu=2000)
    return inc.victim_table(pod if pkg == "jax" else cross([pod])[0])


@pytest.mark.parametrize("shards", SHARDS)
def test_preempt_parity_sharded_mesh(shards):
    """test_device_parity.py:741: the victim search split by row over the
    mesh equals the JAX mesh's, the single-device engine's and the
    oracle's, field for field."""
    jt = _victim_twin(8, "jax")
    pt = _victim_twin(shards, "port")
    got = BatchEngine(mesh=cpu_mesh(shards)).find_victims(pt)
    single = BatchEngine(device="cpu").find_victims(pt)
    want = JaxEngine(mesh=jax_mesh()).find_victims(jt)
    n = min(pt.n, jt.n)
    assert pt.n % shards == 0
    for other in (single, oracle_find_victims(pt)):
        assert (got.pick, got.kstar, got.feasible) == \
            (other.pick, other.kstar, other.feasible)
        assert np.array_equal(got.node_kstar, other.node_kstar)
        assert np.array_equal(got.node_score, other.node_score)
    assert pt.node_names[got.pick] == jt.node_names[want.pick]
    assert got.victim_keys(pt) == jax_oracle(jt).victim_keys(jt)
    assert np.array_equal(got.node_kstar[:n][pt.cand[:n]],
                          want.node_kstar[:n][jt.cand[:n]])


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8, 13])
@pytest.mark.parametrize("seed", range(3))
def test_sharded_victim_twin_equals_jax_and_the_plain_search(shards, seed):
    """victim_search_sharded_plain over random sorted tables (rows not a
    multiple of the shards included, and an all -1 table) equals JAX
    `_make_preempt` and the unsharded plain search."""
    from test_torch_preemption import _jax_preempt, _sorted_table
    for kind in ("random", "none_fit"):
        t = _sorted_table(10 + seed, 5, seed, kind) \
            if kind == "random" else _sorted_table(10, 3, seed, "random")
        if kind == "none_fit":
            t.cand[:] = False
        args = vk.VictimArgs.from_table(t, "cpu")
        pick, kstar, score = vk.victim_search_sharded_plain(args, shards)
        jp, jk, js = _jax_preempt(t)
        assert int(pick) == jp
        assert np.array_equal(kstar.numpy(), jk)
        assert np.array_equal(score.numpy(), js)
        res = vk.victim_search_sharded(args, shards)
        assert int(res.pick) == jp
        p2, k2, s2 = vk.victim_search_plain(args)
        assert int(p2) == jp and torch.equal(k2, kstar) and \
            torch.equal(s2, score)


def test_sharded_victim_plan():
    plan, b = vk.sharded_plan(5120, 16, 4, sms=132)
    per = vk.launch_plan(1280, 16, 33)
    assert b == 1280 and plan.grid == 4 * per.grid
    assert plan.group == per.group and plan.threads == per.threads
    # one counter and the unsharded layout: pick, kstar, score, and a
    # winner a block
    assert vk.out_words(5120, plan) == 1 + 2 * 5120 + 2 * plan.grid
    with pytest.raises(ValueError, match="shards"):
        vk.victim_search_sharded(vk.VictimArgs.from_table(
            __import__("test_torch_preemption")._sorted_table(4, 2, 0),
            "cpu"), 0)


# ------------------------------------------------ the batch loop


@pytest.mark.parametrize("shards", [2, 8])
def test_batch_scheduler_on_sharded_mesh_end_to_end(shards):
    """test_batch_sched.py:159: the live loop over a mesh binds every
    pod exactly as one uninterrupted engine run over the same pods."""
    registry = Registry()
    client = InProcClient(registry)
    factory = ConfigFactory(client, rate_limit=False).start()
    config = factory.create_batch(mesh=cpu_mesh(shards))
    assert config.engine.n_shards == shards
    sched = BatchScheduler(config).run()
    try:
        for i in range(16):
            client.create("nodes", cross([ready_node(f"mnode-{i:02d}")])[0])
        assert wait_until(lambda: len(factory.node_lister.list()) == 16,
                          timeout=30)
        for i in range(200):
            client.create("pods", cross([pending_pod(
                f"mpod-{i:03d}", labels={"app": "m"})])[0])
        assert wait_until(lambda: all(
            p.spec.node_name for p in client.list("pods")[0]), timeout=120)
        bound = {p.metadata.name: p.spec.node_name
                 for p in client.list("pods")[0]}
        # the JAX engine under its mesh, on the same objects
        want, _ = JaxEngine(mesh=jax_mesh()).schedule(JaxSnapshot(
            nodes=[ready_node(f"mnode-{i:02d}") for i in range(16)],
            services=[],
            pending_pods=[pending_pod(f"mpod-{i:03d}", labels={"app": "m"})
                          for i in range(200)]))
        for i, host in enumerate(want):
            assert bound[f"mpod-{i:03d}"] == host, (i, host)
        assert sched.config.engine.scan_stats["runs"] >= 1
    finally:
        sched.stop()
        factory.stop()


def test_k7_bound_counts_the_records():
    """K7's bound: each shard's records written once, their payload
    only (the flags beside it are the protocol's): a candidate a valid
    pod (composite and slot), a group max a spread pod, a zone histogram
    an anti pod (an int32 a zone), a done record; bytes over the memory
    rate."""
    from kubernetes_tpu_torch.sched.device import bounds
    rate = {"int_ops_per_s": 1e12}
    got = bounds.k7_bound(4, 100, 10, 5, 3, rate)
    assert got["k7_bytes"] == 4 * (100 * 12 + 10 * 4 + 5 * 4 * 3 + 8)
    assert got["k7_ops"] == 3 * (3 * 100 + 10 + 3 * 5)
    assert got["k7_bound_by"] == "bytes"
    assert got["k7_bound_ms"] == got["k7_bytes"] / bounds.HBM_BYTES_PER_S \
        * 1e3
    assert bounds.k7_bound(1, 100, 0, 0, 1, rate)["k7_ops"] == 0


def test_k7_profile_edits_apply_to_the_source(tmp_path, monkeypatch):
    """profile_kernels' K7 copy: this source carries the probe points
    (each exchange kind's six, the first poll in k7_read, the launch's
    begin and end) and gets their definitions before them and the
    reader; a source without the points is refused."""
    from kubernetes_tpu_torch.kubemark import profile_kernels as pk
    monkeypatch.setattr(pk, "VARIANT_DIR", str(tmp_path))
    base = open(sk.SOURCE).read()
    for kind in range(3):
        for phase in (0, 1, 3, 4, 5):
            assert f"K7_MARK({kind}, {phase});" in base, (kind, phase)
    assert "K7_MARK(-1, 2)" in base and "K7_PROBE_END(shard);" in base
    text = open(pk._variant("k7", sk.SOURCE, pk._k7_edits(base))).read()
    assert text.index("#define K7_MARK(kind, phase) k7_mark") < \
        text.index("#ifndef K7_MARK")
    assert "k7_dbg_read" in text
    with pytest.raises(ValueError):
        pk._k7_edits(base.replace("#ifndef K7_MARK", "#if 0"))


def test_sharded_victim_profile_edits_apply_to_the_source(tmp_path,
                                                          monkeypatch):
    """profile_kernels' K4 copy takes the sharded K4's slots too: its
    start, first maximum, counter and end, each anchor found once after
    K4's own edits, so both kernels write the same eight slots."""
    from kubernetes_tpu_torch.kubemark import profile_kernels as pk
    from kubernetes_tpu_torch.sched.device import victim_kernel as vk
    monkeypatch.setattr(pk, "VARIANT_DIR", str(tmp_path))
    text = open(pk._variant("phases", vk.SOURCE, pk._phase_edits()
                            + pk._sharded_phase_edits())).read()
    body = text[text.index("victim_sharded_kernel(const VictimParams a)"):]
    body = body[:body.index("extern \"C\"")]
    at = "victim_dbg[(blockIdx.y * gridDim.x + blockIdx.x) * 8 + %d]"
    for slot in range(8):
        if slot not in (1, 2):      # search_node's, shared with K4
            assert at % slot in body, slot
    assert text.count(at % 1) == text.count(at % 2) == 1
    assert "victim_dbg[blockIdx.x * 8 + 1]" not in text
    assert body.index("+ 4] = clock64()") > body.index("count_done(")
    assert body.index("+ 5] = clock64()") > body.index("a.pick[0] = best_j")


def test_mesh_delta_tile_routes_rows_to_their_owners(monkeypatch):
    """Under a mesh the mirror stays one tensor with each shard's block a
    view of it: a delta tile still goes out in one staging buffer and
    one K3 launch, each dirty row lands in its owner's block (slot //
    block) as a full upload would put it, and the tile equals the
    unsharded engine's."""
    from kubernetes_tpu_torch.sched.device import scatter_kernel
    launches = []
    real = scatter_kernel.apply_staged
    monkeypatch.setattr(scatter_kernel, "apply_staged",
                        lambda staged: launches.append(1) or real(staged))
    results, mirrors = {}, {}
    mesh = cpu_mesh(4)
    for kind, engine in (("mesh", BatchEngine(mesh=mesh)),
                         ("single", BatchEngine(device="cpu"))):
        inc = IncrementalEncoder(node_capacity=16, mesh_devices=4)
        for i in range(16):
            inc.on_node_add(cross([make_node(f"n-{i:02d}", 4000,
                                             4 * 1024 * MI, 40)])[0])
        pods = cross(_mk_inc_pods("a", 8))
        e1 = inc.encode_tile(pods, [], [], pad_to=8)
        a1, _ = engine.run_chunked(e1, 8)
        inc.assume_assigned(e1, pods, a1)
        launches.clear()
        e2 = inc.encode_tile(cross(_mk_inc_pods("b", 8)), [], [], pad_to=8)
        a2, _ = engine.run_chunked(e2, 8)
        results[kind] = (a1.tolist(), a2.tolist(), len(launches))
        mirrors[kind] = engine._table_cache
        if kind == "mesh":
            assert engine.upload_stats["delta_tiles"] == 1
            full = BatchEngine(mesh=mesh)
            full.run_chunked(e2, 8)
            assert full.upload_stats["full_tiles"] == 1
            rows = np.nonzero(e2.delta.state_dirty_gen
                              > e1.delta.table_gen)[0]
            assert rows.size
            n = engine._table_cache.state.cpu_used.shape[0]
            for s in rows.tolist():
                lo, hi = mesh.blocks(n)[mesh.owner(s, n)]
                got = block_view(engine._table_cache.state, STATE_SPLIT,
                                 lo, hi)
                want = block_view(full._table_cache.state, STATE_SPLIT,
                                  lo, hi)
                for f, ax in STATE_SPLIT.items():
                    g, w = getattr(got, f), getattr(want, f)
                    if ax == 0:
                        assert torch.equal(g[s - lo], w[s - lo]), f
                    else:
                        assert torch.equal(g[:, s - lo], w[:, s - lo]), f
            for tab in ("node", "state"):
                for g, w in zip(getattr(engine._table_cache, tab),
                                getattr(full._table_cache, tab)):
                    assert torch.equal(g, w)
    for tab in ("node", "state"):
        for g, w in zip(getattr(mirrors["mesh"], tab),
                        getattr(mirrors["single"], tab)):
            assert torch.equal(g, w)
    assert results["mesh"] == results["single"]
    assert results["mesh"][2] == 1


# ------------------------------------ numpy models of K7's two protocols


def _k7_flag_model(seed, launches=3000, shards=3, words=3, gen_max=5,
                   flag=lambda gen, m: gen << 2 | (m & 3), slots=2,
                   zero_at_wrap=True):
    """The sharded K1's record protocol (csrc/scan_kernel.cu, struct K7)
    as a random interleaving of relaxed word stores and polls. Each
    launch takes its generation from the header (+1); per kind, shard r
    posts counts 0 .. M - 1 (a word a step, in any order, into slot
    m % slots), and after posting m reads every shard's record of count
    m, polling until each word carries flag(gen, m). It posts m + 1 only
    once it has read m. The last shard past its reads ends the launch:
    generation gen_max zeroes every record and sets the header to 0.
    The zone kind is used in launch 0 and then only by launches whose
    generation it last had, so its slots sit unused across a wrap. ->
    None, or the first fault: a record accepted with another write's
    payload (stale), or a write into a slot that a reader has still to
    read (the parity reuse rule)."""
    rng = np.random.default_rng(seed)
    buf = {}          # (kind, slot, shard, word) -> (flag, payload)
    header = 0
    for launch in range(launches):
        gen = header + 1
        counts = {"cand": int(rng.integers(1, 6))}
        if launch == 0 or (gen == 1 and rng.random() < 0.7):
            counts["zone"] = int(rng.integers(1, 4))
        for kind, total in counts.items():
            read = [0] * shards         # counts each shard has read
            posting = [list(rng.permutation(words)) for _ in range(shards)]
            posted = [0] * shards       # counts each shard has posted
            while min(read) < total:
                r = int(rng.integers(shards))
                if read[r] == total:
                    continue
                if posted[r] == read[r]:          # post count m, a word
                    m = posted[r]
                    if min(read) < m + 1 - slots:
                        return ("reuse", launch, kind, r, m)
                    w = posting[r].pop()
                    buf[kind, m % slots, r, w] = (flag(gen, m),
                                                  (launch, r, m, w))
                    if not posting[r]:
                        posted[r] += 1
                        posting[r] = list(rng.permutation(words))
                    continue
                m = read[r]                       # poll count m, once
                got = [buf.get((kind, m % slots, q, w), (0, None))
                       for q in range(shards) for w in range(words)]
                if all(f == flag(gen, m) for f, _ in got):
                    want = [(launch, q, m, w) for q in range(shards)
                            for w in range(words)]
                    if [v for _, v in got] != want:
                        return ("stale", launch, kind, r, m)
                    read[r] += 1
        if gen == gen_max:
            if zero_at_wrap:
                buf = {}
            header = 0
        else:
            header = gen
    return None


def test_k7_flag_protocol_numpy_model():
    """The flag-in-data records: over 3000 launches of random
    interleavings, with the zone slots left unused across generation
    wraps, no reader accepts a stale word and no write lands in a slot
    a reader has still to read. The model's rule is the source's: the
    flag's expression, the records by parity, the zeroing at
    K7_GEN_MAX. Each part of the rule is needed: a flag without the
    count's bits accepts the slot's last use, one slot a kind breaks the
    reuse rule, and no zeroing accepts a word from before the wrap."""
    src = open(sk.SOURCE).read()
    assert "return gen << 2 | (m & 3);" in src
    assert "#define K7_GEN_MAX ((1u << 30) - 1)" in src
    assert sk.K7_GEN_MAX == (1 << 30) - 1
    assert "const int par = count & 1" in src
    assert "if (x.gen == K7_GEN_MAX)" in src
    for seed in range(3):
        assert _k7_flag_model(seed) is None
    assert _k7_flag_model(0, flag=lambda gen, m: gen)[0] == "stale"
    assert _k7_flag_model(0, flag=lambda gen, m: gen << 1 | (m & 1))[0] \
        == "stale"
    assert _k7_flag_model(0, slots=1)[0] == "reuse"
    assert _k7_flag_model(0, zero_at_wrap=False)[0] == "stale"


_LLONG_MIN, _INT_MAX = -(1 << 63), (1 << 31) - 1


def _beats(s, i, t, j):
    return s > t or (s == t and i < j)


def _warp_best(pairs, beats=_beats):
    """redux.sync's best over a warp's (score, index) pairs."""
    best = (_LLONG_MIN, _INT_MAX)
    for s, i in pairs:
        if beats(s, i, *best):
            best = (s, i)
    return best


def _k4_one_counter(block_s, block_i, shards, warps, beats=_beats):
    """victim_sharded_kernel's last block: warp w takes shards w, w +
    warps, ...: each shard's blocks lane-strided (lane l: l, l + 32,
    ...), the warp's best of them the shard's winner, the warp's best of
    its shards' winners; then warp 0 the best of the warps'."""
    per = len(block_s) // shards
    out = []
    for w in range(warps):
        best = (_LLONG_MIN, _INT_MAX)
        for r in range(w, shards, warps):
            lanes = []
            for lane in range(32):
                lanes.append(_warp_best(
                    [(block_s[r * per + b], block_i[r * per + b])
                     for b in range(lane, per, 32)], beats))
            s, i = _warp_best(lanes, beats)
            if beats(s, i, *best):
                best = (s, i)
        out.append(best)
    return _warp_best(out, beats)[1]


def _k4_two_level(block_s, block_i, shards):
    """The JAX engine's order: each shard's first maximum, then the
    first maximum of the shards' (np.argmax twice)."""
    per = len(block_s) // shards
    wins = []
    for r in range(shards):
        s = np.asarray(block_s[r * per:(r + 1) * per])
        i = np.asarray(block_i[r * per:(r + 1) * per])
        top = s.max()
        wins.append((int(top), int(i[s == top].min())))
    top = max(s for s, _ in wins)
    return min(i for s, i in wins if s == top)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_k4_one_counter_reduction_numpy_model(shards):
    """The sharded K4's one-counter reduction (a warp a shard over its
    blocks, then the shards' winners) equals the two-level one and the
    first maximum of the whole score vector, ties included (scores from
    a few values, -1 where nothing helps), with 1 to 70 blocks a shard
    and fewer warps than shards; it fails when ties go to the larger
    index."""
    rng = np.random.default_rng(shards)
    for trial in range(40):
        per = int(rng.integers(1, 71))
        warps = int(rng.choice([1, 3, 32]))
        rows = int(rng.integers(1, 9))            # nodes a block
        score = rng.choice([-1, 5, 7, 7, 9], size=shards * per * rows)
        if trial % 5 == 0:
            score[:] = -1
        bs, bi = [], []
        for b in range(shards * per):
            blk = score[b * rows:(b + 1) * rows]
            bs.append(int(blk.max()))
            bi.append(b * rows + int(np.argmax(blk)))
        got = _k4_one_counter(bs, bi, shards, warps)
        assert got == _k4_two_level(bs, bi, shards) == int(np.argmax(score))
    bs, bi = [7] * (2 * shards), list(range(2 * shards))
    assert _k4_one_counter(bs, bi, shards, 32,
                           beats=lambda s, i, t, j: s > t or
                           (s == t and i > j)) != _k4_two_level(bs, bi,
                                                                shards)
