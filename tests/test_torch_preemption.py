"""The port's priority preemption (kubernetes_tpu_torch.sched.preemption,
IncrementalEncoder.victim_table, BatchEngine.find_victims over the victim
kernel's plain version, the batch loop's _try_preempt) against the JAX
package's, on the CPU.

A JAX encoder and the port's are fed the same bound pods (through the
wire format); every victim table the two cut must be field-equal, and
the port's search bit-equal to the JAX engine's and to the serial oracle
(pick, k*, feasibility, the per-node arrays, the victim keys), on every
single-device shape of tests/test_device_parity.py and a seeded sweep.
The batch loops of both packages, driven without their threads over
registries holding the same cluster, must make the same eviction
decisions. Tolerance 0: everything here is an integer."""

import random

import numpy as np
import pytest
import torch

from kubernetes_tpu.api.client import InProcClient as JaxClient
from kubernetes_tpu.api.registry import Registry as JaxRegistry
from kubernetes_tpu.sched.batch import BatchScheduler as JaxScheduler
from kubernetes_tpu.sched.batch import BatchSchedulerConfig as JaxConfig
from kubernetes_tpu.sched.device import BatchEngine as JaxEngine
from kubernetes_tpu.sched.device.incremental import \
    IncrementalEncoder as JaxIncremental
from kubernetes_tpu.sched.factory import ConfigFactory as JaxFactory
from kubernetes_tpu.sched.preemption import \
    PreemptionPass as JaxPreemptionPass
from kubernetes_tpu.sched.preemption import \
    oracle_find_victims as jax_oracle
from kubernetes_tpu.utils.clock import FakeClock as JaxFakeClock
from kubernetes_tpu_torch.api.client import InProcClient
from kubernetes_tpu_torch.api.registry import Registry
from kubernetes_tpu_torch.sched.batch import (BatchScheduler,
                                              BatchSchedulerConfig)
from kubernetes_tpu_torch.sched.device import BatchEngine, victim_kernel
from kubernetes_tpu_torch.sched.device.incremental import IncrementalEncoder
from kubernetes_tpu_torch.sched.factory import ConfigFactory
from kubernetes_tpu_torch.sched.preemption import (PreemptionPass,
                                                   oracle_find_victims)
from kubernetes_tpu_torch.utils.clock import FakeClock

from test_device_parity import MI, _bound_pod, _preemptor, make_node
from test_torch_encode import cross

TABLE_ARRAYS = ("cand", "cpu_cap", "mem_cap", "pod_cap", "cpu_used",
                "mem_used", "pod_count", "tie_rank", "v_prio", "v_cpu",
                "v_mem", "v_valid")
TABLE_SCALARS = ("pod_key", "pod_uid", "prio", "req_cpu", "req_mem",
                 "zero_req", "victims", "node_names", "state_epoch",
                 "shard_epochs")


class Twin:
    """A JAX encoder and the port's, fed the same events."""

    def __init__(self, n_nodes=6, node_capacity=8):
        self.jax = JaxIncremental(node_capacity=node_capacity)
        self.port = IncrementalEncoder(node_capacity=node_capacity)
        for i in range(n_nodes):
            self.event("on_node_add", make_node(f"n{i:03d}", 4000,
                                                1024 * MI, 8))

    def event(self, name, *objs):
        getattr(self.jax, name)(*objs)
        getattr(self.port, name)(*cross(objs))

    def tables(self, pod):
        """-> (JAX table, port table), held field-equal."""
        jt = self.jax.victim_table(pod)
        pt = self.port.victim_table(cross([pod])[0])
        assert_tables_equal(jt, pt)
        assert pt.encoder_id == self.port.encoder_id
        return jt, pt


def assert_tables_equal(jt, pt):
    for f in TABLE_ARRAYS:
        a, b = getattr(jt, f), getattr(pt, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f
    for f in TABLE_SCALARS:
        assert getattr(jt, f) == getattr(pt, f), f


def search(twin, pod, engine=None):
    """The port's search bit-equal to the JAX engine's and to both
    oracles on the same cut. -> the port's result and table."""
    jt, pt = twin.tables(pod)
    got = (engine or BatchEngine(device="cpu")).find_victims(pt)
    for want in (JaxEngine().find_victims(jt), jax_oracle(jt),
                 oracle_find_victims(pt)):
        assert (got.pick, got.kstar, got.feasible) == \
            (want.pick, want.kstar, want.feasible)
        assert got.node_kstar.dtype == np.int64
        assert np.array_equal(got.node_kstar, want.node_kstar)
        assert np.array_equal(got.node_score, want.node_score)
    assert got.victim_keys(pt) == jax_oracle(jt).victim_keys(jt)
    return got, pt


def test_parity_mixed_priorities():
    twin = Twin()
    k = 0
    for i in range(6):
        for prio, cpu in [(-100, 900), (-100, 900), (-50, 900), (0, 900)]:
            twin.event("on_pod_add", _bound_pod(f"b{k:03d}", f"n{i:03d}",
                                                prio, cpu, 64))
            k += 1
    got, t = search(twin, _preemptor(prio=100, cpu=1000))
    assert got.feasible and got.kstar > 0
    assert got.victim_keys(t) == t.victims[got.pick][:got.kstar]


def test_parity_identical_nodes_tie():
    twin = Twin()
    for i in range(6):
        twin.event("on_pod_add", _bound_pod(f"t{i}", f"n{i:03d}", -100,
                                            3600, 64))
    got, _ = search(twin, _preemptor(cpu=1000))
    assert got.feasible and got.kstar == 1


def test_parity_no_feasible_victims():
    twin = Twin()
    for i in range(6):
        twin.event("on_pod_add", _bound_pod(f"h{i}", f"n{i:03d}", 1000,
                                            3600, 64))
    got, t = search(twin, _preemptor(prio=100, cpu=1000))
    assert not got.feasible and got.pick == 0
    assert (got.node_score == -1).all() and (got.node_kstar == 0).all()
    assert got.victim_keys(t) == []


def test_parity_zero_request_counts_only():
    twin = Twin()
    for i in range(6):
        for j in range(8):
            twin.event("on_pod_add", _bound_pod(f"z{i}-{j}", f"n{i:03d}",
                                                -100, 10, 1))
    jt, _ = twin.tables(_preemptor(cpu=0, mem=0))
    assert jt.zero_req
    got, _ = search(twin, _preemptor(cpu=0, mem=0))
    assert got.feasible and got.kstar == 1


def test_parity_free_node_wins():
    twin = Twin()
    for i in range(5):
        twin.event("on_pod_add", _bound_pod(f"f{i}", f"n{i:03d}", -100,
                                            3600, 64))
    got, t = search(twin, _preemptor(cpu=1000))
    assert got.feasible and got.kstar == 0
    assert t.node_names[got.pick] == "n005"


def test_parity_mid_tile_node_death():
    twin = Twin()
    for i in range(6):
        twin.event("on_pod_add", _bound_pod(f"d{i}", f"n{i:03d}", -100,
                                            3600, 64))
    pod = _preemptor(cpu=1000)
    got, before = search(twin, pod)
    victim_node = before.node_names[got.pick]
    twin.event("on_node_delete", make_node(victim_node, 4000, 1024 * MI, 8))
    got2, after = search(twin, pod)
    assert after.state_epoch > before.state_epoch
    assert not after.cand[before.node_names.index(victim_node)]
    assert got2.feasible and after.node_names[got2.pick] != victim_node


@pytest.mark.parametrize("seed", range(12))
def test_parity_random_sweep(seed):
    """The JAX package's sweep (seeds 0-5) and six more: random clusters
    and preemptors, pinned hosts among them."""
    rng = random.Random(seed)
    twin = Twin(n_nodes=rng.randrange(3, 9), node_capacity=16)
    k = 0
    for i in range(len(twin.port.node_slot)):
        for _ in range(rng.randrange(0, 7)):
            twin.event("on_pod_add", _bound_pod(
                f"r{seed}-{k:03d}", f"n{i:03d}", rng.randrange(-200, 200),
                rng.choice([0, 100, 500, 900, 1200]),
                rng.choice([16, 64, 128])))
            k += 1
    pod = _preemptor(prio=rng.randrange(-100, 1001),
                     cpu=rng.choice([0, 500, 1000, 2000]),
                     mem=rng.choice([0, 64, 256]))
    if seed >= 6 and rng.random() < 0.5:
        pod.spec.node_name = f"n{rng.randrange(len(twin.port.node_slot)):03d}"
    search(twin, pod)


@pytest.mark.parametrize("v,n", [(1, 1), (1, 7), (3, 5), (16, 33)])
def test_plain_search_equals_oracle_on_random_tables(v, n):
    """The kernel's plain version on tables the encoder does not cut:
    unsorted victims, holes in the valid mask, zero capacities, pod caps
    at the count, a table of one victim column."""
    from kubernetes_tpu_torch.sched.preemption import VictimTable
    rng = np.random.default_rng(v * 100 + n)
    for trial in range(25):
        t = VictimTable(
            pod_key=("default", "p"), pod_uid="u",
            prio=int(rng.integers(-3, 4)), req_cpu=int(rng.integers(0, 6)),
            req_mem=int(rng.integers(0, 6)), zero_req=trial % 5 == 0,
            cand=rng.random(n) < 0.8,
            cpu_cap=rng.integers(0, 10, n), mem_cap=rng.integers(0, 10, n),
            pod_cap=rng.integers(0, 5, n), cpu_used=rng.integers(0, 12, n),
            mem_used=rng.integers(0, 12, n), pod_count=rng.integers(0, 6, n),
            tie_rank=rng.permutation(n).astype(np.int64),
            v_prio=rng.integers(-3, 3, (n, v)), v_cpu=rng.integers(0, 5, (n, v)),
            v_mem=rng.integers(0, 5, (n, v)), v_valid=rng.random((n, v)) < 0.7,
            victims=[[("default", f"v{j}-{i}", f"u{j}-{i}") for i in range(v)]
                     for j in range(n)],
            node_names=[f"n{j}" for j in range(n)])
        got = BatchEngine(device="cpu").find_victims(t)
        want = oracle_find_victims(t) if _prefix_masked(t) else None
        pick, kstar, score = victim_kernel.victim_search_plain(
            victim_kernel.VictimArgs.from_table(t, "cpu"))
        assert (got.pick, got.feasible) == (int(pick), bool(score[got.pick]
                                                             >= 0))
        assert np.array_equal(got.node_kstar, kstar.numpy())
        assert np.array_equal(got.node_score, score.numpy())
        if want is not None:
            assert np.array_equal(got.node_score, want.node_score)
            assert np.array_equal(got.node_kstar, want.node_kstar)


def _prefix_masked(t) -> bool:
    """The oracle releases the first k entries whatever their mask; the
    device formulation releases only the masked ones. They agree when
    each row's evictable entries form a prefix, as the encoder cuts
    them."""
    vm = t.v_valid & (t.v_prio < t.prio)
    return bool((np.diff(vm.astype(np.int8), axis=1) <= 0).all())


def test_walk_counts_what_the_search_reads():
    """victim_kernel.walk: every candidate node steps to its first
    fitting k; a node with nothing evictable and no room walks every
    column."""
    twin = Twin()
    for i in range(6):
        twin.event("on_pod_add", _bound_pod(f"w{i}", f"n{i:03d}", -100,
                                            3600, 64))
    _, t = twin.tables(_preemptor(cpu=1000))
    read, steps = victim_kernel.walk(
        victim_kernel.VictimArgs.from_table(t, "cpu"))
    assert (read, steps) == (6, 12)       # k = 1 on each of 6 nodes
    _, t = twin.tables(_preemptor(prio=-1000, cpu=1000))
    read, steps = victim_kernel.walk(
        victim_kernel.VictimArgs.from_table(t, "cpu"))
    assert t.v == 1 and (read, steps) == (6, 12)


# ------------------------------------------------ the batch loop, unthreaded

CLUSTER = [("n000", [(-100, 900), (-100, 900), (0, 900), (0, 900)]),
           ("n001", [(-50, 1900), (-10, 1900)]),
           ("n002", [(500, 3800)]),
           ("n003", [(-100, 2000), (200, 1900)])]
PREEMPTORS = [("hi", 100, 1800, 64), ("mid", 0, 900, 64),
              ("top", 1000, 3000, 64), ("low", -500, 500, 64),
              ("free", 100, 0, 0)]


def _loop(pkg):
    """One package's batch scheduler over a registry holding CLUSTER, its
    encoder fed the same objects directly; no thread is started."""
    if pkg == "jax":
        client = JaxClient(JaxRegistry())
        factory = JaxFactory(client, rate_limit=False)
        pre = JaxPreemptionPass(seed=3, clock=JaxFakeClock())
        sched = JaxScheduler(JaxConfig(factory, engine=JaxEngine(),
                                       preemption=pre))
        inc, conv = JaxIncremental(), (lambda o: o)
    else:
        client = InProcClient(Registry())
        factory = ConfigFactory(client, rate_limit=False)
        pre = PreemptionPass(seed=3, clock=FakeClock())
        sched = BatchScheduler(BatchSchedulerConfig(
            factory, engine=BatchEngine(device="cpu"), preemption=pre))
        inc, conv = IncrementalEncoder(), (lambda o: cross([o])[0])
    for name, pods in CLUSTER:
        node = conv(make_node(name, 4000, 1024 * MI, 8))
        client.create("nodes", node)
        inc.on_node_add(node)
        for j, (prio, cpu) in enumerate(pods):
            pod = conv(_bound_pod(f"{name}-{j}", name, prio, cpu, 64))
            client.create("pods", pod)
            inc.on_pod_add(client.get("pods", pod.metadata.name, "default"))
    sched._inc = inc
    return sched, client, conv


def _decisions(pkg):
    sched, client, conv = _loop(pkg)
    for name, prio, cpu, mem in PREEMPTORS:
        sched._route_unscheduled([conv(_preemptor(name, prio, cpu, mem))])
    pre = sched.config.preemption
    gone = sorted(p.metadata.name for p in client.list("pods", "default")[0]
                  if p.metadata.deletion_timestamp)
    queued = sorted(p.metadata.name
                    for p in sched.config.factory.pod_queue.list())
    return ([(d.pod_key, d.node, d.pick, d.kstar, d.score, d.victims,
              d.evicted) for d in pre.decisions], gone, queued,
            pre.audit())


def test_route_unscheduled_makes_the_jax_loops_decisions():
    want = _decisions("jax")
    got = _decisions("port")
    assert got == want
    decisions, gone, queued, audit = got
    assert audit == []
    assert len(decisions) >= 2 and gone
    assert all(d[3] > 0 for d in decisions)


def test_victim_search_failure_is_not_no_preemption(monkeypatch):
    """A failing search (a refused kernel launch) raises through
    _try_preempt, and _route_unscheduled sends the pod down the error
    path with that failure, not with a FitError."""
    sched, _, conv = _loop("port")

    def refused(args):
        raise RuntimeError("victim kernel launch failed: CUDA error 9 "
                           "(cudaErrorInvalidConfiguration)")

    monkeypatch.setattr(victim_kernel, "victim_search", refused)
    pod = conv(_preemptor("hi", 100, 1800, 64))
    with pytest.raises(RuntimeError, match="victim kernel"):
        sched._try_preempt(pod)
    errors = []
    monkeypatch.setattr(sched, "_error",
                        lambda p, e: errors.append((p.metadata.name, e)))
    sched._route_unscheduled([pod])
    assert [(n, type(e)) for n, e in errors] == [("hi", RuntimeError)]
    assert sched.config.preemption.decisions == []


def test_victim_table_cut_failure_takes_the_plain_error_path(monkeypatch):
    from kubernetes_tpu_torch.sched.generic import FitError
    sched, _, conv = _loop("port")

    def torn(pod):
        raise KeyError("default/gone")

    monkeypatch.setattr(sched._inc, "victim_table", torn)
    errors = []
    monkeypatch.setattr(sched, "_error",
                        lambda p, e: errors.append(type(e)))
    sched._route_unscheduled([conv(_preemptor("hi", 100, 1800, 64))])
    assert errors == [FitError]


def test_create_batch_takes_a_preemption_pass():
    factory = ConfigFactory(InProcClient(Registry()), rate_limit=False)
    pre = PreemptionPass(seed=1, clock=FakeClock())
    config = factory.create_batch(device="cpu", preemption=pre)
    assert config.preemption is pre


# ------------------------------------ the victim kernel's packing and lanes

def _jax_preempt(t):
    """JAX `_make_preempt` on a VictimTable's arrays -> (pick, kstar,
    score) as numpy."""
    import jax
    from kubernetes_tpu.sched.device.engine import _make_preempt, ensure_x64
    ensure_x64()                      # as the JAX engine runs it
    pick, kstar, score = jax.jit(_make_preempt())(
        t.cand, t.cpu_cap, t.mem_cap, t.pod_cap, t.cpu_used, t.mem_used,
        t.pod_count, t.tie_rank, t.v_prio, t.v_cpu, t.v_mem, t.v_valid,
        np.int64(t.prio), np.int64(t.req_cpu), np.int64(t.req_mem),
        np.bool_(t.zero_req))
    return int(pick), np.asarray(kstar), np.asarray(score)


def _sorted_table(n, v, seed, kind="random"):
    """A VictimTable as the encoder cuts them: each row's victims sorted
    (priority asc), the valid ones first, the pad at PMAX + 1, so the
    evictable ones form a prefix and the oracle applies. `kind`:
    "infeasible" (every victim outranks the preemptor and no node has
    room), "zero_req" (a preemptor that requests nothing), "ties" (every
    node the same but its tie_rank)."""
    from kubernetes_tpu_torch.sched.preemption import PMAX, VictimTable
    rng = np.random.default_rng(seed)
    rows = 1 if kind == "ties" else n
    count = rng.integers(0, v + 1, rows)
    prio = np.sort(rng.integers(-50, 50, (rows, v)), axis=1)
    valid = np.arange(v)[None, :] < count[:, None]
    prio = np.where(valid, prio, PMAX + 1)
    cpu = np.where(valid, rng.integers(0, 600, (rows, v)), 0)
    mem = np.where(valid, rng.integers(0, 600, (rows, v)), 0)
    cpu_cap = rng.choice([0, 2000, 4000], rows)
    mem_cap = rng.choice([0, 2000, 4000], rows)
    pod_cap = rng.integers(0, v + 2, rows)
    node = dict(cand=rng.random(rows) < 0.9, cpu_cap=cpu_cap,
                mem_cap=mem_cap, pod_cap=pod_cap,
                cpu_used=rng.integers(0, 4500, rows),
                mem_used=rng.integers(0, 4500, rows),
                pod_count=np.minimum(count, pod_cap + 1))
    preemptor = 100 if kind == "infeasible" else int(rng.integers(-20, 60))
    if kind == "infeasible":
        prio = np.where(valid, prio + 200, prio)
        node["pod_count"] = node["pod_cap"].copy()
    if kind == "ties":
        node = {k: np.repeat(x, n) for k, x in node.items()}
        node["cand"][:] = True
        prio, cpu, mem, valid = (np.repeat(x, n, axis=0)
                                 for x in (prio, cpu, mem, valid))
    zero = kind == "zero_req"
    return VictimTable(
        pod_key=("default", "p"), pod_uid="u", prio=preemptor,
        req_cpu=0 if zero else int(rng.integers(1, 2500)),
        req_mem=0 if zero else int(rng.integers(0, 2500)), zero_req=zero,
        tie_rank=rng.permutation(n).astype(np.int64),
        v_prio=prio.astype(np.int64), v_cpu=cpu.astype(np.int64),
        v_mem=mem.astype(np.int64), v_valid=valid,
        victims=[[("default", f"v{j}-{i}", f"u{j}-{i}") for i in range(v)]
                 for j in range(n)],
        node_names=[f"n{j}" for j in range(n)],
        **{k: x.astype(bool if k == "cand" else np.int64)
           for k, x in node.items()})


@pytest.mark.parametrize("v", [0, 1, 16, 31, 32, 33, 64])
def test_packed_args_hold_the_tables_fields(v):
    """VictimArgs.from_table packs the table into one buffer: every
    field is a view into it and equals the table's array."""
    t = _sorted_table(37, v, v)
    a = victim_kernel.VictimArgs.from_table(t, "cpu")
    lo = a.packed.data_ptr()
    hi = lo + a.packed.numel()
    parts, nbytes = victim_kernel.packed_layout(t.n, t.v)
    assert a.packed.dtype == torch.uint8 and a.packed.numel() == nbytes
    for f in TABLE_ARRAYS:
        x = getattr(a, f)
        if x.numel():              # an empty view has no address
            assert lo <= x.data_ptr() and x.data_ptr() + x.numel() * \
                x.element_size() <= hi, f
            assert x.data_ptr() - lo == parts[f][0]
        assert parts[f][0] % 16 == 0
        assert parts[f][3] == x.numel() * x.element_size()
        assert x.is_contiguous() and tuple(x.shape) == getattr(t, f).shape
        assert np.array_equal(x.numpy(), getattr(t, f)), f
    assert (a.prio, a.req_cpu, a.req_mem, a.zero_req) == \
        (t.prio, t.req_cpu, t.req_mem, t.zero_req)
    # the parts do not overlap and fill the buffer in order
    ends = sorted((off, off + size) for off, _, _, size in parts.values())
    assert all(e <= s for (_, e), (s, _) in zip(ends, ends[1:]))
    assert ends[-1][1] <= nbytes


@pytest.mark.parametrize("kind", ["random", "infeasible", "zero_req",
                                  "ties"])
@pytest.mark.parametrize("v", [0, 1, 16, 31, 32, 33, 64])
def test_plain_search_over_packed_args_equals_jax_and_the_oracle(v, kind):
    """The plain version over the packed args equals JAX _make_preempt
    and the serial oracle, and find_victims returns the same through its
    one pull. Tolerance 0 (int64)."""
    t = _sorted_table(53, v, 100 + v, kind)
    pick, kstar, score = victim_kernel.victim_search_plain(
        victim_kernel.VictimArgs.from_table(t, "cpu"))
    j_pick, j_kstar, j_score = _jax_preempt(t)
    want = oracle_find_victims(t)
    assert int(pick) == j_pick == want.pick
    assert np.array_equal(kstar.numpy(), j_kstar)
    assert np.array_equal(score.numpy(), j_score)
    assert np.array_equal(kstar.numpy(), want.node_kstar)
    assert np.array_equal(score.numpy(), want.node_score)
    engine = BatchEngine(device="cpu")
    got = engine.find_victims(t)
    assert (got.pick, got.kstar, got.feasible) == \
        (want.pick, want.kstar, want.feasible)
    assert np.array_equal(got.node_score, want.node_score)
    assert engine.victim_stats["searches"] == 1
    assert engine.victim_stats["kernel_ms"] == 0.0      # no card
    if kind == "infeasible":
        assert pick == 0 and (score == -1).all() and (kstar == 0).all()
    if kind == "ties" and want.feasible:
        # the same score before tie_rank on every feasible node: the
        # largest tie_rank wins
        feas = want.node_score >= 0
        assert len(set((want.node_score[feas] - t.tie_rank[feas]))) == 1
        assert t.tie_rank[want.pick] == t.tie_rank[feas].max()


def _lane_search(a, plan):
    """The victim kernel's algorithm in numpy, as its lanes run it
    (csrc/victim_kernel.cu, search_node and the first maximum): a group
    of G lanes a node walks the row in chunks of G; each chunk's masked
    cpu and memory go through an inclusive scan by doubling shifts
    (__shfl_up_sync), carried from the chunk before; res_ok at k = i + 1
    is a ballot whose first set bit gives the first k that fits; nv adds
    the mask ballot's popcount; after the first chunk the walk goes on
    only while a node has no fitting k yet or too few evictable victims
    to reach it. Then each
    block's first maximum (its nodes' groups), and the first maximum of
    the blocks' records. -> (pick, kstar, score)."""
    from kubernetes_tpu_torch.sched.preemption import (PMAX, SCORE_STRIDE,
                                                       SENIOR_NONE)
    n, v = a.shape
    g = plan.group
    f = {k: getattr(a, k).numpy() for k in TABLE_ARRAYS}
    cand = f["cand"]

    def fits_after(k, rc, rm):
        ok = (f["pod_count"][:, None] - k) < f["pod_cap"][:, None]
        if a.zero_req:
            return ok
        cc, mc = f["cpu_cap"][:, None], f["mem_cap"][:, None]
        return ok & ((cc == 0) | (cc - (f["cpu_used"][:, None] - rc)
                                  >= a.req_cpu)) \
            & ((mc == 0) | (mc - (f["mem_used"][:, None] - rm) >= a.req_mem))

    zero = np.zeros((n, 1), np.int64)
    k0 = np.where(cand & fits_after(0, zero, zero)[:, 0], 0, -1)
    senior = np.full(n, SENIOR_NONE, np.int64)
    nv = np.zeros(n, np.int64)
    rc0 = np.zeros(n, np.int64)
    rm0 = np.zeros(n, np.int64)
    lane = np.arange(g)
    c0 = 0
    while c0 < v:
        i = c0 + lane
        has = cand[:, None] & (i < v)[None, :]
        col = np.minimum(i, max(v - 1, 0))
        vp = np.where(has, f["v_prio"][:, col], 0)
        m = has & np.where(has, f["v_valid"][:, col], False) & (vp < a.prio)
        rc = np.where(m, f["v_cpu"][:, col], 0)
        rm = np.where(m, f["v_mem"][:, col], 0)
        d = 1
        while d < g:                          # the doubling scan
            rc = rc + np.where(lane >= d, np.roll(rc, d, axis=1), 0)
            rm = rm + np.where(lane >= d, np.roll(rm, d, axis=1), 0)
            d *= 2
        rc, rm = rc + rc0[:, None], rm + rm0[:, None]
        ok = has & fits_after(i[None, :] + 1, rc, rm)
        ballot = (ok.astype(np.int64) << lane).sum(axis=1)
        first = np.where(ballot > 0, np.argmax(ok, axis=1), -1)
        fresh = (k0 < 0) & (first >= 0)
        senior = np.where(fresh, vp[np.arange(n), np.maximum(first, 0)],
                          senior)
        k0 = np.where(fresh, c0 + first + 1, k0)
        nv += np.array([bin(x).count("1") for x in
                        (m.astype(np.int64) << lane).sum(axis=1)])
        rc0, rm0 = rc[:, -1], rm[:, -1]
        if not (cand & (c0 + g < v) & ~((k0 >= 0) & (k0 <= nv))).any():
            break
        c0 += g
    feas = cand & (k0 >= 0) & (k0 <= nv)
    kstar = np.where(feas, k0, 0)
    score = np.where(feas, ((v - kstar) * SCORE_STRIDE + (PMAX - senior))
                     * n + f["tie_rank"], -1)
    # first maximum: the larger score, then the smaller index, per block
    # of nodes, then over the blocks' records
    per_block = plan.threads // g
    recs = [(int(score[lo:lo + per_block].max()),
             lo + int(np.argmax(score[lo:lo + per_block])))
            for lo in range(0, n, per_block)]
    pick = max(recs, key=lambda r: (r[0], -r[1]))[1]
    return pick, kstar, score


@pytest.mark.parametrize("v", [0, 1, 2, 3, 15, 16, 17, 31, 32, 33, 63, 64,
                               65, 100])
def test_lane_model_equals_the_plain_search(v):
    """The kernel's lane algorithm, modelled, on random tables the
    encoder does not cut (unsorted victims, holes in the valid mask),
    chunk edges included, under two blockings: equal to the plain
    version."""
    rng = np.random.default_rng(v)
    for trial in range(6):
        n = int(rng.integers(1, 300))
        t = _sorted_table(n, v, 1000 * v + trial)
        # shuffle the victims and punch holes: the kernel's rule holds
        # on any row, not only the encoder's
        perm = rng.permutation(v)
        t.v_prio, t.v_cpu, t.v_mem = (x[:, perm] for x in
                                      (t.v_prio, t.v_cpu, t.v_mem))
        t.v_valid = t.v_valid[:, perm] | (rng.random((n, v)) < 0.2)
        t.zero_req = trial == 3
        a = victim_kernel.VictimArgs.from_table(t, "cpu")
        pick, kstar, score = victim_kernel.victim_search_plain(a)
        # one CTA an SM, and blockings of a few nodes a CTA
        for sms in (132, 7):
            plan = victim_kernel.launch_plan(n, v, sms)
            got = _lane_search(a, plan)
            assert got[0] == int(pick), (n, plan)
            assert np.array_equal(got[1], kstar.numpy())
            assert np.array_equal(got[2], score.numpy())


@pytest.mark.parametrize("v,group", [(0, 1), (1, 1), (2, 2), (3, 4), (8, 8),
                                     (9, 16), (16, 16), (17, 32), (32, 32),
                                     (33, 32), (100, 32)])
def test_group_width_is_the_power_of_two_at_or_above_v(v, group):
    assert victim_kernel.group_width(v) == group


@pytest.mark.parametrize("n,v,plan", [
    # the preempt fixture's tables: 5120 slots at 16, 8 and 1 victims
    (5120, 16, (16, 640, 128)), (5120, 8, (8, 320, 128)),
    (5120, 1, (1, 64, 80)), (5000, 16, (16, 608, 132)),
    # fewer nodes than SMs: a node a CTA; more than a CTA can hold
    (1, 0, (1, 32, 1)), (31, 1, (1, 32, 1)), (300, 33, (32, 96, 100)),
    (20480, 16, (16, 1024, 320))])
def test_victim_launch_plan(n, v, plan):
    """Every node a group of lanes, the nodes shared evenly by at most
    one CTA an SM (132) in whole warps, 1024 threads a CTA at most."""
    got = victim_kernel.launch_plan(n, v)
    assert tuple(got) == plan
    assert got.grid * got.threads >= n * got.group
    assert got.grid <= 132 or got.threads == victim_kernel.BLOCK_THREADS
    assert victim_kernel.out_words(n, got) == 1 + 2 * n + 2 * got.grid


def test_victim_result_is_one_buffer():
    t = _sorted_table(9, 4, 3)
    res = victim_kernel.victim_search(
        victim_kernel.VictimArgs.from_table(t, "cpu"))
    flat = res.flat()
    assert flat.shape == (19,) and flat.dtype == torch.int64
    assert int(flat[0]) == int(res.pick)
    assert torch.equal(flat[1:10], res.kstar)
    assert torch.equal(flat[10:], res.score)
    assert res.kstar.data_ptr() == flat.data_ptr() + 8
