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
