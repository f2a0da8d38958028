"""The port's pending FIFO (`kubernetes_tpu_torch.api.cache.FIFO`, a heap
with lazy deletion) pops in the JAX package's FIFO's order
(`kubernetes_tpu.api.cache.FIFO`, a deque swept on every pop), pop for
pop, on seeded streams of add, update with and without a priority
change, delete, re-add before and after a pop, and pop. The objects of
each package are built from the same numpy draws. Tolerance 0: the
answers are names."""

import threading
import time

import numpy as np
import pytest

from kubernetes_tpu.api.cache import FIFO as JaxFIFO
from kubernetes_tpu.core import types as jax_api
from kubernetes_tpu_torch.api.cache import FIFO
from kubernetes_tpu_torch.core import types as api

PRIORITIES = {"zero": [0], "two": [0, 100], "many": [-5, 0, 3, 7, 1000]}


def _pod(types, name, prio, ns="default"):
    return types.Pod(metadata=types.ObjectMeta(name=name, namespace=ns),
                     spec=types.PodSpec(priority=int(prio)))


def _state(fifo):
    return (len(fifo), sorted(o.metadata.name for o in fifo.list()))


def _replay(seed, priorities, n_ops=3000, n_keys=60):
    """Drive both FIFOs through one seeded stream -> the names popped."""
    rng = np.random.default_rng(seed)
    mine, ref = FIFO(), JaxFIFO()
    popped = []
    for _ in range(n_ops):
        op = rng.choice(["add", "add", "update", "delete", "pop", "pop"])
        name = f"p{int(rng.integers(n_keys))}"
        prio = rng.choice(priorities)
        if op in ("add", "update"):
            mine.add(_pod(api, name, prio))
            ref.add(_pod(jax_api, name, prio))
        elif op == "delete":
            mine.delete(_pod(api, name, 0))
            ref.delete(_pod(jax_api, name, 0))
        else:
            got, want = mine.pop(timeout=0), ref.pop(timeout=0)
            assert (got is None) == (want is None)
            if got is not None:
                assert got.metadata.name == want.metadata.name
                assert got.spec.priority == want.spec.priority
                popped.append(got.metadata.name)
        assert _state(mine) == _state(ref)
        assert mine.contains(f"default/{name}") == \
            ref.contains(f"default/{name}")
    while True:
        got, want = mine.pop(timeout=0), ref.pop(timeout=0)
        assert (got is None) == (want is None)
        if got is None:
            return popped
        assert got.metadata.name == want.metadata.name
        popped.append(got.metadata.name)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("priorities", sorted(PRIORITIES))
def test_pops_in_the_jax_fifos_order(priorities, seed):
    popped = _replay(seed, PRIORITIES[priorities])
    assert len(popped) > 100


@pytest.mark.parametrize("before_pop", [True, False])
def test_deleted_key_re_added_pops_where_the_jax_fifo_puts_it(before_pop):
    """Re-added before a pop has compacted the queue, a deleted key pops
    at its old position; after one, at the end."""
    orders = []
    for fifo, types in ((FIFO(), api), (JaxFIFO(), jax_api)):
        for name in ("a", "b", "c", "d"):
            fifo.add(_pod(types, name, 0))
        fifo.delete(_pod(types, "b", 0))
        first = []
        if not before_pop:
            first.append(fifo.pop(timeout=0).metadata.name)
        fifo.add(_pod(types, "b", 0))
        order = first + [fifo.pop(timeout=0).metadata.name
                         for _ in range(len(fifo))]
        orders.append(order)
    assert orders[0] == orders[1]
    assert orders[0] == (["a", "b", "c", "d"] if before_pop
                         else ["a", "c", "d", "b"])


def test_priority_change_re_ranks_and_keeps_the_position():
    orders = []
    for fifo, types in ((FIFO(), api), (JaxFIFO(), jax_api)):
        for name, prio in (("a", 0), ("b", 5), ("c", 0), ("d", 5)):
            fifo.add(_pod(types, name, prio))
        fifo.add(_pod(types, "c", 9))      # up: first
        fifo.add(_pod(types, "b", 0))      # down: back among the zeros
        orders.append([fifo.pop(timeout=0).metadata.name
                       for _ in range(4)])
    assert orders[0] == orders[1] == ["c", "d", "a", "b"]


def test_objects_without_a_priority_pop_in_insertion_order():
    fifo = FIFO()
    nodes = [api.Node(metadata=api.ObjectMeta(name=f"n{i}"))
             for i in (3, 1, 2)]
    for n in nodes:
        fifo.add(n)
    assert [fifo.pop(timeout=0).metadata.name for _ in nodes] == \
        ["n3", "n1", "n2"]


def test_heap_stays_bounded_under_churn():
    """Lazy deletion never lets dead heap items outgrow the queue."""
    fifo = FIFO()
    rng = np.random.default_rng(5)
    for i in range(20000):
        fifo.add(_pod(api, f"p{i % 50}", rng.integers(0, 4)))
        if i % 3 == 0:
            fifo.delete(_pod(api, f"p{(i * 7) % 50}", 0))
    assert len(fifo._heap) <= 2 * len(fifo) + 65


def test_a_pop_looks_at_the_heap_top_only():
    """Draining n pods without churn inspects n heap items in all: no pop
    sweeps the queue (the JAX FIFO's pop visits every queued key)."""
    fifo = FIFO()
    for i in range(3000):
        fifo.add(_pod(api, f"p{i}", i % 3))
    seen = []
    current = fifo._current
    fifo._current = lambda item: seen.append(item) or current(item)
    names = [fifo.pop(timeout=0).metadata.name for _ in range(3000)]
    assert len(seen) == 3000 and fifo.pop(timeout=0) is None
    assert names[:2] == ["p2", "p5"] and names[-1] == "p2997"


def test_blocking_pop_wakes_on_add_and_close():
    fifo = FIFO()
    got = []
    t = threading.Thread(target=lambda: got.append(fifo.pop(timeout=5)))
    t.start()
    time.sleep(0.05)
    fifo.add(_pod(api, "late", 0))
    t.join(5)
    assert got[0].metadata.name == "late"
    assert fifo.last_pop_wait >= 0.0
    t = threading.Thread(target=lambda: got.append(fifo.pop()))
    t.start()
    fifo.close()
    t.join(5)
    assert got[1] is None and fifo.closed
    assert fifo.pop(timeout=0.01) is None
