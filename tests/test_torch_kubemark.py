"""The port's kubemark benchmark (kubernetes_tpu_torch.kubemark.benchmark)
on the CPU: master + hollow fleet + the live batch pipeline, 30 writers.

As tests/test_kubemark.py does for the JAX package, every pod binds and
the fleet confirms it Running. And the invariant the card's e2e gate
rests on holds: the benchmark's pods are identical, so the per-node
counts of bound pods equal those of one uninterrupted engine run over
the fleet's nodes — and those of the JAX package's own benchmark at the
same size. Tolerance 0: counts are integers."""

from kubernetes_tpu.api.registry import Registry as JaxRegistry
from kubernetes_tpu.kubemark.benchmark import _bench_pod as jax_bench_pod
from kubernetes_tpu.kubemark.benchmark import \
    run_scheduling_benchmark as jax_benchmark
from kubernetes_tpu.kubemark.fleet import HollowFleet as JaxFleet
from kubernetes_tpu.sched.device import BatchEngine as JaxEngine
from kubernetes_tpu.sched.device import ClusterSnapshot as JaxSnapshot
from kubernetes_tpu_torch.api.registry import Registry
from kubernetes_tpu_torch.kubemark.benchmark import run_scheduling_benchmark
from kubernetes_tpu_torch.kubemark.fixtures import node_counts_digest
from kubernetes_tpu_torch.kubemark.gpu_evidence import (E2E_LAYERS,
                                                        section_e2e)

MAX_PODS = 32  # run_scheduling_benchmark's default max_pods_per_node


def counts(registry):
    nodes, _ = registry.list("nodes")
    pods, _ = registry.list("pods", "default")
    return node_counts_digest([n.metadata.name for n in nodes],
                              [p.spec.node_name for p in pods])


def one_shot_counts(n_nodes, n_pods):
    """The JAX engine's one uninterrupted run over the fleet's nodes."""
    fleet = JaxFleet(None, n_nodes, cpu="4", memory="32Gi",
                     max_pods=MAX_PODS)
    hosts, _ = JaxEngine().schedule(JaxSnapshot(
        nodes=[fleet._node_object(i) for i in range(n_nodes)],
        pending_pods=[jax_bench_pod(i) for i in range(n_pods)]))
    return node_counts_digest(fleet.node_names(), hosts)


def test_benchmark_binds_and_runs_every_pod_with_jax_counts():
    registry = Registry()
    r = run_scheduling_benchmark(n_nodes=40, n_pods=150, mode="batch",
                                 wait_running=True, registry=registry,
                                 device="cpu")
    assert r.scheduled == 150 and r.running == 150
    assert r.pods_per_sec > 0
    # every run of the engine is counted once: a full upload, a delta
    # scatter into the device table mirror, or a reuse of it
    st = r.upload_stats
    assert st["full_tiles"] + st["delta_tiles"] + st["reuse_tiles"] \
        == r.scan_stats["runs"] >= 1
    jax_registry = JaxRegistry()
    jr = jax_benchmark(n_nodes=40, n_pods=150, mode="batch",
                       wait_running=True, registry=jax_registry)
    assert jr.scheduled == 150
    got = counts(registry)
    assert got == counts(jax_registry)
    assert got == one_shot_counts(40, 150)
    assert got[1] == 150


def test_e2e_section_counts_equal_one_uninterrupted_run():
    out = section_e2e(60, 600, device="cpu")
    assert out["scheduled"] == 600
    assert out["tiles_chained"] + out["tiles_unchained"] >= 1
    assert (out["counts_sha256"], out["counts_bound"]) == \
        one_shot_counts(60, 600)
    # every host layer around the scan is read in situ, the FIFO drain
    # and the fleet's Running echo included (the echo may still be
    # running when the last binding is seen, so its count is not held)
    assert set(out["layers"]) == set(E2E_LAYERS)
    for layer in ("drain", "encode", "commit"):
        assert out["layers"][layer]["count"] >= 1, layer
        assert out["layers"][layer]["seconds"] >= 0.0, layer
