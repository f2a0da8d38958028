"""The port's split-process deployment (`python -m kubernetes_tpu_torch`:
hyperkube.py, master.py, kubemark/deployment.py) on the CPU.

tests/test_multiprocess.py's bind pipeline at its 10 nodes x 40 pods,
with every component a `python -m kubernetes_tpu_torch` process and the
scheduler on the CPU (`--cpu`); the same deployment through
kubemark/deployment.run_split (chip_smoke's split phase, small), its
per-node counts equal to the JAX engine's; `migrate-storage` against a
live apiserver process; `controller-manager` against a live apiserver
process (its healthz served, an RC's pods created); the usage exit
codes; and a scheduler without
`--cpu` on a box with no card exiting non-zero before it binds
anything. Also pins fixtures.SPLIT_COUNTS, the digests chip_smoke's
split phase and the card test are held to, with the JAX engine."""

import json
import os
import subprocess
import sys
import tempfile
import time

import pytest

from kubernetes_tpu.kubemark.benchmark import _bench_pod as jax_bench_pod
from kubernetes_tpu.kubemark.fleet import HollowFleet as JaxFleet
from kubernetes_tpu.sched.device import BatchEngine as JaxEngine
from kubernetes_tpu.sched.device import ClusterSnapshot as JaxSnapshot
from kubernetes_tpu.sched.device import encode_snapshot as jax_encode
from kubernetes_tpu_torch.api.client import HttpClient
from kubernetes_tpu_torch.core import types as api
from kubernetes_tpu_torch.core.quantity import parse_quantity
from kubernetes_tpu_torch.kubemark.deployment import Child, run_split
from kubernetes_tpu_torch.kubemark.fixtures import (SMOKE_CHUNK,
                                                    SPLIT_COUNTS,
                                                    node_counts_digest,
                                                    smoke_pod_pad)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_counts(n_nodes, n_pods, max_pods):
    """One uninterrupted JAX engine run of n_pods bench pods over the
    JAX fleet's n_nodes -> (sha256, bound) of the per-node counts."""
    fleet = JaxFleet(None, n_nodes, cpu="4", memory="32Gi",
                     max_pods=max_pods)
    enc = jax_encode(JaxSnapshot(
        nodes=[fleet._node_object(i) for i in range(n_nodes)],
        pending_pods=[jax_bench_pod(i) for i in range(n_pods)]),
        pod_pad_to=smoke_pod_pad(n_pods))
    assigned, _ = JaxEngine().run_chunked(enc, SMOKE_CHUNK)
    hosts = [enc.node_names[i] if i >= 0 else None
             for i in assigned[:enc.n_pods]]
    return node_counts_digest(fleet.node_names(), hosts)


def bench_pod(i):
    return api.Pod(
        metadata=api.ObjectMeta(name=f"mp-pod-{i:03d}", namespace="default"),
        spec=api.PodSpec(containers=[api.Container(
            name="c", image="img",
            resources=api.ResourceRequirements(
                requests={"cpu": parse_quantity("100m"),
                          "memory": parse_quantity("64Mi")}))]),
        status=api.PodStatus(phase="Pending"))


def run(*argv, timeout=120, **env):
    return subprocess.run(
        [sys.executable, "-m", "kubernetes_tpu_torch", *argv],
        capture_output=True, text=True, cwd=REPO, timeout=timeout,
        env={**os.environ, "PYTHONPATH": REPO, **env})


@pytest.fixture()
def log_dir():
    with tempfile.TemporaryDirectory(prefix="split-") as d:
        yield d


def test_split_process_bind_pipeline(log_dir):
    n_nodes, n_pods = 10, 40
    procs = []
    try:
        apiserver = Child("apiserver", "--port", "0", "--storage-backend",
                          "native", "--admission-control",
                          "NamespaceAutoProvision", log_dir=log_dir)
        procs.append(apiserver)
        url = apiserver.wait_ready().split()[-1]
        fleet = Child("hollow-fleet", "--master", url, "--num-nodes",
                      str(n_nodes), "--heartbeat-interval", "60",
                      log_dir=log_dir)
        sched = Child("scheduler", "--master", url, "--mode", "batch",
                      "--no-rate-limit", "--cpu", log_dir=log_dir)
        procs += [fleet, sched]
        fleet.wait_ready()
        assert sched.wait_ready().endswith("device=cpu")

        client = HttpClient(url)
        for i in range(n_pods):
            client.create("pods", bench_pod(i), "default")

        deadline = time.time() + 180
        bound = running = 0
        while time.time() < deadline:
            pods, _ = client.list("pods", "default")
            mine = [p for p in pods
                    if p.metadata.name.startswith("mp-pod-")]
            bound = sum(1 for p in mine if p.spec.node_name)
            running = sum(1 for p in mine if p.status.phase == "Running")
            if bound >= n_pods and running >= n_pods:
                break
            time.sleep(0.2)
        assert bound == n_pods, f"only {bound}/{n_pods} bound"
        assert running == n_pods, f"only {running}/{n_pods} running"

        # every binding target must be a fleet node that exists
        nodes = {n.metadata.name for n in client.list("nodes")[0]}
        for p in client.list("pods", "default")[0]:
            if p.metadata.name.startswith("mp-pod-"):
                assert p.spec.node_name in nodes
    finally:
        codes = {p.component: p.terminate() for p in reversed(procs)}
    assert codes == {"apiserver": 0, "hollow-fleet": 0, "scheduler": 0}


def test_run_split_on_the_cpu():
    """chip_smoke's split phase, small: batch POSTs of 128, every pod
    bound once and Running, no node over capacity, the counts the JAX
    engine's; the scheduler on the CPU, which launches no kernel (its
    READY line and the launch counts it prints as it exits)."""
    r = run_split(12, 150, cpu=True)
    assert r["running"] == r["bound_seen"] == 150 and r["rebinds"] == 0
    assert r["scheduler_ready"] == "scheduler ready mode=batch device=cpu"
    assert r["scheduler_launches"] == {
        k: 0 for k in ("scan_chunk", "scatter_prologue", "probe",
                       "filter_masks", "argsort_rows", "victim_search",
                       "victim_search_sharded", "scan_chunk_sharded",
                       "spec_pass", "spec_repair")}
    assert r["exit_codes"] == {"scheduler": 0, "hollow-fleet": 0,
                               "apiserver": 0}
    assert (r["counts_sha256"], r["counts_bound"]) == jax_counts(12, 150,
                                                                 40)
    assert set(r["startup_s"]) == {"apiserver", "hollow-fleet",
                                   "scheduler"}
    assert r["elapsed_s"] > 0 and r["pods_per_sec"] > 0


@pytest.mark.parametrize("shape", sorted(SPLIT_COUNTS))
def test_split_counts_are_the_jax_engines(shape):
    want = SPLIT_COUNTS[shape]
    assert shape == f"{want['n_nodes']}x{want['n_pods']}"
    assert jax_counts(want["n_nodes"], want["n_pods"], want["max_pods"]) \
        == (want["sha256"], want["bound"])


def test_migrate_storage_component(log_dir):
    """migrate-storage against a live apiserver process: every stored
    object rewritten through the current codec (resourceVersions bump;
    content survives)."""
    apiserver = Child("apiserver", "--port", "0", log_dir=log_dir)
    try:
        url = apiserver.wait_ready().split()[-1]
        client = HttpClient(url)
        created = client.create("pods", bench_pod(0))
        out = run("migrate-storage", "--master", url)
        assert out.returncode == 0, out.stderr[-1000:]
        report = json.loads(out.stdout.strip().splitlines()[-1])
        assert report["rewritten"] >= 1  # at least the pod
        assert not report["failed"]
        after = client.get("pods", "mp-pod-000", "default")
        assert int(after.metadata.resource_version) > \
            int(created.metadata.resource_version)
        assert after.spec.containers[0].image == "img"
        out = run("migrate-storage", "--master", url, "--resources",
                  "nodes")
        assert out.returncode == 0
        assert json.loads(out.stdout.strip().splitlines()[-1])[
            "rewritten"] == 0
    finally:
        assert apiserver.terminate() == 0


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_controller_manager_component(log_dir):
    """`controller-manager --master <url>` against a port apiserver
    process: it prints its READY line, serves healthz on the port it is
    given, and its replication manager creates an RC's pods."""
    import urllib.request
    apiserver = Child("apiserver", "--port", "0", log_dir=log_dir)
    procs = [apiserver]
    try:
        url = apiserver.wait_ready().split()[-1]
        port = _free_port()
        manager = Child("controller-manager", "--master", url, "--port",
                        str(port), log_dir=log_dir)
        procs.append(manager)
        assert manager.wait_ready() == "controller-manager ready"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as resp:
            assert resp.status == 200
            assert resp.read().strip() == b"ok"
        client = HttpClient(url)
        labels = {"app": "cm"}
        client.create("replicationcontrollers", api.ReplicationController(
            metadata=api.ObjectMeta(name="cm", namespace="default"),
            spec=api.ReplicationControllerSpec(
                replicas=3, selector=dict(labels),
                template=api.PodTemplateSpec(
                    metadata=api.ObjectMeta(labels=dict(labels)),
                    spec=bench_pod(0).spec))), "default")
        deadline = time.time() + 60
        mine = []
        while time.time() < deadline:
            mine = client.list("pods", "default",
                               label_selector="app=cm")[0]
            if len(mine) == 3:
                break
            time.sleep(0.2)
        assert len(mine) == 3, [p.metadata.name for p in mine]
        # the service-account controller made the default namespace's
        # account
        assert wait_for(lambda: client.get("serviceaccounts", "default",
                                           "default"))
    finally:
        codes = {p.component: p.terminate() for p in reversed(procs)}
    assert codes == {"apiserver": 0, "controller-manager": 0}


def wait_for(fn, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            if fn():
                return True
        except Exception:
            pass
        time.sleep(0.2)
    return False


@pytest.mark.parametrize("argv,code,says", [
    ((), 1, "usage: python -m kubernetes_tpu_torch <apiserver"),
    (("-h",), 0, "controller-manager | hollow-fleet | kube-apiserver | "
                 "kube-controller-manager | kube-scheduler | "
                 "migrate-storage | scheduler>"),
    (("no-such-thing",), 1, "unknown component 'no-such-thing'"),
    (("kubelet",), 1, "unknown component 'kubelet'"),
    (("scheduler",), 2, "the following arguments are required: --master"),
    (("controller-manager",), 2,
     "the following arguments are required: --master"),
])
def test_hyperkube_usage(argv, code, says):
    out = run(*argv, timeout=60)
    assert out.returncode == code
    assert says in out.stdout + out.stderr


def test_scheduler_needs_a_card_or_cpu(log_dir):
    """Without --cpu and with no card (none visible to the child), the
    scheduler exits non-zero with the engine's error and binds nothing."""
    apiserver = Child("apiserver", "--port", "0", log_dir=log_dir)
    try:
        url = apiserver.wait_ready().split()[-1]
        client = HttpClient(url)
        client.create("nodes", api.Node(metadata=api.ObjectMeta(name="n0")))
        client.create("pods", bench_pod(0))
        out = run("scheduler", "--master", url, "--mode", "batch",
                  "--no-rate-limit", CUDA_VISIBLE_DEVICES="")
        assert out.returncode == 1
        assert "no CUDA device" in out.stderr
        assert "ready" not in out.stdout
        time.sleep(0.5)
        assert not client.get("pods", "mp-pod-000", "default").spec.node_name
    finally:
        assert apiserver.terminate() == 0
