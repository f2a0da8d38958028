"""The port stands alone: importing and running it (scheduling a batch,
one extender round trip, the live pipeline under the kubemark
benchmark and the evidence tool's e2e section, a victim search, a
scatter through the table mirror, a mixed-mode config, a batch on a
node-axis mesh and the shard-failure drill over the leases, all on the
CPU) loads neither jax nor any module of the JAX package, and its entry
points refuse to run without a CUDA device unless a device is named. Run in a subprocess, because this test
process has jax loaded (tests/conftest.py)."""

import ast
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "kubernetes_tpu_torch")

CHILD = r"""
import json, sys
import torch
from kubernetes_tpu_torch.kubemark.fixtures import mixed_snapshot
from kubernetes_tpu_torch.sched.api import ExtenderConfig
from kubernetes_tpu_torch.sched.device import BatchEngine, schedule_batch
from kubernetes_tpu_torch.sched.extender import HTTPExtender
from kubernetes_tpu_torch.sched.extender_server import (DeviceBackend,
                                                        ExtenderServer)

snap = mixed_snapshot(3, 20, 6, 10)
names = schedule_batch(snap, device="cpu")
server = ExtenderServer(DeviceBackend(
    device="cpu",
    state_provider=lambda: (snap.existing_pods, [], []))).start()
try:
    client = HTTPExtender(ExtenderConfig(
        url_prefix=server.url, filter_verb="filter",
        prioritize_verb="prioritize"))
    fit = client.filter(snap.pending_pods[1], snap.nodes)
    prio, _ = client.prioritize(snap.pending_pods[1], snap.nodes)
finally:
    server.stop()

def is_foreign(m):
    return (m == "jax" or m.startswith("jax.") or m == "kubernetes_tpu"
            or m.startswith("kubernetes_tpu."))

# the live pipeline under the kubemark benchmark, and the evidence tool
from kubernetes_tpu_torch.kubemark.benchmark import run_scheduling_benchmark
from kubernetes_tpu_torch.kubemark.gpu_evidence import section_e2e
bench = run_scheduling_benchmark(n_nodes=8, n_pods=40, wait_running=True,
                                 device="cpu")
e2e = section_e2e(8, 40, device="cpu")

# preemption: the victim search over an encoder's table
from kubernetes_tpu_torch.kubemark import fixtures as fx
spec = fx.preempt_spec(n_nodes=30, n_preemptors=4)
inc = fx.preempt_encoder(spec)
engine = BatchEngine(device="cpu")
feasible = [engine.find_victims(inc.victim_table(p)).feasible
            for p in fx.preempt_pods(spec)]
# the table mirror: a second tile after an assume scatters its rows
# (the fleet is full by CPU: pods that request nothing still fit)
tile = [fx._preempt_pod(f"z{i}", "", 0, 0, 0) for i in range(4)]
enc = inc.encode_tile(tile, [], [])
assigned, _ = engine.run_chunked(enc, 8)
inc.assume_assigned(enc, tile, assigned)
engine.run_chunked(inc.encode_tile(tile[:1], [], []), 8)
# mixed mode
from kubernetes_tpu_torch.api.client import InProcClient
from kubernetes_tpu_torch.api.registry import Registry
from kubernetes_tpu_torch.sched.api import Policy
from kubernetes_tpu_torch.sched.factory import ConfigFactory
factory = ConfigFactory(InProcClient(Registry()), rate_limit=False)
policy = Policy(extenders=[ExtenderConfig(url_prefix="http://x",
                                          filter_verb="filter")])
mixed = type(factory.create_mixed(policy, device="cpu").algorithm).__name__
# the node-axis mesh (a CPU mesh of four shards) and shard-failure
# tolerance over the leases (the survivor drill)
from kubernetes_tpu_torch.sched.device import NodeMesh
meshed = schedule_batch(snap, mesh=NodeMesh(["cpu"] * 4)) == names
drill = fx.shard_survivor_drill(n_nodes=16, n_pods=16, shards=4, dead=1,
                                device="cpu")
loaded = sorted(m for m in sys.modules if m in (
    "kubernetes_tpu_torch.sched.device.mesh",
    "kubernetes_tpu_torch.sched.device.shardfail",
    "kubernetes_tpu_torch.utils.leaderelection"))

torch.cuda.is_available = lambda: False
errors = []
for make in (BatchEngine, DeviceBackend,
             lambda: run_scheduling_benchmark(2, 1),
             lambda: section_e2e(2, 1),
             lambda: factory.create_mixed(policy)):
    try:
        make()
    except RuntimeError as e:
        errors.append(str(e))
print(json.dumps({"foreign": sorted(m for m in sys.modules if is_foreign(m)),
                  "bound": sum(n is not None for n in names),
                  "fit": len(fit), "prio": len(prio), "errors": errors,
                  "bench": [bench.scheduled, bench.running],
                  "e2e": e2e["scheduled"], "feasible": feasible,
                  "delta": engine.upload_stats["delta_tiles"],
                  "mixed": mixed, "meshed": meshed,
                  "drill": [drill["mesh_after"], drill["second_half_bound"]],
                  "loaded": loaded}))
"""


def test_port_runs_without_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["foreign"] == []
    assert res["bound"] > 0 and 0 < res["fit"] < 20 and res["prio"] == 20
    assert res["bench"] == [40, 40] and res["e2e"] == 40
    assert len(res["feasible"]) == 4 and any(res["feasible"])
    assert res["delta"] == 1 and res["mixed"] == "DeviceAssistedAlgorithm"
    assert len(res["errors"]) == 5
    assert all("no CUDA device" in e for e in res["errors"])
    assert res["meshed"] and res["drill"] == [3, True]
    assert len(res["loaded"]) == 3


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_neither_jax_nor_the_jax_package():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    bad = {}
    for path in files:
        for m in _imports(path):
            root = m.split(".")[0]
            if root in ("jax", "jaxlib", "kubernetes_tpu"):
                bad.setdefault(os.path.relpath(path, REPO), []).append(m)
    assert len(files) > 15 and bad == {}
