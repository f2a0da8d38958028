"""The port stands alone: importing and running it (scheduling a batch,
one extender round trip, the live pipeline under the kubemark
benchmark and the evidence tool's e2e section, a victim search, a
scatter through the table mirror, a mixed-mode config, a batch on a
node-axis mesh and the shard-failure drill over the leases, the
shard-kill soak, the chaos package, the controllers and the soaks'
modules, one CRUD and one watch through the port's ApiServer and
HttpClient with its lazily imported handlers, a metrics scrape of it, the
SLO run's and the fan-out soak's modules, a journaled Store and the
native store with their recoveries, a Master over the native store with
an admission chain, a recorded event, a migration, a traced engine run,
`python -m kubernetes_tpu_torch -h`, and the controller manager with
every controller reconciling an RC, and the process-crash soak's
module, all on the CPU) loads neither
jax nor any module of the JAX package, and its entry points refuse to run without a CUDA device unless
a device is named. Run in a subprocess, because this test process has
jax loaded (tests/conftest.py)."""

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
# the soak and chaos paths: the chaos package, the controllers, the
# soaks, the flight recorder and the device pick; the shard-kill soak
import kubernetes_tpu_torch.chaos
import kubernetes_tpu_torch.controllers
from kubernetes_tpu_torch.kubemark import node_chaos, shard_soak, soak
import kubernetes_tpu_torch.obs.flightrec
from kubernetes_tpu_torch.utils.platform import pick_device
shard = shard_soak.run_shard_kill_soak(device="cpu")
loaded = sorted(m for m in sys.modules if m in (
    "kubernetes_tpu_torch.sched.device.mesh",
    "kubernetes_tpu_torch.sched.device.shardfail",
    "kubernetes_tpu_torch.utils.leaderelection",
    "kubernetes_tpu_torch.chaos.crash",
    "kubernetes_tpu_torch.chaos.injector",
    "kubernetes_tpu_torch.chaos.nodes",
    "kubernetes_tpu_torch.chaos.workload",
    "kubernetes_tpu_torch.controllers.framework",
    "kubernetes_tpu_torch.controllers.node",
    "kubernetes_tpu_torch.controllers.replication",
    "kubernetes_tpu_torch.utils.workqueue",
    "kubernetes_tpu_torch.obs.flightrec",
    "kubernetes_tpu_torch.utils.platform"))

# the HTTP plane and the metrics plane: one CRUD and one watch through
# the port's ApiServer and HttpClient, the lazily imported handlers
# (swagger, the dashboards, the websocket watch, the node proxy's relay,
# third-party groups, the pod log relay), a FleetScraper scrape of the
# server, and the SLO run's and the fan-out soak's modules
import urllib.error, urllib.request
from kubernetes_tpu_torch.api.server import ApiServer
from kubernetes_tpu_torch.api.client import HttpClient
from kubernetes_tpu_torch.api.tunneler import WsTunneler
from kubernetes_tpu_torch.core import types as api
from kubernetes_tpu_torch.obs.metricsplane import FleetScraper, HttpTarget
from kubernetes_tpu_torch.utils import wsstream
from kubernetes_tpu_torch.kubemark.slo import run_density_slo
from kubernetes_tpu_torch.kubemark.fanout_soak import run_fanout_soak
import kubernetes_tpu_torch.auth
srv = ApiServer(Registry(), port=0).start()
try:
    hc = HttpClient(srv.url)
    w = hc.watch("pods", "default")
    hc.create("nodes", api.Node(metadata=api.ObjectMeta(name="n0")))
    hc.create("pods", api.Pod(
        metadata=api.ObjectMeta(name="h0", namespace="default"),
        spec=api.PodSpec(containers=[api.Container(name="c", image="i")])))
    got = hc.get("pods", "h0", "default").metadata.name
    ev = w.next(timeout=10)
    w.stop()
    codes = []
    for path in ("/swaggerapi", "/ui", "/ui/server",
                 "/api/v1/proxy/nodes/n0/healthz", "/apis/ghost.io/v1/x",
                 "/api/v1/namespaces/default/pods/h0/log"):
        try:
            with urllib.request.urlopen(srv.url + path, timeout=10) as r:
                codes.append(r.status)
        except urllib.error.HTTPError as e:
            codes.append(e.code)
    hc.delete("pods", "h0", "default", grace_period_seconds=0)
    ws = wsstream.client_connect("127.0.0.1", srv.port,
                                 "/api/v1/pods?watch=true")
    wsstream.write_frame(ws.sendall, b"hi", wsstream.PING, mask=True)
    pong = wsstream.read_frame(ws.recv)
    ws.close()
    scraper = FleetScraper([HttpTarget("apiserver", srv.url + "/metrics")])
    scraped = sorted(scraper.sample()["counters"])
finally:
    srv.stop()
http = {"crud": got, "watch": [ev.type, ev.object.metadata.name],
        "codes": codes, "pong": pong[1].decode(),
        "scraped": "apiserver_request_count" in scraped,
        "tunneler": WsTunneler.__name__}

# the durable store, the master with admission and events, the split
# deployment's entry point and the profiling hook: a journaled Store and
# its recovery, the native store with its WAL, a Master over the native
# store with an admission chain, a recorded event, a migration, a traced
# engine run, and `python -m kubernetes_tpu_torch -h` run in this process
import runpy, tempfile
from kubernetes_tpu_torch.core.store import Store
from kubernetes_tpu_torch.core.native_store import NativeStore
from kubernetes_tpu_torch.core.migrate import migrate_store
from kubernetes_tpu_torch.api.record import EventBroadcaster, ClientEventSink
from kubernetes_tpu_torch.master import Master, MasterConfig
from kubernetes_tpu_torch.utils.profiling import profiled_schedule
from kubernetes_tpu_torch.kubemark.deployment import run_durable_e2e
from kubernetes_tpu_torch.kubemark import profile_window
import kubernetes_tpu_torch.hyperkube
with tempfile.TemporaryDirectory() as d:
    st = Store(wal_dir=d + "/py")
    st.create("/registry/nodes//n0", api.Node(metadata=api.ObjectMeta(name="n0")))
    st.wal_close()
    rec_rev = Store.recover(d + "/py").current_revision
    ns = NativeStore(wal_dir=d + "/nat")
    ns.create("/registry/nodes//n0", api.Node(metadata=api.ObjectMeta(name="n0")))
    ns.close()
    nat_rev = NativeStore.recover(d + "/nat").current_revision
    prof = profiled_schedule(engine, enc, d + "/trace", 8)[1] == d + "/trace"
m = Master(MasterConfig(storage_backend="native",
                        admission_control=["SecurityContextDeny",
                                           "NamespaceLifecycle"])).start()
try:
    mc = HttpClient(m.url)
    refused = False
    try:
        mc.create("pods", api.Pod(metadata=api.ObjectMeta(name="x", namespace="ghost"),
                                  spec=api.PodSpec(containers=[api.Container(name="c", image="i")])),
                  "ghost")
    except Exception:
        refused = True
    EventBroadcaster().start_recording_to_sink(ClientEventSink(mc)).new_recorder(
        api.EventSource(component="isolation")).event(
        mc.get("namespaces", "default"), "Normal", "Checked", "ok")
    migrated = migrate_store(m.store).rewritten
finally:
    m.stop()
sys.argv = ["kubernetes_tpu_torch", "-h"]
try:
    runpy.run_module("kubernetes_tpu_torch", run_name="__main__")
except SystemExit as e:
    usage_code = e.code
store = {"recovered": [rec_rev, nat_rev], "refused": refused,
         "migrated": migrated > 0, "profiled": prof, "usage": usage_code}
loaded_store = sorted(m for m in sys.modules if m in (
    "kubernetes_tpu_torch.core.wal",
    "kubernetes_tpu_torch.core.native_store",
    "kubernetes_tpu_torch.native.build",
    "kubernetes_tpu_torch.core.migrate",
    "kubernetes_tpu_torch.api.record",
    "kubernetes_tpu_torch.utils.healthz",
    "kubernetes_tpu_torch.kubelet.securitycontext",
    "kubernetes_tpu_torch.admission.plugins",
    "kubernetes_tpu_torch.master",
    "kubernetes_tpu_torch.hyperkube",
    "kubernetes_tpu_torch.utils.profiling",
    "kubernetes_tpu_torch.kubemark.deployment",
    "kubernetes_tpu_torch.kubemark.profile_window"))

# the controller manager: every controller over an in-proc registry, an
# RC's pods created, a FakeCloudProvider for the service and route
# controllers; the process-crash soak's module
import time
from kubernetes_tpu_torch.cloudprovider import FakeCloudProvider
from kubernetes_tpu_torch.controllers.manager import ControllerManager
from kubernetes_tpu_torch.kubemark import crash_soak
cm_client = InProcClient(Registry())
cm = ControllerManager(cm_client, cloud=FakeCloudProvider(),
                       metrics_source=lambda ns, sel: None).run()
try:
    cm_client.create("replicationcontrollers", api.ReplicationController(
        metadata=api.ObjectMeta(name="iso", namespace="default"),
        spec=api.ReplicationControllerSpec(
            replicas=2, selector={"app": "iso"},
            template=api.PodTemplateSpec(
                metadata=api.ObjectMeta(labels={"app": "iso"}),
                spec=api.PodSpec(containers=[
                    api.Container(name="c", image="i")])))), "default")
    deadline = time.time() + 30
    while time.time() < deadline and len(cm_client.list(
            "pods", "default", label_selector="app=iso")[0]) < 2:
        time.sleep(0.05)
    cm_pods = len(cm_client.list("pods", "default",
                                 label_selector="app=iso")[0])
    cm_controllers = len(cm.controllers)
finally:
    cm.stop()
loaded_ctrl = sorted(m for m in sys.modules if m in (
    "kubernetes_tpu_torch.cloudprovider",
    "kubernetes_tpu_torch.cloudprovider.cloud",
    "kubernetes_tpu_torch.controllers.gc",
    "kubernetes_tpu_torch.controllers.persistentvolume",
    "kubernetes_tpu_torch.controllers.podautoscaler",
    "kubernetes_tpu_torch.controllers.resourcequota",
    "kubernetes_tpu_torch.controllers.namespace",
    "kubernetes_tpu_torch.controllers.serviceaccount",
    "kubernetes_tpu_torch.controllers.endpoint",
    "kubernetes_tpu_torch.controllers.job",
    "kubernetes_tpu_torch.controllers.daemon",
    "kubernetes_tpu_torch.controllers.deployment",
    "kubernetes_tpu_torch.controllers.service",
    "kubernetes_tpu_torch.controllers.manager",
    "kubernetes_tpu_torch.kubemark.crash_soak"))

torch.cuda.is_available = lambda: False
errors = []
for make in (BatchEngine, DeviceBackend,
             lambda: run_scheduling_benchmark(2, 1),
             lambda: section_e2e(2, 1),
             lambda: factory.create_mixed(policy),
             lambda: soak.run_soak(duration_s=1.0, n_nodes=2),
             shard_soak.run_shard_kill_soak,
             lambda: node_chaos.run_node_kill_soak(n_nodes=2),
             lambda: node_chaos.run_partition_gate(n_nodes=2),
             lambda: run_scheduling_benchmark(2, 1, chaos_seed=1),
             pick_device,
             lambda: run_density_slo(n_nodes=2, n_pods=2),
             lambda: fx.run_chaos_soak(seed=0),
             lambda: run_durable_e2e(2, 1),
             lambda: profile_window.main(["--nodes", "2", "--pods", "1"]),
             lambda: crash_soak.run_crash_soak(n_nodes=2)):
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
                  "shard_soak": [shard.converged, shard.parity_ok],
                  "loaded": loaded, "http": http, "store": store,
                  "loaded_store": loaded_store,
                  "controllers": [cm_controllers, cm_pods],
                  "loaded_ctrl": loaded_ctrl}))
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
    assert len(res["errors"]) == 16
    assert all("no CUDA device" in e for e in res["errors"])
    assert res["meshed"] and res["drill"] == [3, True]
    assert res["shard_soak"] == [True, True]
    assert len(res["loaded"]) == 13
    http = res["http"]
    assert http["crud"] == "h0" and http["watch"] == ["ADDED", "h0"]
    # swagger, both dashboards, a node proxy to a node with no kubelet
    # endpoint, an unknown third-party group, an unscheduled pod's log
    assert http["codes"] == [200, 200, 200, 404, 404, 400]
    assert http["pong"] == "hi" and http["scraped"]
    assert res["store"] == {"recovered": [1, 1], "refused": True,
                            "migrated": True, "profiled": True,
                            "usage": 0}
    assert len(res["loaded_store"]) == 13
    # twelve controllers, the HPA and the service and route controllers
    assert res["controllers"] == [15, 2]
    assert len(res["loaded_ctrl"]) == 15


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
