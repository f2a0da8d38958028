"""The port's controllers and their manager (kubernetes_tpu_torch/
controllers/, cloudprovider/) against the JAX package's.

tests/test_controllers.py and tests/test_workload_controllers.py run on
the port as they stand: each source is compiled into a namespace of its
own with every `kubernetes_tpu.` import pointed at
`kubernetes_tpu_torch.` (test_controllers.py's helpers from
tests/test_sched_e2e.py carried over to the port's types through the
wire), and its test classes and functions are collected here. Then the
two packages side by side: one seeded script of objects, made with the
JAX types and carried over the wire, goes through both packages'
controllers under a FakeClock (a Job to completion, a DaemonSet over
three nodes, a Deployment rollout, an HPA over a fixed metrics source, a
namespace deletion, a quota's usage, service accounts and their
tokens), and the objects the controllers leave are wire-equal once
uids, stamps, revisions, generated name suffixes and token bytes are
masked."""

import os

import pytest

from kubernetes_tpu_torch.api.client import InProcClient
from kubernetes_tpu_torch.api.registry import Registry

from test_sched_e2e import pending_pod as jax_pending_pod
from test_sched_e2e import ready_node as jax_ready_node
from test_sched_e2e import wait_until as jax_wait_until
from test_torch_encode import cross

HERE = os.path.dirname(os.path.abspath(__file__))


def _port_namespace(name, extra=None):
    """Compile tests/<name> with its imports pointed at the port, in a
    namespace of its own (the two suites define helpers of one name with
    different signatures)."""
    path = os.path.join(HERE, name)
    with open(path) as f:
        src = f.read()
    assert src.count("from kubernetes_tpu.") >= 4
    src = src.replace(
        "from tests.test_sched_e2e import pending_pod, ready_node, "
        "wait_until\n", "")
    assert "test_sched_e2e" not in src
    ns = {"__name__": f"port_{name[:-3]}", "__file__": path}
    ns.update(extra or {})
    exec(compile(src.replace("from kubernetes_tpu.",
                             "from kubernetes_tpu_torch."), path, "exec"),
         ns)
    return ns


def _sched_ready_node(*args, **kw):
    return cross([jax_ready_node(*args, **kw)])[0]


def _sched_pending_pod(*args, **kw):
    return cross([jax_pending_pod(*args, **kw)])[0]


_SUITES = [
    _port_namespace("test_controllers.py", {
        "ready_node": _sched_ready_node, "pending_pod": _sched_pending_pod,
        "wait_until": jax_wait_until}),
    _port_namespace("test_workload_controllers.py"),
]
_COLLECTED = {}
for _ns in _SUITES:
    for _name, _obj in list(_ns.items()):
        if (_name.startswith("Test") and isinstance(_obj, type)) or (
                _name.startswith("test_") and callable(_obj)):
            assert _name not in _COLLECTED, _name
            _COLLECTED[_name] = _obj
globals().update(_COLLECTED)


@pytest.fixture()
def cluster():
    """Both suites' `cluster` fixture: a port Registry and its client."""
    registry = Registry()
    yield registry, InProcClient(registry)


# ------------------------------------------------------- side by side

import json  # noqa: E402
import re  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
from dataclasses import replace  # noqa: E402

import kubernetes_tpu.controllers as jax_controllers  # noqa: E402
from kubernetes_tpu.api.client import InProcClient as JaxClient  # noqa: E402
from kubernetes_tpu.api.registry import Registry as JaxRegistry  # noqa: E402
from kubernetes_tpu.core import types as jax_api  # noqa: E402
from kubernetes_tpu.core.quantity import parse_quantity as jax_q  # noqa: E402
from kubernetes_tpu.core.scheme import default_scheme as jax_scheme  # noqa: E402
from kubernetes_tpu.utils.clock import FakeClock as JaxClock  # noqa: E402
import kubernetes_tpu_torch.controllers as port_controllers  # noqa: E402
from kubernetes_tpu_torch.core import types as port_api  # noqa: E402
from kubernetes_tpu_torch.core.scheme import default_scheme as port_scheme  # noqa: E402
from kubernetes_tpu_torch.utils.clock import FakeClock as PortClock  # noqa: E402

PKGS = {"jax": (jax_controllers, JaxRegistry, JaxClient, jax_scheme,
                jax_api, JaxClock),
        "port": (port_controllers, Registry, InProcClient, port_scheme,
                 port_api, PortClock)}
#: what the side-by-side script reads back, every namespace
RESOURCES = ("namespaces", "nodes", "pods", "replicationcontrollers",
             "jobs", "daemonsets", "deployments",
             "horizontalpodautoscalers", "resourcequotas",
             "serviceaccounts", "secrets", "services")
_RFC3339 = re.compile(r"^\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d(\.\d+)?Z$")
_ANNOTATED_RV = re.compile(r'"resourceVersion":\s*"\d+"')


def _tpl(labels, image="img"):
    return jax_api.PodTemplateSpec(
        metadata=jax_api.ObjectMeta(labels=dict(labels)),
        spec=jax_api.PodSpec(containers=[jax_api.Container(
            name="c", image=image, resources=jax_api.ResourceRequirements(
                requests={"cpu": jax_q("100m"),
                          "memory": jax_q("64Mi")}))]))


def _node(name):
    return jax_api.Node(
        metadata=jax_api.ObjectMeta(name=name, labels={"zone": name[-1]}),
        status=jax_api.NodeStatus(
            capacity={"cpu": jax_q("4"), "memory": jax_q("8Gi"),
                      "pods": jax_q("110")},
            conditions=[jax_api.NodeCondition(type="Ready",
                                              status="True")]))


def _script(seed):
    """The seeded objects of the script, JAX types: widths and counts
    drawn from `seed`."""
    import random
    rng = random.Random(seed)
    job_n = rng.randint(2, 4)
    return {
        "nodes": [_node(f"n{i}") for i in range(3)],
        "namespaces": [jax_api.Namespace(metadata=jax_api.ObjectMeta(
            name=n)) for n in ("default", "doomed", "team")],
        "job": jax_api.Job(
            metadata=jax_api.ObjectMeta(name="work", namespace="default"),
            spec=jax_api.JobSpec(parallelism=2, completions=job_n,
                                 selector={"job": "work"},
                                 template=_tpl({"job": "work"}))),
        "daemonset": jax_api.DaemonSet(
            metadata=jax_api.ObjectMeta(name="agent", namespace="default"),
            spec=jax_api.DaemonSetSpec(selector={"ds": "agent"},
                                       template=_tpl({"ds": "agent"}))),
        "deployment": jax_api.Deployment(
            metadata=jax_api.ObjectMeta(name="web", namespace="default"),
            spec=jax_api.DeploymentSpec(
                replicas=rng.randint(2, 3), selector={"app": "web"},
                template=_tpl({"app": "web"}))),
        "rollout_image": f"img:v{rng.randint(2, 9)}",
        "hpa_rc": jax_api.ReplicationController(
            metadata=jax_api.ObjectMeta(name="front", namespace="team"),
            spec=jax_api.ReplicationControllerSpec(
                replicas=2, selector={"app": "front"},
                template=_tpl({"app": "front"}))),
        "hpa": jax_api.HorizontalPodAutoscaler(
            metadata=jax_api.ObjectMeta(name="front-hpa", namespace="team"),
            spec=jax_api.HorizontalPodAutoscalerSpec(
                scale_ref=jax_api.SubresourceReference(
                    kind="ReplicationController", name="front",
                    namespace="team"),
                min_replicas=1, max_replicas=6,
                cpu_utilization_target_percentage=60)),
        "utilization": float(rng.choice([90, 150, 200])),
        "doomed": [
            jax_api.Pod(metadata=jax_api.ObjectMeta(
                name="p1", namespace="doomed"), spec=_tpl({}).spec),
            jax_api.Service(metadata=jax_api.ObjectMeta(
                name="s1", namespace="doomed"),
                spec=jax_api.ServiceSpec(selector={"a": "b"}))],
        "quota": jax_api.ResourceQuota(
            metadata=jax_api.ObjectMeta(name="q", namespace="team"),
            spec=jax_api.ResourceQuotaSpec(hard={
                "pods": jax_q("20"), "cpu": jax_q("4"),
                "memory": jax_q("2Gi"),
                "replicationcontrollers": jax_q("5")})),
    }


def _wait(cond, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            if cond():
                return True
        except Exception:
            pass
        time.sleep(0.02)
    return cond()


def _drive(pkg, seed):
    """The script through one package's controllers -> every object of
    RESOURCES, as wire dicts."""
    ctl, registry_cls, client_cls, scheme, api, clock_cls = PKGS[pkg]
    script = _script(seed)

    def mine(obj):
        return scheme.decode_dict(jax_scheme.encode_dict(obj))

    registry = registry_cls()
    client = client_cls(registry)
    clock = clock_cls(start=1_000.0)
    for ns in script["namespaces"]:
        client.create("namespaces", mine(ns))
    for n in script["nodes"]:
        client.create("nodes", mine(n))

    def pods(ns, key, value):
        return [p for p in client.list("pods", ns)[0]
                if p.metadata.labels.get(key) == value
                and p.metadata.deletion_timestamp is None]

    stop_ready = threading.Event()

    def readiness():
        """The kubelet's part for the deployment's pods: Running and
        Ready, so the rolling update can scale the old RC down."""
        while not stop_ready.is_set():
            for p in pods("default", "app", "web"):
                if not ctl.framework.is_pod_ready(p):
                    try:
                        client.update_status("pods", replace(
                            p, status=replace(
                                p.status, phase="Running",
                                conditions=[api.PodCondition(
                                    type="Ready", status="True")])),
                            "default")
                    except Exception:
                        pass
            stop_ready.wait(0.02)

    util = script["utilization"]
    running = [
        ctl.ServiceAccountsController(client),
        ctl.TokensController(client),
        ctl.NamespaceController(client),
        ctl.ReplicationManager(client),
        ctl.JobController(client, clock=clock),
        ctl.DaemonSetController(client),
        ctl.DeploymentController(client)]
    for c in running:
        c.run()
    pump = threading.Thread(target=readiness, daemon=True)
    pump.start()
    try:
        # a Job to completion: complete each Pending pod in turn
        job = script["job"]
        client.create("jobs", mine(job), "default")
        for _ in range(job.spec.completions):
            assert _wait(lambda: any(p.status.phase == "Pending"
                                     for p in pods("default", "job",
                                                   "work")))
            victim = next(p for p in pods("default", "job", "work")
                          if p.status.phase == "Pending")
            client.update_status("pods", replace(
                victim, status=api.PodStatus(phase="Succeeded")), "default")
        assert _wait(lambda: client.get("jobs", "work", "default")
                     .status.succeeded == job.spec.completions)
        assert _wait(lambda: client.get("jobs", "work", "default")
                     .status.completion_time)
        # a DaemonSet over the three nodes
        client.create("daemonsets", mine(script["daemonset"]), "default")
        assert _wait(lambda: sorted(p.spec.node_name for p in pods(
            "default", "ds", "agent")) == ["n0", "n1", "n2"])
        assert _wait(lambda: client.get("daemonsets", "agent", "default")
                     .status.current_number_scheduled == 3)
        # a Deployment, then a rollout to a new image
        dep = script["deployment"]
        want = dep.spec.replicas
        client.create("deployments", mine(dep), "default")
        assert _wait(lambda: len(pods("default", "app", "web")) == want)
        fresh = client.get("deployments", "web", "default")
        tpl = mine(replace(dep, spec=replace(dep.spec, template=_tpl(
            {"app": "web"}, script["rollout_image"])))).spec.template
        client.update("deployments", replace(
            fresh, spec=replace(fresh.spec, template=tpl)), "default")

        def rolled():
            rcs = [rc for rc in client.list("replicationcontrollers",
                                            "default")[0]
                   if rc.metadata.labels.get("app") == "web"
                   or rc.spec.selector.get("app") == "web"]
            live = [rc for rc in rcs if rc.spec.replicas > 0]
            web = pods("default", "app", "web")
            return (len(live) == 1 and live[0].status.replicas == want
                    and live[0].spec.template.spec.containers[0].image
                    == script["rollout_image"]
                    and len(web) == want
                    and all(ctl.framework.is_pod_ready(p) for p in web)
                    and client.get("deployments", "web", "default")
                    .status.updated_replicas == want)
        assert _wait(rolled, timeout=60)
        # the HPA over a fixed metrics source (one reconcile)
        client.create("replicationcontrollers", mine(script["hpa_rc"]),
                      "team")
        client.create("horizontalpodautoscalers", mine(script["hpa"]),
                      "team")
        hpa = ctl.HorizontalController(client, lambda ns, sel: util,
                                       clock=clock)
        hpa.reconcile_once()
        rc_front = client.get("replicationcontrollers", "front", "team")
        assert _wait(lambda: len(pods("team", "app", "front"))
                     == rc_front.spec.replicas)
        # a quota's usage (one sync)
        client.create("resourcequotas", mine(script["quota"]), "team")
        ctl.ResourceQuotaController(client).sync_once()
        # a namespace deletion with its pod and service
        for obj in script["doomed"]:
            client.create("pods" if isinstance(obj, jax_api.Pod)
                          else "services",
                          mine(obj), "doomed")
        client.delete("namespaces", "doomed")

        def gone():
            try:
                client.get("namespaces", "doomed")
                return False
            except Exception:
                return True
        assert _wait(gone)
        # service accounts and their tokens in every live namespace
        assert _wait(lambda: all(
            any(r.name == "default-token" for r in client.get(
                "serviceaccounts", "default", ns).secrets)
            for ns in ("default", "team")))
        # at rest: every status written (no write for half a second)
        assert _wait(lambda: client.get("deployments", "web", "default")
                     .status.available_replicas == want)
        rev, since = registry.store.current_revision, time.time()
        deadline = since + 30
        while time.time() - since < 0.5 and time.time() < deadline:
            time.sleep(0.05)
            if registry.store.current_revision != rev:
                rev, since = registry.store.current_revision, time.time()
        assert time.time() - since >= 0.5, "the controllers never settled"
    finally:
        stop_ready.set()
        pump.join(timeout=10)
        for c in reversed(running):
            c.stop()
    out = {}
    for resource in RESOURCES:
        items, _ = client.list(resource)
        out[resource] = [scheme.encode_dict(o) for o in items]
    return out


def _masked(by_resource):
    """Uids, resource versions, wall-clock stamps, generated name
    suffixes (an RC's, in its pods' names too) and token bytes masked,
    each resource's objects sorted."""
    objs = [o for items in by_resource.values() for o in items]
    uids = {o["metadata"].get("uid") for o in objs} - {None, ""}
    gen = {}

    def walk(v):
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        if isinstance(v, list):
            return [walk(x) for x in v]
        if isinstance(v, str):
            if v in uids:
                return "<uid>"
            if _RFC3339.match(v):
                return "<time>"
            for real in order:     # longest first: a pod's name holds
                v = v.replace(real, gen[real])   # its RC's
            return _ANNOTATED_RV.sub('"resourceVersion": "<rv>"', v)
        return v

    for o in objs:
        md = o["metadata"]
        if md.get("generateName") and md["name"].startswith(
                md["generateName"]):
            gen[md["name"]] = md["generateName"] + "<suffix>"
    order = sorted(gen, key=len, reverse=True)

    def mask(o):
        o = walk(o)
        md = o["metadata"]
        for k in ("uid", "resourceVersion", "creationTimestamp",
                  "selfLink"):
            md.pop(k, None)
        if o.get("type") == "kubernetes.io/service-account-token":
            o["data"] = {k: "<token>" for k in o.get("data", {})}
        return o
    return {r: sorted((mask(o) for o in items),
                      key=lambda o: json.dumps(o, sort_keys=True))
            for r, items in by_resource.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_controllers_side_by_side_wire_equal(seed):
    """One seeded script through both packages' controllers: the Job
    completes, the DaemonSet runs a pod a node, the Deployment rolls out
    to its new image, the HPA scales its RC, the quota counts the team's
    usage, the doomed namespace goes with its pod and service, and every
    live namespace has its default service account and token: every
    object read back is wire-equal once masked."""
    jax_out, port_out = _drive("jax", seed), _drive("port", seed)
    jax_masked, port_masked = _masked(jax_out), _masked(port_out)
    for resource in RESOURCES:
        assert port_masked[resource] == jax_masked[resource], resource
    # the script did what it says, in both
    jobs = jax_out["jobs"]
    assert jobs[0]["status"]["succeeded"] == jobs[0]["spec"]["completions"]
    assert {n["metadata"]["name"] for n in jax_out["namespaces"]} == {
        "default", "team"}
    quota = jax_out["resourcequotas"][0]["status"]["used"]
    assert quota["pods"] == str(len([
        p for p in jax_out["pods"] if p["metadata"]["namespace"] == "team"]))


def test_replication_burst_runs_on_a_bounded_thread_set():
    """The replication manager's burst (up to 500 creates or deletes a
    sync) runs every call before the sync returns, on at most
    SPAWN_THREADS threads at once, and a call that raises does not stop
    the others."""
    from kubernetes_tpu_torch.controllers import replication
    lock = threading.Lock()
    state = {"now": 0, "peak": 0, "done": 0}

    def call(i):
        def fn():
            with lock:
                state["now"] += 1
                state["peak"] = max(state["peak"], state["now"])
            time.sleep(0.002)
            with lock:
                state["now"] -= 1
                state["done"] += 1
            if i == 7:
                raise RuntimeError("one call fails")
        return fn
    replication.ReplicationManager._spawn_all([call(i) for i in range(120)])
    assert state["done"] == 120
    assert 1 < state["peak"] <= replication.SPAWN_THREADS
