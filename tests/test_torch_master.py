"""The port's master, admission chain and event recording
(kubernetes_tpu_torch/master.py, admission/, api/record.py,
utils/healthz.py) against the JAX package's.

tests/test_master.py and tests/test_admission_auth.py run on the port as
they stand: their sources are compiled here with every `kubernetes_tpu.`
import pointed at `kubernetes_tpu_torch.` (tests/conftest.py's
`ensure_default_namespace` replaced by the port's own), every case of
both, the resource-quota controller's included. Then the two packages side by
side: one script of admission cases (namespace lifecycle, auto-provision
and exists, limit ranger, quota, service account, SecurityContextDeny,
AlwaysDeny) gives the same verdicts and admitted objects in both; an
event recorder deduplicates and aggregates alike; the master's
componentstatus probe reads the port's healthz server."""

import os
import time
import urllib.request

import pytest

from kubernetes_tpu import admission as jax_adm
from kubernetes_tpu.api import record as jax_record
from kubernetes_tpu.api.client import InProcClient as JaxClient
from kubernetes_tpu.api.registry import Registry as JaxRegistry
from kubernetes_tpu.core import types as jax_api
from kubernetes_tpu.core.errors import ApiError as JaxApiError
from kubernetes_tpu.core.quantity import parse_quantity as jax_q
from kubernetes_tpu.core.scheme import default_scheme as jax_scheme
from kubernetes_tpu_torch import admission as port_adm
from kubernetes_tpu_torch.api import record as port_record
from kubernetes_tpu_torch.api.client import InProcClient as PortClient
from kubernetes_tpu_torch.api.registry import Registry as PortRegistry
from kubernetes_tpu_torch.core import types as port_api
from kubernetes_tpu_torch.core.errors import ApiError as PortApiError
from kubernetes_tpu_torch.core.scheme import default_scheme as port_scheme

TYPES = {"jax": jax_api, "port": port_api}
HERE = os.path.dirname(os.path.abspath(__file__))


def _port_source(name):
    path = os.path.join(HERE, name)
    with open(path) as f:
        src = f.read()
    assert src.count("from kubernetes_tpu.") >= 4
    return compile(
        src.replace("from tests.conftest import ensure_default_namespace\n",
                    "")
        .replace("from kubernetes_tpu.", "from kubernetes_tpu_torch."),
        path, "exec")


def ensure_default_namespace(client):
    """tests/conftest.py's helper, with the port's types."""
    from kubernetes_tpu_torch.core import types as api
    from kubernetes_tpu_torch.core.errors import AlreadyExists
    try:
        client.create("namespaces", api.Namespace(
            metadata=api.ObjectMeta(name="default")))
    except AlreadyExists:
        pass


exec(_port_source("test_master.py"))
exec(_port_source("test_admission_auth.py"))

PKGS = {"jax": (jax_adm, JaxRegistry, jax_scheme, JaxApiError, JaxClient,
                jax_record),
        "port": (port_adm, PortRegistry, port_scheme, PortApiError,
                 PortClient, port_record)}


def _pod(name, ns="default", cpu=None, privileged=False, host_net=False):
    req = {"cpu": jax_q(cpu), "memory": jax_q("64Mi")} if cpu else {}
    return jax_api.Pod(
        metadata=jax_api.ObjectMeta(name=name, namespace=ns),
        spec=jax_api.PodSpec(host_network=host_net, containers=[
            jax_api.Container(name="c", image="img", privileged=privileged,
                              resources=jax_api.ResourceRequirements(
                                  requests=req))]))


# (plugins, [(verb, resource, object or name, namespace)]): objects are
# JAX objects, carried to the port through the wire format
CASES = {
    "lifecycle": (["NamespaceLifecycle"], [
        ("create", "pods", _pod("p", ns="nope"), "nope"),
        ("create", "namespaces", jax_api.Namespace(
            metadata=jax_api.ObjectMeta(name="dying")), ""),
        ("delete", "namespaces", "dying", ""),
        ("create", "pods", _pod("p", ns="dying"), "dying"),
        ("delete", "namespaces", "default", ""),
        ("create", "pods", _pod("ok"), "default")]),
    "autoprovision": (["NamespaceAutoProvision"], [
        ("create", "pods", _pod("p", ns="fresh"), "fresh"),
        ("get", "namespaces", "fresh", "")]),
    "exists": (["NamespaceExists"], [
        ("create", "pods", _pod("p", ns="nope"), "nope"),
        ("create", "pods", _pod("p"), "default")]),
    "limitranger": (["LimitRanger"], [
        ("create", "limitranges", jax_api.LimitRange(
            metadata=jax_api.ObjectMeta(name="lims", namespace="default"),
            spec=jax_api.LimitRangeSpec(limits=[jax_api.ConfigEntry(
                type="Container", min={"cpu": jax_q("50m")},
                max={"cpu": jax_q("2")},
                default={"cpu": jax_q("100m"),
                         "memory": jax_q("128Mi")})])), "default"),
        ("create", "pods", _pod("p"), "default"),
        ("create", "pods", _pod("big", cpu="4"), "default"),
        ("create", "pods", _pod("tiny", cpu="10m"), "default")]),
    "quota": (["ResourceQuota"], [
        ("create", "resourcequotas", jax_api.ResourceQuota(
            metadata=jax_api.ObjectMeta(name="q", namespace="default"),
            spec=jax_api.ResourceQuotaSpec(hard={
                "pods": jax_q("2"), "cpu": jax_q("500m")})), "default"),
        ("create", "pods", _pod("a", cpu="300m"), "default"),
        ("create", "pods", _pod("b", cpu="300m"), "default"),
        ("create", "pods", _pod("c", cpu="100m"), "default"),
        ("create", "pods", _pod("d", cpu="100m"), "default"),
        ("get", "resourcequotas", "q", "default")]),
    "serviceaccount": (["ServiceAccount"], [
        ("create", "pods", _pod("p"), "default"),
        ("create", "secrets", jax_api.Secret(
            metadata=jax_api.ObjectMeta(
                name="tok", namespace="default",
                annotations={"kubernetes.io/service-account.name":
                             "default"}),
            type="kubernetes.io/service-account-token",
            data={"token": "t0k"}), "default"),
        ("create", "serviceaccounts", jax_api.ServiceAccount(
            metadata=jax_api.ObjectMeta(name="default",
                                        namespace="default"),
            secrets=[jax_api.ObjectReference(kind="Secret", name="tok")]),
         "default"),
        ("create", "pods", _pod("p2"), "default")]),
    "scdeny": (["SecurityContextDeny"], [
        ("create", "pods", _pod("p", privileged=True), "default"),
        ("create", "pods", _pod("h", host_net=True), "default"),
        ("create", "pods", _pod("ok"), "default")]),
    "chain": (["NamespaceLifecycle", "LimitRanger", "ServiceAccount",
               "SecurityContextDeny", "ResourceQuota"], [
        ("create", "pods", _pod("p"), "default"),
        ("create", "serviceaccounts", jax_api.ServiceAccount(
            metadata=jax_api.ObjectMeta(name="default",
                                        namespace="default")), "default"),
        ("create", "pods", _pod("p", privileged=True), "default"),
        ("create", "pods", _pod("p"), "default"),
        ("create", "pods", _pod("q", ns="gone"), "gone")]),
    "alwaysdeny": (["AlwaysDeny"], [
        ("create", "pods", _pod("p"), "default")]),
}


def _mask(wire):
    """Drop the fields each run stamps anew (uids, timestamps)."""
    if isinstance(wire, dict):
        return {k: _mask(v) for k, v in wire.items()
                if k not in ("uid", "creationTimestamp", "deletionTimestamp")}
    if isinstance(wire, list):
        return [_mask(v) for v in wire]
    return wire


def verdicts(pkg, plugins, ops):
    adm, registry_cls, scheme, api_error, _c, _r = PKGS[pkg]
    registry = registry_cls()
    registry.create("namespaces", scheme.decode_dict(jax_scheme.encode_dict(
        jax_api.Namespace(metadata=jax_api.ObjectMeta(name="default")))))
    registry.admission = adm.registry_hook(
        adm.new_from_plugins(registry, list(plugins)))
    out = []
    for verb, resource, obj, ns in ops:
        try:
            if verb == "create":
                got = registry.create(
                    resource, scheme.decode_dict(jax_scheme.encode_dict(obj)),
                    ns)
            elif verb == "get":
                got = registry.get(resource, obj, ns)
            else:
                got = registry.delete(resource, obj, ns)
            out.append(_mask(scheme.encode_dict(got)))
        except api_error as e:
            out.append(["refused", type(e).__name__, e.code])
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_admission_verdicts_alike(case):
    plugins, ops = CASES[case]
    want = verdicts("jax", plugins, ops)
    assert verdicts("port", plugins, ops) == want
    assert any(isinstance(v, list) and v[0] == "refused" for v in want) \
        or case == "autoprovision"


def _events(pkg):
    """A recorder over InProcClient(Registry()): 12 identical events
    (deduplicated into one with a count), 12 that differ only by their
    message (aggregated past 10), one of another reason."""
    _a, registry_cls, scheme, _e, client_cls, record = PKGS[pkg]
    registry = registry_cls()
    client = client_cls(registry)
    pod = scheme.decode_dict(jax_scheme.encode_dict(_pod("web")))
    pod = client.create("pods", pod, "default")
    api = TYPES[pkg]
    broadcaster = record.EventBroadcaster().start_recording_to_sink(
        record.ClientEventSink(client))
    rec = broadcaster.new_recorder(api.EventSource(component="scheduler",
                                                   host="h1"))
    for _ in range(12):
        rec.event(pod, "Warning", "FailedScheduling", "no fit")
    for i in range(12):
        rec.eventf(pod, "Normal", "Pulled", "image %d pulled", i)
    rec.event(pod, "Normal", "Scheduled", "bound to n1")
    deadline = time.time() + 10
    seen = None
    while time.time() < deadline:
        events, _ = client.list("events", "default")
        now = sorted((e.reason, e.type, e.message, e.count,
                      e.involved_object.name, e.source.component)
                     for e in events)
        if now == seen and sum(e[3] for e in now) >= 25:
            break
        seen = now
        time.sleep(0.2)
    broadcaster.shutdown()
    return seen


def test_event_recording_alike():
    want = _events("jax")
    got = _events("port")
    assert got == want
    counts = {(r, m): c for r, _t, m, c, _n, _s in got}
    assert counts[("FailedScheduling", "no fit")] == 12
    assert ("Scheduled", "bound to n1") in counts


def test_componentstatus_reads_the_healthz_server():
    """The master's componentstatus probe reads a HealthzServer's answer
    and reports unhealthy once the server is gone."""
    from kubernetes_tpu_torch.utils.healthz import HealthzServer
    from kubernetes_tpu_torch.master import _healthz_probe
    server = HealthzServer(port=0).start()
    try:
        with urllib.request.urlopen(server.url + "/healthz",
                                    timeout=5) as r:
            assert r.status == 200 and r.read() == b"ok"
        assert _healthz_probe(server.port)() == (True, "ok")
    finally:
        server.stop()
    ok, msg = _healthz_probe(server.port)()
    assert not ok and "healthz" in msg
