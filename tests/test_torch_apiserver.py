"""The port's HTTP plane against the JAX package's (kubernetes_tpu_torch/
api/{server,client,relay,tunneler,swagger,ui_app}.py, auth/,
utils/wsstream.py).

One seeded request script is played against the JAX ApiServer over a JAX
Registry and against the port's over a port Registry, as raw HTTP: the
status, the Content-Type, the body and every watch frame must be equal,
with uids and RFC 3339 timestamps masked. Then the two packages' clients
and servers are crossed (the JAX HttpClient against the port's server,
and the port's against the JAX server), the TLS and client-cert cases of
tests/test_tls_auth.py run on the port, the kubelet relay verbs go
through the port's server and InProcClient to a JAX KubeletServer
(reached only over HTTP and websocket), and the authentication and
authorization tables of tests/test_admission_auth.py decide alike in
both packages. The admission cases of that file run on the port in
tests/test_torch_master.py."""

import base64
import http.client
import json
import random
import re
import socket
import ssl
import subprocess
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from kubernetes_tpu import auth as jax_auth
from kubernetes_tpu import obs as jax_obs
from kubernetes_tpu.api.client import HttpClient as JaxHttpClient
from kubernetes_tpu.api.registry import Registry as JaxRegistry
from kubernetes_tpu.api.server import ApiServer as JaxServer
from kubernetes_tpu.core import types as jax_api
from kubernetes_tpu.core.quantity import parse_quantity as jax_quantity
from kubernetes_tpu.core.scheme import default_scheme as jax_scheme
from kubernetes_tpu.kubelet.container import FakeRuntime
from kubernetes_tpu.kubelet.server import KubeletServer
from kubernetes_tpu.kubelet.subprocess_runtime import SubprocessRuntime
from kubernetes_tpu.utils import wsstream as jax_ws
from kubernetes_tpu.utils.metrics import MetricsRegistry as JaxMetrics
from kubernetes_tpu_torch import auth
from kubernetes_tpu_torch import obs as port_obs
from kubernetes_tpu_torch.api import relay
from kubernetes_tpu_torch.api.client import HttpClient, InProcClient
from kubernetes_tpu_torch.api.registry import Registry
from kubernetes_tpu_torch.api.server import ApiServer, ApiServerPool
from kubernetes_tpu_torch.api.tunneler import WsTunneler
from kubernetes_tpu_torch.core import types as api
from kubernetes_tpu_torch.core.errors import ApiError, NotFound
from kubernetes_tpu_torch.core.scheme import default_scheme as port_scheme
from kubernetes_tpu_torch.utils import wsstream
from kubernetes_tpu_torch.utils.metrics import MetricsRegistry

from test_torch_encode import cross

PKGS = {"jax": (JaxServer, JaxRegistry, JaxMetrics, jax_ws),
        "port": (ApiServer, Registry, MetricsRegistry, wsstream)}

_UID = re.compile(rb"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                  rb"[0-9a-f]{12}")
_TS = re.compile(rb"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d(?:\.\d+)?"
                 rb"(?:Z|[+-]\d\d:\d\d)")
_PORT = re.compile(rb"127\.0\.0\.1:\d+")
_TRACE = re.compile(rb"00-[0-9a-f]{32}-[0-9a-f]{16}-0\d")


def mask(raw: bytes) -> bytes:
    """Random uids, wall-clock timestamps and each server's own port
    differ between runs; every other byte must not."""
    return _PORT.sub(b"127.0.0.1:<port>",
                     _TS.sub(b"<ts>", _UID.sub(b"<uid>", raw)))


def mask_trace(raw: bytes) -> bytes:
    """Where a client of one package talks to a server of the other,
    the trace ids come from two tracers' counters."""
    return _TRACE.sub(b"<trace>", mask(raw))


class Side:
    """One package's ApiServer over its own Registry and MetricsRegistry,
    driven with raw HTTP."""

    def __init__(self, pkg, **kw):
        server_cls, registry_cls, metrics_cls, self.ws = PKGS[pkg]
        self.pkg = pkg
        self.registry = registry_cls()
        self.metrics = metrics_cls()
        self.server = server_cls(self.registry, port=0, metrics=self.metrics,
                                 **kw).start()

    def call(self, method, path, body=None, ctype="application/json"):
        conn = http.client.HTTPConnection("127.0.0.1", self.server.port,
                                          timeout=15)
        try:
            data = None
            headers = {}
            if body is not None:
                data = body if isinstance(body, bytes) else \
                    json.dumps(body).encode()
                headers["Content-Type"] = ctype
            conn.request(method, path, body=data, headers=headers)
            resp = conn.getresponse()
            return (resp.status, resp.getheader("Content-Type"),
                    resp.getheader("Retry-After"), mask(resp.read()))
        finally:
            conn.close()

    def stop(self):
        self.server.stop()


@pytest.fixture(autouse=True)
def seeded_tracers():
    """Each package's tracer is replaced by one seeded alike for the
    test, so the trace ids a server stamps into objects (the traceparent
    annotation) are equal too when both see the same requests."""
    prev = [jax_obs.set_tracer(jax_obs.Tracer(seed=0)),
            port_obs.set_tracer(port_obs.Tracer(seed=0))]
    yield
    jax_obs.set_tracer(prev[0])
    port_obs.set_tracer(prev[1])


@pytest.fixture()
def sides():
    """Both packages' servers, made in pairs."""
    made = []

    def make(**kw):
        pair = (Side("jax", **kw), Side("port", **kw))
        made.extend(pair)
        return pair

    yield make
    for s in made:
        s.stop()


def play_both(pair, steps):
    """Play each step on both sides in turn; -> the outcomes, equal."""
    outs = []
    for i, step in enumerate(steps):
        got = [s.call(*step) for s in pair]
        assert got[0] == got[1], (i, step, got)
        outs.append(got[0])
    return outs


# ------------------------------------------------------- the request script

def pod_wire(name, ns="default", labels=None, node="", containers=None,
             ports=None):
    c = [{"name": "c", "image": "img"}] if containers is None else containers
    if ports:
        c[0]["ports"] = [{"containerPort": p} for p in ports]
    return {"kind": "Pod", "apiVersion": "v1",
            "metadata": {"name": name, "namespace": ns,
                         "labels": labels or {}},
            "spec": {"nodeName": node, "containers": c},
            "status": {"phase": "Pending"}}


def node_wire(name):
    return {"kind": "Node", "apiVersion": "v1",
            "metadata": {"name": name},
            "status": {"capacity": {"cpu": "4", "memory": "8Gi",
                                    "pods": "110"}}}


def seeded_pods(seed, n=12):
    rng = random.Random(seed)
    return [pod_wire(f"p-{i:02d}",
                     labels={"app": rng.choice(["web", "db"]),
                             "tier": rng.choice(["a", "b"])},
                     node=rng.choice(["", "n1", "n2"]))
            for i in range(n)]


P = "/api/v1/namespaces/default/pods"
JSON_PATCH = "application/json-patch+json"
MERGE_PATCH = "application/merge-patch+json"
SMP = "application/strategic-merge-patch+json"


def crud_script(seed):
    pods = seeded_pods(seed)
    rng = random.Random(seed + 1)
    steps = [("POST", "/api/v1/nodes", node_wire("n1")),
             ("POST", "/api/v1/nodes", node_wire("n2")),
             ("POST", "/api/v1/namespaces",
              {"kind": "Namespace", "metadata": {"name": "ns-b"}})]
    steps += [("POST", P, p) for p in pods]
    steps += [("GET", f"{P}/{p['metadata']['name']}") for p in pods[:4]]
    victim = rng.choice(pods)["metadata"]["name"]
    steps += [
        # errors: not found, already exists, invalid, malformed, unknown
        ("GET", f"{P}/ghost"),
        ("POST", P, pods[0]),
        ("POST", P, {"kind": "Pod", "metadata": {"name": "x",
                                                 "namespace": "default"}}),
        ("POST", P, b"{not json", "application/json"),
        ("GET", "/api/v1/namespaces/default/widgets"),
        ("GET", "/nothing/here"),
        ("DELETE", f"{P}/ghost"),
        # a stale resourceVersion conflicts; the right one updates
        ("PUT", f"{P}/p-01", {**pods[1], "metadata": {
            **pods[1]["metadata"], "resourceVersion": "1"}}),
        ("PUT", f"{P}/p-01", {**pods[1], "metadata": {
            **pods[1]["metadata"], "labels": {"app": "web", "tier": "z"}}}),
        ("PUT", f"{P}/p-02/status", {**pods[2], "status": {
            "phase": "Running"}}),
        # selectors
        ("GET", f"{P}?labelSelector=app%3Dweb"),
        ("GET", f"{P}?labelSelector=app%21%3Ddb%2Ctier%3Da"),
        ("GET", f"{P}?labelSelector=tier+in+%28a%2Cz%29"),
        ("GET", f"{P}?fieldSelector=spec.nodeName%3D"),
        ("GET", f"{P}?fieldSelector=spec.nodeName%3Dn1"),
        ("GET", f"{P}?fieldSelector=status.phase%3DRunning"),
        ("GET", "/api/v1/pods?labelSelector=app%3Ddb"),
        ("GET", f"{P}?fieldSelector=no.such.field%3Dx"),
        ("GET", f"{P}?labelSelector=%3D%3D%3D"),
        # the binding subresource
        ("POST", "/api/v1/namespaces/default/bindings",
         {"kind": "Binding", "metadata": {"name": "p-00",
                                          "namespace": "default"},
          "target": {"kind": "Node", "name": "n2"}}),
        ("POST", f"{P}/p-00/binding",
         {"kind": "Binding", "metadata": {"name": "p-00"},
          "target": {"kind": "Node", "name": "n1"}}),
        ("DELETE", f"{P}/{victim}"),
        ("GET", f"{P}/{victim}"),
        ("GET", "/api/v1/nodes"),
        ("GET", "/api/v1/namespaces"),
    ]
    return steps


def patch_script():
    two = [{"name": "c1", "image": "img:v1"}, {"name": "c2", "image": "other"}]
    return [
        ("POST", P, pod_wire("pp", labels={"app": "web", "tier": "x"},
                             containers=two)),
        ("PATCH", f"{P}/pp", {"metadata": {"labels": {"tier": None,
                                                      "env": "prod"}},
                              "spec": {"containers": [
                                  {"name": "c1", "image": "img:v2"}]}}, SMP),
        ("PATCH", f"{P}/pp", {"spec": {"containers": [
            {"name": "only", "image": "solo"}]}}, MERGE_PATCH),
        ("PATCH", f"{P}/pp", [
            {"op": "test", "path": "/metadata/labels/app", "value": "web"},
            {"op": "replace", "path": "/spec/containers/0/image",
             "value": "img:v3"},
            {"op": "remove", "path": "/metadata/labels/env"}], JSON_PATCH),
        ("PATCH", f"{P}/pp", [{"op": "test", "path": "/metadata/labels/app",
                               "value": "nope"}], JSON_PATCH),
        # $patch directives and RFC 6901's strict array tokens
        ("PATCH", f"{P}/pp", {"spec": {"containers": [
            {"$patch": "replace"}, {"name": "c1", "image": "a"},
            {"name": "c2", "image": "b"}]}}, SMP),
        ("PATCH", f"{P}/pp", {"spec": {"containers": [
            {"name": "c1", "$patch": "delete"}]}}, SMP),
        ("PATCH", f"{P}/pp", {"metadata": {"labels": {
            "$patch": "replace", "only": "this"}}}, SMP),
        ("PATCH", f"{P}/pp", [{"op": "replace", "path": "/spec/containers/-1",
                               "value": {}}], JSON_PATCH),
        ("PATCH", f"{P}/pp", [{"op": "add", "value": {}}], JSON_PATCH),
        ("PATCH", f"{P}/pp", [{"op": "replace", "path": "/metadata/name/x",
                               "value": 1}], JSON_PATCH),
        ("PATCH", f"{P}/pp", [{"op": "add", "path": "/x", "value": 1}], SMP),
        ("PATCH", f"{P}/pp", [{"op": "add", "path": "/spec/containers/99",
                               "value": {}}], JSON_PATCH),
        ("PATCH", f"{P}/pp", {"spec": {"volumes": [
            {"name": "ghost", "$patch": "delete"}]}}, SMP),
        ("PATCH", f"{P}/ghost", {"metadata": {"labels": {"a": "b"}}}, SMP),
        ("PATCH", f"{P}/pp", {"metadata": {}}, "text/plain"),
        ("GET", f"{P}/pp"),
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_request_script_is_wire_equal(sides, seed):
    pair = sides()
    outs = play_both(pair, crud_script(seed) + patch_script())
    codes = {o[0] for o in outs}
    # the script reaches successes and the error codes it means to
    assert {200, 201, 400, 404, 409, 422} <= codes, codes


def watch_body(side, path):
    """A watch bounded by timeoutSeconds: the server ends the chunked
    stream; -> its frames, masked, one a line."""
    conn = http.client.HTTPConnection("127.0.0.1", side.server.port,
                                      timeout=15)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        return resp.status, [mask(line) for line in body.splitlines()
                             if line.strip()]
    finally:
        conn.close()


@pytest.mark.parametrize("seed", [0, 1])
def test_watch_frames_from_a_resource_version_are_equal(sides, seed):
    pair = sides()
    pods = seeded_pods(seed, 6)
    play_both(pair, [("POST", P, p) for p in pods[:3]])
    _, _, _, listing = play_both(pair, [("GET", P)])[0]
    rv = json.loads(listing)["metadata"]["resourceVersion"]
    play_both(pair, [("POST", P, p) for p in pods[3:]]
              + [("DELETE", f"{P}/p-00"),
                 ("PUT", f"{P}/p-04/status",
                  {**pods[4], "status": {"phase": "Running"}})])
    paths = (f"{P}?watch=true&resourceVersion={rv}&timeoutSeconds=1",
             f"/api/v1/watch/namespaces/default/pods?resourceVersion="
             f"{rv}&timeoutSeconds=1&labelSelector=app%3Dweb",
             f"/api/v1/pods?watch=1&resourceVersion={rv}"
             f"&timeoutSeconds=1&fieldSelector=status.phase%3DRunning",
             "/api/v1/nodes?watch=true&timeoutSeconds=1",
             f"{P}?watch=true&resourceVersion=1&timeoutSeconds=1")
    # every stream runs its second out at once (watches are exempt from
    # the in-flight limit)
    with ThreadPoolExecutor(len(paths) * 2) as ex:
        futures = [[ex.submit(watch_body, s, path) for s in pair]
                   for path in paths]
        got = [[f.result() for f in pf] for pf in futures]
    for path, (jax_frames, port_frames) in zip(paths, got):
        assert jax_frames == port_frames, (path, jax_frames, port_frames)
    status, frames = got[0][0]
    assert status == 200 and len(frames) == 5


def ws_watch(side, path, created, timeout=10.0):
    """Open a websocket watch, ping it, create `created` over HTTP, and
    -> (pong payload, the text frames that carry them, masked)."""
    ws_mod = side.ws
    sock = ws_mod.client_connect("127.0.0.1", side.server.port, path)
    try:
        sock.settimeout(timeout)
        ws_mod.write_frame(sock.sendall, b"are-you-there", ws_mod.PING,
                           mask=True)
        pong = None
        while pong is None:
            op, payload = ws_mod.read_frame(sock.recv)
            assert op != ws_mod.CLOSE
            if op == ws_mod.PONG:
                pong = payload
        for body in created:
            assert side.call("POST", P, body)[0] == 201
        frames = []
        while len(frames) < len(created):
            op, payload = ws_mod.read_frame(sock.recv)
            assert op != ws_mod.CLOSE
            if op == ws_mod.TEXT:
                frames.append(mask(payload))
        return pong, frames
    finally:
        sock.close()


def test_websocket_watch_with_ping_pong_is_equal(sides):
    pair = sides()
    created = [pod_wire(f"ws-{i}", labels={"app": "ws"}) for i in range(3)]
    got = [ws_watch(s, f"{P}?watch=true&labelSelector=app%3Dws", created)
           for s in pair]
    assert got[0] == got[1]
    assert got[0][0] == b"are-you-there" and len(got[0][1]) == 3
    assert json.loads(got[0][1][0])["type"] == "ADDED"


def test_create_batch_with_mixed_namespaces_is_equal(sides):
    pair = sides()
    play_both(pair, [("POST", "/api/v1/namespaces",
                      {"kind": "Namespace", "metadata": {"name": "ns-b"}})])
    outs = play_both(pair, [
        ("POST", P, [pod_wire(f"b-{i}") for i in range(4)]),
        ("POST", "/api/v1/namespaces/ns-b/pods",
         [pod_wire("b-x", ns="ns-b"), pod_wire("b-y", ns="ns-b")]),
        ("POST", P, [pod_wire("b-0"), pod_wire("b-9")]),
        ("POST", P, [pod_wire("b-bad", containers=[])]),
        ("POST", P, []),
        ("GET", "/api/v1/pods"),
    ])
    assert outs[0][0] == 201 and outs[2][0] == 409
    # the clients group a mixed batch a namespace a POST, in input order
    made = []
    for side, client_cls, types, scheme in (
            (pair[0], JaxHttpClient, jax_api, jax_scheme),
            (pair[1], HttpClient, api, port_scheme)):
        c = client_cls(side.server.url)
        objs = [types.Pod(metadata=types.ObjectMeta(name=n, namespace=ns),
                          spec=types.PodSpec(containers=[
                              types.Container(name="c", image="i")]))
                for n, ns in (("m-0", "default"), ("m-1", "ns-b"),
                              ("m-2", "default"))]
        made.append([mask(json.dumps(scheme.encode_dict(o)).encode())
                     for o in c.create_batch("pods", objs)])
    assert made[0] == made[1]
    assert [json.loads(m)["metadata"]["namespace"] for m in made[1]] == [
        "default", "ns-b", "default"]


def test_healthz_discovery_and_metric_names_are_equal(sides):
    pair = sides()
    play_both(pair, crud_script(3)[:8])
    play_both(pair, [("GET", "/healthz"), ("GET", "/healthz/ping"),
                     ("GET", "/api"), ("GET", "/apis"), ("GET", "/api/v1"),
                     ("GET", "/apis/extensions/v1beta1"),
                     ("GET", "/swaggerapi"), ("GET", "/ui"),
                     ("GET", "/ui/server")])

    def names(side):
        status, _, _, body = side.call("GET", "/metrics")
        assert status == 200
        return sorted({line.split("{")[0].split(" ")[0]
                       for line in body.decode().splitlines()
                       if line and not line.startswith("#")})

    got = [names(s) for s in pair]
    assert got[0] == got[1]
    assert "apiserver_request_count" in got[1]
    assert "apiserver_request_latencies_microseconds" in got[1] or any(
        n.startswith("apiserver_request_latencies_microseconds")
        for n in got[1])


def test_list_bytes_cache_under_churn_is_equal(sides):
    pair = sides()
    rng = random.Random(5)
    steps = []
    live = []
    for i in range(30):
        if live and rng.random() < 0.35:
            name = live.pop(rng.randrange(len(live)))
            steps.append(("DELETE", f"{P}/{name}"))
        else:
            name = f"c-{i:02d}"
            live.append(name)
            steps.append(("POST", P, pod_wire(
                name, labels={"app": rng.choice(["web", "db"])})))
        # a LIST, its repeat (served from the cache) and a filtered one
        steps += [("GET", P), ("GET", P), ("GET", f"{P}?labelSelector="
                                                 f"app%3Dweb")]
    outs = play_both(pair, steps)
    assert all(o[0] in (200, 201) for o in outs)
    caches = [len(s.server._list_bytes_cache) for s in pair]
    assert caches[0] == caches[1] and caches[1] >= 1


RUNTIME_CONFIGS = [
    {"api/v1": False},
    {"apis/extensions/v1beta1": False},
    {"apis/extensions/v1beta1/deployments": False},
    {"api/all": False, "apis/extensions/v1beta1": True},
]


@pytest.mark.parametrize("rc", RUNTIME_CONFIGS,
                         ids=["no-v1", "no-ext", "no-deployments",
                              "ext-only"])
def test_runtime_config_switches_are_equal(sides, rc):
    pair = sides(runtime_config=rc)
    outs = play_both(pair, [
        ("GET", "/api"), ("GET", "/apis"), ("GET", "/api/v1"),
        ("GET", "/apis/extensions/v1beta1"),
        ("GET", P), ("GET", "/api/v1/nodes"),
        ("GET", "/apis/extensions/v1beta1/namespaces/default/deployments"),
        ("GET", "/apis/extensions/v1beta1/namespaces/default/jobs"),
        ("GET", "/api/v1/namespaces/default/deployments"),
        ("GET", "/apis/extensions/v1beta1/namespaces/default/pods"),
        ("GET", "/api/v1/watch/namespaces/default/deployments"
                "?timeoutSeconds=1")])
    assert 404 in {o[0] for o in outs}


@pytest.fixture()
def backend():
    """A live HTTP backend playing a pod: GET answers its path, writes
    echo their method, path and body."""
    class H(BaseHTTPRequestHandler):
        def _answer(self, body):
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._answer(f"backend:{self.path}".encode())

        def _echo(self):
            n = int(self.headers.get("Content-Length") or 0)
            payload = self.rfile.read(n) if n else b""
            self._answer(f"{self.command}:{self.path}:".encode() + payload)

        do_POST = do_PUT = do_PATCH = do_DELETE = _echo

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()


def test_workload_proxy_is_equal(sides, backend):
    pair = sides()
    running = {"phase": "Running", "podIP": "127.0.0.1"}
    svc = {"kind": "Service", "metadata": {"name": "svc",
                                           "namespace": "default"},
           "spec": {"ports": [{"name": "http", "port": 80}]}}
    eps = {"kind": "Endpoints", "metadata": {"name": "svc",
                                             "namespace": "default"},
           "subsets": [{"addresses": [{"ip": "127.0.0.1"}],
                        "ports": [{"name": "http", "port": backend}]}]}
    proxy = "/api/v1/proxy/namespaces/default"
    setup = [("POST", P, pod_wire("web-1", ports=[backend])),
             ("PUT", f"{P}/web-1/status",
              {**pod_wire("web-1", ports=[backend]), "status": running}),
             ("POST", P, pod_wire("web-3")),
             ("POST", "/api/v1/namespaces/default/services", svc),
             ("POST", "/api/v1/namespaces/default/endpoints", eps),
             ("POST", "/api/v1/namespaces/default/services",
              {**svc, "metadata": {"name": "lone", "namespace": "default"}}),
             ("POST", "/api/v1/namespaces/default/endpoints",
              {"kind": "Endpoints", "metadata": {"name": "lone",
                                                 "namespace": "default"}})]
    outs = play_both(pair, setup + [
        ("GET", f"{proxy}/pods/web-1/healthz?x=1"),
        ("GET", f"{proxy}/pods/web-1:{backend}/ok"),
        ("POST", f"{proxy}/pods/web-1:{backend}/db/write", b"hello",
         "application/test"),
        ("PUT", f"{proxy}/pods/web-1:{backend}/db/write", b"again",
         "application/test"),
        ("DELETE", f"{proxy}/pods/web-1:{backend}/db/row"),
        ("GET", f"{proxy}/pods/web-3:80/x"),
        ("GET", f"{proxy}/pods/web-1:http/x"),
        ("GET", f"{proxy}/services/svc:http/hi"),
        ("GET", f"{proxy}/services/svc:80/hi"),
        ("GET", f"{proxy}/services/svc/hi"),
        ("GET", f"{proxy}/services/lone:http/x"),
        ("GET", f"{proxy}/services/svc:81/x"),
        ("GET", f"{proxy}/services/ghost/x")])
    relayed = outs[len(setup):]
    assert relayed[0][0] == 200 and relayed[0][3] == b"backend:/healthz?x=1"
    assert relayed[2][3] == b"POST:/db/write:hello"
    assert [o[0] for o in relayed[5:7]] == [503, 400]
    assert relayed[7][3] == relayed[9][3] == b"backend:/hi"
    assert relayed[10][0] == relayed[11][0] == 503


def test_max_in_flight_sheds_alike(sides):
    """A server with no in-flight slots sheds every short request with
    the same 429 Status and Retry-After; watches and health stay open."""
    pair = sides(max_in_flight=1, shed_retry_after=0.25)
    for s in pair:
        s.server._inflight.acquire()
    outs = play_both(pair, [("GET", P), ("POST", P, pod_wire("shed")),
                            ("GET", "/healthz"),
                            ("GET", f"{P}?watch=true&timeoutSeconds=1")])
    assert [o[0] for o in outs] == [429, 429, 200, 200]
    assert outs[0][2] == "0.25"
    for s in pair:
        s.server._inflight.release()


# ---------------------------------------------------------- the cross-wire

def _crud_and_watch(client, types, scheme, ns_name):
    """CRUD and a watch through `client` -> the masked wire of each
    answer."""
    out = []

    def wire(obj):
        return mask_trace(json.dumps(scheme.encode_dict(obj),
                               sort_keys=True).encode())

    client.create("namespaces", types.Namespace(
        metadata=types.ObjectMeta(name=ns_name)))
    w = client.watch("pods", ns_name)
    try:
        pod = types.Pod(
            metadata=types.ObjectMeta(name="x1", namespace=ns_name,
                                      labels={"app": "web"}),
            spec=types.PodSpec(containers=[types.Container(name="c",
                                                           image="i")]))
        out.append(wire(client.create("pods", pod, ns_name)))
        got = client.get("pods", "x1", ns_name)
        out.append(wire(got))
        got.metadata.labels["tier"] = "b"
        out.append(wire(client.update("pods", got, ns_name)))
        items, rev = client.list("pods", ns_name, label_selector="app=web")
        out.append([wire(i) for i in items])
        client.delete("pods", "x1", ns_name, grace_period_seconds=0)
        events = []
        while len(events) < 3:
            ev = w.next(timeout=10)
            assert ev is not None
            events.append((ev.type, wire(ev.object)))
        out.append(events)
        try:
            client.get("pods", "x1", ns_name)
            out.append("found")
        except Exception as e:       # either package's NotFound
            out.append((type(e).__name__, getattr(e, "code", None)))
    finally:
        w.stop()
    return out


@pytest.mark.parametrize("direction", ["jax_client_port_server",
                                       "port_client_jax_server"])
def test_clients_and_servers_interoperate(sides, direction):
    jax_side, port_side = sides()
    if direction == "jax_client_port_server":
        crossed = _crud_and_watch(JaxHttpClient(port_side.server.url),
                                  jax_api, jax_scheme, "xw")
        same = _crud_and_watch(JaxHttpClient(jax_side.server.url),
                               jax_api, jax_scheme, "xw")
    else:
        crossed = _crud_and_watch(HttpClient(jax_side.server.url),
                                  api, port_scheme, "xw")
        same = _crud_and_watch(HttpClient(port_side.server.url),
                               api, port_scheme, "xw")
    assert crossed == same
    assert [e[0] for e in crossed[4]] == ["ADDED", "MODIFIED", "DELETED"]
    assert crossed[5] == ("NotFound", 404)


def test_port_client_handles_jax_server_errors_and_selectors(sides):
    jax_side, _ = sides()
    c = HttpClient(jax_side.server.url)
    c.create_batch("pods", cross([jax_api.Pod(
        metadata=jax_api.ObjectMeta(name=f"s-{i}", namespace="default",
                                    labels={"app": "web" if i % 2 else "db"}),
        spec=jax_api.PodSpec(containers=[jax_api.Container(
            name="c", image="i")])) for i in range(4)]))
    items, rev = c.list("pods", "default", label_selector="app=web")
    assert sorted(p.metadata.name for p in items) == ["s-1", "s-3"]
    assert rev > 0
    with pytest.raises(NotFound):
        c.get("pods", "ghost", "default")


def test_api_server_pool_serves_one_store():
    registry = Registry()
    pool = ApiServerPool(registry, n_workers=2).start()
    try:
        a, b = (HttpClient(w.url) for w in pool.workers)
        w = b.watch("pods", "default")
        a.create("pods", cross([jax_api.Pod(
            metadata=jax_api.ObjectMeta(name="pool-0", namespace="default"),
            spec=jax_api.PodSpec(containers=[jax_api.Container(
                name="c", image="i")]))])[0])
        ev = w.next(timeout=10)
        w.stop()
        assert ev is not None and ev.object.metadata.name == "pool-0"
        assert [p.metadata.name for p in b.list("pods", "default")[0]] == [
            "pool-0"]
    finally:
        pool.stop()


# ------------------------------------------------------------- TLS + x509

def _openssl(*args, cwd):
    subprocess.run(["openssl", *args], cwd=cwd, check=True,
                   capture_output=True)


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    d = tmp_path_factory.mktemp("certs")
    _openssl("req", "-x509", "-newkey", "rsa:2048", "-nodes", "-days", "1",
             "-keyout", "ca.key", "-out", "ca.crt",
             "-subj", "/CN=test-ca", cwd=d)
    _openssl("req", "-newkey", "rsa:2048", "-nodes",
             "-keyout", "server.key", "-out", "server.csr",
             "-subj", "/CN=127.0.0.1", cwd=d)
    (d / "san.cnf").write_text("subjectAltName=IP:127.0.0.1\n")
    _openssl("x509", "-req", "-in", "server.csr", "-CA", "ca.crt",
             "-CAkey", "ca.key", "-CAcreateserial", "-days", "1",
             "-out", "server.crt", "-extfile", "san.cnf", cwd=d)
    _openssl("req", "-newkey", "rsa:2048", "-nodes",
             "-keyout", "alice.key", "-out", "alice.csr",
             "-subj", "/O=dev-team/CN=alice", cwd=d)
    _openssl("x509", "-req", "-in", "alice.csr", "-CA", "ca.crt",
             "-CAkey", "ca.key", "-CAcreateserial", "-days", "1",
             "-out", "alice.crt", cwd=d)
    _openssl("req", "-x509", "-newkey", "rsa:2048", "-nodes", "-days", "1",
             "-keyout", "rogue-ca.key", "-out", "rogue-ca.crt",
             "-subj", "/CN=rogue-ca", cwd=d)
    _openssl("req", "-newkey", "rsa:2048", "-nodes",
             "-keyout", "mallory.key", "-out", "mallory.csr",
             "-subj", "/CN=alice", cwd=d)
    _openssl("x509", "-req", "-in", "mallory.csr", "-CA", "rogue-ca.crt",
             "-CAkey", "rogue-ca.key", "-CAcreateserial", "-days", "1",
             "-out", "mallory.crt", cwd=d)
    return d


@pytest.fixture()
def tls_server(certs):
    server = ApiServer(
        Registry(), port=0,
        tls_cert_file=str(certs / "server.crt"),
        tls_key_file=str(certs / "server.key"),
        tls_client_ca_file=str(certs / "ca.crt"),
        authenticator=auth.authenticate.X509Authenticator(),
        authorizer=auth.authorize.ABACAuthorizer(
            [auth.authorize.ABACPolicy(user="alice")])).start()
    yield server, certs
    server.stop()


def _client_ctx(certs, cert=None, key=None):
    ctx = ssl.create_default_context(cafile=str(certs / "ca.crt"))
    if cert:
        ctx.load_cert_chain(str(certs / cert), str(certs / key))
    return ctx


def _tls_case(case, server, certs):
    alice = _client_ctx(certs, "alice.crt", "alice.key")
    if case == "client_cert_authenticates":
        assert server.url.startswith("https://")
        pods, _ = HttpClient(server.url, ssl_context=alice).list(
            "pods", "default")
        assert pods == []
    elif case == "no_client_cert_is_401":
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(server.url + "/api/v1/pods",
                                   context=_client_ctx(certs))
        assert e.value.code == 401
    elif case == "untrusted_ca_rejected":
        ctx = _client_ctx(certs, "mallory.crt", "mallory.key")
        with pytest.raises((urllib.error.URLError, ssl.SSLError,
                            ConnectionError, OSError)):
            urllib.request.urlopen(server.url + "/api/v1/pods", context=ctx)
    elif case == "spoofed_peer_header_stripped":
        req = urllib.request.Request(
            server.url + "/api/v1/pods", headers={
                "X-Peer-Certificate": json.dumps(
                    [[["commonName", "alice"]]])})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, context=_client_ctx(certs))
        assert e.value.code == 401
    elif case == "watch_over_tls":
        client = HttpClient(server.url, ssl_context=alice)
        w = client.watch("pods", "default")
        try:
            client.create("pods", api.Pod(
                metadata=api.ObjectMeta(name="p1", namespace="default"),
                spec=api.PodSpec(containers=[api.Container(name="c",
                                                           image="img")])))
            ev = w.next(timeout=10)
            assert ev is not None and ev.object.metadata.name == "p1"
        finally:
            w.stop()
    elif case == "silent_client_does_not_block":
        silent = socket.create_connection(("127.0.0.1", server.port))
        try:
            time.sleep(0.1)
            t0 = time.time()
            pods, _ = HttpClient(server.url, ssl_context=alice,
                                 timeout=5.0).list("pods", "default")
            assert time.time() - t0 < 5.0 and pods == []
        finally:
            silent.close()


TLS_CASES = ["client_cert_authenticates", "no_client_cert_is_401",
             "untrusted_ca_rejected", "spoofed_peer_header_stripped",
             "watch_over_tls", "silent_client_does_not_block"]


@pytest.mark.parametrize("case", TLS_CASES)
def test_tls_and_client_certs_on_the_port(tls_server, case):
    _tls_case(case, *tls_server)


def test_x509_groups_from_organization_both_packages():
    subject = [[["organizationName", "dev-team"]], [["commonName", "alice"]]]
    for mod in (jax_auth, auth):
        a = mod.authenticate.X509Authenticator()
        info, ok = a.authenticate({"X-Peer-Certificate": json.dumps(subject)})
        assert ok and info.name == "alice" and info.groups == ["dev-team"]
        assert not a.authenticate({})[1]


# ------------------------------------------------------- authn / authz tables

def basic(user, pw):
    return {"Authorization":
            "Basic " + base64.b64encode(f"{user}:{pw}".encode()).decode()}


AUTHN_HEADERS = [{}, basic("alice", "secret"), basic("alice", "wrong"),
                 basic("mallory", "secret"),
                 {"Authorization": "Bearer tok123"},
                 {"Authorization": "Bearer nope"},
                 {"Authorization": "Basic !!notbase64"},
                 {"Authorization": "Digest abc"},
                 {"Authorization": "bearer tok123"}]
POLICY_LINES = ['{"user": "alice", "resource": "pods", "readonly": true}',
                '{"group": "admins"}',
                '{"user": "carol", "namespace": "team-a"}',
                '{"user": "*", "resource": "events", "readonly": true}']


def _authn(mod):
    return mod.UnionAuthenticator([
        mod.BasicAuthAuthenticator.from_lines(["secret,alice,1"]),
        mod.TokenAuthenticator.from_lines(["tok123,bob,2,admins"])])


def _decide(mod, headers):
    info, ok = mod.authenticate_request(_authn(mod), headers)
    return ok, None if info is None else (info.name, info.uid,
                                          list(info.groups))


@pytest.mark.parametrize("i", range(len(AUTHN_HEADERS)))
def test_authentication_table_decides_alike(i):
    assert _decide(jax_auth, AUTHN_HEADERS[i]) == \
        _decide(auth, AUTHN_HEADERS[i])


AUTHZ_ROWS = [(user, groups, read_only, resource, ns)
              for user, groups in (("alice", []), ("bob", ["admins"]),
                                   ("carol", []), ("dave", []))
              for read_only in (True, False)
              for resource, ns in (("pods", "default"), ("nodes", ""),
                                   ("events", "team-a"),
                                   ("pods", "team-a"))]


def test_authorization_table_decides_alike():
    decisions = []
    for mod in (jax_auth, auth):
        z = mod.abac_from_lines(POLICY_LINES)
        row = []
        for user, groups, read_only, resource, ns in AUTHZ_ROWS:
            attrs = mod.AuthorizerAttributes(
                user=mod.UserInfo(name=user, groups=groups),
                read_only=read_only, resource=resource, namespace=ns)
            row.append((z.authorize(attrs),
                        mod.AlwaysAllowAuthorizer().authorize(attrs),
                        mod.AlwaysDenyAuthorizer().authorize(attrs)))
        decisions.append(row)
    assert decisions[0] == decisions[1]
    assert any(d[0] for d in decisions[1]) and not all(
        d[0] for d in decisions[1])


@pytest.fixture()
def secured_server():
    registry = Registry()
    server = ApiServer(registry, port=0, authenticator=_authn(auth),
                       authorizer=auth.abac_from_lines(POLICY_LINES)).start()
    yield server
    server.stop()


def mkpod(name):
    return api.Pod(metadata=api.ObjectMeta(name=name, namespace="default"),
                   spec=api.PodSpec(containers=[api.Container(
                       name="c", image="i")]))


def _secured_case(case, url):
    if case == "unauthenticated_401":
        with pytest.raises(ApiError) as e:
            HttpClient(url).list("pods", "default")
        assert e.value.code == 401
    elif case == "wrong_password_401":
        with pytest.raises(ApiError) as e:
            HttpClient(url, headers=basic("alice", "wrong")).list(
                "pods", "default")
        assert e.value.code == 401
    elif case == "readonly_user_gets_not_posts":
        c = HttpClient(url, headers=basic("alice", "secret"))
        c.list("pods", "default")
        with pytest.raises(ApiError) as e:
            c.create("pods", mkpod("p"), "default")
        assert e.value.code == 403
        with pytest.raises(ApiError) as e:
            c.list("nodes")
        assert e.value.code == 403
    elif case == "group_admin_writes":
        c = HttpClient(url, headers={"Authorization": "Bearer tok123"})
        assert c.create("pods", mkpod("p"), "default").metadata.name == "p"
    elif case == "healthz_open":
        with urllib.request.urlopen(url + "/healthz") as resp:
            assert resp.status == 200 and resp.read() == b"ok"
    elif case == "watch_carries_auth":
        c = HttpClient(url, headers={"Authorization": "Bearer tok123"})
        w = c.watch("pods", "default")
        try:
            c.create("pods", mkpod("seen"), "default")
            ev = w.next(timeout=10)
            assert ev is not None and ev.object.metadata.name == "seen"
        finally:
            w.stop()
        with pytest.raises(ApiError) as e:
            HttpClient(url).watch("pods", "default")
        assert e.value.code == 401
    elif case == "finalize_authorizes_as_namespaces":
        c = HttpClient(url, headers={"Authorization": "Bearer tok123"})
        c.create("namespaces", api.Namespace(
            metadata=api.ObjectMeta(name="fin")))
        c.delete("namespaces", "fin")
        assert c.get("namespaces", "fin").status.phase == "Terminating"


SECURED_CASES = ["unauthenticated_401", "wrong_password_401",
                 "readonly_user_gets_not_posts", "group_admin_writes",
                 "healthz_open", "watch_carries_auth",
                 "finalize_authorizes_as_namespaces"]


@pytest.mark.parametrize("case", SECURED_CASES)
def test_secured_port_server(secured_server, case):
    _secured_case(case, secured_server.url)


def test_secured_servers_answer_alike():
    """The same unauthenticated, forbidden and allowed requests against
    both packages' secured servers: codes and Status bodies equal."""
    servers = [JaxServer(JaxRegistry(), port=0,
                         authenticator=_authn(jax_auth),
                         authorizer=jax_auth.abac_from_lines(POLICY_LINES)),
               ApiServer(Registry(), port=0, authenticator=_authn(auth),
                         authorizer=auth.abac_from_lines(POLICY_LINES))]
    for s in servers:
        s.start()
    try:
        outs = []
        for s in servers:
            row = []
            for headers, method, path, body in (
                    ({}, "GET", P, None),
                    (basic("alice", "secret"), "GET", P, None),
                    (basic("alice", "secret"), "POST", P, pod_wire("a")),
                    (basic("alice", "secret"), "GET", "/api/v1/nodes", None),
                    ({"Authorization": "Bearer tok123"}, "POST", P,
                     pod_wire("b")),
                    (basic("carol", "x"), "GET", P, None),
                    ({}, "GET", "/healthz", None)):
                conn = http.client.HTTPConnection("127.0.0.1", s.port,
                                                  timeout=10)
                data = None if body is None else json.dumps(body).encode()
                conn.request(method, path, body=data, headers={
                    **headers, "Content-Type": "application/json"})
                resp = conn.getresponse()
                row.append((resp.status, mask(resp.read())))
                conn.close()
            outs.append(row)
        assert outs[0] == outs[1], outs
        assert [o[0] for o in outs[1]] == [401, 200, 403, 403, 201, 401, 200]
    finally:
        for s in servers:
            s.stop()


# ------------------------------------------------------------ kubelet relay

def _register_node(registry, name, port):
    registry.create("nodes", api.Node(
        metadata=api.ObjectMeta(name=name),
        status=api.NodeStatus(
            addresses=[api.NodeAddress(type="InternalIP",
                                       address="127.0.0.1")],
            daemon_endpoints=api.NodeDaemonEndpoints(
                kubelet_endpoint=api.DaemonEndpoint(port=port)))))


@pytest.fixture()
def relay_cluster(tmp_path):
    """A port Registry whose node's kubelet is the JAX package's
    KubeletServer over a real `cat` process (reached only over HTTP and
    websocket), the port's ApiServer in front."""
    runtime = SubprocessRuntime(root_dir=str(tmp_path))
    pod = jax_api.Pod(
        metadata=jax_api.ObjectMeta(name="cat", namespace="default",
                                    uid="uid-relay"),
        spec=jax_api.PodSpec(node_name="node-1", containers=[
            jax_api.Container(name="main", image="busybox",
                              command=["sh", "-c", "echo relay-log; cat"],
                              stdin=True)]))
    runtime.start_container(pod, pod.spec.containers[0])
    ksrv = KubeletServer("node-1", lambda: [pod], runtime,
                         lambda: {"cpu": jax_quantity("4")}).start()
    registry = Registry()
    _register_node(registry, "node-1", ksrv.port)
    registry.create("pods", cross([pod])[0])
    server = ApiServer(registry, port=0).start()
    deadline = time.time() + 10
    while time.time() < deadline and b"relay-log" not in \
            _logs_raw(ksrv.port):
        time.sleep(0.05)
    yield registry, server, ksrv
    server.stop()
    ksrv.stop()
    runtime.kill_pod("uid-relay")


def _logs_raw(port):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/containerLogs/default/cat/main",
                timeout=5) as resp:
            return resp.read()
    except (urllib.error.URLError, OSError):
        return b""


def _read_output(ws, want, timeout=10.0):
    got = b""
    deadline = time.time() + timeout
    ws.settimeout(2.0)
    while want not in got and time.time() < deadline:
        try:
            opcode, payload = wsstream.read_frame(ws.recv)
        except (TimeoutError, ConnectionError, OSError):
            continue
        if opcode == wsstream.CLOSE:
            break
        if opcode == wsstream.BINARY:
            got += payload
    return got


def _drive_exec(ws, send):
    if send:
        wsstream.write_frame(ws.sendall, send, wsstream.BINARY, mask=True)
    wsstream.write_frame(ws.sendall, wsstream.EOF_MARKER, wsstream.TEXT,
                         mask=True)
    out, code = b"", None
    ws.settimeout(10.0)
    while True:
        opcode, payload = wsstream.read_frame(ws.recv)
        if opcode == wsstream.CLOSE:
            break
        if opcode == wsstream.BINARY:
            out += payload
        elif opcode == wsstream.TEXT and payload != wsstream.EOF_MARKER:
            code = json.loads(payload)["exitCode"]
    return out, code


def _client(kind, registry, server):
    return InProcClient(registry) if kind == "inproc" else \
        HttpClient(server.url)


@pytest.mark.parametrize("kind", ["inproc", "http"])
def test_relay_logs_and_node_proxy(relay_cluster, kind):
    registry, server, _ = relay_cluster
    c = _client(kind, registry, server)
    assert c.pod_logs("cat", "default").startswith("relay-log\n")
    assert c.pod_logs("cat", "default", "main", tail_lines=1) == \
        "relay-log\n"
    assert c.node_proxy("node-1", "healthz") == b"ok"
    raw = c.node_proxy("node-1",
                       "exec/default/cat/main?command=echo&command=hi")
    res = json.loads(raw)
    assert res["exitCode"] == 0 and "hi" in res["output"]
    with pytest.raises(ApiError):
        c.pod_logs("ghost", "default")
    stream = c.pod_logs_stream("cat", "default")
    try:
        first = next(iter(stream))
        assert first.startswith("relay-log")
    finally:
        stream.close()


@pytest.mark.parametrize("kind", ["inproc", "http"])
def test_relay_attach_and_exec(relay_cluster, kind):
    registry, server, _ = relay_cluster
    c = _client(kind, registry, server)
    ws = c.attach_open("cat", "default", stdin=True)
    try:
        wsstream.write_frame(ws.sendall, b"via attach\n", wsstream.BINARY,
                             mask=True)
        assert b"via attach\n" in _read_output(ws, b"via attach\n")
    finally:
        ws.close()
    ws = c.exec_open("cat", "default", ["cat"], stdin=True)
    try:
        assert _drive_exec(ws, b"via exec\n") == (b"via exec\n", 0)
    finally:
        ws.close()
    ws = c.exec_open("cat", "default", ["sh", "-c", "echo out; exit 7"],
                     stdin=True)
    try:
        assert _drive_exec(ws, b"") == (b"out\n", 7)
    finally:
        ws.close()


@pytest.fixture()
def echo_port():
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]

    def serve():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return

            def handle(c):
                with c:
                    while True:
                        data = c.recv(65536)
                        if not data:
                            return
                        c.sendall(data.upper())
            threading.Thread(target=handle, args=(conn,),
                             daemon=True).start()

    threading.Thread(target=serve, daemon=True).start()
    yield port
    srv.close()


@pytest.mark.parametrize("kind", ["inproc", "http"])
def test_relay_portforward(echo_port, kind):
    runtime = FakeRuntime()
    pod = jax_api.Pod(
        metadata=jax_api.ObjectMeta(name="web", namespace="default",
                                    uid="uid-pf"),
        spec=jax_api.PodSpec(node_name="node-1", containers=[
            jax_api.Container(name="app", image="img")]))
    runtime.start_container(pod, pod.spec.containers[0])
    runtime.set_port_address("uid-pf", 80, ("127.0.0.1", echo_port))
    ksrv = KubeletServer("node-1", lambda: [pod], runtime,
                         lambda: {"cpu": jax_quantity("4")}).start()
    registry = Registry()
    _register_node(registry, "node-1", ksrv.port)
    registry.create("pods", cross([pod])[0])
    registry.create("pods", api.Pod(
        metadata=api.ObjectMeta(name="floating", namespace="default"),
        spec=api.PodSpec(containers=[api.Container(name="c", image="i")])))
    server = ApiServer(registry, port=0).start()
    try:
        c = _client(kind, registry, server)
        ws = c.portforward_open("web", "default", 80)
        try:
            wsstream.write_frame(ws.sendall, b"over the relay",
                                 wsstream.BINARY, mask=True)
            assert wsstream.read_frame(ws.recv) == (wsstream.BINARY,
                                                    b"OVER THE RELAY")
        finally:
            ws.close()
        with pytest.raises((ApiError, ConnectionError)):
            c.portforward_open("floating", "default", 80)
    finally:
        server.stop()
        ksrv.stop()


def test_kubelet_base_url_matches_the_jax_kubelet():
    """The relay's own copy of kubelet/server.py kubelet_base_url."""
    from kubernetes_tpu.kubelet.server import kubelet_base_url
    nodes = [jax_api.Node(metadata=jax_api.ObjectMeta(name="a"),
                          status=jax_api.NodeStatus(
                              addresses=addrs,
                              daemon_endpoints=jax_api.NodeDaemonEndpoints(
                                  kubelet_endpoint=jax_api.DaemonEndpoint(
                                      port=port))))
             for addrs in ([], [jax_api.NodeAddress(type="InternalIP",
                                                    address="10.0.0.9")])
             for port in (0, 10250)]
    for jn, pn in zip(nodes, cross(nodes)):
        try:
            want = kubelet_base_url(jn)
        except KeyError as e:
            with pytest.raises(KeyError) as got:
                relay.kubelet_base_url(pn)
            assert str(got.value) == str(e)
        else:
            assert relay.kubelet_base_url(pn) == want


def test_relay_legs_ride_the_tunnel(relay_cluster):
    """With a tunneler's dial set on the server (the master wires it),
    node-proxy GETs, follow-logs and interactive exec go through tunnel
    legs to the kubelet's /tunnel endpoint."""
    registry, server, ksrv = relay_cluster
    t = WsTunneler(sync_interval=0.05, healthy_sleep=0.0, dial_timeout=2.0)
    t.run(lambda: [("node-1", "127.0.0.1", ksrv.port)])
    try:
        deadline = time.time() + 10
        while time.time() < deadline and t.tunnel_count() == 0:
            time.sleep(0.02)
        assert t.tunnel_count() == 1 and t.healthy()
        dialed = []
        server.tunnel_dial = \
            lambda h, p: (dialed.append((h, p)), t.dial(h, p))[1]
        with urllib.request.urlopen(
                server.url + "/api/v1/proxy/nodes/node-1/healthz",
                timeout=10) as resp:
            assert resp.read() == b"ok"
        assert dialed == [("127.0.0.1", ksrv.port)]
        dialed.clear()
        with urllib.request.urlopen(
                server.url + "/api/v1/namespaces/default/pods/cat/log"
                             "?follow=true", timeout=10) as resp:
            got = b""
            end = time.time() + 10
            while b"relay-log" not in got and time.time() < end:
                piece = resp.read1(64)
                if not piece:
                    break
                got += piece
        assert got.startswith(b"relay-log"), got
        assert dialed
        dialed.clear()
        ws = HttpClient(server.url).exec_open("cat", "default", ["cat"],
                                              stdin=True)
        try:
            assert _drive_exec(ws, b"thru tunnel\n") == (b"thru tunnel\n", 0)
        finally:
            ws.close()
        assert dialed
    finally:
        t.stop()


def test_apiserver_takes_a_burst_of_connections():
    """The listening socket's backlog holds a burst: 300 clients that
    connect at once each get their answer (socketserver's default
    backlog of 5 reset some of them)."""
    import http.client
    import threading as _threading
    from kubernetes_tpu_torch.api import server as port_server
    assert port_server._HttpServer.request_queue_size >= 1024
    srv = port_server.ApiServer(Registry(), port=0).start()
    codes, errors = [], []
    go = _threading.Event()

    def one():
        go.wait()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                              timeout=60)
            conn.request("GET", "/healthz")
            codes.append(conn.getresponse().status)
            conn.close()
        except Exception as e:             # counted below
            errors.append(repr(e))
    threads = [_threading.Thread(target=one) for _ in range(300)]
    try:
        for t in threads:
            t.start()
        go.set()
        for t in threads:
            t.join(timeout=120)
    finally:
        srv.stop()
    assert errors == [] and codes == [200] * 300
