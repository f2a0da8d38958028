"""Shared kubelet-relay plumbing: the ApiServer's node proxy and the
in-proc client implement the same relay (resolve the node's daemon
endpoint, fetch, map errors; exec paths pass the CONNECT admission
moment first). One implementation, two mounts."""

from __future__ import annotations

import urllib.error
import urllib.request
from typing import Optional

from ..core.errors import BadGateway, NotFound


def exec_admission(registry, rest_path: str) -> None:
    """Run the CONNECT admission for a kubelet exec relay path
    (`exec/{ns}/{pod}/{container}...`) — DenyExecOnPrivileged's moment
    (ref: plugin/pkg/admission/exec). Non-exec paths are a no-op."""
    segments = [s for s in rest_path.split("?")[0].split("/") if s]
    if segments and segments[0] == "exec" and len(segments) >= 3 \
            and registry.admission is not None:
        registry.admission("CONNECT", "pods/exec", None,
                           segments[1], segments[2])


def fetch_kubelet(url: str, timeout: float = 30.0) -> bytes:
    """GET a kubelet-server URL with the client-side error mapping: 404
    passes through as NotFound, anything else wrong becomes 502."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.read()
    except urllib.error.HTTPError as e:
        if e.code == 404:
            raise NotFound(e.read().decode(errors="replace"))
        raise BadGateway(f"kubelet answered {e.code}")
    except (urllib.error.URLError, OSError) as e:
        raise BadGateway(f"kubelet unreachable: {e}")


def fetch_kubelet_response(url: str, timeout: float = 30.0,
                           method: str = "GET",
                           body: "bytes | None" = None,
                           content_type: str = ""):
    """Any-method verbatim HTTP relay -> (status, content_type, body):
    backend statuses pass through untouched; only transport failures
    become 502 (what the ApiServer proxy forwards). The reference's
    ProxyHandler relays every verb with the request body intact
    (pkg/apiserver/proxy.go:52 ServeHTTP — no method filter)."""
    headers = {}
    if content_type:
        headers["Content-Type"] = content_type
    req = urllib.request.Request(url, data=body, headers=headers,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return (resp.status, resp.headers.get("Content-Type",
                                                  "text/plain"),
                    resp.read())
    except urllib.error.HTTPError as e:
        return e.code, "text/plain", e.read()
    except (urllib.error.URLError, OSError) as e:
        raise BadGateway(f"kubelet unreachable: {e}")


def open_kubelet_stream(url: str, verbatim_errors: bool = False):
    """Open a follow-stream to the kubelet; caller closes.

    verbatim_errors=False (in-proc clients): typed error mapping —
    404 -> NotFound, other HTTP errors -> 502.
    verbatim_errors=True (the ApiServer's HTTP relay): kubelet HTTP
    statuses return as the response object itself (HTTPError doubles as
    one) so the proxy can pass status + body through untouched, exactly
    like its non-follow _relay path. Transport failures are 502 both
    ways."""
    try:
        return urllib.request.urlopen(url, timeout=None)
    except urllib.error.HTTPError as e:
        if verbatim_errors:
            return e
        if e.code == 404:
            raise NotFound(e.read().decode(errors="replace"))
        raise BadGateway(f"kubelet answered {e.code}")
    except (urllib.error.URLError, OSError) as e:
        raise BadGateway(f"kubelet unreachable: {e}")


def iter_http_stream(resp):
    """Yield decoded text pieces from a live HTTP response as they
    arrive (read1: return as soon as ANY data is buffered — a plain
    read(n) would block until n bytes amass, defeating `logs -f`)."""
    try:
        while True:
            data = resp.read1(65536)
            if not data:
                return
            yield data.decode(errors="replace")
    finally:
        resp.close()


def kubelet_base_url(node) -> str:
    """Resolve a node's kubelet server from its registered daemon
    endpoint + first address (the apiserver relay and in-proc clients
    share this).

    The port has no kubelet package: this is its own copy of the JAX
    package's kubelet/server.py kubelet_base_url, kept here until the
    kubelet is ported, when the two are to be reconciled."""
    port = node.status.daemon_endpoints.kubelet_endpoint.port
    if not port:
        raise KeyError(
            f"node {node.metadata.name!r} has no kubelet endpoint "
            f"registered")
    addr = "127.0.0.1"
    for a in node.status.addresses:
        if a.address:
            addr = a.address
            break
    return f"http://{addr}:{port}"


def kubelet_base_for(registry, node_name: str) -> str:
    """Resolve a node's kubelet base URL from the registry, mapping a
    missing endpoint to NotFound."""
    node = registry.get("nodes", node_name)
    try:
        return kubelet_base_url(node)
    except KeyError as e:
        raise NotFound(str(e))


def resolve_pod_container(registry, namespace: str, name: str,
                          container: str = ""):
    """-> (container, kubelet base URL): scheduled-check,
    single-container defaulting, daemon-endpoint lookup. The ONE
    implementation behind the log, attach, and port-forward paths —
    container defaulting must not drift between them."""
    from ..core.errors import BadRequest

    pod = registry.get("pods", name, namespace)
    if not pod.spec.node_name:
        raise BadRequest(f"pod {name!r} is not scheduled yet")
    if not container:
        if len(pod.spec.containers) > 1:
            raise BadRequest(
                f"pod {name!r} has several containers; name one")
        container = pod.spec.containers[0].name
    return container, kubelet_base_for(registry, pod.spec.node_name)


def container_log_url(registry, namespace: str, name: str,
                      container: str = "", query: str = "") -> str:
    """Resolve a pod's kubelet containerLogs URL (see
    resolve_pod_container).

    query: pre-encoded query string without the '?' (e.g. 'follow=true')."""
    container, base = resolve_pod_container(registry, namespace, name,
                                            container)
    url = f"{base}/containerLogs/{namespace}/{name}/{container}"
    return url + (f"?{query}" if query else "")
