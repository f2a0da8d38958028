"""Clients: one interface, in-process and HTTP transports.

Reference: pkg/client/unversioned (fluent REST client, request.go). Agents,
controllers and the scheduler are written against `Client`; the kubemark-style
in-process harness wires them straight to the Registry (zero serialization),
while real deployments go over HTTP with identical semantics — mirroring how
the reference's integration tests wire components directly to an in-process
master (test/integration/framework/master_utils.go:92).

`HttpClient` speaks the JAX package's wire format, so either package's
client talks to either package's `ApiServer`. The kubelet relay verbs
(logs, exec, attach, port-forward) go through `api/relay.py`, which
reaches a node's kubelet over HTTP and websocket only.
"""

from __future__ import annotations

import http.client
import json
import logging
import socket
import threading
import urllib.parse
import urllib.request
from typing import Any, Iterator, List, Optional, Tuple

from .. import obs
from ..core import types as api
from ..core.errors import (ApiError, BadGateway, BadRequest, NotFound,
                           from_status)
from ..core.scheme import Scheme, default_scheme
from ..core.watch import Event, Watcher
from .registry import Registry
from .retry import RetryPolicy

logger = logging.getLogger("kubernetes_tpu_torch.client")


class Client:
    """Verb interface over resources. Implementations: InProcClient,
    HttpClient."""

    def create(self, resource: str, obj: Any, namespace: str = "") -> Any:
        raise NotImplementedError

    def create_batch(self, resource: str, objs: List[Any],
                     namespace: str = "") -> List[Any]:
        """Create many objects of one resource in a single apiserver
        round-trip / store window (the write-side analogue of
        bind_batch). Default: sequential creates."""
        return [self.create(resource, o, namespace) for o in objs]

    def create_from_template(self, resource: str, template: Any,
                             names: List[str], namespace: str = ""
                             ) -> List[Any]:
        """Columnar bulk create: one template object, many names
        (registry.create_from_template). Default: expand client-side
        into a create_batch — any Client gets the semantics, the
        in-proc registry gets the fast path."""
        from ..core.types import expand_template_rows
        return self.create_batch(resource,
                                 expand_template_rows(template, names),
                                 namespace)

    def get(self, resource: str, name: str, namespace: str = "") -> Any:
        raise NotImplementedError

    def list(self, resource: str, namespace: str = "",
             label_selector: str = "", field_selector: str = ""
             ) -> Tuple[List[Any], int]:
        raise NotImplementedError

    def update(self, resource: str, obj: Any, namespace: str = "") -> Any:
        raise NotImplementedError

    def update_status(self, resource: str, obj: Any, namespace: str = "") -> Any:
        raise NotImplementedError

    def patch(self, resource: str, name: str, patch_body: Any,
              namespace: str = "",
              patch_type: str = "application/strategic-merge-patch+json"
              ) -> Any:
        """Server-side PATCH with the reference's three content types
        (ref: client/unversioned request.go Patch)."""
        raise NotImplementedError

    def get_scale(self, resource: str, name: str,
                  namespace: str = "") -> Any:
        """GET .../{name}/scale (ref: client/unversioned Scales getter)."""
        raise NotImplementedError

    def update_scale(self, resource: str, name: str, scale: Any,
                     namespace: str = "") -> Any:
        raise NotImplementedError

    def update_status_batch(self, resource: str, objs: List[Any],
                            namespace: str = "") -> List[Any]:
        # Default: sequential (the reference wire protocol has no status
        # batching; the in-proc client overrides with one store pass).
        return [self.update_status(resource, o, namespace) for o in objs]

    def delete(self, resource: str, name: str, namespace: str = "",
               grace_period_seconds: Optional[int] = None,
               uid: Optional[str] = None) -> Any:
        raise NotImplementedError

    def watch(self, resource: str, namespace: str = "",
              since_rev: Optional[int] = None, label_selector: str = "",
              field_selector: str = "") -> Watcher:
        raise NotImplementedError

    def bind(self, binding: api.Binding, namespace: str = "") -> Any:
        raise NotImplementedError

    def bind_batch(self, bindings: List[api.Binding],
                   namespace: str = "") -> List[Any]:
        # Default: sequential binds (HTTP transport can't batch in the
        # reference wire protocol; the in-proc client overrides this).
        return [self.bind(b, namespace) for b in bindings]

    def bind_batch_hosts(self, assignments: List[Tuple[str, str, str]]
                         ) -> List[Any]:
        """Columnar bind: (namespace, name, host) rows. Default:
        expand into Binding objects; the in-proc client hands the rows
        straight to the registry."""
        return self.bind_batch([api.Binding(
            metadata=api.ObjectMeta(namespace=ns, name=name),
            target=api.ObjectReference(kind="Node", name=host))
            for ns, name, host in assignments])

    def finalize_namespace(self, obj: api.Namespace) -> Any:
        raise NotImplementedError

    def pod_logs(self, name: str, namespace: str = "default",
                 container: str = "", tail_lines: int = 0,
                 previous: bool = False) -> str:
        """Container logs via the pod `log` subresource (the apiserver
        relays to the node's kubelet server)."""
        raise NotImplementedError

    def node_proxy(self, node_name: str, path: str) -> bytes:
        """GET a kubelet-server path through the node proxy."""
        raise NotImplementedError

    def pod_logs_stream(self, name: str, namespace: str = "default",
                        container: str = ""):
        """Follow a container's log (kubectl logs -f): yields text
        pieces until the container exits or the caller stops."""
        raise NotImplementedError


class InProcClient(Client):
    def __init__(self, registry: Registry):
        self.registry = registry

    def create(self, resource, obj, namespace=""):
        return self.registry.create(resource, obj, namespace)

    def create_batch(self, resource, objs, namespace=""):
        return self.registry.create_batch(resource, objs, namespace)

    def create_from_template(self, resource, template, names, namespace=""):
        return self.registry.create_from_template(resource, template,
                                                  names, namespace)

    def get(self, resource, name, namespace=""):
        return self.registry.get(resource, name, namespace)

    def list(self, resource, namespace="", label_selector="", field_selector=""):
        return self.registry.list(resource, namespace, label_selector,
                                  field_selector)

    def update(self, resource, obj, namespace=""):
        return self.registry.update(resource, obj, namespace)

    def update_status(self, resource, obj, namespace=""):
        return self.registry.update_status(resource, obj, namespace)

    def update_status_batch(self, resource, objs, namespace=""):
        return self.registry.update_status_batch(resource, objs, namespace)

    def patch(self, resource, name, patch_body, namespace="",
              patch_type="application/strategic-merge-patch+json"):
        return self.registry.patch(resource, name, patch_body, namespace,
                                   patch_type=patch_type)

    def get_scale(self, resource, name, namespace=""):
        return self.registry.get_scale(resource, name, namespace)

    def update_scale(self, resource, name, scale, namespace=""):
        return self.registry.update_scale(resource, name, scale, namespace)

    def delete(self, resource, name, namespace="",
               grace_period_seconds=None, uid=None):
        return self.registry.delete(
            resource, name, namespace,
            grace_period_seconds=grace_period_seconds, uid=uid)

    def watch(self, resource, namespace="", since_rev=None,
              label_selector="", field_selector=""):
        return self.registry.watch(resource, namespace, since_rev,
                                   label_selector, field_selector)

    def bind(self, binding, namespace=""):
        return self.registry.bind(binding, namespace)

    def bind_batch(self, bindings, namespace=""):
        return self.registry.bind_batch(bindings, namespace)

    def bind_batch_hosts(self, assignments):
        return self.registry.bind_batch_hosts(assignments)

    def pod_logs(self, name, namespace="default", container="",
                 tail_lines=0, previous=False):
        # even in-proc, the kubelet is across the network: resolve the
        # node's daemon endpoint and fetch (same relay ApiServer does)
        from .relay import container_log_url, fetch_kubelet
        params = []
        if tail_lines:
            params.append(f"tailLines={tail_lines}")
        if previous:
            params.append("previous=true")
        url = container_log_url(
            self.registry, namespace, name, container, "&".join(params))
        return fetch_kubelet(url).decode()

    def node_proxy(self, node_name, path):
        # in-proc: the same relay ApiServer performs, incl. the exec
        # CONNECT admission moment
        from .relay import exec_admission, fetch_kubelet, kubelet_base_for
        exec_admission(self.registry, path)
        base = kubelet_base_for(self.registry, node_name)
        return fetch_kubelet(f"{base}/{path}")

    def portforward_open(self, name, namespace, port):
        """-> an upgraded websocket socket carrying the pod's TCP port
        as binary frames. In-proc skips the apiserver leg and dials the
        kubelet directly (same frames either way)."""
        import urllib.parse as up
        from ..utils import wsstream
        from .relay import kubelet_base_for
        pod = self.registry.get("pods", name, namespace)
        if not pod.spec.node_name:
            raise BadRequest(f"pod {name!r} is not scheduled yet")
        base = kubelet_base_for(self.registry, pod.spec.node_name)
        split = up.urlsplit(base)
        return wsstream.client_connect(
            split.hostname, split.port,
            f"/portForward/{namespace}/{name}?port={port}")

    def attach_open(self, name, namespace, container="", stdin=False):
        """-> an upgraded websocket: the container's live output as
        binary frames (and stdin upstream when asked). In-proc dials
        the kubelet directly."""
        import urllib.parse as up
        from ..utils import wsstream
        from .relay import resolve_pod_container
        container, base = resolve_pod_container(self.registry, namespace,
                                                name, container)
        split = up.urlsplit(base)
        q = "?stdin=true" if stdin else ""
        return wsstream.client_connect(
            split.hostname, split.port,
            f"/attach/{namespace}/{name}/{container}{q}")

    def exec_open(self, name, namespace, cmd, container="", stdin=False):
        """-> an upgraded websocket for INTERACTIVE exec: output as
        binary frames, stdin upstream, a final TEXT {"exitCode": N}
        frame before CLOSE. In-proc dials the kubelet directly."""
        import urllib.parse as up
        from ..utils import wsstream
        from .relay import resolve_pod_container
        container, base = resolve_pod_container(self.registry, namespace,
                                                name, container)
        split = up.urlsplit(base)
        params = [("command", c) for c in cmd]
        if stdin:
            params.append(("stdin", "true"))
        q = "?" + up.urlencode(params)
        return wsstream.client_connect(
            split.hostname, split.port,
            f"/exec/{namespace}/{name}/{container}{q}")

    def pod_logs_stream(self, name, namespace="default", container=""):
        from .relay import (container_log_url, iter_http_stream,
                            open_kubelet_stream)
        url = container_log_url(self.registry, namespace, name, container,
                                "follow=true")
        return iter_http_stream(open_kubelet_stream(url))

    def finalize_namespace(self, obj):
        return self.registry.finalize_namespace(obj)


class _HttpWatcher(Watcher):
    """Adapts a chunked HTTP watch stream to the Watcher interface by
    pumping parsed events from a reader thread. Holds the raw connection so
    stop() can shutdown() the socket — closing the buffered response instead
    would block on the reader's buffer lock until the next heartbeat."""

    def __init__(self, conn, resp, scheme: Scheme, capacity: int = 100_000):
        super().__init__(capacity)
        self._conn = conn
        self._resp = resp
        self._scheme = scheme
        #: True when the stream died mid-flight (not a clean server end
        #: or a deliberate stop()) — Reflector logs the reconnect and
        #: backs off instead of treating it as a clean stop
        self.failed = False
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _pump(self):
        err: Optional[Exception] = None
        try:
            for raw in self._resp:
                line = raw.strip()
                if not line:
                    continue
                data = json.loads(line)
                obj = data["object"]
                if data["type"] == "ERROR":
                    self.send(Event("ERROR", from_status(obj)))
                    break
                self.send(Event(data["type"],
                                self._scheme.decode_watched(obj)))
        except Exception as e:
            # a deliberate stop() shuts the socket down under the
            # reader — that is a clean stop, not a stream failure
            if not self.stopped:
                err = e
        finally:
            if err is not None:
                self.failed = True
                self.send(Event("ERROR", ApiError(
                    f"watch stream disconnected: {err!r}")))
            self.stop()

    def stop(self):
        try:
            if self._conn.sock is not None:
                self._conn.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._conn.close()
        except Exception:
            pass
        super().stop()


class HttpClient(Client):
    def __init__(self, base_url: str, scheme: Scheme = default_scheme,
                 timeout: float = 30.0,
                 headers: Optional[dict] = None,
                 ssl_context=None,
                 retry: Optional[RetryPolicy] = None):
        """headers: sent with every request (Authorization etc. — the
        kubeconfig credential role). ssl_context: for https servers —
        CA trust plus an optional client certificate
        (ssl.SSLContext.load_cert_chain), the x509 credential role.
        retry: the resilience policy (api.retry.RetryPolicy) — None
        picks the default (idempotency-aware retries + breaker); pass
        RetryPolicy.disabled() for raw single-shot requests."""
        self.base_url = base_url.rstrip("/")
        self.scheme = scheme
        self.timeout = timeout
        self.headers = dict(headers or {})
        self.ssl_context = ssl_context
        self.retry = retry if retry is not None else RetryPolicy()
        self._breaker = self.retry.make_breaker()

    # ------------------------------------------------------------ plumbing

    def _url(self, resource: str, namespace: str = "", name: str = "",
             sub: str = "", query: Optional[dict] = None) -> str:
        from .registry import EXTENSIONS_RESOURCES
        info = Registry.info(resource)
        group = ("apis/extensions/v1beta1"
                 if resource in EXTENSIONS_RESOURCES else "api/v1")
        parts = [self.base_url, group]
        if info.namespaced and namespace:
            parts += ["namespaces", namespace]
        parts.append(resource)
        if name:
            parts.append(name)
        if sub:
            parts.append(sub)
        url = "/".join(parts)
        if query:
            url += "?" + urllib.parse.urlencode(
                {k: v for k, v in query.items() if v})
        return url

    def _do(self, method: str, url: str, body: Any = None,
            stream: bool = False, raw_body: Optional[bytes] = None,
            content_type: str = "application/json",
            idempotent: Optional[bool] = None):
        """One REST request under the retry policy. idempotent: None
        defaults to method == GET; verb methods pass True when the
        request carries its own replay guard (uid precondition, CAS
        resourceVersion). Streams bypass retry — their consumers
        (Reflector, log followers) own reconnection.

        Tracing: one root span per logical request; every retry
        attempt is a sibling child span carrying its OWN traceparent
        (fresh span id, shared trace id), so the server's spans show
        which attempt committed and which were lost."""
        tr = obs.tracer()
        if stream:
            ctx = obs.current()
            return self._do_once(
                method, url, body, stream, raw_body, content_type,
                traceparent=obs.format_traceparent(ctx) if ctx else None)
        if idempotent is None:
            idempotent = method in ("GET", "HEAD")
        if not tr.enabled:
            return self.retry.call(
                lambda: self._do_once(method, url, body, False, raw_body,
                                      content_type),
                idempotent=idempotent, breaker=self._breaker,
                probe=self._probe_healthz)
        root = tr.start_span(
            f"http {method}", parent=obs.current(),
            attrs={"path": urllib.parse.urlsplit(url).path})

        def attempt():
            span = tr.start_span(f"http {method} attempt", parent=root)
            try:
                resp = self._do_once(
                    method, url, body, False, raw_body, content_type,
                    traceparent=obs.format_traceparent(span))
            except BaseException:
                tr.end(span, status="error")
                raise
            tr.end(span)
            return resp

        try:
            result = self.retry.call(
                attempt, idempotent=idempotent, breaker=self._breaker,
                probe=self._probe_healthz)
        except BaseException:
            tr.end(root, status="error")
            raise
        tr.end(root)
        return result

    def _probe_healthz(self) -> bool:
        """The breaker's recovery probe: one cheap unretried GET."""
        try:
            resp = urllib.request.urlopen(
                self.base_url + "/healthz", timeout=2.0,
                context=self.ssl_context)
            ok = resp.status == 200
            resp.close()
            return ok
        except Exception:
            return False

    def _do_once(self, method: str, url: str, body: Any = None,
                 stream: bool = False, raw_body: Optional[bytes] = None,
                 content_type: str = "application/json",
                 traceparent: Optional[str] = None):
        data = raw_body
        headers = {"Accept": "application/json", **self.headers}
        if traceparent:
            headers["traceparent"] = traceparent
        if body is not None:
            data = self.scheme.encode(body).encode()
        if data is not None:
            headers["Content-Type"] = content_type
        req = urllib.request.Request(url, data=data, headers=headers,
                                     method=method)
        try:
            resp = urllib.request.urlopen(
                req, timeout=None if stream else self.timeout,
                context=self.ssl_context)
        except urllib.error.HTTPError as e:
            retry_after = e.headers.get("Retry-After") if e.headers \
                else None
            try:
                status = json.loads(e.read().decode())
            except Exception:
                err = ApiError(f"HTTP {e.code} from {url}")
            else:
                err = from_status(status)
            if retry_after:
                try:
                    err.retry_after = float(retry_after)
                except ValueError:
                    pass
            raise err
        if stream:
            return resp
        payload = resp.read().decode()
        resp.close()
        return json.loads(payload) if payload else None

    def _decode(self, data: dict) -> Any:
        return self.scheme.decode_dict(data)

    # --------------------------------------------------------------- verbs

    def create(self, resource, obj, namespace=""):
        ns = namespace or getattr(obj.metadata, "namespace", "") or "default"
        return self._decode(self._do("POST", self._url(resource, ns), obj))

    def create_batch(self, resource, objs, namespace=""):
        """POST a JSON array: one batched store window server-side.
        Objects are grouped by namespace (the URL names one namespace;
        a mixed-namespace batch becomes one POST per namespace, same
        result order as the input)."""
        if not objs:
            return []
        groups: dict = {}
        for i, o in enumerate(objs):
            ns = (namespace or getattr(o.metadata, "namespace", "")
                  or "default")
            groups.setdefault(ns, []).append((i, o))
        out = [None] * len(objs)
        for ns, members in groups.items():
            payload = json.dumps(
                [self.scheme.encode_dict(o) for _i, o in members]).encode()
            data = self._do("POST", self._url(resource, ns),
                            raw_body=payload)
            kind = data["kind"][:-4] if data["kind"].endswith("List") \
                else data["kind"]
            for (i, _o), item in zip(members, data["items"]):
                out[i] = self._decode({**item, "kind": kind})
        return out

    def get(self, resource, name, namespace=""):
        ns = namespace or "default"
        return self._decode(self._do("GET", self._url(resource, ns, name)))

    def list(self, resource, namespace="", label_selector="", field_selector=""):
        data = self._do("GET", self._url(resource, namespace, query={
            "labelSelector": label_selector, "fieldSelector": field_selector}))
        items = [self._decode({**i, "kind": data["kind"][:-4]})
                 for i in data["items"]]
        rev = int(data["metadata"].get("resourceVersion") or 0)
        return items, rev

    @staticmethod
    def _has_rv(obj) -> bool:
        """A PUT carrying a resourceVersion is CAS — replaying it after
        an ambiguous connection loss surfaces as Conflict, never as a
        silent double-commit, so it is safe to retry."""
        meta = getattr(obj, "metadata", None)
        return bool(getattr(meta, "resource_version", ""))

    def update(self, resource, obj, namespace=""):
        ns = namespace or obj.metadata.namespace
        return self._decode(self._do(
            "PUT", self._url(resource, ns, obj.metadata.name), obj,
            idempotent=self._has_rv(obj)))

    def update_status(self, resource, obj, namespace=""):
        ns = namespace or obj.metadata.namespace
        return self._decode(self._do(
            "PUT", self._url(resource, ns, obj.metadata.name, "status"), obj,
            idempotent=self._has_rv(obj)))

    def patch(self, resource, name, patch_body, namespace="",
              patch_type="application/strategic-merge-patch+json"):
        ns = namespace or "default"
        raw = json.dumps(patch_body).encode()
        return self._decode(self._do(
            "PATCH", self._url(resource, ns, name), raw_body=raw,
            content_type=patch_type))

    def get_scale(self, resource, name, namespace=""):
        ns = namespace or "default"
        return self._decode(self._do(
            "GET", self._url(resource, ns, name, "scale")))

    def update_scale(self, resource, name, scale, namespace=""):
        ns = namespace or "default"
        return self._decode(self._do(
            "PUT", self._url(resource, ns, name, "scale"), scale,
            idempotent=self._has_rv(scale)))

    def delete(self, resource, name, namespace="",
               grace_period_seconds=None, uid=None):
        ns = namespace or "default"
        body = None
        if grace_period_seconds is not None or uid:
            body = api.DeleteOptions(
                grace_period_seconds=grace_period_seconds,
                preconditions=api.Preconditions(uid=uid) if uid else None)
        # uid precondition makes a replay unambiguous: the same object
        # deletes once, a replacement answers Conflict, a completed
        # delete answers NotFound — all terminal signals for callers
        return self._decode(self._do(
            "DELETE", self._url(resource, ns, name), body,
            idempotent=bool(uid)))

    def _ws_connect(self, path: str):
        """Upgrade a websocket to the apiserver carrying this client's
        credentials and TLS posture (the same posture every other
        request gets from _do) — the one place the scheme/port/ssl
        defaulting lives for upgraded streams."""
        import urllib.parse as up
        from ..utils import wsstream
        split = up.urlsplit(self.base_url)
        port_num = split.port or (443 if split.scheme == "https" else 80)
        ctx = None
        if split.scheme == "https":
            import ssl as _ssl
            ctx = self.ssl_context or _ssl.create_default_context()
        return wsstream.client_connect(split.hostname, port_num, path,
                                       headers=self.headers,
                                       ssl_context=ctx)

    def portforward_open(self, name, namespace, port):
        """-> an upgraded websocket socket through the apiserver's
        portforward relay (the remote-kubectl leg)."""
        ns = namespace or "default"
        return self._ws_connect(
            f"/api/v1/namespaces/{ns}/pods/{name}/portforward"
            f"?port={port}")

    def attach_open(self, name, namespace, container="", stdin=False):
        """-> an upgraded websocket through the apiserver's attach
        relay."""
        import urllib.parse as up
        ns = namespace or "default"
        params = {}
        if container:
            params["container"] = container
        if stdin:
            params["stdin"] = "true"
        q = ("?" + up.urlencode(params)) if params else ""
        return self._ws_connect(
            f"/api/v1/namespaces/{ns}/pods/{name}/attach{q}")

    def exec_open(self, name, namespace, cmd, container="", stdin=False):
        """-> an upgraded websocket through the apiserver's exec
        relay (interactive exec; the one-shot path stays node_proxy)."""
        import urllib.parse as up
        ns = namespace or "default"
        params = [("command", c) for c in cmd]
        if container:
            params.append(("container", container))
        if stdin:
            params.append(("stdin", "true"))
        return self._ws_connect(
            f"/api/v1/namespaces/{ns}/pods/{name}/exec?"
            + up.urlencode(params))

    def watch(self, resource, namespace="", since_rev=None,
              label_selector="", field_selector=""):
        url = self._url(resource, namespace, query={
            "watch": "true",
            "labelSelector": label_selector,
            "fieldSelector": field_selector,
            "resourceVersion": "" if since_rev is None else str(since_rev)})
        split = urllib.parse.urlsplit(url)
        if split.scheme == "https":
            conn = http.client.HTTPSConnection(split.hostname, split.port,
                                               context=self.ssl_context)
        else:
            conn = http.client.HTTPConnection(split.hostname, split.port)
        path = split.path + ("?" + split.query if split.query else "")
        watch_headers = {"Accept": "application/json", **self.headers}
        ctx = obs.current()
        if ctx is not None:
            watch_headers["traceparent"] = obs.format_traceparent(ctx)
        conn.request("GET", path, headers=watch_headers)
        resp = conn.getresponse()
        if resp.status != 200:
            body = resp.read().decode()
            conn.close()
            try:
                raise from_status(json.loads(body))
            except json.JSONDecodeError:
                raise ApiError(f"HTTP {resp.status} from {url}")
        return _HttpWatcher(conn, resp, self.scheme)

    def bind(self, binding, namespace=""):
        ns = namespace or binding.metadata.namespace or "default"
        return self._decode(self._do(
            "POST", self._url("bindings", ns), binding))

    def finalize_namespace(self, obj):
        return self._decode(self._do(
            "PUT", self._url("namespaces", "", obj.metadata.name,
                             "finalize"), obj,
            idempotent=self._has_rv(obj)))

    def bind_batch(self, bindings, namespace=""):
        """POST a JSON array to the bindings resource: one batched store
        commit server-side (all-or-nothing; each binding carries its own
        namespace)."""
        if not bindings:
            return []
        payload = json.dumps(
            [self.scheme.encode_dict(b) for b in bindings]).encode()
        data = self._do("POST", self._url("bindings", namespace),
                        raw_body=payload)
        return [self._decode({**i, "kind": "Pod"}) for i in data["items"]]

    def pod_logs(self, name, namespace="default", container="",
                 tail_lines=0, previous=False):
        query = {"container": container}
        if tail_lines:
            query["tailLines"] = str(tail_lines)
        if previous:
            query["previous"] = "true"
        url = self._url("pods", namespace, name, "log", query)
        resp = self._do("GET", url, stream=True)
        try:
            return resp.read().decode()
        finally:
            resp.close()

    def pod_logs_stream(self, name, namespace="default", container=""):
        from .relay import iter_http_stream
        url = self._url("pods", namespace, name, "log",
                        {"container": container, "follow": "true"})
        return iter_http_stream(self._do("GET", url, stream=True))

    def node_proxy(self, node_name: str, path: str) -> bytes:
        """GET through the apiserver's node proxy
        (/api/v1/proxy/nodes/{name}/{path})."""
        url = f"{self.base_url}/api/v1/proxy/nodes/{node_name}/{path}"
        resp = self._do("GET", url, stream=True)
        try:
            return resp.read()
        finally:
            resp.close()


def confirm_pod_deletion(client: Client, pod: Any, attempts: int = 8,
                         backoff_s: float = 0.5,
                         clock=None, rng=None) -> None:
    """The grace-0, uid-guarded delete that completes a graceful pod
    deletion from the node side (real kubelet, hollow kubelet, fleet).
    NotFound/Conflict are terminal — the pod is gone, or a same-name
    replacement took the name; transient API errors retry off-thread
    with jittered backoff, because a marked pod emits no further watch
    events and a dropped confirm would leave it Terminating forever.
    Exhaustion is loud: the pod will sit Terminating until something
    else (a fleet/kubelet restart's re-list) re-drives it, so the
    operator must hear about it.

    clock (utils/clock.Clock) and rng (random.Random) are injectable
    for deterministic harnesses; the defaults are the real clock and
    the process RNG."""
    import random as _random

    from ..core.errors import Conflict, NotFound
    from ..utils.clock import REAL

    clock = clock or REAL
    rng = rng or _random

    def attempt() -> bool:
        try:
            client.delete("pods", pod.metadata.name,
                          pod.metadata.namespace,
                          grace_period_seconds=0, uid=pod.metadata.uid)
        except (NotFound, Conflict):
            pass  # outcome reached (gone or replaced)
        except Exception:
            return False
        return True

    if attempt():
        return

    def retry_loop():
        delay = backoff_s
        for _ in range(attempts - 1):
            # jittered: a fleet confirming thousands of pods against a
            # restarting apiserver must not replay them in one wave
            clock.sleep(delay * (0.5 + rng.random()))
            if attempt():
                return
            delay = min(delay * 2, 5.0)
        logger.warning(
            "confirm_pod_deletion: giving up on %s/%s after %d "
            "attempts; pod stays Terminating until a re-list re-drives "
            "the confirm", pod.metadata.namespace, pod.metadata.name,
            attempts)

    threading.Thread(target=retry_loop, daemon=True,
                     name=f"confirm-del-{pod.metadata.name}").start()
