"""The API server: REST + watch streaming over the registry.

Reference: pkg/apiserver (route install api_installer.go:64, REST dispatch
resthandler.go, watch-over-HTTP watch.go:81, MaxInFlightLimit handlers.go:76)
composed by pkg/master/master.go:279. Routes:

    GET    /healthz | /metrics | /api | /api/v1
    GET    /api/v1/{resource}                      (cluster-scoped or all-ns)
    GET    /api/v1/namespaces/{ns}/{resource}      [?labelSelector=&fieldSelector=
                                                    &watch=true&resourceVersion=]
    POST   /api/v1[/namespaces/{ns}]/{resource}
    GET    /api/v1[/namespaces/{ns}]/{resource}/{name}
    PUT    /api/v1[/namespaces/{ns}]/{resource}/{name}[/status]
    DELETE /api/v1[/namespaces/{ns}]/{resource}/{name}
    POST   /api/v1/namespaces/{ns}/bindings        (pod binding subresource)
    POST   /api/v1/namespaces/{ns}/pods/{name}/binding

Watch responses stream one JSON object per line:
    {"type": "ADDED|MODIFIED|DELETED|ERROR", "object": {...}}
matching the reference's watch/json wire format (pkg/watch/json).
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional, Tuple

from .. import obs
from ..auth.authenticate import authenticate_request
from ..auth.authorize import AuthorizerAttributes
from ..core.errors import (ApiError, BadGateway, BadRequest, Forbidden,
                           MethodNotSupported, NotFound, ServiceUnavailable,
                           TooManyRequests, Unauthorized)
from ..core import types as api_types
from ..core.scheme import Scheme, default_scheme
from ..utils.metrics import (APISERVER_WORKER_REQUESTS, MetricsRegistry,
                             global_metrics)
from .registry import RESOURCES, Registry

WATCH_HEARTBEAT_SECONDS = 30.0

# /api/v1/proxy/nodes/{name}/exec/... — the relayed kubelet exec surface
_EXEC_PROXY_RE = re.compile(r"/proxy/nodes/[^/]+/exec(/|$)")
# pods/{name}/portforward and /attach — a GET in transport, a raw
# channel into the pod in effect (the reference requires the create
# verb on both subresources)
_PORTFORWARD_RE = re.compile(r"/pods/[^/]+/(portforward|attach|exec)$")


def _authz_target(path: str):
    """(resource, namespace) for authorization attributes; non-API paths
    authorize against resource ""."""
    parts = [p for p in path.split("/") if p]
    if len(parts) >= 3 and parts[0] == "apis":
        parts = parts[3:]
    elif len(parts) >= 3 and parts[0] == "api":
        parts = parts[2:]
    else:
        return "", ""
    if not parts:
        return "", ""  # bare group discovery (/apis/extensions/v1beta1)
    if parts[0] == "watch":
        parts = parts[1:]
    if (parts and parts[0] == "proxy" and len(parts) >= 4
            and parts[1] == "namespaces"):
        # a namespaced proxy request authorizes against the proxied
        # resource IN its namespace — an unscoped 'proxy' grant must
        # not reach every namespace, and a namespace-confined policy
        # must cover its own pods/services proxying
        return parts[3], parts[2]
    if parts and parts[0] == "namespaces" and len(parts) >= 3 \
            and parts[2] not in ("status", "finalize"):
        return parts[2], parts[1]
    if parts and parts[0] == "namespaces":
        # the namespaces resource itself, incl. its own subresources
        # (same carve-out the router applies)
        return "namespaces", ""
    if parts:
        return parts[0], ""
    return "", ""


class _HttpServer(ThreadingHTTPServer):
    """The listening socket's backlog: socketserver's default of 5 resets
    the connections that arrive while five wait to be accepted (a
    replication manager's burst of creates, every client opening a
    connection a request), and the client's breaker then counts each
    reset as the server being down. The reference's Go listener takes
    the system's limit (net.core.somaxconn)."""
    request_queue_size = 4096


class ApiServer:
    def __init__(self, registry: Registry, host: str = "127.0.0.1",
                 port: int = 0, max_in_flight: int = 400,
                 scheme: Scheme = default_scheme,
                 metrics: Optional[MetricsRegistry] = None,
                 authenticator=None, authorizer=None, request_log=None,
                 tls_cert_file: str = "", tls_key_file: str = "",
                 tls_client_ca_file: str = "",
                 runtime_config: Optional[dict] = None,
                 shed_retry_after: float = 1.0,
                 worker_index: int = 0, fanout_shard=None):
        """tls_cert_file/tls_key_file: serve HTTPS (the reference's
        --tls-cert-file/--tls-private-key-file secure port).
        tls_client_ca_file: additionally request client certificates
        verified against this CA (--client-ca-file); the verified peer
        subject reaches authenticators as the X-Peer-Certificate
        pseudo-header (auth.X509Authenticator consumes it).

        runtime_config: the reference's --runtime-config ConfigurationMap
        (cmd/kube-apiserver/app/server.go:244, parsed :427
        parseRuntimeConfig): `api/v1=false` and
        `apis/extensions/v1beta1=false` disable a whole group-version,
        `apis/extensions/v1beta1/<resource>=false` one extensions
        resource; `api/all=false` turns every version off except those
        explicitly re-enabled. Disabled surfaces 404 and vanish from
        discovery. `api/legacy` is accepted (no pre-v1 wire versions
        exist here to govern).

        worker_index/fanout_shard: Fleet serving (ApiServerPool). The
        shard is this worker's delivery partition over the shared
        store's publish ring — watches served by this worker register
        on it and are pumped by its drain thread, so delivery work is
        split across workers instead of queuing behind one publisher.
        fanout_shard=None keeps the classic single-plane behavior
        (watches ride the store's committer-drained default shard)."""
        self.registry = registry
        self.worker_index = worker_index
        self._shard = fanout_shard
        rc = dict(runtime_config or {})
        all_default = rc.get("api/all", True)
        self._v1_enabled = rc.get("api/v1", all_default)
        self._ext_enabled = rc.get("apis/extensions/v1beta1", all_default)
        prefix = "apis/extensions/v1beta1/"
        self._disabled_resources = {
            k[len(prefix):] for k, v in rc.items()
            if k.startswith(prefix) and not v}
        self._rc_gating = (not self._v1_enabled or not self._ext_enabled
                           or bool(self._disabled_resources))
        self.scheme = scheme
        self.metrics = metrics or global_metrics
        # ref: --max-requests-inflight (cmd/kube-apiserver/app/server.go),
        # MaxInFlightLimit pkg/apiserver/handlers.go:76
        self._inflight = threading.BoundedSemaphore(max_in_flight)
        # the backpressure hint shed 429s carry (Retry-After seconds);
        # the retrying client treats it as a backoff floor
        self.shed_retry_after = shed_retry_after
        # (resource, ns, selectors) -> (segment write version, response
        # bytes): whole-LIST responses reused verbatim between writes
        # to that resource (the watch cache's LIST half at the byte
        # tier; see the GET list handler)
        self._list_bytes_cache: dict = {}
        self.authenticator = authenticator
        self.authorizer = authorizer
        self.request_log = request_log
        self._tls = bool(tls_cert_file)

        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet; httplog is opt-in
                if server.request_log:
                    server.request_log(fmt % args)

            def do_GET(self):
                server.handle(self, "GET")

            def do_POST(self):
                server.handle(self, "POST")

            def do_PUT(self):
                server.handle(self, "PUT")

            def do_DELETE(self):
                server.handle(self, "DELETE")

            def do_PATCH(self):
                # resource PATCH (three patch content types,
                # resthandler.go patchResource) and the any-method
                # proxy relay (pkg/apiserver/proxy.go:52)
                server.handle(self, "PATCH")

        self.httpd = _HttpServer((host, port), Handler)
        self.httpd.daemon_threads = True
        if self._tls:
            import ssl
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert_file, tls_key_file or None)
            if tls_client_ca_file:
                ctx.load_verify_locations(tls_client_ca_file)
                # request-but-don't-require: unauthenticated clients may
                # still basic-auth/token-auth; presented certs must chain
                # to the CA (ref: --client-ca-file x509 request auth)
                ctx.verify_mode = ssl.CERT_OPTIONAL
            # Handshake in the per-connection thread, NOT on the listening
            # socket: wrapping the listener would run the (blocking,
            # unbounded) handshake inside the single accept loop, letting
            # one silent TCP client park the whole control plane.
            # ThreadingMixIn calls finish_request from the spawned thread.
            httpd = self.httpd
            orig_finish = httpd.finish_request

            def finish_request(request, client_address):
                request.settimeout(10)  # bound the handshake
                try:
                    tls_conn = ctx.wrap_socket(request, server_side=True)
                except (ssl.SSLError, OSError, TimeoutError):
                    try:
                        request.close()
                    except OSError:
                        pass
                    return
                tls_conn.settimeout(None)  # watches stream indefinitely
                orig_finish(tls_conn, client_address)

            httpd.finish_request = finish_request
        self.port = self.httpd.server_address[1]
        self.host = host
        self._thread: Optional[threading.Thread] = None
        # live watch streams, so stop() can end them: a stopped server
        # must behave like a killed one — shutting only the accept loop
        # would leave established watch handler threads streaming from
        # the in-process registry forever, and clients would never
        # notice the "crash" (the fault tier restarts servers in-proc)
        self._live_watchers: set = set()
        self._watchers_lock = threading.Lock()

    # ------------------------------------------------------------ lifecycle

    @property
    def url(self) -> str:
        scheme = "https" if self._tls else "http"
        return f"{scheme}://{self.host}:{self.port}"

    def start(self) -> "ApiServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True,
            name=f"apiserver-{self.worker_index}")
        self._thread.start()
        if self._shard is not None:
            self._shard.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        if self._shard is not None:
            # joins the pump and 410s this worker's watchers (clients
            # re-list against a surviving worker)
            self._shard.stop()
        with self._watchers_lock:
            live = list(self._live_watchers)
            self._live_watchers.clear()
        for w in live:
            w.stop()  # handler threads write their final chunk and exit
        self.httpd.server_close()
        # thread-lifecycle audit: serve_forever returns after shutdown();
        # join so a stopped server leaves NO live accept thread behind
        # (the restart chaos tests assert this)
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    # ------------------------------------------------------------- dispatch

    def handle(self, h: BaseHTTPRequestHandler, method: str) -> None:
        start = time.monotonic()
        # per-REQUEST metric marker on a per-CONNECTION handler object:
        # keep-alive serves many requests through one h, so the batch
        # flag must reset here or every request after one batch POST
        # would be mislabeled ':batch' (and dropped from the SLO gate)
        h._batch_request = False
        # per-request body-consumption marker (same per-connection
        # handler object reuse hazard as _batch_request): _send_error's
        # keep-alive framing guard must not trust an earlier request's
        # flag
        h._body_consumed = False
        parsed = urllib.parse.urlsplit(h.path)
        path = parsed.path.rstrip("/")
        query = {k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()}
        # Long-running requests (watches) are exempt from the in-flight
        # limit, or thousands of agents' watches would starve every other
        # request (ref: pkg/apiserver/handlers.go longRunningRequestRE).
        long_running = (query.get("watch") in ("true", "1")
                        or query.get("follow") in ("true", "1")
                        or "/watch/" in path or path.endswith("/watch")
                        or path.endswith("/portforward")
                        or path.endswith("/attach")
                        or path.endswith("/exec")
                        # health stays shed-exempt: it is the retrying
                        # client's breaker probe and the LB liveness
                        # check — a saturated server must still answer
                        # "alive" or every breaker stays open
                        or path in ("/healthz", "/healthz/ping")
                        # /metrics too: the fleet scraper must keep
                        # reading THROUGH a 429/503 storm — the storm
                        # is exactly what the series needs to show
                        # (Prometheus' own scrape would also bypass an
                        # ingress shedder on the metrics port)
                        or path == "/metrics")
        if not long_running and not self._inflight.acquire(blocking=False):
            # sheds-per-resource: the saturation signal dashboards and
            # the chaos/scale gates read (ref: apiserver
            # dropped_requests metric, pkg/apiserver/handlers.go:83)
            self.metrics.inc("apiserver_dropped_requests",
                             {"resource": _authz_target(path)[0] or "none"})
            err = TooManyRequests("too many requests in flight")
            err.retry_after = self.shed_retry_after
            self._send_error(h, err)
            return
        # the SERVER span: extracted traceparent (or a fresh trace) for
        # every routed request, installed as the current context so
        # registry/store spans nest under it. A span exists per request
        # ARRIVAL — an injected client-side fault never reaches here,
        # and a bare POST is never replayed after ambiguous loss, which
        # together are why "one server span per committed object" holds
        # under chaos (tests/test_obs.py). Self-observation endpoints
        # are excluded, as are breaker/LB health probes.
        tracer = obs.tracer()
        server_span = obs.NOOP
        if tracer.enabled and path not in ("/healthz", "/healthz/ping",
                                           "/metrics", "/debug/trace"):
            res0 = _authz_target(path)[0]
            server_span = tracer.start_span(
                f"apiserver {method} {res0 or path}",
                parent=obs.parse_traceparent(h.headers.get("traceparent")),
                attrs={"verb": method, "resource": res0 or "none"})
        span_status = "error"
        try:
            # handler chain order per master.go:702,710:
            # authenticate -> 401, authorize -> 403, then route.
            # healthz stays open (load balancers / liveness probes carry
            # no credentials).
            health_path = path in ("/healthz", "/healthz/ping")
            # the verified TLS peer subject travels to authenticators as
            # a pseudo-header (the reference's x509 request authenticator
            # reads req.TLS.PeerCertificates). Strip any client-supplied
            # copy first — it would be a trivial spoof otherwise.
            if "X-Peer-Certificate" in h.headers:
                del h.headers["X-Peer-Certificate"]
            if self._tls:
                try:
                    peer = h.connection.getpeercert()
                except (ValueError, OSError):
                    peer = None
                if peer and peer.get("subject"):
                    h.headers["X-Peer-Certificate"] = json.dumps(
                        peer["subject"])
            user = None
            if not health_path:
                user, ok = authenticate_request(self.authenticator, h.headers)
                if not ok:
                    raise Unauthorized("authentication required")
            if self.authorizer is not None and not health_path:
                resource, namespace = _authz_target(path)
                # the node proxy's /exec relay runs commands on the node:
                # a GET in transport, a write in effect — never authorize
                # it under a read-only grant. Match on the SAME normalized
                # segments the router uses (raw-path matching is bypassable
                # with empty segments: /proxy/nodes/n1//exec/...)
                norm = "/" + "/".join(p for p in path.split("/") if p)
                write_effect = bool(_EXEC_PROXY_RE.search(norm)
                                    or _PORTFORWARD_RE.search(norm))
                attrs = AuthorizerAttributes(
                    user=user,
                    read_only=(method == "GET" and not write_effect),
                    resource=resource, namespace=namespace)
                if not self.authorizer.authorize(attrs):
                    name = user.name if user else "unknown"
                    raise Forbidden(f"user {name!r} cannot "
                                    f"{method} {resource or path}")
            with obs.use(server_span):
                self._route(h, method, path, query)
            span_status = "ok"
        except ApiError as e:
            span_status = f"error:{e.code}"
            self._send_error(h, e)
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # crash-only server, but report the request
            self._send_error(h, ApiError(f"internal error: {e!r}"))
        finally:
            tracer.end(server_span, status=span_status)
            if not long_running:
                self._inflight.release()
            # per-verb AND per-resource service time, server-side — the
            # reference's apiserver metrics shape (pkg/apiserver/metrics/
            # metrics.go:33-62 RequestLatency{verb,resource}); the SLO
            # suite gates on these summaries, not on client probes.
            # Excluded from the gated summary, as the reference's
            # HighLatencyRequests excludes them (metrics_util.go:194):
            # long-running requests (a watch open for minutes is not a
            # slow GET), and N-object batch POSTs, which get their own
            # ':batch' resource label (one 128-pod create is not a
            # representative single-request sample)
            if not long_running:
                res_label = _authz_target(path)[0] or "none"
                if getattr(h, "_batch_request", False):
                    res_label += ":batch"
                self.metrics.observe(
                    "apiserver_request_latencies_microseconds",
                    (time.monotonic() - start) * 1e6,
                    {"verb": method, "resource": res_label})
            self.metrics.inc("apiserver_request_count", {"verb": method})
            self.metrics.inc(APISERVER_WORKER_REQUESTS,
                             {"worker": str(self.worker_index)})

    def _route(self, h, method: str, path: str, query: dict) -> None:
        if path == "/healthz" or path == "/healthz/ping":
            return self._send_raw(h, 200, b"ok", "text/plain")
        if path == "/metrics":
            return self._send_raw(h, 200, self.metrics.render().encode(),
                                  "text/plain; version=0.0.4")
        if path == "/debug/trace":
            # the span buffer next to /metrics: ?format=perfetto
            # (default) is trace-event JSON for ui.perfetto.dev /
            # chrome://tracing; ?format=spans is the raw span dump
            # tools/trace_report.py analyzes
            t = obs.tracer()
            if query.get("format") == "spans":
                body = json.dumps([s.to_dict() for s in t.spans()])
            else:
                body = t.export_json()
            return self._send_raw(h, 200, body.encode(),
                                  "application/json")
        if path == "/swaggerapi":
            from .swagger import swagger_api
            return self._send_json(h, 200, swagger_api(self.url))
        if path in ("/ui", "/ui/"):
            # the client-side dashboard (pkg/ui role): a static shell —
            # no cluster data is rendered server-side; the app lists and
            # watches through the public REST API from the browser
            from .ui_app import UI_APP_HTML
            return self._send_raw(h, 200, UI_APP_HTML.encode(),
                                  "text/html; charset=utf-8")
        if path in ("/ui/server", "/ui/server/"):
            # the server-rendered variant stays for curl-style use
            from .swagger import ui_page
            return self._send_raw(
                h, 200,
                ui_page(self.registry,
                        namespace=query.get("namespace", "")).encode(),
                "text/html; charset=utf-8")
        if path == "/api":
            return self._send_json(h, 200, {
                "kind": "APIVersions",
                "versions": ["v1"] if self._v1_enabled else []})
        if path == "/apis":
            groups = [{"name": "extensions",
                       "versions": [{"groupVersion": "extensions/v1beta1",
                                     "version": "v1beta1"}]}] \
                if self._ext_enabled else []
            for g, kinds in sorted(
                    self.registry.third_party_groups().items()):
                versions = sorted({v for _, v in kinds.values()})
                groups.append({"name": g, "versions": [
                    {"groupVersion": f"{g}/{v}", "version": v}
                    for v in versions]})
            return self._send_json(h, 200, {"kind": "APIGroupList",
                                            "groups": groups})
        from .registry import EXTENSIONS_RESOURCES
        if path in ("/api/v1", ""):
            if not self._v1_enabled:
                raise NotFound(name="api/v1 disabled by --runtime-config")
            return self._send_json(h, 200, {
                "kind": "APIResourceList", "groupVersion": "v1",
                "resources": [
                    {"name": n, "namespaced": i.namespaced, "kind": i.kind}
                    for n, i in sorted(RESOURCES.items())
                    if n not in EXTENSIONS_RESOURCES]})
        if path == "/apis/extensions/v1beta1":
            if not self._ext_enabled:
                raise NotFound(
                    name="extensions/v1beta1 disabled by --runtime-config")
            return self._send_json(h, 200, {
                "kind": "APIResourceList",
                "groupVersion": "extensions/v1beta1",
                "resources": [
                    {"name": n, "namespaced": i.namespaced, "kind": i.kind}
                    for n, i in sorted(RESOURCES.items())
                    if n in EXTENSIONS_RESOURCES
                    and n not in self._disabled_resources]})

        parts = [p for p in path.split("/") if p]
        # strip "api/v1" or "apis/extensions/v1beta1" (one flat registry
        # serves both groups; the reference mounts the extensions group at
        # its own prefix, master.go:1049) — enforcing --runtime-config
        # group/resource switches at the mount point
        if len(parts) >= 3 and parts[0] == "apis" and \
                parts[1] == "extensions" and parts[2] == "v1beta1":
            if not self._ext_enabled:
                raise NotFound(
                    name="extensions/v1beta1 disabled by --runtime-config")
            parts = parts[3:]
        elif len(parts) >= 2 and parts[0] == "api" and parts[1] == "v1":
            if not self._v1_enabled:
                raise NotFound(name="api/v1 disabled by --runtime-config")
            parts = parts[2:]
        elif parts[0] == "apis" and len(parts) >= 2:
            # dynamic third-party groups (master.go:972
            # InstallThirdPartyResource): /apis/<group>[/<version>/...]
            return self._route_third_party(h, method, parts[1:], query)
        else:
            raise NotFound(f"path {path!r} not found")
        if not parts:
            raise NotFound(f"path {path!r} not found")

        if self._rc_gating:
            # one flat registry serves BOTH mounts, so group/resource
            # switches must classify the TARGET resource, not trust the
            # prefix the caller picked (else a disabled group remains
            # reachable by swapping prefixes, or a disabled resource via
            # the legacy watch/ path). _authz_target is the one path
            # grammar (watch/proxy prefixes, the namespaces
            # status/finalize carve-out) — reuse it, don't re-derive it.
            res, _ = _authz_target(path)
            if res in EXTENSIONS_RESOURCES:
                if not self._ext_enabled or res in self._disabled_resources:
                    raise NotFound(
                        name=f"{res} disabled by --runtime-config")
            elif res and not self._v1_enabled:
                raise NotFound(
                    name=f"{res} (api/v1) disabled by --runtime-config")

        namespace = ""
        if (parts[0] == "namespaces" and len(parts) >= 3
                and parts[2] not in ("status", "finalize")):
            # /namespaces/{ns}/{resource}...
            namespace, parts = parts[1], parts[2:]
        elif parts[0] == "namespaces":
            # the namespaces resource itself, incl. its own subresources:
            # /api/v1/namespaces[/{name}[/status|/finalize]]
            pass
        # also accept the legacy /api/v1/watch/... prefix
        is_watch_path = parts[0] == "watch"
        if is_watch_path:
            parts = parts[1:]
            if parts and parts[0] == "namespaces" and len(parts) >= 2:
                namespace, parts = parts[1], parts[2:]

        if not parts:
            raise NotFound(f"path {path!r} not found")
        # node proxy: /api/v1/proxy/nodes/{name}/{kubelet path...}
        # (ref: pkg/apiserver ProxyHandler + master.go "proxy/nodes")
        if parts[0] == "proxy" and len(parts) >= 3 and parts[1] == "nodes":
            # any-method relay (ref: pkg/apiserver/proxy.go:52
            # ServeHTTP has no method filter — kubectl proxy write
            # round-trips are a reference capability). Forward the
            # ORIGINAL query string: the flattened `query` dict drops
            # repeated params (kubelet /exec takes repeated ?command=)
            raw_q = urllib.parse.urlsplit(h.path).query
            return self._proxy_node(h, parts[2], "/".join(parts[3:]),
                                    raw_q, method=method,
                                    body=self._proxy_body(h, method),
                                    ctype=h.headers.get("Content-Type",
                                                        ""))
        # pod/service proxy:
        # /api/v1/proxy/namespaces/{ns}/{pods|services}/{id[:port]}/...
        # (ref: apiserver ProxyHandler + pod/strategy.go:199 +
        # service/rest.go:288 ResourceLocation)
        if (parts[0] == "proxy" and len(parts) >= 5
                and parts[1] == "namespaces"
                and parts[3] in ("pods", "services")):
            raw_q = urllib.parse.urlsplit(h.path).query
            return self._proxy_workload(h, parts[3], parts[2], parts[4],
                                        "/".join(parts[5:]), raw_q,
                                        method=method,
                                        body=self._proxy_body(h, method),
                                        ctype=h.headers.get("Content-Type",
                                                            ""))
        resource = parts[0]
        name = parts[1] if len(parts) > 1 else ""
        sub = parts[2] if len(parts) > 2 else ""
        watching = is_watch_path or query.get("watch") in ("true", "1")

        if method == "GET":
            if resource == "pods" and sub == "log":
                # ref: pod log subresource — the apiserver relays to the
                # node's kubelet server (pkg/registry/pod/etcd LogREST ->
                # kubelet /containerLogs, server.go:242)
                return self._serve_pod_log(h, namespace, name, query)
            if resource == "pods" and sub == "portforward":
                return self._serve_port_forward(h, namespace, name, query)
            if resource == "pods" and sub == "attach":
                return self._serve_attach(h, namespace, name, query)
            if resource == "pods" and sub == "exec" and \
                    self._wants_websocket(h):
                return self._serve_exec_ws(h, namespace, name, query)
            if sub == "scale":
                scale = self.registry.get_scale(resource, name, namespace)
                return self._send_json(h, 200,
                                       self.scheme.encode_dict(scale))
            if watching and not name:
                return self._serve_watch(h, resource, namespace, query)
            if not name:
                info = Registry.info(resource)
                # segment version read BEFORE the list: a write landing
                # between the list and a version read taken after it
                # would cache these (pre-write) bytes under the
                # post-write version — readers would then reuse stale
                # bytes. Read-before instead: the same interleave now
                # caches under the OLD version, which the next reader
                # sees as expired and rebuilds (a wasted cache slot,
                # never a stale serve).
                # never byte-cache TTL'd resources (events expire
                # passively — no write bumps the version) or computed
                # ones (componentstatuses is probed live per request;
                # its segment version would sit at 0 forever and pin
                # the first response)
                wv = (getattr(self.registry.store, "write_version", None)
                      if not info.ttl
                      and resource != "componentstatuses" else None)
                seg_ver = (wv(Registry.prefix(resource)) if wv is not None
                           else None)
                # two cache tiers: per-object fragments (serde.wire_json
                # — a 5k-node LIST was ~1.9s of reflective encode before
                # them) and the WHOLE response body keyed by (list args)
                # and validated by segment write version: repeated LISTs
                # between writes reduce to a socket write WITHOUT
                # touching the store — checked BEFORE registry.list, so
                # a hit skips the per-object selector scan entirely (5k
                # kubelets polling nodeName-filtered pod LISTs would
                # otherwise pay an O(pods) filter pass per poll only to
                # throw the result away). A hit must also still be
                # WATCHABLE: the cached bytes embed the resourceVersion
                # the list was built at, and a write-quiet resource's
                # segment version never moves while busier segments
                # roll the shared watch window forward — serving an
                # aged-out rev forever would livelock that resource's
                # list->watch->410 recovery loop. TTL'd resources
                # (events) expire passively — no write bumps the
                # version, so their bytes never cache (wv None above).
                ck = (resource, namespace,
                      query.get("labelSelector", ""),
                      query.get("fieldSelector", ""))
                cached = (self._list_bytes_cache.get(ck)
                          if seg_ver is not None else None)
                if cached is not None and cached[0] == seg_ver:
                    floor_fn = getattr(self.registry.store, "watch_floor",
                                       None)
                    if floor_fn is None or cached[1] >= floor_fn():
                        return self._send_raw(h, 200, cached[2],
                                              "application/json")
                items, rev = self.registry.list(
                    resource, namespace,
                    query.get("labelSelector", ""),
                    query.get("fieldSelector", ""))
                body = self.scheme.encode_list_bytes(info.kind, items,
                                                     str(rev))
                if seg_ver is not None:
                    if len(self._list_bytes_cache) >= 32:
                        self._list_bytes_cache.clear()
                    self._list_bytes_cache[ck] = (seg_ver, rev, body)
                return self._send_raw(h, 200, body, "application/json")
            obj = self.registry.get(resource, name, namespace)
            return self._send_json(h, 200, self.scheme.encode_dict(obj))

        if method == "POST":
            body = self._read_body(h)
            if isinstance(body, list):
                h._batch_request = True  # metrics: ':batch' label
            if resource == "bindings" and isinstance(body, list):
                # batched bindings tile: one store pass, per-pod conflict
                # semantics (registry.bind_batch)
                bindings = [self.scheme.decode_dict(b) for b in body]
                pods = self.registry.bind_batch(bindings, namespace)
                return self._send_json(h, 201, self.scheme.encode_list(
                    "Pod", pods, "0"))
            if isinstance(body, list) and not name and not sub:
                # batched create: one store window, one watch flush
                # (write-side analogue of the bindings tile above);
                # collection URLs only — named/subresource POSTs (e.g.
                # pods/{name}/binding) keep their own handlers
                objs = [self.scheme.decode_dict(b) for b in body]
                created = self.registry.create_batch(resource, objs,
                                                     namespace)
                info = Registry.info(resource)
                return self._send_json(h, 201, self.scheme.encode_list(
                    info.kind, created, "0"))
            obj = self.scheme.decode_dict(body)
            if resource == "pods" and sub == "binding":
                created = self.registry.bind(obj, namespace)
            else:
                created = self.registry.create(resource, obj, namespace)
            return self._send_json(h, 201, self.scheme.encode_dict(created))

        if method == "PUT":
            if not name:
                raise MethodNotSupported("PUT requires a resource name")
            body = self._read_body(h)
            obj = self.scheme.decode_dict(body)
            if sub == "status":
                updated = self.registry.update_status(resource, obj, namespace)
            elif sub == "scale":
                updated = self.registry.update_scale(resource, name, obj,
                                                     namespace)
            elif sub == "finalize" and resource == "namespaces":
                updated = self.registry.finalize_namespace(obj)
            elif sub:
                raise NotFound(f"subresource {sub!r} not found")
            else:
                updated = self.registry.update(resource, obj, namespace)
            return self._send_json(h, 200, self.scheme.encode_dict(updated))

        if method == "PATCH":
            if not name:
                raise MethodNotSupported("PATCH requires a resource name")
            if sub:
                raise MethodNotSupported(
                    "PATCH on subresources is not supported")
            # the patch TYPE rides the Content-Type (ref:
            # pkg/api/types.go:2065 PatchType); absent defaults to
            # strategic like kubectl's own patches
            ctype = (h.headers.get("Content-Type", "")
                     .split(";")[0].strip().lower()
                     or Registry.PATCH_STRATEGIC)
            if ctype == "application/json":
                ctype = Registry.PATCH_STRATEGIC
            body = self._read_body(h)
            patched = self.registry.patch(resource, name, body, namespace,
                                          patch_type=ctype)
            return self._send_json(h, 200, self.scheme.encode_dict(patched))

        if method == "DELETE":
            if not name:
                deleted = self.registry.delete_collection(
                    resource, namespace,
                    query.get("labelSelector", ""),
                    query.get("fieldSelector", ""))
                info = Registry.info(resource)
                return self._send_json(h, 200, self.scheme.encode_list(
                    info.kind, deleted))
            # DeleteOptions ride the DELETE body (kind DeleteOptions,
            # gracePeriodSeconds; pkg/apiserver/resthandler.go Delete);
            # a query param is accepted for curl ergonomics
            grace = None
            uid = None
            if query.get("gracePeriodSeconds", "") != "":
                try:
                    grace = int(query["gracePeriodSeconds"])
                except ValueError:
                    raise BadRequest("gracePeriodSeconds: not an integer")
            if int(h.headers.get("Content-Length") or 0) > 0:
                body = self._read_body(h)
                if isinstance(body, dict) and body:
                    opts = self.scheme.decode_dict(
                        body, expect=api_types.DeleteOptions) \
                        if body.get("kind") == "DeleteOptions" else None
                    if opts is not None:
                        if opts.grace_period_seconds is not None:
                            grace = opts.grace_period_seconds
                        if opts.preconditions is not None \
                                and opts.preconditions.uid:
                            uid = opts.preconditions.uid
            obj = self.registry.delete(resource, name, namespace,
                                       grace_period_seconds=grace,
                                       uid=uid)
            return self._send_json(h, 200, self.scheme.encode_dict(obj))

        raise MethodNotSupported(f"method {method} not supported")

    # -------------------------------------------- third-party resources

    def _route_third_party(self, h, method: str, parts: list,
                           query: dict) -> None:
        """REST verbs for dynamically-registered groups (the CRD
        ancestor; ref: pkg/registry/thirdpartyresourcedata + the
        per-group APIGroupVersion master.go builds)."""
        from .registry import decode_third_party, encode_third_party
        group = parts[0]
        groups = self.registry.third_party_groups()
        if group not in groups:
            raise NotFound(f"group {group!r} not found")
        if len(parts) == 1:  # group discovery
            versions = sorted({v for _, v in groups[group].values()})
            return self._send_json(h, 200, {
                "kind": "APIGroup", "name": group,
                "versions": [{"groupVersion": f"{group}/{v}",
                              "version": v} for v in versions]})
        version, rest = parts[1], parts[2:]
        if not rest:  # version discovery
            declared_versions = {v for _, v in groups[group].values()}
            if version not in declared_versions:
                raise NotFound(
                    f"group {group!r} has no version {version!r}")
            return self._send_json(h, 200, {
                "kind": "APIResourceList",
                "groupVersion": f"{group}/{version}",
                "resources": [
                    {"name": plural, "namespaced": True, "kind": kind}
                    for plural, (kind, v) in sorted(
                        groups[group].items()) if v == version]})
        namespace = ""
        if rest[0] == "namespaces" and len(rest) >= 2:
            namespace, rest = rest[1], rest[2:]
        if not rest:
            raise NotFound("resource required")
        plural = rest[0]
        name = rest[1] if len(rest) > 1 else ""
        kind, declared = self.registry.third_party_kind(group, plural,
                                                        groups=groups)
        if version != declared:
            raise NotFound(
                f"group {group!r} serves version {declared!r}")
        gv = f"{group}/{version}"
        encode = lambda obj: encode_third_party(obj, kind, gv)  # noqa: E731

        if method == "GET":
            if query.get("watch") in ("true", "1") and not name:
                rv = query.get("resourceVersion")
                deadline = self._watch_deadline(query)
                watcher = self.registry.third_party_watch(
                    group, plural, namespace,
                    int(rv) if rv not in (None, "") else None,
                    checked=True)
                self.metrics.inc("apiserver_watch_count",
                                 {"resource": f"{group}/{plural}"})
                if self._wants_websocket(h):
                    return self._serve_watch_websocket(h, watcher, encode,
                                                       deadline=deadline)
                return self._stream_watch_events(h, watcher, encode,
                                                 deadline=deadline)
            if not name:
                items, rev = self.registry.third_party_list(
                    group, plural, namespace, checked=True)
                return self._send_json(h, 200, {
                    "kind": kind + "List", "apiVersion": gv,
                    "metadata": {"resourceVersion": str(rev)},
                    "items": [encode(i) for i in items]})
            obj = self.registry.third_party_get(
                group, plural, name, namespace or "default", checked=True)
            return self._send_json(h, 200, encode(obj))
        if method == "POST":
            obj = decode_third_party(self._read_body(h))
            created = self.registry.third_party_create(
                group, plural, obj, namespace, checked=True)
            return self._send_json(h, 201, encode(created))
        if method == "PUT":
            if not name:
                raise MethodNotSupported("PUT requires a resource name")
            obj = decode_third_party(self._read_body(h))
            # the URL names the object; the body must not redirect the
            # write elsewhere (typed PUT enforces the same)
            obj.metadata.name = name
            if namespace:
                obj.metadata.namespace = namespace
            updated = self.registry.third_party_update(
                group, plural, obj, namespace, checked=True)
            return self._send_json(h, 200, encode(updated))
        if method == "DELETE":
            if not name:
                raise MethodNotSupported("DELETE requires a name")
            deleted = self.registry.third_party_delete(
                group, plural, name, namespace or "default", checked=True)
            return self._send_json(h, 200, encode(deleted))
        raise MethodNotSupported(f"method {method} not supported")

    # ----------------------------------------------------- kubelet relay

    def _kubelet_base(self, node_name: str) -> str:
        from .relay import kubelet_base_for
        return kubelet_base_for(self.registry, node_name)

    # when a master tunneler is running, master->node GETs ride the
    # tunnels (ref: master.go wires tunneler.Dial into the node-proxy
    # transport); set by Master after the tunneler starts
    tunnel_dial = None

    def _tunnel_conn(self, host: str, port: int):
        """One tunnel leg, with every dial failure mapped to 502 (a
        wedged node raises TimeoutError — an OSError, not a
        ConnectionError — and must not surface as a 500)."""
        try:
            return self.tunnel_dial(host, port)
        except (ConnectionError, OSError) as e:
            raise BadGateway(f"tunnel to {host}: {e}")

    def _node_ws(self, host: str, port: int, path: str):
        """Websocket leg to a kubelet: through the tunnel when the
        master tunneler is running (master.go wires tunneler.Dial into
        the whole node-proxy transport — streaming legs included),
        direct otherwise."""
        from ..utils import wsstream
        if self.tunnel_dial is not None:
            conn = self._tunnel_conn(host, port)
            try:
                return wsstream.client_connect(host, port, path,
                                               sock=conn)
            except BaseException:
                conn.close()
                raise
        return wsstream.client_connect(host, port, path)

    def _relay(self, h, url: str, method: str = "GET",
               body: "bytes | None" = None, ctype: str = "") -> None:
        if self.tunnel_dial is not None:
            parsed = urllib.parse.urlsplit(url)
            host, port = parsed.hostname, parsed.port or 80
            path = parsed.path + (f"?{parsed.query}" if parsed.query
                                  else "")
            from .tunneler import http_request_over
            conn = self._tunnel_conn(host, port)
            try:
                status, rtype, rbody = http_request_over(
                    conn, host, path, method=method, body=body,
                    content_type=ctype)
            except (ConnectionError, OSError, ValueError) as e:
                raise BadGateway(f"tunneled relay {host}: {e}")
            finally:
                conn.close()
            return self._send_raw(h, status, rbody, rtype)
        from .relay import fetch_kubelet_response
        status, rtype, rbody = fetch_kubelet_response(
            url, method=method, body=body, content_type=ctype)
        self._send_raw(h, status, rbody, rtype)

    def _serve_port_forward(self, h, namespace: str, name: str,
                            query: dict) -> None:
        """GET /pods/{name}/portforward?port=N, websocket upgrade: the
        apiserver leg of port forwarding — relays frames to the owning
        kubelet's /portForward endpoint (ref: pkg/registry/pod/etcd
        PortForwardREST -> kubelet server.go PortForward; SPDY there,
        websocket here)."""
        import urllib.parse as _parse

        from ..utils import wsstream

        pod = self.registry.get("pods", name, namespace)
        if not pod.spec.node_name:
            raise BadRequest(f"pod {name!r} is not scheduled yet")
        port = query.get("port", "")
        base = self._kubelet_base(pod.spec.node_name)
        split = _parse.urlsplit(base)
        path = (f"/portForward/{namespace}/{name}"
                f"?port={_parse.quote(port)}")
        try:
            up = self._node_ws(split.hostname, split.port, path)
        except (ConnectionError, OSError, BadGateway) as e:
            raise BadGateway(f"kubelet portForward: {e}")
        try:
            if not wsstream.server_handshake(h):
                return

            def down_write(b: bytes) -> None:
                h.wfile.write(b)
                h.wfile.flush()

            wsstream.relay_ws(h.rfile.read, down_write, up)
        finally:
            up.close()
            h.close_connection = True

    def _serve_attach(self, h, namespace: str, name: str,
                      query: dict) -> None:
        """GET /pods/{name}/attach?container=&stdin=, websocket upgrade
        relayed to the owning kubelet's /attach endpoint (ref:
        pkg/registry/pod/etcd AttachREST -> kubelet AttachContainer)."""
        import urllib.parse as _parse

        from ..utils import wsstream
        from .relay import resolve_pod_container

        container, base = resolve_pod_container(
            self.registry, namespace, name, query.get("container", ""))
        params = {k: query[k] for k in ("stdin",) if k in query}
        q = ("?" + _parse.urlencode(params)) if params else ""
        split = _parse.urlsplit(base)
        path = f"/attach/{namespace}/{name}/{container}{q}"
        try:
            up = self._node_ws(split.hostname, split.port, path)
        except (ConnectionError, OSError, BadGateway) as e:
            raise BadGateway(f"kubelet attach: {e}")
        try:
            if not wsstream.server_handshake(h):
                return

            def down_write(b: bytes) -> None:
                h.wfile.write(b)
                h.wfile.flush()

            wsstream.relay_ws(h.rfile.read, down_write, up)
        finally:
            up.close()
            h.close_connection = True

    def _serve_exec_ws(self, h, namespace: str, name: str,
                       query: dict) -> None:
        """GET /pods/{name}/exec?command=...&container=&stdin= with a
        websocket upgrade: relayed to the owning kubelet's interactive
        /exec endpoint (ref: pkg/registry/pod/etcd ExecREST -> kubelet
        ExecInContainer, server.go:242). Non-upgrade exec requests keep
        the one-shot node-proxy path."""
        import urllib.parse as _parse

        from ..utils import wsstream
        from .relay import exec_admission, resolve_pod_container

        container, base = resolve_pod_container(
            self.registry, namespace, name, query.get("container", ""))
        # CONNECT admission (DenyExecOnPrivileged) gates this relay
        # exactly like the one-shot node-proxy exec path — the
        # websocket variant must not be an admission bypass
        exec_admission(self.registry, f"exec/{namespace}/{name}/{container}")
        # the dispatch query dict collapses repeats; command is
        # multi-valued, so re-parse it from the raw request line
        raw_q = _parse.parse_qs(_parse.urlsplit(h.path).query)
        params = [("command", c) for c in raw_q.get("command", [])]
        if "stdin" in query:
            params.append(("stdin", query["stdin"]))
        q = ("?" + _parse.urlencode(params)) if params else ""
        split = _parse.urlsplit(base)
        path = f"/exec/{namespace}/{name}/{container}{q}"
        try:
            up = self._node_ws(split.hostname, split.port, path)
        except (ConnectionError, OSError, BadGateway) as e:
            raise BadGateway(f"kubelet exec: {e}")
        try:
            if not wsstream.server_handshake(h):
                return

            def down_write(b: bytes) -> None:
                h.wfile.write(b)
                h.wfile.flush()

            wsstream.relay_ws(h.rfile.read, down_write, up)
        finally:
            up.close()
            h.close_connection = True

    def _serve_pod_log(self, h, namespace: str, name: str,
                       query: dict) -> None:
        from .relay import container_log_url
        params = {k: query[k] for k in ("tailLines", "follow",
                                        "previous")
                  if k in query}
        url = container_log_url(self.registry, namespace, name,
                                query.get("container", ""),
                                urllib.parse.urlencode(params))
        if query.get("follow") in ("true", "1"):
            return self._relay_stream(h, url)
        self._relay(h, url)

    def _relay_stream_tunneled(self, h, url: str) -> None:
        """The follow-logs relay over a tunnel leg: headers parsed, then
        body pieces copied through as they arrive (the streaming half of
        master.go's tunneler.Dial transport wiring)."""
        from .tunneler import http_stream_over
        parsed = urllib.parse.urlsplit(url)
        host, port = parsed.hostname, parsed.port or 80
        path = parsed.path + (f"?{parsed.query}" if parsed.query else "")
        conn = self._tunnel_conn(host, port)
        try:
            try:
                status, ctype, chunks = http_stream_over(conn, host, path)
            except (ConnectionError, OSError, ValueError) as e:
                raise BadGateway(f"tunneled stream {host}: {e}")
            h.send_response(status)
            h.send_header("Content-Type", ctype)
            h.send_header("Transfer-Encoding", "chunked")
            h.end_headers()
            try:
                for piece in chunks:
                    h.wfile.write(f"{len(piece):x}\r\n".encode()
                                  + piece + b"\r\n")
                    h.wfile.flush()
                h.wfile.write(b"0\r\n\r\n")
                h.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass  # follower left; closing conn ends the upstream
        finally:
            conn.close()
            h.close_connection = True

    def _relay_stream(self, h, url: str) -> None:
        """Streaming relay (follow logs): pieces copied through as they
        arrive (relay.open_kubelet_stream carries the shared error
        mapping, so a kubelet 404 surfaces as the same typed NotFound
        the in-proc path raises)."""
        import select
        from .relay import open_kubelet_stream
        if self.tunnel_dial is not None:
            return self._relay_stream_tunneled(h, url)
        # transport failures raise BadGateway (JSON status); kubelet HTTP
        # statuses pass through verbatim like the non-follow _relay path
        upstream = open_kubelet_stream(url, verbatim_errors=True)
        code = getattr(upstream, "status", getattr(upstream, "code", 200))
        if code != 200:
            body = upstream.read()
            upstream.close()
            return self._send_raw(h, code, body, "text/plain")
        # Disconnect watchdog: with a quiet container nothing is ever
        # written downstream, so a vanished follower would otherwise pin
        # this thread in upstream.read1 forever. The follower sends no
        # bytes after its GET — a readable client socket means EOF/reset;
        # closing upstream unblocks the read loop.
        gone = threading.Event()

        def watchdog():
            while not gone.is_set():
                try:
                    readable, _, _ = select.select([h.connection], [], [],
                                                   0.5)
                except (ValueError, OSError):
                    return  # handler already closed the client socket
                if readable and not gone.is_set():
                    try:
                        upstream.close()
                    except Exception:
                        pass
                    return

        threading.Thread(target=watchdog, daemon=True,
                         name="log-relay-watchdog").start()
        try:
            h.send_response(200)
            h.send_header("Content-Type", "text/plain")
            h.send_header("Transfer-Encoding", "chunked")
            h.end_headers()
            while True:
                data = upstream.read1(65536)
                if not data:
                    break
                h.wfile.write(f"{len(data):x}\r\n".encode())
                h.wfile.write(data + b"\r\n")
                h.wfile.flush()
            h.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError, ValueError, OSError):
            # broken upstream or watchdog-closed stream: no valid
            # terminator possible — drop the connection so the follower
            # gets EOF instead of hanging on a keep-alive socket
            h.close_connection = True
        finally:
            gone.set()
            upstream.close()

    @staticmethod
    def _proxy_body(h, method: str) -> "bytes | None":
        """Request body for a proxied write (the reference's proxy
        streams it; one-shot reads serve the same verbs here).
        Chunked uploads are rejected rather than half-read: ignoring
        Transfer-Encoding would forward an empty body AND leave the
        chunk bytes on the keep-alive socket to be misparsed as the
        next request line."""
        if method in ("GET", "HEAD"):
            return None
        if "chunked" in (h.headers.get("Transfer-Encoding") or "").lower():
            h.close_connection = True
            raise BadRequest(
                "proxied writes require Content-Length "
                "(chunked request bodies are not supported)")
        try:
            length = int(h.headers.get("Content-Length") or 0)
        except ValueError:
            h.close_connection = True
            raise BadRequest("invalid Content-Length")
        if length < 0:
            # rfile.read(-1) would block on the keep-alive socket until
            # the client hangs up, pinning an in-flight slot
            h.close_connection = True
            raise BadRequest("invalid Content-Length")
        body = h.rfile.read(length) if length else b""
        h._body_consumed = True
        return body

    def _proxy_node(self, h, node_name: str, rest: str,
                    raw_query: str, method: str = "GET",
                    body: "bytes | None" = None,
                    ctype: str = "") -> None:
        from .relay import exec_admission
        # exec admission (DenyExecOnPrivileged): the relay is the
        # CONNECT moment (ref: plugin/pkg/admission/exec)
        exec_admission(self.registry, rest)
        base = self._kubelet_base(node_name)
        self._relay(h, f"{base}/{rest}"
                    + (f"?{raw_query}" if raw_query else ""),
                    method=method, body=body, ctype=ctype)

    @staticmethod
    def _split_name_port(ident: str) -> "tuple[str, str]":
        """'name', 'name:port' or 'http:name:port' (util
        SplitSchemeNamePort; only the http scheme is served here)."""
        bits = ident.split(":")
        if len(bits) == 1:
            return bits[0], ""
        if len(bits) == 2:
            return bits[0], bits[1]
        if len(bits) == 3 and bits[0] == "http":
            return bits[1], bits[2]
        raise BadRequest(f"invalid proxy request {ident!r}")

    def _proxy_workload(self, h, resource: str, namespace: str,
                        ident: str, rest: str, raw_query: str,
                        method: str = "GET",
                        body: "bytes | None" = None,
                        ctype: str = "") -> None:
        """Locate the backend for a pod/service proxy request and relay
        (ref: pkg/registry/pod/strategy.go:199 ResourceLocation — pod
        IP, port defaulting to the first declared container port;
        pkg/registry/service/rest.go:288 — resolve a port number to its
        service-port name, then pick a ready endpoint carrying it)."""
        import random
        name, port = self._split_name_port(ident)
        if resource == "pods":
            pod = self.registry.get("pods", name, namespace)
            if not port:
                for c in pod.spec.containers:
                    if c.ports:
                        port = str(c.ports[0].container_port)
                        break
            if not pod.status.pod_ip or not port:
                raise ServiceUnavailable(
                    f"pod {name!r} has no address/port to proxy to")
            if not port.isdigit():
                raise BadRequest(
                    f"pod proxy port must be numeric, got {port!r}")
            host, hport = pod.status.pod_ip, int(port)
        else:
            svc = self.registry.get("services", name, namespace)
            port_name = port
            if port.isdigit():  # number -> declared port's name
                match = [sp for sp in svc.spec.ports
                         if sp.port == int(port)]
                if not match:
                    raise ServiceUnavailable(
                        f"no service port {port} found for service "
                        f"{name!r}")
                port_name = match[0].name
            elif not port:
                if len(svc.spec.ports) != 1:
                    raise BadRequest(
                        f"service {name!r} has multiple ports; specify "
                        f"one as {name}:port")
                port_name = svc.spec.ports[0].name
            eps = self.registry.get("endpoints", name, namespace)
            candidates = []
            for subset in eps.subsets:
                for ep_port in subset.ports:
                    if ep_port.name == port_name:
                        candidates += [(a.ip, ep_port.port)
                                       for a in subset.addresses]
            if not candidates:
                raise ServiceUnavailable(
                    f"no endpoints available for service {name!r}")
            # random pick spreads load like rest.go:322's random subset
            host, hport = random.choice(candidates)
        self._relay(h, f"http://{host}:{hport}/{rest}"
                    + (f"?{raw_query}" if raw_query else ""),
                    method=method, body=body, ctype=ctype)

    # -------------------------------------------------------------- watch

    @staticmethod
    def _wants_websocket(h) -> bool:
        """(ref: pkg/apiserver/watch.go:44 isWebsocketRequest)"""
        connection = (h.headers.get("Connection") or "").lower()
        upgrade = (h.headers.get("Upgrade") or "").lower()
        return "upgrade" in connection and upgrade == "websocket"

    def _serve_watch(self, h, resource: str, namespace: str, query: dict) -> None:
        rv = query.get("resourceVersion")
        since_rev = int(rv) if rv not in (None, "") else None
        deadline = self._watch_deadline(query)
        watcher = self.registry.watch(resource, namespace, since_rev,
                                      query.get("labelSelector", ""),
                                      query.get("fieldSelector", ""),
                                      shard=self._shard)
        self.metrics.inc("apiserver_watch_count", {"resource": resource})
        if self._wants_websocket(h):
            return self._serve_watch_websocket(h, watcher,
                                               deadline=deadline)
        self._stream_watch_events(h, watcher, self.scheme.encode_dict,
                                  deadline=deadline)

    @staticmethod
    def _encode_watch_object(encode, ev):
        """ERROR events carry an ApiError, not a registered API type —
        they serialize as their Status dict (the reference's watch wire
        sends a Status object; api/client._HttpWatcher decodes exactly
        that via from_status). Letting encode() raise here would write
        a second HTTP response into the half-open chunked body and
        desync the connection."""
        from ..core.errors import ApiError
        if isinstance(ev.object, ApiError):
            return ev.object.status()
        return encode(ev.object)

    @staticmethod
    def _watch_deadline(query: dict):
        """?timeoutSeconds= -> absolute monotonic deadline or None
        (ref: the WatchServer's request timeout, api_installer.go
        TimeoutSeconds): the stream ends cleanly after N seconds and
        the client re-lists/re-watches — the reflector's normal
        recovery path. Parsed BEFORE the watcher registers so a
        malformed value can't leak an unstopped watcher into the
        store; nan/inf reject rather than silently unbounding."""
        raw = query.get("timeoutSeconds", "")
        if raw == "":
            return None
        try:
            timeout = float(raw)
        except ValueError:
            raise BadRequest("timeoutSeconds: not a number")
        if not math.isfinite(timeout) or timeout < 0:
            raise BadRequest(
                "timeoutSeconds: must be a non-negative finite number")
        return time.monotonic() + timeout

    @staticmethod
    def _watch_tick(watcher, deadline):
        """One bounded watcher.next: (event, expired). The deadline caps
        the wait so an expired watch ends within a heartbeat."""
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None, True
            ev = watcher.next(timeout=min(WATCH_HEARTBEAT_SECONDS,
                                          remaining))
        else:
            ev = watcher.next(timeout=WATCH_HEARTBEAT_SECONDS)
        return ev, (deadline is not None
                    and time.monotonic() >= deadline and ev is None)

    def _track_watcher(self, watcher) -> None:
        with self._watchers_lock:
            self._live_watchers.add(watcher)

    def _untrack_watcher(self, watcher) -> None:
        with self._watchers_lock:
            self._live_watchers.discard(watcher)

    def _stream_watch_events(self, h, watcher, encode, deadline=None) -> None:
        """Chunked JSON event stream shared by the typed watch and the
        third-party watch (encode: object -> wire dict)."""
        self._track_watcher(watcher)
        try:
            h.send_response(200)
            h.send_header("Content-Type", "application/json")
            h.send_header("Transfer-Encoding", "chunked")
            h.end_headers()

            def write_chunk(payload: bytes) -> None:
                h.wfile.write(f"{len(payload):x}\r\n".encode())
                h.wfile.write(payload + b"\r\n")
                h.wfile.flush()

            while True:
                ev, expired = self._watch_tick(watcher, deadline)
                if expired:
                    break
                if ev is None:
                    if watcher.stopped:
                        break
                    write_chunk(b"\n")  # keep-alive blank line
                    continue
                line = json.dumps({
                    "type": ev.type,
                    "object": self._encode_watch_object(encode, ev),
                }).encode() + b"\n"
                write_chunk(line)
            h.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            self._untrack_watcher(watcher)
            watcher.stop()

    def _serve_watch_websocket(self, h, watcher, encode=None,
                               deadline=None) -> None:
        """Watch over a websocket (ref: watch.go:89 HandleWS; wire events
        are the same JSON objects, one per text frame). Framing and
        handshake come from utils/wsstream (the pkg/util/wsstream role);
        client frames are drained and discarded like the reference's
        Receive loop (watch.go:96)."""
        from ..utils import wsstream

        if encode is None:
            encode = self.scheme.encode_dict
        self._track_watcher(watcher)
        try:
            if not wsstream.server_handshake(h):
                return
            # event writer and the drain thread's pongs share the pipe
            wlock = threading.Lock()

            def write(b: bytes) -> None:
                with wlock:
                    h.wfile.write(b)
                    h.wfile.flush()

            def drain_client_frames():
                """Read client frames: answer Ping with Pong (RFC 6455
                5.5.3, echoing the payload), stop the watcher on Close
                (or a malformed/oversized frame), discard the rest like
                the reference's Receive loop."""
                try:
                    while True:
                        opcode, payload = wsstream.read_frame(
                            h.rfile.read)
                        if opcode == wsstream.CLOSE:
                            break
                        if opcode == wsstream.PING:
                            wsstream.write_frame(write, payload,
                                                 wsstream.PONG)
                except (ConnectionError, OSError, ValueError):
                    pass
                finally:
                    watcher.stop()

            threading.Thread(target=drain_client_frames,
                             daemon=True).start()

            while True:
                ev, expired = self._watch_tick(watcher, deadline)
                if expired:
                    break
                if ev is None:
                    if watcher.stopped:
                        break
                    wsstream.write_frame(write, b"", wsstream.PING)
                    continue
                line = json.dumps({
                    "type": ev.type,
                    "object": self._encode_watch_object(encode, ev),
                }).encode()
                wsstream.write_frame(write, line, wsstream.TEXT)
            wsstream.write_frame(write, b"", wsstream.CLOSE)
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            self._untrack_watcher(watcher)
            watcher.stop()
            h.close_connection = True

    # ------------------------------------------------------------- helpers

    @staticmethod
    def _read_body(h) -> dict:
        try:
            length = int(h.headers.get("Content-Length") or 0)
        except ValueError:
            h.close_connection = True
            raise BadRequest("invalid Content-Length")
        if length <= 0:
            raise BadRequest("empty request body")
        raw = h.rfile.read(length)
        h._body_consumed = True
        try:
            return json.loads(raw)
        except json.JSONDecodeError as e:
            raise BadRequest(f"invalid JSON body: {e}")

    def _send_json(self, h, code: int, payload: dict,
                   extra_headers: Optional[dict] = None) -> None:
        self._send_raw(h, code, json.dumps(payload).encode(),
                       "application/json", extra_headers=extra_headers)

    def _send_error(self, h, err: ApiError) -> None:
        # an error can fire before a body-bearing request's body was
        # read (e.g. PATCH to a subresource -> MethodNotSupported);
        # leftover body bytes would desync HTTP/1.1 keep-alive framing —
        # the next request on the connection parses mid-body. Close
        # unless a body reader ran to completion (a 409 AFTER the read
        # keeps its keep-alive — conflict-heavy CAS traffic must not
        # pay a reconnect per retry).
        if (h.command not in ("GET", "HEAD")
                and not getattr(h, "_body_consumed", False)):
            try:
                # nonzero (incl. negative) means framing can't be
                # trusted; only an explicit 0 / absent header is safe
                pending = int(h.headers.get("Content-Length") or 0) != 0
            except ValueError:
                pending = True  # unparseable: can't trust the framing
            if pending or h.headers.get("Transfer-Encoding"):
                h.close_connection = True
        extra = None
        retry_after = getattr(err, "retry_after", None)
        if retry_after:
            # fractional values allowed (DIVERGENCES.md: RFC 7231 says
            # integer delta-seconds; sub-second shed windows would all
            # round to the same wave otherwise)
            extra = {"Retry-After": f"{retry_after:g}"}
        try:
            self._send_json(h, err.code, err.status(), extra_headers=extra)
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass

    @staticmethod
    def _send_raw(h, code: int, payload: bytes, ctype: str,
                  extra_headers: Optional[dict] = None) -> None:
        h.send_response(code)
        h.send_header("Content-Type", ctype)
        h.send_header("Content-Length", str(len(payload)))
        for k, v in (extra_headers or {}).items():
            h.send_header(k, v)
        h.end_headers()
        h.wfile.write(payload)


class ApiServerPool:
    """N apiserver workers over ONE shared store — the horizontally-
    scaled serving plane (Fleet serving, README). Each worker is a full
    ApiServer on its own port with its own fan-out shard from the
    shared store (attach_fanout_shard), so the watchers a worker serves
    are pumped by that worker's own drain thread: delivery parallelism
    scales with workers instead of queuing behind the single committer-
    drained publisher. Reads and writes all land on the same store
    (one revision stream, one watch history), so any worker can serve
    any client — the in-proc stand-in for N apiserver processes behind
    a load balancer over shared etcd (DIVERGENCES #33).

    Stores without shard support (anything duck-typed that lacks
    attach_fanout_shard) still pool fine: those workers serve watches
    off the store's default delivery path.

    restart(i) models one apiserver process bouncing behind the LB:
    the old worker's watchers get 410 (ERROR + close, via shard.stop),
    and the replacement binds the SAME port — in-flight connections
    queue in the listen backlog instead of landing refused, so a
    scraper or client that retries sees a blip, not an outage."""

    def __init__(self, registry: Registry, n_workers: int = 2,
                 host: str = "127.0.0.1",
                 metrics: Optional[MetricsRegistry] = None,
                 **server_kwargs):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.registry = registry
        self.host = host
        self.metrics = metrics
        self._server_kwargs = dict(server_kwargs)
        self.workers: list = []
        for i in range(n_workers):
            self.workers.append(self._build(i, port=0))

    def _build(self, index: int, port: int) -> ApiServer:
        store = self.registry.store
        shard = (store.attach_fanout_shard(f"worker-{index}")
                 if hasattr(store, "attach_fanout_shard") else None)
        return ApiServer(self.registry, host=self.host, port=port,
                         metrics=self.metrics, worker_index=index,
                         fanout_shard=shard, **self._server_kwargs)

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "ApiServerPool":
        for w in self.workers:
            w.start()
        return self

    def stop(self) -> None:
        for w in self.workers:
            w.stop()

    def restart(self, index: int) -> ApiServer:
        """Bounce worker `index` in place (rolling-restart chaos): stop
        the old instance (accept thread joined, shard pump joined,
        watchers 410'd), then bind a fresh instance — fresh shard
        cursor, fresh handler state — on the SAME port."""
        old = self.workers[index]
        port = old.port
        old.stop()
        neu = self._build(index, port=port)
        self.workers[index] = neu
        neu.start()
        return neu

    # ------------------------------------------------------------- helpers

    def urls(self) -> list:
        return [w.url for w in self.workers]

    def shards(self) -> list:
        return [w._shard for w in self.workers if w._shard is not None]

    def alive_threads(self) -> list:
        """Every live thread the pool owns (restart chaos asserts this
        is empty after stop): accept threads + shard pumps."""
        out = []
        for w in self.workers:
            t = w._thread
            if t is not None and t.is_alive():
                out.append(t)
            sh = w._shard
            if sh is not None and sh._thread is not None \
                    and sh._thread.is_alive():
                out.append(sh._thread)
        return out
