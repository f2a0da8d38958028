"""Scheduler extender — the HTTP sidecar SERVER (the device seam, serving).

Serves the reference's extender wire protocol so the GPU scoring backend
bolts onto a *stock* kube-scheduler unchanged — the stock scheduler POSTs
ExtenderArgs and the port's device engine answers Filter / Prioritize.

Reference: plugin/pkg/scheduler/extender.go:38-172 (the client that will
call us), api/types.go:114-158 (wire types), and the server shape in
test/integration/extender_test.go:66-103 (Extender.serveHTTP) +
docs/design/scheduler_extender.md. Routes:

    POST {prefix}/{apiVersion}/{filterVerb}
        body: ExtenderArgs{"pod": <Pod>, "nodes": <NodeList>}
        resp: ExtenderFilterResult{"nodes": <NodeList>, "error": str}
    POST {prefix}/{apiVersion}/{prioritizeVerb}
        body: ExtenderArgs
        resp: HostPriorityList [{"host": str, "score": int}]

Filter errors are reported in-band (the caller fails the pod); prioritize
errors yield an empty list (the caller ignores prioritize failures,
generic_scheduler.go:197-199 / extender_test.go:92-95).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Sequence, Tuple

from ..core import types as api
from ..core.scheme import Scheme, default_scheme
from .api import HostPriority

# fn(pod, node) -> bool            (extender_test.go:53 fitPredicate)
FitPredicate = Callable[[api.Pod, api.Node], bool]
# fn(pod, nodes) -> [HostPriority] (extender_test.go:54 priorityFunc)
PriorityFunc = Callable[[api.Pod, Sequence[api.Node]], List[HostPriority]]


class CallableBackend:
    """Arbitrary predicates/prioritizers behind the wire protocol — the
    reference integration test's Extender struct (extender_test.go:60-147).
    """

    def __init__(self, predicates: Sequence[FitPredicate] = (),
                 prioritizers: Sequence[Tuple[PriorityFunc, int]] = ()):
        self.predicates = list(predicates)
        self.prioritizers = list(prioritizers)

    def filter(self, pod: api.Pod,
               nodes: Sequence[api.Node]) -> List[api.Node]:
        """(ref: extender_test.go:104 Extender.Filter)"""
        filtered = []
        for node in nodes:
            if all(pred(pod, node) for pred in self.predicates):
                filtered.append(node)
        return filtered

    def prioritize(self, pod: api.Pod,
                   nodes: Sequence[api.Node]) -> List[HostPriority]:
        """(ref: extender_test.go:126 Extender.Prioritize)"""
        combined = {}
        for func, weight in self.prioritizers:
            if weight == 0:
                continue
            for entry in func(pod, nodes):
                combined[entry.host] = combined.get(entry.host, 0) \
                    + entry.score * weight
        return [HostPriority(h, s) for h, s in combined.items()]


class DeviceBackend:
    """The device backend behind the extender seam: predicates answered as
    a device mask (the filter kernel, BatchEngine.filter_masks),
    priorities as device score totals (BatchEngine.probe).

    `state_provider()` supplies the cluster context the wire format does
    not carry (existing pods / services / RCs — a deployed sidecar feeds
    this from its own reflectors against the apiserver); candidate nodes
    always come from the request, per the protocol. `device=None` is the
    CUDA device."""

    def __init__(self, weights=None, policy=None,
                 state_provider: Optional[Callable] = None, device=None):
        from .device import BatchEngine
        from .device.engine import DEFAULT_WEIGHTS
        self.engine = BatchEngine(weights or DEFAULT_WEIGHTS, policy=policy,
                                  device=device)
        self.state_provider = state_provider or (lambda: ([], [], []))

    def _encode(self, pod: api.Pod, nodes: Sequence[api.Node]):
        from .device import ClusterSnapshot, encode_snapshot
        existing, services, controllers = self.state_provider()
        snap = ClusterSnapshot(
            nodes=list(nodes), existing_pods=list(existing),
            services=list(services), controllers=list(controllers),
            pending_pods=[pod])
        return encode_snapshot(snap, policy=self.engine.policy)

    def filter(self, pod: api.Pod,
               nodes: Sequence[api.Node]) -> List[api.Node]:
        # mask-only: rides the CUDA filter kernel when the encoding
        # qualifies (engine.filter_masks)
        enc = self._encode(pod, nodes)
        mask = self.engine.filter_masks(enc)[0]
        by_name = {n.metadata.name: n for n in nodes}
        return [by_name[enc.node_names[i]]
                for i in range(len(enc.node_names))
                if mask[i] and enc.node_names[i] in by_name]

    def prioritize(self, pod: api.Pod,
                   nodes: Sequence[api.Node]) -> List[HostPriority]:
        enc = self._encode(pod, nodes)
        _mask, total = self.engine.probe(enc)
        total = total[0]
        wanted = {n.metadata.name for n in nodes}
        return [HostPriority(enc.node_names[i], int(total[i]))
                for i in range(len(enc.node_names))
                if enc.node_names[i] in wanted]


class ExtenderServer:
    """HTTP sidecar serving one backend over the extender wire protocol."""

    def __init__(self, backend, filter_verb: str = "filter",
                 prioritize_verb: str = "prioritize",
                 api_version: str = "v1", host: str = "127.0.0.1",
                 port: int = 0, scheme: Scheme = default_scheme):
        self.backend = backend
        self.filter_verb = filter_verb
        self.prioritize_verb = prioritize_verb
        self.api_version = api_version
        self.scheme = scheme
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                server.handle(self)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self.host = host
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        """Drops into ExtenderConfig.url_prefix."""
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ExtenderServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()

    # ----------------------------------------------------------- dispatch

    def _decode_args(self, h) -> Tuple[api.Pod, List[api.Node]]:
        length = int(h.headers.get("Content-Length") or 0)
        args = json.loads(h.rfile.read(length))
        pod = self.scheme.decode_dict({**args["pod"], "kind": "Pod"})
        items = (args.get("nodes") or {}).get("items") or []
        nodes = [self.scheme.decode_dict({**n, "kind": "Node"})
                 for n in items]
        return pod, nodes

    def handle(self, h: BaseHTTPRequestHandler) -> None:
        # verb dispatch by path suffix, as the reference test server does
        # (extender_test.go:80 strings.Contains(req.URL.Path, filter))
        leaf = h.path.rstrip("/").rsplit("/", 1)[-1]
        try:
            if leaf == self.filter_verb:
                payload = self._handle_filter(h)
            elif leaf == self.prioritize_verb:
                payload = self._handle_prioritize(h)
            else:
                return self._send(h, 404, {"error": f"unknown verb {leaf!r}"})
            self._send(h, 200, payload)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _handle_filter(self, h) -> dict:
        try:
            pod, nodes = self._decode_args(h)
            filtered = self.backend.filter(pod, nodes)
            return {"nodes": self.scheme.encode_list("Node", filtered),
                    "error": ""}
        except Exception as e:  # in-band error fails the pod (extender.go:95)
            return {"nodes": {"kind": "NodeList", "items": []},
                    "error": str(e) or repr(e)}

    def _handle_prioritize(self, h) -> list:
        try:
            pod, nodes = self._decode_args(h)
            return [{"host": p.host, "score": p.score}
                    for p in self.backend.prioritize(pod, nodes)]
        except Exception:  # prioritize errors are ignored by the caller
            return []

    def _send(self, h, code: int, payload) -> None:
        raw = json.dumps(payload).encode()
        h.send_response(code)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(raw)))
        h.end_headers()
        h.wfile.write(raw)
