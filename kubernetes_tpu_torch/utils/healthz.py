"""Tiny healthz/metrics server every control-plane binary mounts.

Reference: pkg/healthz (235 LoC) + the per-binary mounts (scheduler
serves healthz/metrics/pprof on :10251,
plugin/cmd/kube-scheduler/app/server.go:128-143; controller-manager on
:10252). The componentstatus resource probes these fixed local ports
(pkg/registry/componentstatus)."""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .metrics import MetricsRegistry, global_metrics

SCHEDULER_PORT = 10251            # ref: --port default, scheduler
CONTROLLER_MANAGER_PORT = 10252   # ref: --port default, controller-manager


class HealthzServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 metrics: Optional[MetricsRegistry] = None,
                 checks: Optional[dict] = None):
        """checks: name -> callable() raising/False on unhealthy."""
        self.metrics = metrics or global_metrics
        self.checks = dict(checks or {})
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                server.handle(self)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self.host = host
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "HealthzServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()

    def handle(self, h) -> None:
        path = h.path.split("?")[0].rstrip("/")
        try:
            if path in ("", "/healthz", "/healthz/ping"):
                for name, check in self.checks.items():
                    try:
                        if check() is False:
                            raise RuntimeError(f"check {name} failed")
                    except Exception as e:
                        return self._send(h, 500, f"unhealthy: {e}")
                return self._send(h, 200, "ok")
            if path == "/metrics":
                return self._send(h, 200, self.metrics.render(),
                                  "text/plain; version=0.0.4")
            self._send(h, 404, f"not found: {path}")
        except (BrokenPipeError, ConnectionResetError):
            pass

    @staticmethod
    def _send(h, code: int, text: str,
              ctype: str = "text/plain") -> None:
        payload = text.encode()
        h.send_response(code)
        h.send_header("Content-Type", ctype)
        h.send_header("Content-Length", str(len(payload)))
        h.end_headers()
        h.wfile.write(payload)
