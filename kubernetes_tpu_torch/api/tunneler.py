"""Master->node tunneler.

Reference: pkg/master/tunneler.go — on clouds where the master cannot
reach node networks directly, master-originated node traffic (healthz,
kubelet API, pod proxying) rides secured tunnels the master maintains
to every node: an address-sync loop (1s cadence, backing off to ~10s
while healthy), a 5-minute full refresh, Dial() through a tunnel, and
SecondsSinceSync() feeding a master healthz gate.

The transport: there is no sshd in the picture, so the tunnel
leg is a websocket to the node kubelet's /tunnel endpoint, which dials
node-locally on the master's behalf (kubelet/server.py _tunnel) — the
same role sshd's direct-tcpip channel plays for the reference, with
the same loop structure and health surface. One divergence: the
reference holds one persistent SSH transport per node and multiplexes
dials over it; here each dial opens its own websocket leg (HTTP
keep-alive infrastructure makes per-dial legs cheap, and a dead node
fails the dial instead of a shared transport).
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..utils import wsstream

# (node_name, host, kubelet_port) per node
AddressFunc = Callable[[], List[Tuple[str, str, int]]]

TUNNEL_SYNC_HEALTHZ_MAX_S = 600  # ref: master.go tunnel healthz gate


class TunnelConn:
    """Socket-like view of one websocket tunnel leg: sendall/recv/close
    over binary frames (the client side of utils/wsstream.bridge)."""

    def __init__(self, ws: socket.socket):
        self._ws = ws
        self._buf = b""
        self._eof = False

    def sendall(self, data: bytes) -> None:
        wsstream.write_frame(self._ws.sendall, data, wsstream.BINARY,
                             mask=True)

    def recv(self, n: int) -> bytes:
        while not self._buf and not self._eof:
            try:
                opcode, payload = wsstream.read_frame(self._ws.recv)
            except TimeoutError:
                # a settimeout() expiry is the caller's signal (the
                # tunneled log-stream idle bound), NOT end-of-stream
                raise
            except (ConnectionError, OSError):
                # socket semantics: a recv blocked across shutdown()
                # (or an abruptly dead tunnel leg) reads EOF, it does
                # not raise — the relay pumps treat b"" as done
                self._eof = True
                break
            if opcode == wsstream.CLOSE:
                self._eof = True
                break
            if opcode == wsstream.BINARY and payload:
                self._buf += payload
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def close(self) -> None:
        try:
            wsstream.write_frame(self._ws.sendall, b"", wsstream.CLOSE,
                                 mask=True)
        except (ConnectionError, OSError):
            pass
        self._ws.close()

    def settimeout(self, t) -> None:
        self._ws.settimeout(t)

    def shutdown(self, how: int = socket.SHUT_RDWR) -> None:
        """socket.shutdown analogue so relay teardown paths
        (utils/wsstream.relay_ws) can unblock a peer pump thread:
        best-effort CLOSE frame, then shut the underlying socket so a
        blocked read returns immediately."""
        try:
            wsstream.write_frame(self._ws.sendall, b"", wsstream.CLOSE,
                                 mask=True)
        except (ConnectionError, OSError):
            pass
        self._eof = True
        try:
            self._ws.shutdown(how)
        except OSError:
            pass


def http_get_over(conn: TunnelConn, host: str, path: str,
                  timeout: float = 30.0):
    """One HTTP GET over an open tunnel leg (see http_request_over)."""
    return http_request_over(conn, host, path, timeout=timeout)


def http_request_over(conn: TunnelConn, host: str, path: str,
                      timeout: float = 30.0, method: str = "GET",
                      body: "bytes | None" = None,
                      content_type: str = ""):
    """One HTTP request over an open tunnel leg -> (status,
    content_type, body). HTTP/1.0 with Connection: close keeps the
    framing trivial (read to EOF) — the tunneled requests are the
    master's one-shot node calls (healthz, /pods, /stats, and the
    any-method proxy relay), exactly the SSH tunnel's traffic in the
    reference (master.go wires tunneler.Dial into the node-proxy
    transport; pkg/apiserver/proxy.go:52 relays every verb)."""
    conn.settimeout(timeout)
    head = (f"{method} {path} HTTP/1.0\r\nHost: {host}\r\n"
            f"Connection: close\r\n")
    if body is not None:
        head += f"Content-Length: {len(body)}\r\n"
        if content_type:
            head += f"Content-Type: {content_type}\r\n"
    conn.sendall(head.encode() + b"\r\n" + (body or b""))
    buf = b""
    while True:
        piece = conn.recv(65536)
        if not piece:
            break
        buf += piece
    head, _, body = buf.partition(b"\r\n\r\n")
    lines = head.split(b"\r\n")
    try:
        status = int(lines[0].split()[1])
    except (IndexError, ValueError):
        raise ConnectionError(
            f"malformed tunneled response: {lines[0][:100]!r}")
    ctype = "text/plain"
    for line in lines[1:]:
        if line.lower().startswith(b"content-type:"):
            ctype = line.split(b":", 1)[1].strip().decode()
    return status, ctype, body


def http_stream_over(conn: TunnelConn, host: str, path: str,
                     timeout: float = 30.0):
    """Streaming HTTP GET over a tunnel leg -> (status, content_type,
    chunk iterator). The iterator yields body pieces as they arrive
    until EOF (the follow-logs relay); the caller closes conn."""
    conn.settimeout(timeout)
    conn.sendall(f"GET {path} HTTP/1.0\r\nHost: {host}\r\n"
                 f"Connection: close\r\n\r\n".encode())
    buf = b""
    while b"\r\n\r\n" not in buf:
        piece = conn.recv(65536)
        if not piece:
            break
        buf += piece
    head, _, leftover = buf.partition(b"\r\n\r\n")
    lines = head.split(b"\r\n")
    try:
        status = int(lines[0].split()[1])
    except (IndexError, ValueError):
        raise ConnectionError(
            f"malformed tunneled response: {lines[0][:100]!r}")
    ctype = "text/plain"
    chunked = False
    for line in lines[1:]:
        if line.lower().startswith(b"content-type:"):
            ctype = line.split(b":", 1)[1].strip().decode()
        elif line.lower().startswith(b"transfer-encoding:") and \
                b"chunked" in line.lower():
            chunked = True

    def raw():
        # a follow stream can sit quiet for minutes between pieces, so
        # the handshake timeout must not tear the body phase down — but
        # a WEDGED node (a failure mode this deployment hits) must not
        # pin an apiserver handler thread forever either: bound the
        # idle gap at 15 min and let the timeout release the thread
        conn.settimeout(900.0)
        if leftover:
            yield leftover
        while True:
            piece = conn.recv(65536)
            if not piece:
                return
            yield piece

    if not chunked:
        return status, ctype, raw()

    def dechunked():
        # the kubelet streams follow bodies chunked; relaying the raw
        # framing would hand the client size lines as content — decode
        # the inner layer and yield clean payload pieces
        buf = b""
        src = raw()
        for piece in src:
            buf += piece
            while True:
                nl = buf.find(b"\r\n")
                if nl < 0:
                    break
                try:
                    size = int(buf[:nl].split(b";")[0], 16)
                except ValueError:
                    raise ConnectionError(
                        f"bad chunk size line: {buf[:nl][:40]!r}")
                if size == 0:
                    return
                # need size bytes + trailing CRLF after the size line
                while len(buf) < nl + 2 + size + 2:
                    try:
                        more = next(src)
                    except StopIteration:
                        return
                    buf += more
                yield buf[nl + 2:nl + 2 + size]
                buf = buf[nl + 2 + size + 2:]

    return status, ctype, dechunked()


class Tunneler:
    """(ref: tunneler.go:36 Tunneler interface)"""

    def run(self, address_func: AddressFunc) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        raise NotImplementedError

    def dial(self, host: str, port: int) -> TunnelConn:
        raise NotImplementedError

    def seconds_since_sync(self) -> int:
        raise NotImplementedError


class WsTunneler(Tunneler):
    """Maintains one verified tunnel endpoint per node (ref:
    SSHTunneler + util.SSHTunnelList)."""

    def __init__(self, sync_interval: float = 1.0,
                 healthy_sleep: float = 9.0,
                 refresh_interval: float = 300.0,
                 dial_timeout: float = 10.0, clock=time):
        self.sync_interval = sync_interval
        self.healthy_sleep = healthy_sleep
        self.refresh_interval = refresh_interval
        self.dial_timeout = dial_timeout
        self._clock = clock
        self._tunnels: Dict[str, Tuple[str, int]] = {}  # host -> (host, port)
        self._lock = threading.Lock()
        self._last_sync = 0.0
        self._stop: Optional[threading.Event] = None
        self._address_func: Optional[AddressFunc] = None
        self._threads: List[threading.Thread] = []

    # -------------------------------------------------------- lifecycle

    def run(self, address_func: AddressFunc) -> None:
        if self._stop is not None:
            return  # ref: Run is idempotent (tunneler.go:69)
        self._stop = threading.Event()
        self._address_func = address_func
        t1 = threading.Thread(target=self._sync_loop, daemon=True,
                              name="tunnel-sync")
        t2 = threading.Thread(target=self._refresh_loop, daemon=True,
                              name="tunnel-refresh")
        self._threads = [t1, t2]
        t1.start()
        t2.start()

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()

    # ------------------------------------------------------------ loops

    def _verify(self, host: str, port: int) -> bool:
        """A tunnel endpoint is healthy when the kubelet answers a TCP
        connect (the SSH analogue: the transport handshake succeeds)."""
        try:
            with socket.create_connection((host, port),
                                          timeout=self.dial_timeout):
                return True
        except OSError:
            return False

    def _load(self, force: bool = False) -> None:
        addrs = self._address_func() if self._address_func else []
        want = {host: (host, port) for _name, host, port in addrs}
        with self._lock:
            changed = set(want) != set(self._tunnels)
        if not (changed or force):
            with self._lock:
                self._last_sync = self._clock.time()
            return
        verified = {h: hp for h, hp in want.items()
                    if self._verify(hp[0], hp[1])}
        with self._lock:
            self._tunnels = verified
            self._last_sync = self._clock.time()

    def _sync_loop(self) -> None:
        # ref: setupSecureProxy's 1s Until loop that sleeps ~10s while
        # tunnels exist
        while not self._stop.is_set():
            try:
                self._load()
            except Exception:
                pass  # crash-only: next tick retries
            with self._lock:
                healthy = bool(self._tunnels)
            self._stop.wait(self.sync_interval
                            + (self.healthy_sleep if healthy else 0.0))

    def _refresh_loop(self) -> None:
        # ref: the 5-minute full replaceTunnels loop
        while not self._stop.is_set():
            self._stop.wait(self.refresh_interval)
            if self._stop.is_set():
                return
            try:
                self._load(force=True)
            except Exception:
                pass

    # ------------------------------------------------------------- dial

    def dial(self, host: str, port: int) -> TunnelConn:
        """Open a tunnel leg to (host, port) through that node's own
        tunnel endpoint (the target is node-local from the kubelet's
        point of view). Divergence from the SSH list's pick-any-tunnel
        behavior: the kubelet /tunnel leg deliberately refuses
        non-local targets, so only tunneled nodes are dialable — the
        master's node traffic (healthz, kubelet API, pod relays) is
        exactly that set."""
        with self._lock:
            entry = self._tunnels.get(host)
        if entry is None:
            raise ConnectionError(
                f"no healthy tunnel to {host!r} (targets must be "
                f"tunneled nodes)")
        k_host, k_port = entry
        # dial the node's REGISTERED kubelet address, not loopback: a
        # kubelet bound only to its InternalIP serves nothing on
        # 127.0.0.1, and the kubelet-side node-local check admits its
        # own bind address (kubelet/server.py _tunnel)
        ws = wsstream.client_connect(
            k_host, k_port,
            f"/tunnel?host={k_host}&port={port}",
            timeout=self.dial_timeout)
        return TunnelConn(ws)

    def seconds_since_sync(self) -> int:
        with self._lock:
            then = self._last_sync
        return int(self._clock.time() - then)

    def healthy(self) -> bool:
        """The master healthz gate (ref: master.go IsTunnelSyncHealthy:
        lastSync within 600s)."""
        return self.seconds_since_sync() < TUNNEL_SYNC_HEALTHZ_MAX_S

    def tunnel_count(self) -> int:
        with self._lock:
            return len(self._tunnels)
