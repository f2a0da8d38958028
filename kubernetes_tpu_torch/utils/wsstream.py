"""Websocket framing + handshakes — the pkg/util/wsstream role.

The reference upgrades exec/attach/portForward to SPDY streams
(pkg/util/httpstream) and serves watches over websockets
(pkg/util/wsstream); SPDY is dead on the modern web, so every upgraded
stream here is RFC 6455. One implementation serves the apiserver's
websocket watch, the kubelet's portForward endpoint, the apiserver's
portforward relay, and kubectl's local bridge.

Port-forward data plane: binary frames carry raw TCP bytes. TCP
half-close (a client that sends its request then shutdown(SHUT_WR) and
reads the response) has no websocket equivalent, so an in-band TEXT
frame with payload EOF_MARKER propagates it: the receiver shuts the
write side of its TCP leg and keeps pumping the other direction. A
CLOSE frame ends the whole session (the pod-facing side sends it when
the pod connection reaches EOF — the response is complete).
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import threading
from typing import Callable, Dict, Optional, Tuple

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

TEXT = 0x1
BINARY = 0x2
CLOSE = 0x8
PING = 0x9
PONG = 0xA

EOF_MARKER = b"\x00ws-half-close"

# One frame's payload bound. Port-forward pumps emit <=64KiB frames;
# anything bigger from a peer is hostile or broken — without a cap one
# forged 2^40-byte length would make _read_exact buffer until OOM.
MAX_FRAME = 1 << 20


def accept_key(key: str) -> str:
    return base64.b64encode(
        hashlib.sha1((key + _GUID).encode()).digest()).decode()


def server_handshake(h) -> bool:
    """Answer a BaseHTTPRequestHandler's upgrade request with 101.
    Returns False (and a 400) if the client sent no websocket key."""
    key = h.headers.get("Sec-WebSocket-Key", "")
    if not key:
        h.send_response(400)
        h.end_headers()
        return False
    h.send_response(101, "Switching Protocols")
    h.send_header("Upgrade", "websocket")
    h.send_header("Connection", "Upgrade")
    h.send_header("Sec-WebSocket-Accept", accept_key(key))
    h.end_headers()
    return True


def client_connect(host: str, port: int, path: str,
                   timeout: float = 30.0,
                   headers: Optional[Dict[str, str]] = None,
                   ssl_context=None, sock=None) -> socket.socket:
    """Open a websocket as a client: TCP connect (TLS-wrapped when an
    ssl_context is given), HTTP upgrade carrying any extra headers
    (Authorization — the kubeconfig credential role). Returns the socket
    positioned after the 101 response headers.

    sock: an already-connected transport (anything with sendall/recv/
    settimeout/close — e.g. a tunneler TunnelConn) to upgrade in place
    instead of dialing; ssl_context is ignored then."""
    if sock is None:
        sock = socket.create_connection((host, port), timeout=timeout)
    try:
        if ssl_context is not None and isinstance(sock, socket.socket):
            sock = ssl_context.wrap_socket(sock, server_hostname=host)
        key = base64.b64encode(os.urandom(16)).decode()
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        req = (f"GET {path} HTTP/1.1\r\n"
               f"Host: {host}:{port}\r\n"
               "Upgrade: websocket\r\n"
               "Connection: Upgrade\r\n"
               f"Sec-WebSocket-Key: {key}\r\n"
               "Sec-WebSocket-Version: 13\r\n"
               f"{extra}\r\n")
        sock.sendall(req.encode())
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = sock.recv(4096)
            if not chunk:
                raise ConnectionError("upgrade: connection closed")
            buf += chunk
            if len(buf) > 65536:
                raise ConnectionError("upgrade: oversized response")
        head, rest = buf.split(b"\r\n\r\n", 1)
        status = head.split(b"\r\n", 1)[0]
        if b"101" not in status:
            raise ConnectionError(f"upgrade refused: {status.decode()}")
        sock.settimeout(None)
        if rest:
            # server-speaks-first targets (SMTP/SSH banners): the pod's
            # first frame can coalesce with the 101 — hand the leftover
            # bytes back ahead of the socket
            return _PrefixedSocket(sock, rest)
        return sock
    except BaseException:
        sock.close()
        raise


class _PrefixedSocket:
    """A socket whose recv drains buffered bytes first (the tail of the
    TCP segment that carried the upgrade response). Delegates the rest
    of the socket surface."""

    def __init__(self, sock: socket.socket, prefix: bytes):
        self._sock = sock
        self._prefix = prefix

    def recv(self, n: int) -> bytes:
        if self._prefix:
            out, self._prefix = self._prefix[:n], self._prefix[n:]
            return out
        return self._sock.recv(n)

    def __getattr__(self, name):
        return getattr(self._sock, name)


def _xor_mask(payload: bytes, key: bytes) -> bytes:
    """RFC 6455 masking. A per-byte Python loop caps the forward data
    plane at tens of MB/s; XOR of big ints runs at memcpy-ish speed for
    the 64KiB frames the pumps emit."""
    n = len(payload)
    reps = (n + 3) // 4
    p = int.from_bytes(payload, "little")
    m = int.from_bytes((key * reps)[:n], "little")
    return (p ^ m).to_bytes(n, "little")


def _read_exact(read: Callable[[int], bytes], n: int) -> bytes:
    out = bytearray()
    while len(out) < n:
        chunk = read(n - len(out))
        if not chunk:
            raise ConnectionError("websocket: short read")
        out += chunk
    return bytes(out)


def read_frame(read: Callable[[int], bytes]) -> Tuple[int, bytes]:
    """-> (opcode, payload), unmasking if the client masked (clients
    MUST mask per RFC 6455; servers must not). Frames beyond MAX_FRAME
    are rejected before any payload is buffered."""
    head = _read_exact(read, 2)
    opcode = head[0] & 0x0F
    masked = bool(head[1] & 0x80)
    ln = head[1] & 0x7F
    if ln == 126:
        ln = int.from_bytes(_read_exact(read, 2), "big")
    elif ln == 127:
        ln = int.from_bytes(_read_exact(read, 8), "big")
    if ln > MAX_FRAME:
        raise ConnectionError(f"websocket: {ln}-byte frame exceeds cap")
    mask = _read_exact(read, 4) if masked else b""
    payload = _read_exact(read, ln) if ln else b""
    if masked and payload:
        payload = _xor_mask(payload, mask)
    return opcode, payload


def write_frame(write: Callable[[bytes], None], payload: bytes,
                opcode: int = BINARY, mask: bool = False) -> None:
    head = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([(0x80 if mask else 0) | n])
    elif n < 1 << 16:
        head += bytes([(0x80 if mask else 0) | 126]) + n.to_bytes(2, "big")
    else:
        head += bytes([(0x80 if mask else 0) | 127]) + n.to_bytes(8, "big")
    if mask:
        key = os.urandom(4)
        write(head + key + _xor_mask(payload, key))
    else:
        write(head + payload)


def _pump_sock_to_ws(sock: socket.socket, write: Callable[[bytes], None],
                     mask: bool, close_on_eof: bool) -> None:
    """TCP bytes -> binary frames. On EOF: the pod-facing side sends
    CLOSE (the response stream is complete — the session is over); the
    client side sends the half-close marker and lets the reverse
    direction keep flowing."""
    try:
        while True:
            data = sock.recv(65536)
            if not data:
                break
            write_frame(write, data, BINARY, mask=mask)
        write_frame(write, b"" if close_on_eof else EOF_MARKER,
                    CLOSE if close_on_eof else TEXT, mask=mask)
    except (ConnectionError, OSError, ValueError):
        try:
            write_frame(write, b"", CLOSE, mask=mask)
        except (ConnectionError, OSError, ValueError):
            pass


def _pump_ws_to_sock(read: Callable[[int], bytes],
                     sock: socket.socket) -> str:
    """Frames -> TCP bytes. Returns 'close' (peer ended the session),
    'eof' (peer half-closed; reverse data may still flow), or 'error'."""
    try:
        while True:
            opcode, payload = read_frame(read)
            if opcode == CLOSE:
                try:
                    sock.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
                return "close"
            if opcode == TEXT and payload == EOF_MARKER:
                try:
                    sock.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
                return "eof"
            if opcode in (PING, PONG):
                continue
            if payload:
                sock.sendall(payload)
    except (ConnectionError, OSError, ValueError):
        try:
            sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass
        return "error"


def bridge(ws_read: Callable[[int], bytes],
           ws_write: Callable[[bytes], None],
           sock: socket.socket, mask: bool = False,
           pod_side: bool = False) -> None:
    """Bidirectional ws <-> TCP pump. Returns when the session is over:
    both directions drained, or the peer sent CLOSE, or transport error.
    pod_side=True marks the leg whose sock EOF means 'session complete'
    (the kubelet sends CLOSE then); the client leg propagates local EOF
    as a half-close marker instead. Caller closes sock afterwards."""
    t = threading.Thread(
        target=_pump_sock_to_ws, args=(sock, ws_write, mask,
                                       pod_side), daemon=True)
    t.start()
    reason = _pump_ws_to_sock(ws_read, sock)
    if reason in ("close", "error"):
        # session over: unblock the reader thread's recv
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
    # 'eof': the peer half-closed — keep pumping sock -> ws until the
    # sock side finishes (that is the whole point of half-close)
    t.join()


def _pump_ws_to_ws(read: Callable[[int], bytes],
                   write: Callable[[bytes], None], mask: bool) -> None:
    """Re-frame from one websocket to another, preserving data opcodes
    (the half-close TEXT marker must survive the relay). Forwards CLOSE
    and ends."""
    try:
        while True:
            opcode, payload = read_frame(read)
            if opcode == CLOSE:
                write_frame(write, b"", CLOSE, mask=mask)
                return
            if opcode in (PING, PONG):
                continue
            write_frame(write, payload, opcode, mask=mask)
    except (ConnectionError, OSError, ValueError):
        try:
            write_frame(write, b"", CLOSE, mask=mask)
        except (ConnectionError, OSError, ValueError):
            pass


def relay_ws(down_read: Callable[[int], bytes],
             down_write: Callable[[bytes], None],
             up_sock: socket.socket) -> None:
    """Bidirectional websocket relay: downstream server leg <-> an
    already-upgraded upstream client socket (the apiserver's
    portforward middle leg; upstream writes are re-masked because the
    relay is itself a client). Returns when both directions are done;
    caller closes up_sock."""

    def up_write(b: bytes) -> None:
        up_sock.sendall(b)

    def up_read(n: int) -> bytes:
        return up_sock.recv(n)

    t = threading.Thread(target=_pump_ws_to_ws,
                         args=(up_read, down_write, False), daemon=True)
    t.start()
    _pump_ws_to_ws(down_read, up_write, True)
    # downstream leg done (client closed or sent CLOSE): unblock the
    # upstream reader so its pump can forward the final CLOSE and end.
    # up_sock may be a plain socket, a TunnelConn, or a _PrefixedSocket
    # over either — anything socket-like; a missing shutdown must not
    # turn teardown into a spurious 500 on the hijacked connection
    try:
        up_sock.shutdown(socket.SHUT_RDWR)
    except (OSError, AttributeError):
        pass
    t.join(timeout=10)
