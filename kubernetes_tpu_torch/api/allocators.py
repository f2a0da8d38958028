"""Service cluster-IP and node-port allocators.

Reference: pkg/registry/service with pkg/registry/service/ipallocator
(bitmap over the service CIDR, network/broadcast excluded) and
portallocator (the node-port range, default 30000-32767). The service
REST strategy allocates on create, honors explicit requests, rejects
collisions, and releases on delete.
"""

from __future__ import annotations

import ipaddress
import threading
from typing import Optional, Set

from ..core.errors import Invalid


class AllocationError(Invalid):
    pass


class IPAllocator:
    """(ref: ipallocator.Range)"""

    def __init__(self, cidr: str = "10.0.0.0/24"):
        self.network = ipaddress.ip_network(cidr)
        self._base = int(self.network.network_address)
        # usable host addresses: skip network and broadcast
        self._size = self.network.num_addresses - 2
        if self._size <= 0:
            raise AllocationError(f"service CIDR {cidr} has no usable IPs")
        self._used: Set[int] = set()
        self._next = 0
        self._lock = threading.Lock()

    def allocate(self) -> str:
        with self._lock:
            for probe in range(self._size):
                offset = (self._next + probe) % self._size
                if offset not in self._used:
                    self._used.add(offset)
                    self._next = (offset + 1) % self._size
                    return str(ipaddress.ip_address(
                        self._base + 1 + offset))
            raise AllocationError(
                f"service CIDR {self.network} is exhausted")

    def allocate_specific(self, ip: str) -> str:
        try:
            addr = ipaddress.ip_address(ip)
        except ValueError:
            raise AllocationError(f"invalid IP address {ip!r}")
        if addr not in self.network:
            raise AllocationError(
                f"IP {ip} is not in the service CIDR {self.network}")
        offset = int(addr) - self._base - 1
        if offset < 0 or offset >= self._size:
            raise AllocationError(f"IP {ip} is reserved")
        with self._lock:
            if offset in self._used:
                raise AllocationError(f"IP {ip} is already allocated")
            self._used.add(offset)
        return ip

    def release(self, ip: str) -> None:
        try:
            offset = int(ipaddress.ip_address(ip)) - self._base - 1
        except ValueError:
            return
        with self._lock:
            self._used.discard(offset)

    def has(self, ip: str) -> bool:
        try:
            offset = int(ipaddress.ip_address(ip)) - self._base - 1
        except ValueError:
            return False
        with self._lock:
            return offset in self._used


class PortAllocator:
    """(ref: service/portallocator.PortAllocator; default range
    --service-node-port-range=30000-32767)"""

    def __init__(self, base: int = 30000, size: int = 2768):
        self.base = base
        self.size = size
        self._used: Set[int] = set()
        self._next = 0
        self._lock = threading.Lock()

    def allocate(self) -> int:
        with self._lock:
            for probe in range(self.size):
                offset = (self._next + probe) % self.size
                if offset not in self._used:
                    self._used.add(offset)
                    self._next = (offset + 1) % self.size
                    return self.base + offset
            raise AllocationError("node-port range is exhausted")

    def allocate_specific(self, port: int) -> int:
        offset = port - self.base
        if offset < 0 or offset >= self.size:
            raise AllocationError(
                f"port {port} is outside the node-port range "
                f"{self.base}-{self.base + self.size - 1}")
        with self._lock:
            if offset in self._used:
                raise AllocationError(f"port {port} is already allocated")
            self._used.add(offset)
        return port

    def release(self, port: int) -> None:
        with self._lock:
            self._used.discard(port - self.base)
