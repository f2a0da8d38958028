"""Cloud provider interfaces and the in-memory fake.

Reference: pkg/cloudprovider/cloud.go:
    Interface { TCPLoadBalancer() Instances() Zones() Routes() }
and pkg/cloudprovider/providers/fake/fake.go (call-recording fake).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class LoadBalancer:
    name: str = ""
    region: str = ""
    external_ip: str = ""
    ports: List[int] = field(default_factory=list)
    hosts: List[str] = field(default_factory=list)


@dataclass
class Zone:
    failure_domain: str = ""
    region: str = ""


@dataclass
class Route:
    name: str = ""
    target_instance: str = ""
    destination_cidr: str = ""


class Instances:
    def node_addresses(self, name: str) -> List[str]:
        raise NotImplementedError

    def external_id(self, name: str) -> str:
        raise NotImplementedError

    def list_instances(self, name_filter: str = "") -> List[str]:
        raise NotImplementedError


class LoadBalancers:
    """(ref: cloud.go TCPLoadBalancer interface)"""

    def get(self, name: str, region: str) -> Optional[LoadBalancer]:
        raise NotImplementedError

    def list(self) -> List[LoadBalancer]:
        """All balancers this provider manages (for orphan GC)."""
        raise NotImplementedError

    # whether ensure() can honor a requested address at all — AWS
    # classic ELBs cannot (aws.go rejects a requested publicIP); the
    # controller consults this BEFORE tearing anything down
    supports_load_balancer_ip: bool = True

    def ensure(self, name: str, region: str, ports: List[int],
               hosts: List[str],
               load_balancer_ip: str = "") -> LoadBalancer:
        """load_balancer_ip: the service's requested address (ref:
        EnsureTCPLoadBalancer's externalIP parameter) — honored by
        providers that support address reservation, best-effort
        elsewhere."""
        raise NotImplementedError

    def update_hosts(self, name: str, region: str,
                     hosts: List[str]) -> None:
        raise NotImplementedError

    def delete(self, name: str, region: str) -> None:
        raise NotImplementedError


class Zones:
    def get_zone(self) -> Zone:
        raise NotImplementedError


class Routes:
    def list_routes(self, name_filter: str = "") -> List[Route]:
        raise NotImplementedError

    def create_route(self, route: Route) -> None:
        raise NotImplementedError

    def delete_route(self, name: str) -> None:
        raise NotImplementedError


class CloudProvider:
    """(ref: cloud.go Interface; any facet may be unsupported -> None)"""

    def instances(self) -> Optional[Instances]:
        return None

    def load_balancers(self) -> Optional[LoadBalancers]:
        return None

    def zones(self) -> Optional[Zones]:
        return None

    def routes(self) -> Optional[Routes]:
        return None

    # cloud disk attach surface used by the volume plugins
    def attach_disk(self, disk_name: str, node: str) -> None:
        raise NotImplementedError

    def detach_disk(self, disk_name: str, node: str) -> None:
        raise NotImplementedError


class FakeCloudProvider(CloudProvider, Instances, LoadBalancers, Zones,
                        Routes):
    """Records every call; serves canned data (ref: fake/fake.go)."""

    def __init__(self, zone: str = "us-central1-a",
                 region: str = "us-central1"):
        self.zone = zone
        self.region = region
        self.calls: List[str] = []
        self.balancers: Dict[Tuple[str, str], LoadBalancer] = {}
        self.routes_by_name: Dict[str, Route] = {}
        self.attached: Dict[str, str] = {}  # disk -> node
        self.instance_list: List[str] = []
        self._ip_counter = 0
        self._lock = threading.Lock()

    # facets
    def instances(self):
        return self

    def load_balancers(self):
        return self

    def zones(self):
        return self

    def routes(self):
        return self

    # Instances
    def node_addresses(self, name: str) -> List[str]:
        self.calls.append(f"node-addresses:{name}")
        return ["10.1.0.1"]

    def external_id(self, name: str) -> str:
        self.calls.append(f"external-id:{name}")
        return f"ext-{name}"

    def list_instances(self, name_filter: str = "") -> List[str]:
        return [i for i in self.instance_list if name_filter in i]

    # LoadBalancers
    def get(self, name: str, region: str) -> Optional[LoadBalancer]:
        with self._lock:
            return self.balancers.get((name, region))

    def list(self) -> List[LoadBalancer]:
        with self._lock:
            return list(self.balancers.values())

    def ensure(self, name: str, region: str, ports: List[int],
               hosts: List[str],
               load_balancer_ip: str = "") -> LoadBalancer:
        self.calls.append(f"ensure-lb:{name}")
        with self._lock:
            lb = self.balancers.get((name, region))
            if lb is None:
                self._ip_counter += 1
                lb = LoadBalancer(name=name, region=region,
                                  external_ip=(load_balancer_ip
                                               or f"35.0.0.{self._ip_counter}"))
                self.balancers[(name, region)] = lb
            lb.ports = list(ports)
            lb.hosts = list(hosts)
            return lb

    def update_hosts(self, name: str, region: str,
                     hosts: List[str]) -> None:
        self.calls.append(f"update-hosts:{name}")
        with self._lock:
            lb = self.balancers.get((name, region))
            if lb is not None:
                lb.hosts = list(hosts)

    def delete(self, name: str, region: str) -> None:
        self.calls.append(f"delete-lb:{name}")
        with self._lock:
            self.balancers.pop((name, region), None)

    # Zones
    def get_zone(self) -> Zone:
        return Zone(failure_domain=self.zone, region=self.region)

    # Routes
    def list_routes(self, name_filter: str = "") -> List[Route]:
        with self._lock:
            return [r for r in self.routes_by_name.values()
                    if name_filter in r.name]

    def create_route(self, route: Route) -> None:
        self.calls.append(f"create-route:{route.name}")
        with self._lock:
            self.routes_by_name[route.name] = route

    def delete_route(self, name: str) -> None:
        self.calls.append(f"delete-route:{name}")
        with self._lock:
            self.routes_by_name.pop(name, None)

    # disks
    def attach_disk(self, disk_name: str, node: str) -> None:
        self.calls.append(f"attach:{disk_name}:{node}")
        with self._lock:
            self.attached[disk_name] = node

    def detach_disk(self, disk_name: str, node: str) -> None:
        self.calls.append(f"detach:{disk_name}:{node}")
        with self._lock:
            self.attached.pop(disk_name, None)
