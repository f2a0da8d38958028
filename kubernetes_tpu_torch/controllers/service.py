"""Service (cloud load balancer) + route controllers.

Reference: pkg/controller/servicecontroller.go — LoadBalancer-type
services get a cloud LB spanning the cluster's nodes; deletes tear it
down — and pkg/controller/routecontroller.go — one cloud route per node
toward its pod CIDR. Both program the cloudprovider interface.
"""

from __future__ import annotations

import threading
from dataclasses import replace
from typing import Dict, List, Optional

from ..cloudprovider import CloudProvider, Route
from ..core import types as api

SYNC_PERIOD = 10.0

# LB names derive from the service UID (the reference's cloudprovider
# naming, e.g. GCE's "a<uid>"): "a" + first 12 uid chars
_LB_NAME_LEN = 13


def _lb_name(svc: api.Service) -> str:
    if svc.metadata.uid:
        return f"a{svc.metadata.uid[:12]}"
    return f"a{svc.metadata.namespace}-{svc.metadata.name}"[:_LB_NAME_LEN]


def _is_owned_lb_name(name: str) -> bool:
    return len(name) == _LB_NAME_LEN and name.startswith("a")


class ServiceController:
    def __init__(self, client, cloud: CloudProvider,
                 sync_period: float = SYNC_PERIOD, recorder=None):
        self.client = client
        self.cloud = cloud
        self.recorder = recorder
        self.sync_period = sync_period
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # lb name -> the requested address already attempted once (the
        # recreate-on-mismatch path fires a single time per value)
        self._ip_attempts: Dict[str, str] = {}

    def sync_once(self) -> int:
        balancers = self.cloud.load_balancers()
        zones = self.cloud.zones()
        if balancers is None:
            return 0
        region = zones.get_zone().region if zones else ""
        try:
            services, _ = self.client.list("services")
            nodes, _ = self.client.list("nodes")
        except Exception:
            return 0
        hosts = sorted(n.metadata.name for n in nodes)
        actions = 0
        wanted = set()
        for svc in services:
            lb_name = _lb_name(svc)
            if svc.spec.type != "LoadBalancer":
                if svc.status.load_balancer_ingress:
                    # downgraded from LoadBalancer: the GC below removes
                    # the cloud LB; the stale external IP must go too
                    try:
                        self.client.update_status("services", replace(
                            svc, status=api.ServiceStatus()),
                            svc.metadata.namespace)
                        actions += 1
                    except Exception:
                        pass
                continue
            wanted.add(lb_name)
            # one broken service (bad loadBalancerIP, provider error)
            # must not kill reconciliation for every other service —
            # the reference's controller records the error per service
            # and keeps going (servicecontroller.go processDelta)
            try:
                lb = balancers.get(lb_name, region)
                # order-insensitive: providers report ports sorted (ELB
                # listeners and GCE rules have no spec order to
                # preserve)
                ports = sorted(p.port for p in svc.spec.ports)
                want_ip = svc.spec.load_balancer_ip
                if want_ip and not getattr(
                        balancers, "supports_load_balancer_ip", True):
                    # capability check BEFORE any mutation (aws.go
                    # rejects a requested publicIP up front): never
                    # tear down a working LB chasing an address the
                    # provider cannot grant
                    if self.recorder:
                        self.recorder.eventf(
                            svc, "Warning", "LoadBalancerIPUnsupported",
                            "provider cannot honor loadBalancerIP %s; "
                            "keeping the provider-assigned address",
                            want_ip)
                    want_ip = ""
                if (lb is not None and want_ip
                        and lb.external_ip != want_ip
                        and self._ip_attempts.get(lb_name) != want_ip):
                    # the requested address is honored at creation only
                    # (forwarding rules/vips are address-immutable):
                    # recreate ONCE per requested value, like gce.go's
                    # forwardingRuleNeedsUpdate IPAddress check — a
                    # provider that grants a different address anyway
                    # must not trigger delete/recreate churn every sync
                    balancers.delete(lb_name, region)
                    lb = None
                if lb is None or sorted(lb.ports) != ports \
                        or lb.hosts != hosts:
                    lb = balancers.ensure(
                        lb_name, region, ports, hosts,
                        load_balancer_ip=want_ip)
                    actions += 1
                if want_ip:
                    self._ip_attempts[lb_name] = want_ip
                    if lb.external_ip != want_ip and self.recorder:
                        self.recorder.eventf(
                            svc, "Warning", "LoadBalancerIPNotGranted",
                            "requested %s, provider granted %s",
                            want_ip, lb.external_ip)
            except Exception as e:
                if self.recorder:
                    self.recorder.eventf(
                        svc, "Warning", "CreatingLoadBalancerFailed",
                        "Error creating load balancer: %s", e)
                continue
            ingress = [lb.external_ip]
            if svc.status.load_balancer_ingress != ingress:
                try:
                    self.client.update_status("services", replace(
                        svc, status=api.ServiceStatus(
                            load_balancer_ingress=ingress)),
                        svc.metadata.namespace)
                except Exception:
                    pass
        # prune one-shot recreate suppressions for balancers outside the
        # wanted set: a deleted-then-recreated service mints a new uid
        # (new lb name), but a same-name recreate under a provider that
        # reuses uids — or a service flapping LoadBalancer<->ClusterIP —
        # must get its one recreate attempt back instead of inheriting
        # the dead entry forever (the map also stops leaking an entry
        # per deleted service)
        for name in [n for n in self._ip_attempts if n not in wanted]:
            del self._ip_attempts[name]
        # tear down balancers whose service is gone or downgraded — via
        # the interface's list(), and ONLY balancers carrying this
        # controller's naming convention: LBs we never created (operators,
        # other clusters on the same provider) are not ours to delete
        try:
            existing = balancers.list()
        except NotImplementedError:
            existing = []
        for lb in existing:
            if lb.name not in wanted and _is_owned_lb_name(lb.name):
                balancers.delete(lb.name, lb.region)
                actions += 1
        return actions

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.sync_once()
            except Exception:
                pass  # transient provider failure: next period retries
            self._stop.wait(self.sync_period)

    def run(self) -> "ServiceController":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="service-controller")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)


class RouteController:
    """(ref: routecontroller.go — reconcile node routes)"""

    def __init__(self, client, cloud: CloudProvider,
                 cluster_cidr: str = "10.244.0.0/16",
                 sync_period: float = SYNC_PERIOD):
        self.client = client
        self.cloud = cloud
        self.cluster_cidr = cluster_cidr
        self.sync_period = sync_period
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _in_cluster_cidr(self, cidr: str) -> bool:
        import ipaddress
        try:
            return ipaddress.ip_network(cidr).subnet_of(
                ipaddress.ip_network(self.cluster_cidr))
        except ValueError:
            return False

    def sync_once(self) -> int:
        routes = self.cloud.routes()
        if routes is None:
            return 0
        try:
            nodes, _ = self.client.list("nodes")
        except Exception:
            return 0
        # reconcile by TARGET INSTANCE, not route name
        # (routecontroller.go:73 routeMap[route.TargetInstance]): the
        # route's cloud-side name is provider-internal — EC2 routes
        # have none at all (identity = destination CIDR), GCE names
        # are mangled — so node association is the only portable key
        existing = routes.list_routes()
        by_target = {r.target_instance: r for r in existing}
        node_cidrs = {}
        refreshed = set()  # targets re-created THIS pass: their stale
        #                    entry in `existing` must not be GC'd again
        actions = 0
        for node in nodes:
            if not node.spec.pod_cidr:
                # no CIDR assigned yet: nothing to route (the reference
                # waits for the node controller's CIDR allocation)
                continue
            name = node.metadata.name
            cidr = node.spec.pod_cidr
            node_cidrs[name] = cidr
            route = by_target.get(name)
            if route is None or route.destination_cidr != cidr:
                if route is not None:
                    # CIDR reassigned: drop the stale route first — the
                    # Routes contract doesn't promise overwrite
                    routes.delete_route(route.name)
                routes.create_route(Route(
                    name=f"route-{name}", target_instance=name,
                    destination_cidr=cidr))
                refreshed.add(name)
                actions += 1
        for route in existing:
            if route.target_instance in refreshed:
                continue
            # only GC routes INSIDE the cluster CIDR — operator routes
            # are not ours to delete (routecontroller.go
            # isResponsibleForRoute)
            if node_cidrs.get(route.target_instance) != \
                    route.destination_cidr and \
                    self._in_cluster_cidr(route.destination_cidr):
                routes.delete_route(route.name)
                actions += 1
        return actions

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.sync_once()
            except Exception:
                pass  # transient provider failure: next period retries
            self._stop.wait(self.sync_period)

    def run(self) -> "RouteController":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="route-controller")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
