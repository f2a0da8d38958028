"""Endpoints controller: service selector -> Endpoints subsets.

Reference: pkg/controller/endpoint/endpoints_controller.go syncService
(:253-380): for each service with a selector, list matching pods; each pod
with an IP contributes one address per service port (named targetPorts
resolve against container ports, findPort :403); ready pods land in
``addresses``, unready in ``not_ready_addresses``; subsets are repacked so
addresses sharing an identical port set merge (pkg/api/endpoints
RepackSubsets); no-op updates are skipped; a deleted service deletes its
Endpoints object.
"""

from __future__ import annotations

from dataclasses import replace
from typing import List, Optional, Tuple

from ..api.cache import Informer, meta_namespace_key
from ..core import types as api
from ..core.errors import NotFound
from ..core.labels import selector_from_set
from .framework import QueueWorkers, is_pod_ready


def find_port(pod: api.Pod, service_port: api.ServicePort) -> Optional[int]:
    """(endpoints_controller.go:403 findPort) int targetPort used as-is;
    str targetPort looked up among container port names; empty targetPort
    falls back to the service port number."""
    tp = service_port.target_port
    if isinstance(tp, int):
        return tp
    if isinstance(tp, str) and tp:
        for container in pod.spec.containers:
            for port in container.ports:
                if port.name == tp and port.protocol == \
                        (service_port.protocol or "TCP"):
                    return port.container_port
        return None
    return service_port.port or None


def repack_subsets(entries: List[Tuple[api.EndpointAddress, bool,
                                       api.EndpointPort]]
                   ) -> List[api.EndpointSubset]:
    """Merge addresses that share an identical port set
    (pkg/api/endpoints/util.go RepackSubsets)."""
    # per-address port accumulation first
    by_addr: dict = {}
    for addr, ready, port in entries:
        key = (addr.ip, addr.target_ref.name if addr.target_ref else "")
        rec = by_addr.setdefault(key, {"addr": addr, "ready": ready,
                                       "ports": []})
        rec["ports"].append(port)
    # group addresses by their full port set
    by_ports: dict = {}
    for rec in by_addr.values():
        pkey = tuple(sorted((p.name, p.port, p.protocol)
                            for p in rec["ports"]))
        grp = by_ports.setdefault(pkey, {"ports": rec["ports"],
                                         "ready": [], "unready": []})
        (grp["ready"] if rec["ready"] else grp["unready"]).append(rec["addr"])
    subsets = []
    for pkey in sorted(by_ports):
        grp = by_ports[pkey]
        subsets.append(api.EndpointSubset(
            addresses=sorted(grp["ready"], key=lambda a: a.ip),
            not_ready_addresses=sorted(grp["unready"], key=lambda a: a.ip),
            ports=sorted(grp["ports"],
                         key=lambda p: (p.name, p.port, p.protocol))))
    return subsets


class EndpointsController:
    def __init__(self, client, workers: int = 5):
        self.client = client
        self.workers = QueueWorkers(self._sync, workers, name="endpoints")
        self.service_informer = Informer(
            client, "services",
            on_add=lambda s: self.workers.enqueue(meta_namespace_key(s)),
            on_update=lambda o, s: self.workers.enqueue(
                meta_namespace_key(s)),
            on_delete=lambda s: self.workers.enqueue(meta_namespace_key(s)))
        self.pod_informer = Informer(
            client, "pods",
            on_add=self._pod_changed,
            on_update=lambda o, p: self._pod_changed(p, o),
            on_delete=self._pod_changed)

    def _pod_changed(self, pod: api.Pod,
                     old: Optional[api.Pod] = None) -> None:
        for svc in self.service_informer.cache.list():
            if svc.metadata.namespace != pod.metadata.namespace:
                continue
            if not svc.spec.selector:
                continue
            sel = selector_from_set(svc.spec.selector)
            if sel.matches(pod.metadata.labels) or (
                    old is not None and sel.matches(old.metadata.labels)):
                self.workers.enqueue(meta_namespace_key(svc))

    def _sync(self, key: str) -> None:
        svc = self.service_informer.cache.get_by_key(key)
        if svc is None:
            ns, _, name = key.rpartition("/")
            try:
                self.client.delete("endpoints", name, ns)
            except NotFound:
                pass
            return
        if not svc.spec.selector:
            return  # selector-less services get out-of-band endpoints

        sel = selector_from_set(svc.spec.selector)
        entries = []
        for pod in self.pod_informer.cache.list():
            if pod.metadata.namespace != svc.metadata.namespace:
                continue
            if not sel.matches(pod.metadata.labels):
                continue
            if not pod.status.pod_ip or \
                    pod.metadata.deletion_timestamp is not None:
                continue
            for sp in svc.spec.ports or [api.ServicePort()]:
                port_num = find_port(pod, sp)
                if port_num is None:
                    continue
                entries.append((
                    api.EndpointAddress(
                        ip=pod.status.pod_ip,
                        target_ref=api.ObjectReference(
                            kind="Pod", namespace=pod.metadata.namespace,
                            name=pod.metadata.name, uid=pod.metadata.uid)),
                    is_pod_ready(pod),
                    api.EndpointPort(name=sp.name, port=port_num,
                                     protocol=sp.protocol or "TCP")))
        subsets = repack_subsets(entries)

        try:
            current = self.client.get("endpoints", svc.metadata.name,
                                      svc.metadata.namespace)
        except NotFound:
            current = None
        if current is not None and current.subsets == subsets and \
                current.metadata.labels == svc.metadata.labels:
            return  # no-op skipped (syncService :365)
        if current is None:
            self.client.create("endpoints", api.Endpoints(
                metadata=api.ObjectMeta(name=svc.metadata.name,
                                        namespace=svc.metadata.namespace,
                                        labels=dict(svc.metadata.labels)),
                subsets=subsets), svc.metadata.namespace)
        else:
            self.client.update("endpoints", replace(
                current, subsets=subsets,
                metadata=replace(current.metadata,
                                 labels=dict(svc.metadata.labels))),
                svc.metadata.namespace)

    def run(self) -> "EndpointsController":
        self.service_informer.start()
        self.pod_informer.start()
        self.workers.start()
        return self

    def stop(self) -> None:
        self.workers.stop()
        self.service_informer.stop()
        self.pod_informer.stop()
