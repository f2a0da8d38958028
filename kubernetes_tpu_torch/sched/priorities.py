"""Priority functions — bit-exact re-statement of the reference's scoring.

Reference: plugin/pkg/scheduler/algorithm/priorities/priorities.go and
selector_spreading.go. All scores are ints 0..10; callers weight and sum.

Parity-critical details preserved:
  - calculateScore (priorities.go:33): integer division truncation;
    capacity 0 -> 0; requested > capacity -> 0.
  - Nonzero defaults for request-less containers: 100 milliCPU, 200MiB
    (priorities.go:53-54, getNonzeroRequests:58) — applied per-container,
    and an explicit request of 0 stays 0.
  - LeastRequested final score int((cpu_score + mem_score) / 2)
    (priorities.go:112).
  - BalancedResourceAllocation: float fractions, >= 1 on either axis -> 0,
    else int(10 - abs(diff) * 10) (priorities.go:181-242).
  - SelectorSpread counts matching pods per node INCLUDING unassigned pods
    (their count lands under node "" and participates in maxCount,
    selector_spreading.go:80-97); score = int(10 * (max-count)/max).
  - ServiceAntiAffinity: unlabeled nodes always score 0
    (selector_spreading.go:188-191).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..core import labels as labelspkg
from ..core import types as api
from .api import HostPriority
from .predicates import _capacity as _cap_resource
from .predicates import map_pods_to_machines

DEFAULT_MILLI_CPU_REQUEST = 100                 # ref: priorities.go:53
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024      # ref: priorities.go:54


def calculate_score(requested: int, capacity: int) -> int:
    """(ref: priorities.go:33 calculateScore — integer division!)"""
    if capacity == 0:
        return 0
    if requested > capacity:
        return 0
    return ((capacity - requested) * 10) // capacity


def get_nonzero_requests(requests: Dict[str, api.Quantity]) -> Tuple[int, int]:
    """(ref: priorities.go:58 getNonzeroRequests — absent key defaults,
    explicit zero stays zero)"""
    cpu = requests["cpu"].milli if "cpu" in requests else DEFAULT_MILLI_CPU_REQUEST
    mem = requests["memory"].value if "memory" in requests else DEFAULT_MEMORY_REQUEST
    return cpu, mem


def _nonzero_totals(pod: api.Pod, pods: Sequence[api.Pod]) -> Tuple[int, int]:
    total_cpu = 0
    total_mem = 0
    for existing in pods:
        for c in existing.spec.containers:
            cpu, mem = get_nonzero_requests(c.resources.requests)
            total_cpu += cpu
            total_mem += mem
    for c in pod.spec.containers:
        cpu, mem = get_nonzero_requests(c.resources.requests)
        total_cpu += cpu
        total_mem += mem
    return total_cpu, total_mem


def _cap(node: api.Node, resource: str) -> int:
    return _cap_resource(node, resource)


def calculate_resource_occupancy(pod: api.Pod, node: api.Node,
                                 pods: Sequence[api.Pod]) -> HostPriority:
    """(ref: priorities.go:77 calculateResourceOccupancy)"""
    total_cpu, total_mem = _nonzero_totals(pod, pods)
    cpu_score = calculate_score(total_cpu, _cap(node, "cpu"))
    mem_score = calculate_score(total_mem, _cap(node, "memory"))
    return HostPriority(node.metadata.name, (cpu_score + mem_score) // 2)


def least_requested_priority(pod: api.Pod, pod_lister,
                             node_lister) -> List[HostPriority]:
    """(ref: priorities.go:118 LeastRequestedPriority)"""
    nodes = node_lister.list()
    pods_by_machine = map_pods_to_machines(pod_lister)
    return [calculate_resource_occupancy(
                pod, n, pods_by_machine.get(n.metadata.name, []))
            for n in nodes]


def calculate_balanced_resource_allocation(pod: api.Pod, node: api.Node,
                                           pods: Sequence[api.Pod]
                                           ) -> HostPriority:
    """(ref: priorities.go:198 calculateBalancedResourceAllocation)"""
    total_cpu, total_mem = _nonzero_totals(pod, pods)
    cpu_fraction = _fraction(total_cpu, _cap(node, "cpu"))
    mem_fraction = _fraction(total_mem, _cap(node, "memory"))
    if cpu_fraction >= 1 or mem_fraction >= 1:
        score = 0
    else:
        diff = abs(cpu_fraction - mem_fraction)
        score = int(10 - diff * 10)
    return HostPriority(node.metadata.name, score)


def _fraction(requested: int, capacity: int) -> float:
    if capacity == 0:
        return 1.0
    return requested / capacity


def balanced_resource_allocation(pod: api.Pod, pod_lister,
                                 node_lister) -> List[HostPriority]:
    """(ref: priorities.go:181 BalancedResourceAllocation)"""
    nodes = node_lister.list()
    pods_by_machine = map_pods_to_machines(pod_lister)
    return [calculate_balanced_resource_allocation(
                pod, n, pods_by_machine.get(n.metadata.name, []))
            for n in nodes]


def new_node_label_priority(label: str, presence: bool):
    """(ref: priorities.go:148 CalculateNodeLabelPriority — 0 or 10)"""
    def calculate_node_label_priority(pod, pod_lister, node_lister):
        out = []
        for node in node_lister.list():
            exists = label in node.metadata.labels
            success = (exists and presence) or (not exists and not presence)
            out.append(HostPriority(node.metadata.name, 10 if success else 0))
        return out
    return calculate_node_label_priority


def equal_priority(pod: api.Pod, pod_lister, node_lister) -> List[HostPriority]:
    """(ref: generic_scheduler.go:227 EqualPriority — everyone scores 1)"""
    return [HostPriority(n.metadata.name, 1) for n in node_lister.list()]


# ----------------------------------------------------------- spreading

class SelectorSpread:
    """(ref: selector_spreading.go:28-114 SelectorSpread)"""

    def __init__(self, service_lister, controller_lister=None):
        self.service_lister = service_lister
        self.controller_lister = controller_lister

    def calculate_spread_priority(self, pod: api.Pod, pod_lister,
                                  node_lister) -> List[HostPriority]:
        selectors: List[labelspkg.Selector] = []
        if self.service_lister is not None:
            for svc in self.service_lister.get_pod_services(pod):
                selectors.append(labelspkg.selector_from_set(svc.spec.selector))
        if self.controller_lister is not None:
            for rc in self.controller_lister.get_pod_controllers(pod):
                selectors.append(labelspkg.selector_from_set(rc.spec.selector))

        ns_pods: List[api.Pod] = []
        if selectors:
            ns_pods = [p for p in pod_lister.list(labelspkg.everything())
                       if p.metadata.namespace == pod.metadata.namespace]

        counts: Dict[str, int] = {}
        max_count = 0
        for p in ns_pods:
            if any(sel.matches(p.metadata.labels) for sel in selectors):
                host = p.spec.node_name  # unassigned pods count under ""
                counts[host] = counts.get(host, 0) + 1
                max_count = max(max_count, counts[host])

        out = []
        for node in node_lister.list():
            score = 10.0
            if max_count > 0:
                score = 10 * (max_count - counts.get(node.metadata.name, 0)) / max_count
            out.append(HostPriority(node.metadata.name, int(score)))
        return out


class ServiceAntiAffinity:
    """Spread a service's pods across values of a node label — zones
    (ref: selector_spreading.go:117-196 ServiceAntiAffinity)."""

    def __init__(self, service_lister, label: str):
        self.service_lister = service_lister
        self.label = label

    def calculate_anti_affinity_priority(self, pod: api.Pod, pod_lister,
                                         node_lister) -> List[HostPriority]:
        ns_service_pods: List[api.Pod] = []
        services = self.service_lister.get_pod_services(pod)
        if services:
            sel = labelspkg.selector_from_set(services[0].spec.selector)
            ns_service_pods = [p for p in pod_lister.list(sel)
                               if p.metadata.namespace == pod.metadata.namespace]

        labeled: Dict[str, str] = {}
        other: List[str] = []
        for node in node_lister.list():
            if self.label in node.metadata.labels:
                labeled[node.metadata.name] = node.metadata.labels[self.label]
            else:
                other.append(node.metadata.name)

        pod_counts: Dict[str, int] = {}
        for p in ns_service_pods:
            value = labeled.get(p.spec.node_name)
            if value is None:
                continue
            pod_counts[value] = pod_counts.get(value, 0) + 1

        num_service_pods = len(ns_service_pods)
        out = []
        for node_name, value in labeled.items():
            score = 10.0
            if num_service_pods > 0:
                score = 10 * (num_service_pods - pod_counts.get(value, 0)) / num_service_pods
            out.append(HostPriority(node_name, int(score)))
        for node_name in other:
            out.append(HostPriority(node_name, 0))
        return out
