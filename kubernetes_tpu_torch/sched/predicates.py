"""Fit predicates — bit-exact re-statement of the reference's semantics.

Reference: plugin/pkg/scheduler/algorithm/predicates/predicates.go. Every
function documents its source symbol. Signature convention: a predicate is
`fn(pod, existing_pods, node) -> (fit: bool, reason: Optional[str])`; reason
is a failure tag like the reference's FailedResourceType global
(predicates.go:148) — returning it beats mutating a global. `node` is the
api.Node object (the reference passes a node name + NodeInfo getter; our
listers hand the object over directly).

Parity-critical details preserved:
  - getResourceRequest sums requests as integer milliCPU / bytes
    (predicates.go:150).
  - CheckPodsExceedingFreeResources processes pods in list order and SKIPS
    non-fitting pods from the running sum (predicates.go:160-185) — so one
    over-capacity existing pod can fail the predicate for the new pod.
  - Zero-request pods are only checked against the pod-count capacity
    (predicates.go:198-199).
  - Capacity of 0 for cpu/memory means "unlimited" in the fit check
    (CheckPodsExceedingFreeResources: totalMilliCPU == 0 -> fitsCPU).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..core import labels as labelspkg
from ..core import types as api

PredicateResult = Tuple[bool, Optional[str]]

# failure tags (ref: predicates.go FailedResourceType values)
POD_EXCEEDS_FREE_CPU = "PodExceedsFreeCPU"
POD_EXCEEDS_FREE_MEMORY = "PodExceedsFreeMemory"
POD_EXCEEDS_MAX_POD_NUMBER = "PodExceedsMaxPodNumber"
NODE_NOT_SCHEDULABLE = "NodeNotSchedulable"


def node_schedulable(node: api.Node) -> bool:
    """Is the node a live binding target? (ref: factory.go:241
    getNodeConditionPredicate + createNodeLW's spec.unschedulable field
    selector, :281-285.)

    False when spec.unschedulable is set, when the Ready condition is
    not True (False OR Unknown — a stale-heartbeat node the
    NodeController marked Unknown is dead to the scheduler), or when
    OutOfDisk is reported anything but False. The single source of
    node-schedulability truth: the serial oracle's predicate, the
    factory's candidate filter and the device encoders' mask column all
    call this."""
    if node.spec.unschedulable:
        return False
    for cond in node.status.conditions:
        if cond.type == api.NODE_READY and cond.status != api.CONDITION_TRUE:
            return False
        if cond.type == api.NODE_OUT_OF_DISK and \
                cond.status != api.CONDITION_FALSE:
            return False
    return True


def pod_fits_node_schedulable(pod: api.Pod, existing_pods: Sequence[api.Pod],
                              node: api.Node) -> PredicateResult:
    """Node-schedulability as a fit predicate, so a node list that was
    NOT pre-filtered (static listers, mid-tile condition flips) still
    never produces a bind to a NotReady/Unknown/cordoned node."""
    if node_schedulable(node):
        return True, None
    return False, NODE_NOT_SCHEDULABLE


def get_resource_request(pod: api.Pod) -> Tuple[int, int]:
    """(milliCPU, memory bytes) summed over containers
    (ref: predicates.go:150 getResourceRequest)."""
    milli_cpu = 0
    memory = 0
    for c in pod.spec.containers:
        req = c.resources.requests
        if "cpu" in req:
            milli_cpu += req["cpu"].milli
        if "memory" in req:
            memory += req["memory"].value
    return milli_cpu, memory


def _capacity(node: api.Node, resource: str) -> int:
    q = node.status.capacity.get(resource)
    if q is None:
        return 0
    return q.milli if resource == "cpu" else q.value


def check_pods_exceeding_free_resources(
        pods: Sequence[api.Pod], node: api.Node
) -> Tuple[List[api.Pod], List[api.Pod], List[api.Pod]]:
    """(fitting, not_fitting_cpu, not_fitting_memory); order-dependent with
    skip-on-misfit accounting (ref: predicates.go:160
    CheckPodsExceedingFreeResources)."""
    total_milli_cpu = _capacity(node, "cpu")
    total_memory = _capacity(node, "memory")
    cpu_requested = 0
    mem_requested = 0
    fitting: List[api.Pod] = []
    not_cpu: List[api.Pod] = []
    not_mem: List[api.Pod] = []
    for pod in pods:
        req_cpu, req_mem = get_resource_request(pod)
        fits_cpu = total_milli_cpu == 0 or (total_milli_cpu - cpu_requested) >= req_cpu
        fits_mem = total_memory == 0 or (total_memory - mem_requested) >= req_mem
        if not fits_cpu:
            not_cpu.append(pod)
            continue
        if not fits_mem:
            not_mem.append(pod)
            continue
        cpu_requested += req_cpu
        mem_requested += req_mem
        fitting.append(pod)
    return fitting, not_cpu, not_mem


def pod_fits_resources(pod: api.Pod, existing_pods: Sequence[api.Pod],
                       node: api.Node) -> PredicateResult:
    """(ref: predicates.go:192 ResourceFit.PodFitsResources)"""
    req_cpu, req_mem = get_resource_request(pod)
    pod_cap = node.status.capacity.get("pods")
    pod_cap_value = pod_cap.value if pod_cap is not None else 0
    if req_cpu == 0 and req_mem == 0:
        # zero-request pods are only limited by the pod-count capacity;
        # the reference leaves FailedResourceType unset on this path
        # (predicates.go:198-199), so the failure map records the
        # predicate name — reason None mirrors that
        return len(existing_pods) < pod_cap_value, None
    pods = list(existing_pods) + [pod]
    _, exceeding_cpu, exceeding_mem = check_pods_exceeding_free_resources(pods, node)
    if len(pods) > pod_cap_value:
        return False, POD_EXCEEDS_MAX_POD_NUMBER
    if exceeding_cpu:
        return False, POD_EXCEEDS_FREE_CPU
    if exceeding_mem:
        return False, POD_EXCEEDS_FREE_MEMORY
    return True, None


def pod_fits_host_ports(pod: api.Pod, existing_pods: Sequence[api.Pod],
                        node: api.Node) -> PredicateResult:
    """hostPort collision (ref: predicates.go:403 PodFitsHostPorts;
    getUsedPorts :417 — port 0 means unbound and never collides)."""
    existing_ports = get_used_ports(existing_pods)
    want_ports = get_used_ports([pod])
    for port in want_ports:
        if port == 0:
            continue
        if port in existing_ports:
            return False, None
    return True, None


def get_used_ports(pods: Sequence[api.Pod]) -> Dict[int, bool]:
    ports: Dict[int, bool] = {}
    for pod in pods:
        for c in pod.spec.containers:
            for p in c.ports:
                ports[p.host_port] = True
    return ports


def pod_fits_host(pod: api.Pod, existing_pods: Sequence[api.Pod],
                  node: api.Node) -> PredicateResult:
    """spec.nodeName pinning (ref: predicates.go:258 PodFitsHost)."""
    if not pod.spec.node_name:
        return True, None
    return pod.spec.node_name == node.metadata.name, None


def pod_matches_node_labels(pod: api.Pod, node: api.Node) -> bool:
    """(ref: predicates.go:238 PodMatchesNodeLabels)"""
    if not pod.spec.node_selector:
        return True
    sel = labelspkg.selector_from_set(pod.spec.node_selector)
    return sel.matches(node.metadata.labels)


def pod_selector_matches(pod: api.Pod, existing_pods: Sequence[api.Pod],
                         node: api.Node) -> PredicateResult:
    """(ref: predicates.go:250 NodeSelector.PodSelectorMatches)"""
    return pod_matches_node_labels(pod, node), None


# ------------------------------------------------------------ disk conflict

def _have_same(a: Sequence[str], b: Sequence[str]) -> bool:
    return any(x in b for x in a)


def is_volume_conflict(volume: api.Volume, pod: api.Pod) -> bool:
    """(ref: predicates.go:75 isVolumeConflict)
    - GCE PD: same pdName conflicts unless both mounts are read-only
    - AWS EBS: same volumeID always conflicts
    - Ceph RBD: shared monitor + same pool + same image conflicts
    """
    if volume.gce_persistent_disk is not None:
        disk = volume.gce_persistent_disk
        for ev in pod.spec.volumes:
            if (ev.gce_persistent_disk is not None
                    and ev.gce_persistent_disk.pd_name == disk.pd_name
                    and not (ev.gce_persistent_disk.read_only and disk.read_only)):
                return True
    if volume.aws_elastic_block_store is not None:
        vol_id = volume.aws_elastic_block_store.volume_id
        for ev in pod.spec.volumes:
            if (ev.aws_elastic_block_store is not None
                    and ev.aws_elastic_block_store.volume_id == vol_id):
                return True
    if volume.rbd is not None:
        mon, pool, image = (volume.rbd.ceph_monitors, volume.rbd.rbd_pool,
                            volume.rbd.rbd_image)
        for ev in pod.spec.volumes:
            if ev.rbd is not None:
                if (_have_same(mon, ev.rbd.ceph_monitors)
                        and ev.rbd.rbd_pool == pool
                        and ev.rbd.rbd_image == image):
                    return True
    return False


def no_disk_conflict(pod: api.Pod, existing_pods: Sequence[api.Pod],
                     node: api.Node) -> PredicateResult:
    """(ref: predicates.go:127 NoDiskConflict)"""
    for volume in pod.spec.volumes:
        for existing in existing_pods:
            if is_volume_conflict(volume, existing):
                return False, None
    return True, None


# ------------------------------------------------------ configurable preds

def new_node_label_predicate(wanted: Sequence[str], presence: bool):
    """(ref: predicates.go:292 CheckNodeLabelPresence)"""
    def check_node_label_presence(pod, existing_pods, node) -> PredicateResult:
        node_labels = node.metadata.labels
        for label in wanted:
            exists = label in node_labels
            if (exists and not presence) or (not exists and presence):
                return False, None
        return True, None
    return check_node_label_presence


def new_service_affinity_predicate(pod_lister, service_lister,
                                   affinity_labels: Sequence[str],
                                   node_by_name=None):
    """Implicit node-label affinity inherited from peer service pods
    (ref: predicates.go:334 ServiceAffinity.CheckServiceAffinity). The
    reference resolves the peer pod's node via NodeInfo wired at
    construction; `node_by_name(name) -> Optional[Node]` plays that role."""
    def check_service_affinity(pod, existing_pods, node) -> PredicateResult:
        affinity: Dict[str, str] = {}
        labels_exist = True
        for l in affinity_labels:
            if l in pod.spec.node_selector:
                affinity[l] = pod.spec.node_selector[l]
            else:
                labels_exist = False
        if not labels_exist:
            services = service_lister.get_pod_services(pod)
            if services:
                sel = labelspkg.selector_from_set(services[0].spec.selector)
                service_pods = [p for p in pod_lister.list(sel)
                                if p.metadata.namespace == pod.metadata.namespace]
                if service_pods:
                    getter = node_by_name or (lambda n: None)
                    other = getter(service_pods[0].spec.node_name)
                    if other is not None:
                        for l in affinity_labels:
                            if l in affinity:
                                continue
                            if l in other.metadata.labels:
                                affinity[l] = other.metadata.labels[l]
        if not affinity:
            return True, None
        sel = labelspkg.selector_from_set(affinity)
        return sel.matches(node.metadata.labels), None
    return check_service_affinity


# ------------------------------------------------ inter-pod affinity tier

def term_namespaces(pod: api.Pod, term: api.PodAffinityTerm) -> List[str]:
    """Resolved namespace scope: empty list means the pod's own namespace."""
    return list(term.namespaces) if term.namespaces else [pod.metadata.namespace]


def pod_matches_term(candidate: api.Pod, pod: api.Pod,
                     term: api.PodAffinityTerm) -> bool:
    """Does `candidate` fall inside `term`'s selector+namespace scope
    (scope resolved relative to `pod`, the term's owner)?"""
    if candidate.metadata.namespace not in term_namespaces(pod, term):
        return False
    sel = labelspkg.selector_from_set(term.label_selector)
    return sel.matches(candidate.metadata.labels)


def new_inter_pod_affinity_predicate(pod_lister, node_by_name):
    """Required inter-pod affinity/anti-affinity — the quadratic pod x pod
    term (BASELINE config 4; no v1.1 reference symbol — see
    core/types.py PodAffinityTerm).

    Semantics (the parity contract the device engine reproduces):
      - affinity term: the candidate node must carry `topology_key`, and
        some running, assigned pod matching the term must live on a node
        with the same value for that key. Bootstrap rule: if NO pod
        anywhere matches the term but the incoming pod matches its own
        term, the term is satisfied (first pod of a self-affine group).
      - anti-affinity term: no running, assigned pod matching the term may
        share the candidate node's topology domain; a node lacking the key
        belongs to no domain and always passes.
      - pods on unknown nodes (node_by_name -> None) or nodes lacking the
        key occupy no domain; Succeeded/Failed pods are ignored, matching
        MapPodsToMachines' phase filter (predicates.go:429).
    """
    def inter_pod_affinity(pod: api.Pod, existing_pods, node) -> PredicateResult:
        affinity = pod.spec.affinity
        if affinity is None:
            return True, None
        aff_terms = (affinity.pod_affinity.required_during_scheduling
                     if affinity.pod_affinity else [])
        anti_terms = (affinity.pod_anti_affinity.required_during_scheduling
                      if affinity.pod_anti_affinity else [])
        if not aff_terms and not anti_terms:
            return True, None
        all_pods = filter_non_running_pods(
            pod_lister.list(labelspkg.everything()))

        def domain_value(p: api.Pod, key: str) -> Optional[str]:
            if not p.spec.node_name:
                return None
            host = node_by_name(p.spec.node_name)
            if host is None:
                return None
            return host.metadata.labels.get(key)

        for term in aff_terms:
            node_value = node.metadata.labels.get(term.topology_key)
            if node_value is None:
                # an affinity term always needs the key, even under the
                # bootstrap rule — else the first pod of a group could land
                # on a domain-less node and strand the rest
                return False, None
            matches = [p for p in all_pods if pod_matches_term(p, pod, term)]
            if not matches and pod_matches_term(pod, pod, term):
                continue  # bootstrap: first pod of a self-affine group
            if not any(domain_value(p, term.topology_key) == node_value
                       for p in matches):
                return False, None
        for term in anti_terms:
            node_value = node.metadata.labels.get(term.topology_key)
            if node_value is None:
                continue
            for p in all_pods:
                if pod_matches_term(p, pod, term) and \
                        domain_value(p, term.topology_key) == node_value:
                    return False, None
        return True, None
    return inter_pod_affinity


def filter_non_running_pods(pods: Sequence[api.Pod]) -> List[api.Pod]:
    """Drop Succeeded/Failed pods (ref: predicates.go:429
    filterNonRunningPods)."""
    return [p for p in pods
            if p.status.phase not in (api.POD_SUCCEEDED, api.POD_FAILED)]


def map_pods_to_machines(pod_lister) -> Dict[str, List[api.Pod]]:
    """Pivot all pods into hostname -> pods (ref: predicates.go:445
    MapPodsToMachines; unassigned pods land under "")."""
    machine_to_pods: Dict[str, List[api.Pod]] = {}
    pods = filter_non_running_pods(pod_lister.list(labelspkg.everything()))
    for pod in pods:
        machine_to_pods.setdefault(pod.spec.node_name, []).append(pod)
    return machine_to_pods
