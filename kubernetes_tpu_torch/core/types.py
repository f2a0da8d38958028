"""API object schema — the v1.1 subset the control plane operates on.

Reference: pkg/api/types.go (2161 LoC internal types) and pkg/api/v1/types.go
(wire form). We keep the same object model (ObjectMeta / Spec / Status,
camelCase wire names via serde) for the resources the scheduler, controllers,
agents and CLI need: Pod, Node, Service, Endpoints, ReplicationController,
Binding, Event, Namespace, plus small config resources.

All types are plain dataclasses; serialization is handled reflectively by
core.serde. Although the dataclasses are technically mutable, objects that
have passed through the store are FROZEN by contract (core.store docstring):
never mutate one in place — build modified copies with dataclasses.replace
(cheap shallow copies are safe under the same contract) or scheme.deep_copy,
and write them back through the store's CAS loop.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .quantity import Quantity

# Resource names (ref: pkg/api/types.go ResourceCPU/ResourceMemory/ResourcePods)
RESOURCE_CPU = "cpu"
RESOURCE_MEMORY = "memory"
RESOURCE_PODS = "pods"

# Pod phases (ref: pkg/api/types.go PodPhase)
POD_PENDING = "Pending"
POD_RUNNING = "Running"
POD_SUCCEEDED = "Succeeded"
POD_FAILED = "Failed"
POD_UNKNOWN = "Unknown"

# Condition types / statuses
POD_READY = "Ready"
NODE_READY = "Ready"
NODE_OUT_OF_DISK = "OutOfDisk"
CONDITION_TRUE = "True"
CONDITION_FALSE = "False"
CONDITION_UNKNOWN = "Unknown"


def fast_replace(obj, **fields):
    """dataclasses.replace without re-running __init__ — the hot-path
    clone for store revision stamping and binding assignment (measured
    ~3x cheaper; 30k bindings pay it 4x each). Safe because every API
    type here is a plain field dataclass: no __post_init__, no
    __slots__, no InitVar."""
    new = object.__new__(type(obj))
    new.__dict__.update(obj.__dict__)
    new.__dict__.update(fields)
    # a clone is a DIFFERENT object that still carries the original's
    # resourceVersion until the store restamps it — serde.wire_json's
    # rv-keyed fragment cache must not ride along or it would serve
    # the original's bytes for the modified clone
    new.__dict__.pop("_wire_json", None)
    return new


_now_cache = (0, "")  # (unix second, formatted) — timestamps have 1s grain


def expand_template_rows(template, names):
    """One template object -> rows with fresh per-row identity: name
    stamped, uid/resource_version/creation_timestamp cleared so the
    create path restamps them. A server-fetched template must not leak
    its source object's identity — or its age: keeping the fetched
    creation_timestamp would make brand-new rows sort as hours old for
    anything ordering by creation time. One implementation shared by
    Client.create_from_template and the registry's fallback path, so
    identity-reset semantics cannot drift between them."""
    return [fast_replace(template,
                         metadata=fast_replace(template.metadata, name=n,
                                               uid="",
                                               resource_version="",
                                               creation_timestamp=""))
            for n in names]

def now_rfc3339() -> str:
    global _now_cache
    t = int(time.time())
    cached = _now_cache
    if cached[0] != t:
        cached = (t, time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t)))
        _now_cache = cached  # tuple swap is atomic under the GIL
    return cached[1]


@dataclass
class ObjectMeta:
    name: str = ""
    generate_name: str = ""
    namespace: str = ""
    uid: str = ""
    resource_version: str = ""
    creation_timestamp: str = ""
    deletion_timestamp: Optional[str] = None
    # seconds the object is granted to terminate gracefully, stamped by
    # the graceful-delete path together with deletionTimestamp (ref:
    # pkg/api/types.go ObjectMeta.DeletionGracePeriodSeconds)
    deletion_grace_period_seconds: Optional[int] = None
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    generation: int = 0


@dataclass
class ObjectReference:
    kind: str = ""
    namespace: str = ""
    name: str = ""
    uid: str = ""
    api_version: str = ""
    resource_version: str = ""
    field_path: str = ""


@dataclass
class LocalObjectReference:
    name: str = ""


# ---------------------------------------------------------------- volumes

@dataclass
class GCEPersistentDiskVolumeSource:
    pd_name: str = ""
    fs_type: str = ""
    partition: int = 0
    read_only: bool = False


@dataclass
class AWSElasticBlockStoreVolumeSource:
    volume_id: str = ""
    fs_type: str = ""
    partition: int = 0
    read_only: bool = False


@dataclass
class RBDVolumeSource:
    ceph_monitors: List[str] = field(default_factory=list)
    rbd_image: str = ""
    rbd_pool: str = ""
    fs_type: str = ""
    read_only: bool = False


@dataclass
class EmptyDirVolumeSource:
    medium: str = ""


@dataclass
class HostPathVolumeSource:
    path: str = ""


@dataclass
class NFSVolumeSource:
    server: str = ""
    path: str = ""
    read_only: bool = False


@dataclass
class SecretVolumeSource:
    secret_name: str = ""


@dataclass
class DownwardAPIVolumeFile:
    """(ref: pkg/api/types.go:620 — a file at `path` carrying the pod
    field fieldRef selects; only annotations, labels, name, and
    namespace are supported)"""
    path: str = ""
    field_ref: Optional["ObjectFieldSelector"] = None


@dataclass
class DownwardAPIVolumeSource:
    """(ref: pkg/api/types.go:613 DownwardAPIVolumeSource; an empty
    items list projects the standard metadata field set)"""
    items: List[DownwardAPIVolumeFile] = field(default_factory=list)


@dataclass
class PersistentVolumeClaimVolumeSource:
    claim_name: str = ""
    read_only: bool = False


@dataclass
class GitRepoVolumeSource:
    repository: str = ""
    revision: str = ""


@dataclass
class ISCSIVolumeSource:
    """(ref: pkg/api/types.go ISCSIVolumeSource)"""
    target_portal: str = ""
    iqn: str = ""
    lun: int = 0
    fs_type: str = ""
    read_only: bool = False


@dataclass
class GlusterfsVolumeSource:
    """(ref: pkg/api/types.go GlusterfsVolumeSource)"""
    endpoints_name: str = ""
    path: str = ""
    read_only: bool = False


@dataclass
class CephFSVolumeSource:
    """(ref: pkg/api/types.go CephFSVolumeSource)"""
    monitors: List[str] = field(default_factory=list)
    user: str = ""
    secret_file: str = ""
    read_only: bool = False


@dataclass
class FCVolumeSource:
    """(ref: pkg/api/types.go FCVolumeSource)"""
    target_wwns: List[str] = field(default_factory=list)
    lun: int = 0
    fs_type: str = ""
    read_only: bool = False


@dataclass
class CinderVolumeSource:
    """(ref: pkg/api/types.go CinderVolumeSource)"""
    volume_id: str = ""
    fs_type: str = ""
    read_only: bool = False


@dataclass
class FlockerVolumeSource:
    """(ref: pkg/api/types.go FlockerVolumeSource)"""
    dataset_name: str = ""


@dataclass
class Volume:
    name: str = ""
    gce_persistent_disk: Optional[GCEPersistentDiskVolumeSource] = None
    aws_elastic_block_store: Optional[AWSElasticBlockStoreVolumeSource] = None
    rbd: Optional[RBDVolumeSource] = None
    empty_dir: Optional[EmptyDirVolumeSource] = None
    host_path: Optional[HostPathVolumeSource] = None
    nfs: Optional[NFSVolumeSource] = None
    secret: Optional[SecretVolumeSource] = None
    downward_api: Optional[DownwardAPIVolumeSource] = None
    persistent_volume_claim: Optional[PersistentVolumeClaimVolumeSource] = None
    git_repo: Optional[GitRepoVolumeSource] = None
    iscsi: Optional[ISCSIVolumeSource] = None
    glusterfs: Optional[GlusterfsVolumeSource] = None
    cephfs: Optional[CephFSVolumeSource] = None
    fc: Optional[FCVolumeSource] = None
    cinder: Optional[CinderVolumeSource] = None
    flocker: Optional[FlockerVolumeSource] = None


# ---------------------------------------------------------------- containers

@dataclass
class ContainerPort:
    name: str = ""
    host_port: int = 0
    container_port: int = 0
    protocol: str = "TCP"
    host_ip: str = ""


@dataclass
class ResourceRequirements:
    limits: Dict[str, Quantity] = field(default_factory=dict)
    requests: Dict[str, Quantity] = field(default_factory=dict)


@dataclass
class ObjectFieldSelector:
    """Selects a field of the enclosing pod (ref: pkg/api/types.go
    ObjectFieldSelector; resolved by kubelet/envvars.py)."""
    api_version: str = "v1"
    field_path: str = ""


@dataclass
class EnvVarSource:
    """(ref: pkg/api/types.go:670 EnvVarSource — v1.1 has only
    FieldRef)"""
    field_ref: Optional[ObjectFieldSelector] = None


@dataclass
class EnvVar:
    name: str = ""
    value: str = ""
    value_from: Optional[EnvVarSource] = None


@dataclass
class VolumeMount:
    name: str = ""
    mount_path: str = ""
    read_only: bool = False


@dataclass
class ExecAction:
    command: List[str] = field(default_factory=list)


@dataclass
class HTTPGetAction:
    path: str = ""
    port: Any = None
    host: str = ""
    scheme: str = "HTTP"


@dataclass
class TCPSocketAction:
    port: Any = None


@dataclass
class Handler:
    """One action (ref: pkg/api/types.go:816 Handler — the union probes
    and lifecycle hooks share)."""
    exec: Optional[ExecAction] = None
    http_get: Optional[HTTPGetAction] = None
    tcp_socket: Optional[TCPSocketAction] = None


@dataclass
class Lifecycle:
    """(ref: pkg/api/types.go:831 Lifecycle — PostStart runs right
    after a container starts and kills it on failure; PreStop runs
    before a requested kill)"""
    post_start: Optional[Handler] = None
    pre_stop: Optional[Handler] = None


@dataclass
class Probe(Handler):
    """(ref: pkg/api/types.go Probe — literally a Handler embedded
    with timing knobs; inheriting keeps one copy of the action union
    and the identical wire shape)"""
    initial_delay_seconds: int = 0
    timeout_seconds: int = 1
    period_seconds: int = 10
    success_threshold: int = 1
    failure_threshold: int = 3


@dataclass
class Capabilities:
    """(ref: pkg/api/types.go Capabilities — linux capability names to
    grant/revoke at container create)"""
    add: List[str] = field(default_factory=list)
    drop: List[str] = field(default_factory=list)


@dataclass
class SecurityContext:
    """(ref: pkg/api/types.go SecurityContext; applied at the runtime
    boundary by kubelet/securitycontext.py, policed by the
    SecurityContextDeny admission plugin)"""
    capabilities: Optional[Capabilities] = None
    privileged: Optional[bool] = None
    run_as_user: Optional[int] = None
    run_as_non_root: Optional[bool] = None


@dataclass
class Container:
    """privileged is the flat pre-SecurityContext surface kept for
    wire compat; the reference nests it (SecurityContext.Privileged) —
    both are honored (kubelet/securitycontext.effective_privileged)."""
    name: str = ""
    image: str = ""
    command: List[str] = field(default_factory=list)
    args: List[str] = field(default_factory=list)
    ports: List[ContainerPort] = field(default_factory=list)
    env: List[EnvVar] = field(default_factory=list)
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    volume_mounts: List[VolumeMount] = field(default_factory=list)
    image_pull_policy: str = ""
    privileged: bool = False
    security_context: Optional[SecurityContext] = None
    liveness_probe: Optional[Probe] = None
    readiness_probe: Optional[Probe] = None
    lifecycle: Optional[Lifecycle] = None
    # ref: pkg/api/types.go:804 + :153 TerminationMessagePathDefault
    termination_message_path: str = "/dev/termination-log"
    # ref: pkg/api/types.go:813 Container.Stdin — only stdin:true
    # containers get a stdin pipe to attach to
    stdin: bool = False


@dataclass
class ContainerStateRunning:
    started_at: str = ""


@dataclass
class ContainerStateTerminated:
    exit_code: int = 0
    reason: str = ""
    message: str = ""  # the termination message (types.go Terminated)
    started_at: str = ""
    finished_at: str = ""


@dataclass
class ContainerStateWaiting:
    reason: str = ""


@dataclass
class ContainerState:
    waiting: Optional[ContainerStateWaiting] = None
    running: Optional[ContainerStateRunning] = None
    terminated: Optional[ContainerStateTerminated] = None


@dataclass
class ContainerStatus:
    name: str = ""
    state: ContainerState = field(default_factory=ContainerState)
    ready: bool = False
    restart_count: int = 0
    image: str = ""
    image_id: str = ""
    container_id: str = ""


# ---------------------------------------------------------------- pods

@dataclass
class PodAffinityTerm:
    """One required co/anti-location constraint: pods matching
    `label_selector` in `namespaces` (empty = the pod's own namespace),
    within the topology domain named by the node label `topology_key`.

    The v1.1 reference has no inter-pod affinity in-tree; this is the
    BASELINE config-4 extension (the quadratic pod x pod term), modeled on
    the scheduler's ServiceAffinity neighborhood semantics
    (predicates.go:334 — implicit affinity inherited from peer pods'
    node labels) generalized to explicit per-pod terms."""
    label_selector: Dict[str, str] = field(default_factory=dict)
    namespaces: List[str] = field(default_factory=list)
    topology_key: str = ""


@dataclass
class PodAffinity:
    required_during_scheduling: List[PodAffinityTerm] = field(default_factory=list)


@dataclass
class PodAntiAffinity:
    required_during_scheduling: List[PodAffinityTerm] = field(default_factory=list)


@dataclass
class Affinity:
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None


@dataclass
class PodSpec:
    volumes: List[Volume] = field(default_factory=list)
    containers: List[Container] = field(default_factory=list)
    restart_policy: str = "Always"
    termination_grace_period_seconds: Optional[int] = None
    active_deadline_seconds: Optional[int] = None
    dns_policy: str = ""
    node_selector: Dict[str, str] = field(default_factory=dict)
    service_account_name: str = ""
    node_name: str = ""
    host_network: bool = False
    # host PID/IPC namespace sharing (ref: pkg/api/types.go
    # PodSecurityContext.HostPID/HostIPC, surfaced at the top level of
    # the v1 wire form by pkg/api/v1/conversion.go
    # convert_api_PodSpec_To_v1_PodSpec for v1.0.0 compatibility; the
    # runtime maps them to pid/ipc modes, dockertools/manager.go:1994)
    host_pid: bool = False
    host_ipc: bool = False
    # ref: pkg/api/types.go PodSpec.ImagePullSecrets — resolved by the
    # kubelet into a docker keyring (kubelet/credentialprovider.py)
    image_pull_secrets: List[LocalObjectReference] = field(
        default_factory=list)
    affinity: Optional[Affinity] = None
    # flat integer scheduling priority (higher preempts lower; default 0).
    # DIVERGENCES #35: the reference models this as PriorityClass objects
    # resolved at admission plus a nominatedNodeName protocol; here the
    # resolved integer lives directly on the spec so the device tables
    # can carry it as one i64 column.
    priority: int = 0


@dataclass
class PodCondition:
    type: str = ""
    status: str = ""
    reason: str = ""
    message: str = ""


@dataclass
class PodStatus:
    phase: str = ""
    conditions: List[PodCondition] = field(default_factory=list)
    message: str = ""
    reason: str = ""
    host_ip: str = ""
    pod_ip: str = ""
    start_time: Optional[str] = None
    container_statuses: List[ContainerStatus] = field(default_factory=list)


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)


@dataclass
class PodTemplateSpec:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)


# ---------------------------------------------------------------- nodes

@dataclass
class NodeSpec:
    pod_cidr: str = ""
    external_id: str = ""
    provider_id: str = ""
    unschedulable: bool = False


@dataclass
class NodeCondition:
    type: str = ""
    status: str = ""
    last_heartbeat_time: str = ""
    last_transition_time: str = ""
    reason: str = ""
    message: str = ""


@dataclass
class NodeAddress:
    type: str = ""
    address: str = ""


@dataclass
class NodeSystemInfo:
    machine_id: str = ""
    kernel_version: str = ""
    os_image: str = ""
    container_runtime_version: str = ""
    kubelet_version: str = ""


@dataclass
class DaemonEndpoint:
    """(ref: pkg/api/types.go DaemonEndpoint)"""
    port: int = 0


@dataclass
class NodeDaemonEndpoints:
    """Where the node's kubelet server listens
    (ref: pkg/api/types.go NodeDaemonEndpoints; served by
    pkg/kubelet/server.go and consumed by the apiserver node proxy)."""
    kubelet_endpoint: DaemonEndpoint = field(default_factory=DaemonEndpoint)


@dataclass
class NodeStatus:
    capacity: Dict[str, Quantity] = field(default_factory=dict)
    allocatable: Dict[str, Quantity] = field(default_factory=dict)
    phase: str = ""
    conditions: List[NodeCondition] = field(default_factory=list)
    addresses: List[NodeAddress] = field(default_factory=list)
    daemon_endpoints: NodeDaemonEndpoints = field(
        default_factory=NodeDaemonEndpoints)
    node_info: NodeSystemInfo = field(default_factory=NodeSystemInfo)


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)


# ---------------------------------------------------------------- services

@dataclass
class ServicePort:
    name: str = ""
    protocol: str = "TCP"
    port: int = 0
    target_port: Any = None
    node_port: int = 0


@dataclass
class ServiceSpec:
    ports: List[ServicePort] = field(default_factory=list)
    selector: Dict[str, str] = field(default_factory=dict)
    cluster_ip: str = ""
    type: str = "ClusterIP"
    session_affinity: str = "None"
    # addresses outside the service range that also route to the
    # endpoints (ref: pkg/api/v1/types.go:1585 ExternalIPs; the wire
    # accepts the deprecatedPublicIPs alias — serde WIRE_ALIASES)
    external_ips: List[str] = field(default_factory=list)
    # requested address for a type=LoadBalancer service (ref:
    # pkg/api/v1/types.go:1606 — honored by providers that support
    # address reservation, best-effort elsewhere)
    load_balancer_ip: str = ""


@dataclass
class ServiceStatus:
    # external IPs assigned by the cloud LB controller (the reference
    # nests these under status.loadBalancer.ingress[].ip)
    load_balancer_ingress: List[str] = field(default_factory=list)


@dataclass
class Service:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ServiceSpec = field(default_factory=ServiceSpec)
    status: ServiceStatus = field(default_factory=ServiceStatus)


@dataclass
class EndpointAddress:
    ip: str = ""
    target_ref: Optional[ObjectReference] = None


@dataclass
class EndpointPort:
    name: str = ""
    port: int = 0
    protocol: str = "TCP"


@dataclass
class EndpointSubset:
    addresses: List[EndpointAddress] = field(default_factory=list)
    not_ready_addresses: List[EndpointAddress] = field(default_factory=list)
    ports: List[EndpointPort] = field(default_factory=list)


@dataclass
class Endpoints:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    subsets: List[EndpointSubset] = field(default_factory=list)


# ------------------------------------------------- replication controllers

@dataclass
class ReplicationControllerSpec:
    replicas: int = 1
    selector: Dict[str, str] = field(default_factory=dict)
    template: Optional[PodTemplateSpec] = None


@dataclass
class ReplicationControllerStatus:
    replicas: int = 0
    observed_generation: int = 0


@dataclass
class ReplicationController:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ReplicationControllerSpec = field(default_factory=ReplicationControllerSpec)
    status: ReplicationControllerStatus = field(default_factory=ReplicationControllerStatus)


# ---------------------------------------------------------------- binding

@dataclass
class Binding:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    target: ObjectReference = field(default_factory=ObjectReference)


# ----------------------------------------------------------------- leases

@dataclass
class LeaseSpec:
    """coordination.k8s.io Lease spec, forward-ported from the later
    reference (the v1.1 reference elects its master through a raw etcd
    CAS seam; the typed Lease is what that seam became). The *Time
    fields are wall-clock and informational — election liveness runs
    on each elector's LOCAL monotonic clock (utils/leaderelection.py),
    so a wall-clock jump can neither drop nor extend leadership."""
    holder_identity: str = ""
    lease_duration_seconds: int = 15
    acquire_time: str = ""
    renew_time: str = ""
    #: fencing term: increments on every holder CHANGE, never on a
    #: renewal — at most one holder exists per term (CAS-enforced)
    lease_transitions: int = 0


@dataclass
class Lease:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LeaseSpec = field(default_factory=LeaseSpec)


@dataclass
class Preconditions:
    """Delete preconditions (ref: pkg/api/types.go Preconditions) —
    the delete aborts with Conflict unless the target carries this
    uid. The kubelet's graceful-deletion confirm uses it so a pod
    recreated under the same name mid-drain is never collateral."""
    uid: str = ""


@dataclass
class DeleteOptions:
    """DELETE request options (ref: pkg/api/types.go DeleteOptions) —
    gracePeriodSeconds rides the DELETE body; None means "use the
    pod's own spec.terminationGracePeriodSeconds"."""
    grace_period_seconds: Optional[int] = None
    preconditions: Optional[Preconditions] = None


# ---------------------------------------------------------------- events

@dataclass
class EventSource:
    component: str = ""
    host: str = ""


@dataclass
class Event:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    involved_object: ObjectReference = field(default_factory=ObjectReference)
    reason: str = ""
    message: str = ""
    source: EventSource = field(default_factory=EventSource)
    first_timestamp: str = ""
    last_timestamp: str = ""
    count: int = 0
    type: str = ""


# ---------------------------------------------------------------- namespaces

@dataclass
class NamespaceSpec:
    finalizers: List[str] = field(default_factory=list)


@dataclass
class NamespaceStatus:
    phase: str = "Active"


@dataclass
class Namespace:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NamespaceSpec = field(default_factory=NamespaceSpec)
    status: NamespaceStatus = field(default_factory=NamespaceStatus)


# ------------------------------------------------------- config resources

@dataclass
class Secret:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, str] = field(default_factory=dict)
    type: str = "Opaque"


@dataclass
class ConfigEntry:  # helper for LimitRange items
    type: str = ""
    max: Dict[str, Quantity] = field(default_factory=dict)
    min: Dict[str, Quantity] = field(default_factory=dict)
    default: Dict[str, Quantity] = field(default_factory=dict)


@dataclass
class LimitRangeSpec:
    limits: List[ConfigEntry] = field(default_factory=list)


@dataclass
class LimitRange:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LimitRangeSpec = field(default_factory=LimitRangeSpec)


@dataclass
class ResourceQuotaSpec:
    hard: Dict[str, Quantity] = field(default_factory=dict)


@dataclass
class ResourceQuotaStatus:
    hard: Dict[str, Quantity] = field(default_factory=dict)
    used: Dict[str, Quantity] = field(default_factory=dict)


@dataclass
class ResourceQuota:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ResourceQuotaSpec = field(default_factory=ResourceQuotaSpec)
    status: ResourceQuotaStatus = field(default_factory=ResourceQuotaStatus)


@dataclass
class ServiceAccount:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    secrets: List[ObjectReference] = field(default_factory=list)


# ------------------------------------------------- extensions/v1beta1 group
# (ref: pkg/apis/extensions/types.go; mounted by pkg/master/master.go
#  :1049-1091 — HPA, jobs, deployments, daemonsets, ingress)

DEPLOYMENT_POD_TEMPLATE_HASH_KEY = "deployment.kubernetes.io/podTemplateHash"


@dataclass
class JobSpec:
    parallelism: Optional[int] = None   # nil -> defaulted to 1
    completions: Optional[int] = None   # nil -> any single success completes
    selector: Dict[str, str] = field(default_factory=dict)
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)


@dataclass
class JobCondition:
    type: str = ""        # "Complete"
    status: str = ""
    reason: str = ""
    message: str = ""


@dataclass
class JobStatus:
    conditions: List[JobCondition] = field(default_factory=list)
    start_time: Optional[str] = None
    completion_time: Optional[str] = None
    active: int = 0
    succeeded: int = 0
    failed: int = 0


@dataclass
class Job:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: JobSpec = field(default_factory=JobSpec)
    status: JobStatus = field(default_factory=JobStatus)


@dataclass
class ScaleSpec:
    replicas: int = 0


@dataclass
class ScaleStatus:
    replicas: int = 0
    selector: Dict[str, str] = field(default_factory=dict)


@dataclass
class Scale:
    """The scale subresource (ref: pkg/apis/extensions/types.go:38-63
    Scale/ScaleSpec/ScaleStatus) — a scaling request detached from the
    scaled object's full schema, served at .../{name}/scale for
    replicationcontrollers (registry/experimental/controller/etcd) and
    deployments (registry/deployment/etcd); the HPA writes through it."""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ScaleSpec = field(default_factory=ScaleSpec)
    status: ScaleStatus = field(default_factory=ScaleStatus)


@dataclass
class RollingUpdateDeployment:
    # IntOrString: an absolute count or a "25%"-style percentage of
    # spec.replicas (ref: pkg/apis/extensions/types.go:267,279
    # intstr.IntOrString; resolved by controllers/deployment.py
    # resolve_int_or_percent with the reference's ceil rounding)
    max_unavailable: Any = 1
    max_surge: Any = 1


@dataclass
class DeploymentStrategy:
    type: str = "RollingUpdate"   # or "Recreate"
    rolling_update: RollingUpdateDeployment = field(
        default_factory=RollingUpdateDeployment)


@dataclass
class DeploymentSpec:
    replicas: int = 1
    selector: Dict[str, str] = field(default_factory=dict)
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    strategy: DeploymentStrategy = field(default_factory=DeploymentStrategy)
    unique_label_key: str = DEPLOYMENT_POD_TEMPLATE_HASH_KEY


@dataclass
class DeploymentStatus:
    replicas: int = 0
    updated_replicas: int = 0
    # availability means READY pods (deployment/deployment.go
    # GetAvailablePodsForRCs); unavailable counts the gap to the larger
    # of spec.replicas and the current total — during a surge the extra
    # unready pods are unavailable too
    available_replicas: int = 0
    unavailable_replicas: int = 0
    observed_generation: int = 0


@dataclass
class Deployment:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: DeploymentSpec = field(default_factory=DeploymentSpec)
    status: DeploymentStatus = field(default_factory=DeploymentStatus)


@dataclass
class DaemonSetSpec:
    selector: Dict[str, str] = field(default_factory=dict)
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)


@dataclass
class DaemonSetStatus:
    current_number_scheduled: int = 0
    number_misscheduled: int = 0
    desired_number_scheduled: int = 0


@dataclass
class DaemonSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: DaemonSetSpec = field(default_factory=DaemonSetSpec)
    status: DaemonSetStatus = field(default_factory=DaemonSetStatus)


@dataclass
class SubresourceReference:
    kind: str = ""
    name: str = ""
    namespace: str = ""
    subresource: str = ""


@dataclass
class HorizontalPodAutoscalerSpec:
    scale_ref: SubresourceReference = field(
        default_factory=SubresourceReference)
    min_replicas: int = 1
    max_replicas: int = 1
    cpu_utilization_target_percentage: Optional[int] = None


@dataclass
class HorizontalPodAutoscalerStatus:
    observed_generation: int = 0
    last_scale_time: Optional[str] = None
    current_replicas: int = 0
    desired_replicas: int = 0
    current_cpu_utilization_percentage: Optional[int] = None


@dataclass
class HorizontalPodAutoscaler:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: HorizontalPodAutoscalerSpec = field(
        default_factory=HorizontalPodAutoscalerSpec)
    status: HorizontalPodAutoscalerStatus = field(
        default_factory=HorizontalPodAutoscalerStatus)


@dataclass
class IngressBackend:
    service_name: str = ""
    service_port: Any = None


@dataclass
class HTTPIngressPath:
    path: str = ""
    backend: IngressBackend = field(default_factory=IngressBackend)


@dataclass
class HTTPIngressRuleValue:
    paths: List[HTTPIngressPath] = field(default_factory=list)


@dataclass
class IngressRule:
    host: str = ""
    http: Optional[HTTPIngressRuleValue] = None


@dataclass
class IngressSpec:
    backend: Optional[IngressBackend] = None
    rules: List[IngressRule] = field(default_factory=list)


@dataclass
class IngressStatus:
    load_balancer_ingress: List[str] = field(default_factory=list)


@dataclass
class Ingress:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: IngressSpec = field(default_factory=IngressSpec)
    status: IngressStatus = field(default_factory=IngressStatus)


@dataclass
class PodTemplate:
    """(ref: pkg/api/types.go:1121 PodTemplate)"""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)


@dataclass
class ComponentCondition:
    """(ref: pkg/api/types.go ComponentCondition)"""
    type: str = "Healthy"
    status: str = ""
    message: str = ""
    error: str = ""


@dataclass
class ComponentStatus:
    """(ref: pkg/api/types.go:2086 ComponentStatus — the health of
    scheduler/controller-manager/etcd as seen by the apiserver)"""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    conditions: List[ComponentCondition] = field(default_factory=list)


@dataclass
class APIVersionEntry:
    """(ref: pkg/apis/extensions/types.go APIVersion)"""
    name: str = ""


@dataclass
class ThirdPartyResource:
    """Dynamic API registration — the CRD ancestor (ref:
    pkg/apis/extensions/types.go:145; name `<kind>.<domain>...` mounts
    /apis/<domain>/<version>/<kind>s, master.go:972
    InstallThirdPartyResource)."""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    description: str = ""
    versions: List[APIVersionEntry] = field(default_factory=list)


@dataclass
class ThirdPartyResourceData:
    """One custom object: standard metadata + the raw custom fields
    (ref: pkg/registry/thirdpartyresourcedata — the reference stores the
    whole JSON document; `data` carries everything that isn't
    kind/apiVersion/metadata)."""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, Any] = field(default_factory=dict)


# ------------------------------------------------------ persistent volumes

VOLUME_AVAILABLE = "Available"
VOLUME_BOUND = "Bound"
VOLUME_RELEASED = "Released"
CLAIM_PENDING = "Pending"
CLAIM_BOUND = "Bound"


@dataclass
class PersistentVolumeSpec:
    """(ref: pkg/api/types.go PersistentVolumeSpec: capacity, one volume
    source, accessModes, claimRef, reclaim policy)"""
    capacity: Dict[str, Quantity] = field(default_factory=dict)
    access_modes: List[str] = field(default_factory=list)
    claim_ref: Optional[ObjectReference] = None
    persistent_volume_reclaim_policy: str = "Retain"
    host_path: Optional[HostPathVolumeSource] = None
    nfs: Optional[NFSVolumeSource] = None
    gce_persistent_disk: Optional[GCEPersistentDiskVolumeSource] = None
    aws_elastic_block_store: Optional[AWSElasticBlockStoreVolumeSource] = None
    cinder: Optional[CinderVolumeSource] = None
    fc: Optional[FCVolumeSource] = None
    flocker: Optional[FlockerVolumeSource] = None


@dataclass
class PersistentVolumeStatus:
    phase: str = ""
    message: str = ""


@dataclass
class PersistentVolume:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeSpec = field(default_factory=PersistentVolumeSpec)
    status: PersistentVolumeStatus = field(
        default_factory=PersistentVolumeStatus)


@dataclass
class PersistentVolumeClaimSpec:
    access_modes: List[str] = field(default_factory=list)
    resources: ResourceRequirements = field(
        default_factory=ResourceRequirements)
    volume_name: str = ""


@dataclass
class PersistentVolumeClaimStatus:
    phase: str = ""
    access_modes: List[str] = field(default_factory=list)
    capacity: Dict[str, Quantity] = field(default_factory=dict)


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeClaimSpec = field(
        default_factory=PersistentVolumeClaimSpec)
    status: PersistentVolumeClaimStatus = field(
        default_factory=PersistentVolumeClaimStatus)


# ---------------------------------------------------------------- helpers

# Deprecated v1 wire alias: `serviceAccount` mirrors
# `serviceAccountName` on encode and fills it on decode when the
# canonical key is empty (pkg/api/v1/types.go
# PodSpec.DeprecatedServiceAccount, defaults.go, conversion.go).
from . import serde as _serde  # noqa: E402  (needs PodSpec defined)

_serde.WIRE_ALIASES[PodSpec] = {"serviceAccount": "service_account_name"}
# `deprecatedPublicIPs` is externalIPs' pre-v1.1 spelling (ref:
# pkg/api/v1/types.go:1587) — accepted on decode when the canonical key
# is empty, mirrored on encode like the reference's conversion
_serde.WIRE_ALIASES[ServiceSpec] = {"deprecatedPublicIPs": "external_ips"}


def pod_resource_fields(pod: Pod) -> Dict[str, str]:
    """Flat field map for field selectors (ref: pkg/registry/pod PodToSelectableFields)."""
    return {
        "metadata.name": pod.metadata.name,
        "metadata.namespace": pod.metadata.namespace,
        "spec.nodeName": pod.spec.node_name,
        "status.phase": pod.status.phase,
    }


def node_resource_fields(node: Node) -> Dict[str, str]:
    return {
        "metadata.name": node.metadata.name,
        "spec.unschedulable": "true" if node.spec.unschedulable else "false",
    }


def event_resource_fields(ev: Event) -> Dict[str, str]:
    """Selectable fields for events (ref: pkg/registry/event/strategy.go
    getAttrs:88-99 — involvedObject.* plus reason/source/type, merged
    with the ObjectMeta set). kubectl describe's related-events lookup
    and the reference client's Events.Search filter on these
    server-side (pkg/client/unversioned/events.go GetFieldSelector)."""
    o = ev.involved_object
    return {
        "metadata.name": ev.metadata.name,
        "metadata.namespace": ev.metadata.namespace,
        "involvedObject.kind": o.kind,
        "involvedObject.namespace": o.namespace,
        "involvedObject.name": o.name,
        "involvedObject.uid": o.uid,
        "involvedObject.apiVersion": o.api_version,
        "involvedObject.resourceVersion": o.resource_version,
        "involvedObject.fieldPath": o.field_path,
        "reason": ev.reason,
        "source": ev.source.component,
        "type": ev.type,
    }


def generic_resource_fields(obj: Any) -> Dict[str, str]:
    meta = getattr(obj, "metadata", None)
    if meta is None:
        return {}
    return {"metadata.name": meta.name, "metadata.namespace": meta.namespace}


# Per-key getters mirroring the dict builders above. Field selectors
# whose terms all resolve here compile to direct attribute checks — the
# watch fan-out and filtered LISTs otherwise build one throwaway field
# map per object-version (the load-bearing selectors, the scheduler's
# spec.nodeName= / != pair, pay it on every event of a 30k-pod tile).
POD_FIELD_GETTERS: Dict[str, Any] = {
    "metadata.name": lambda o: o.metadata.name,
    "metadata.namespace": lambda o: o.metadata.namespace,
    "spec.nodeName": lambda o: o.spec.node_name,
    "status.phase": lambda o: o.status.phase,
}

EVENT_FIELD_GETTERS: Dict[str, Any] = {
    "metadata.name": lambda o: o.metadata.name,
    "metadata.namespace": lambda o: o.metadata.namespace,
    "involvedObject.kind": lambda o: o.involved_object.kind,
    "involvedObject.namespace": lambda o: o.involved_object.namespace,
    "involvedObject.name": lambda o: o.involved_object.name,
    "involvedObject.uid": lambda o: o.involved_object.uid,
    "involvedObject.apiVersion": lambda o: o.involved_object.api_version,
    "involvedObject.resourceVersion":
        lambda o: o.involved_object.resource_version,
    "involvedObject.fieldPath": lambda o: o.involved_object.field_path,
    "reason": lambda o: o.reason,
    "source": lambda o: o.source.component,
    "type": lambda o: o.type,
}

NODE_FIELD_GETTERS: Dict[str, Any] = {
    "metadata.name": lambda o: o.metadata.name,
    "spec.unschedulable": lambda o: ("true" if o.spec.unschedulable
                                     else "false"),
}

GENERIC_FIELD_GETTERS: Dict[str, Any] = {
    # mirror generic_resource_fields' metadata-is-None guard (it
    # returns {}, whose missing keys read as "" through the dict
    # path's .get default)
    "metadata.name": lambda o: (
        m.name if (m := getattr(o, "metadata", None)) is not None else ""),
    "metadata.namespace": lambda o: (
        m.namespace if (m := getattr(o, "metadata", None)) is not None
        else ""),
}
