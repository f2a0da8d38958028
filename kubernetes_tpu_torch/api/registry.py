"""Per-resource REST strategies over the store — the registry layer.

Reference: pkg/registry/* (19,217 LoC of per-resource strategies over one
generic etcd store, pkg/registry/generic/etcd/etcd.go:152-527). Here each
resource is described by a ResourceInfo (kind, scope, field extractor, TTL,
validation/defaulting hooks) and one Registry executes the generic verbs:
create (name generation, uid, timestamps, validation), get, list (label +
field selectors), update, update-status, delete, watch, plus the pod
`binding` subresource with its bind-only-if-unbound CAS
(ref: pkg/registry/pod/etcd/etcd.go:121-189 BindingREST/assignPod).
"""

from __future__ import annotations

import random
import re
import threading
import time
import uuid
from dataclasses import dataclass, replace, field as dc_field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import obs
from ..core import fields as fieldspkg
from ..core import intstr
from ..core import labels as labelspkg
from ..core import types as api
from ..core.errors import (BadRequest, Conflict, Invalid,
                           MethodNotSupported, NotFound)
from ..core.scheme import Scheme, default_scheme
from ..core.store import Store
from ..core.watch import Watcher

DEFAULT_EVENT_TTL = 60 * 60.0  # ref: --event-ttl default 1h (cmd/kube-apiserver)


_DNS1123_LABEL_RE = re.compile(r"[a-z0-9]([-a-z0-9]*[a-z0-9])?")
_DNS1123_SUBDOMAIN_RE = re.compile(
    r"[a-z0-9]([-a-z0-9]*[a-z0-9])?(\.[a-z0-9]([-a-z0-9]*[a-z0-9])?)*")


# uid generation: uuid4() reads os.urandom per call, which serializes hard
# under concurrent creators (30 writer threads is the reference benchmark
# shape). A per-thread urandom-seeded PRNG keeps uids unique with NO
# shared lock — a profile showed 30 writers spending ~19% of the
# create storm's runnable samples contending one RNG lock
# (PROFILE_e2e.md registry.py:_new_uid).
_uid_local = threading.local()


# Resources whose creation has side effects or verb rewrites beyond the
# plain store write (services allocate IPs/ports, bindings are a verb,
# TPRs mount storage, componentstatuses are computed): batch paths must
# take the per-object create() road for these.
CREATE_SIDE_EFFECT_RESOURCES = ("componentstatuses", "bindings",
                                "services", "thirdpartyresources")
# ...and the template fast path must ALSO route kinds with per-kind
# create defaulting through _prepare_create (namespaces gain the
# kubernetes finalizer there).
TEMPLATE_FALLBACK_RESOURCES = CREATE_SIDE_EFFECT_RESOURCES + ("namespaces",)


def _uid_rng() -> random.Random:
    rng = getattr(_uid_local, "rng", None)
    if rng is None:
        rng = _uid_local.rng = random.Random()  # seeds from os.urandom
    return rng


def _new_uid() -> str:
    bits = _uid_rng().getrandbits(128)
    # format the RFC-4122 v4 shape directly: uuid.UUID's field validation
    # plus __str__ was ~7us per create under the 30-writer benchmark load
    bits = (bits & ~(0xF << 76)) | (0x4 << 76)   # version nibble
    bits = (bits & ~(0x3 << 62)) | (0x2 << 62)   # variant bits
    h = "%032x" % bits
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"


def _name_suffix(n: int = 5) -> str:
    return "%0*x" % (n, _uid_rng().getrandbits(4 * n))


def _dns1123(name: str) -> bool:
    """DNS-1123 subdomain (ref: pkg/api/validation IsDNS1123Subdomain)."""
    return 0 < len(name) <= 253 and bool(_DNS1123_SUBDOMAIN_RE.fullmatch(name))


def _dns1123_label(name: str) -> bool:
    """DNS-1123 label: lowercase ASCII alnum + '-', alnum at both ends,
    <=63. Ref: pkg/api/validation ValidateDNS1123Label (volume names)."""
    return 0 < len(name) <= 63 and bool(_DNS1123_LABEL_RE.fullmatch(name))


def validate_object_meta(meta: api.ObjectMeta, namespaced: bool) -> None:
    if not meta.name and not meta.generate_name:
        raise Invalid("metadata.name: required value")
    if meta.name and not _dns1123(meta.name):
        raise Invalid(f"metadata.name: invalid value {meta.name!r}")
    if namespaced and meta.namespace and not _dns1123(meta.namespace):
        raise Invalid(f"metadata.namespace: invalid value {meta.namespace!r}")


def validate_pod(pod: api.Pod) -> None:
    validate_object_meta(pod.metadata, True)
    if not pod.spec.containers:
        raise Invalid("spec.containers: required value")
    names = set()
    for c in pod.spec.containers:
        if not c.name:
            raise Invalid("spec.containers[].name: required value")
        if c.name in names:
            raise Invalid(f"spec.containers[].name: duplicate {c.name!r}")
        names.add(c.name)
    vol_names = set()
    for v in pod.spec.volumes:
        # DNS-1123 label check also forecloses path traversal through the
        # kubelet volume dir layout (ref: validation.go validateVolumes).
        if not _dns1123_label(v.name):
            raise Invalid(f"spec.volumes[].name: invalid value {v.name!r}")
        if v.name in vol_names:
            raise Invalid("spec.volumes[].name: duplicate volume name")
        vol_names.add(v.name)
    # priority is a flat integer (DIVERGENCES #35); bound |p| <= 1e9 so
    # the device's composite victim score stays exact in int64
    prio = pod.spec.priority
    if type(prio) is not int:
        raise Invalid("spec.priority: must be an integer")
    if abs(prio) > 1_000_000_000:
        raise Invalid("spec.priority: must satisfy |priority| <= 1e9")


def validate_node(node: api.Node) -> None:
    validate_object_meta(node.metadata, False)


def validate_service(svc: api.Service) -> None:
    """ref: pkg/api/validation ValidateService — the address-bearing
    spec fields must parse as IPs before a controller hands them to a
    cloud API (an invalid string would otherwise surface as an opaque
    provider error instead of a 422 at admission time)."""
    import ipaddress
    validate_object_meta(svc.metadata, True)
    # explicit JSON nulls decode to None (serde): treat as defaults
    spec = svc.spec or api.ServiceSpec()
    for label, ip in ([("spec.loadBalancerIP",
                        spec.load_balancer_ip or "")]
                      + [("spec.externalIPs", x)
                         for x in (spec.external_ips or [])]):
        if not ip:
            continue
        try:
            # ip_address: strict v4 dotted-quad OR v6, like the
            # reference's net.ParseIP (inet_aton-style "127.1"
            # shorthand is rejected; an IPv6 externalIP is accepted)
            ipaddress.ip_address(ip)
        except (ValueError, TypeError):
            raise Invalid(f"{label}: {ip!r} is not a valid IP address")


def validate_deployment(d: api.Deployment) -> None:
    """ref: pkg/apis/extensions/validation/validation.go
    ValidateRollingUpdateDeployment:258-268 — both bounds must be
    positive ints or percent strings, and maxUnavailable cannot be 0
    when maxSurge is 0 (the rollout could never make progress)."""
    validate_object_meta(d.metadata, True)
    # explicit JSON nulls decode to None (serde); the reference treats
    # a nil strategy/rollingUpdate as defaults (extensions defaults.go)
    spec = d.spec or api.DeploymentSpec()
    strategy = spec.strategy or api.DeploymentStrategy()
    if strategy.type != "RollingUpdate":
        return
    ru = strategy.rolling_update or api.RollingUpdateDeployment()
    vals = {}
    for fld, v in (("maxUnavailable", ru.max_unavailable),
                   ("maxSurge", ru.max_surge)):
        try:
            vals[fld] = intstr.resolve_int_or_percent(v, 100)
        except (ValueError, TypeError):
            raise Invalid(
                f"spec.strategy.rollingUpdate.{fld}: not an int or percent")
        if vals[fld] < 0:
            raise Invalid(
                f"spec.strategy.rollingUpdate.{fld}: must be non-negative")
    if isinstance(ru.max_unavailable, str) \
            and vals["maxUnavailable"] > 100:
        raise Invalid("spec.strategy.rollingUpdate.maxUnavailable: "
                      "cannot be more than 100%")
    if vals["maxUnavailable"] == 0 and vals["maxSurge"] == 0:
        raise Invalid("spec.strategy.rollingUpdate.maxUnavailable: "
                      "cannot be 0 when maxSurge is 0 as well")


@dataclass
class ResourceInfo:
    name: str                      # plural resource name, e.g. "pods"
    kind: str
    cls: type
    namespaced: bool = True
    fields_fn: Callable[[Any], Dict[str, str]] = api.generic_resource_fields
    validate: Optional[Callable[[Any], None]] = None
    ttl: Optional[float] = None    # fixed TTL (events)
    has_status: bool = True


RESOURCES: Dict[str, ResourceInfo] = {}

_FIELD_GETTER_MAPS = {
    api.pod_resource_fields: api.POD_FIELD_GETTERS,
    api.node_resource_fields: api.NODE_FIELD_GETTERS,
    api.event_resource_fields: api.EVENT_FIELD_GETTERS,
    api.generic_resource_fields: api.GENERIC_FIELD_GETTERS,
}


def _compile_field_pred(info: "ResourceInfo", fsel):
    """Direct-attribute matcher for a parsed field selector, or None.

    The dict path (fsel.matches(info.fields_fn(o))) allocates one
    throwaway field map per object-version; the scheduler's watch pair
    (spec.nodeName= / !=) pays that on every event of a 30k-pod commit
    fan-out, and a node-scoped kubelet LIST pays it per stored pod.
    When every term's key has a registered getter the selector compiles
    to attribute reads — same semantics (missing keys read as "" via
    the dict path's .get default only for keys NO getter covers, which
    is exactly when this returns None and the dict path runs)."""
    getters = _FIELD_GETTER_MAPS.get(info.fields_fn)
    if getters is None:
        return None
    try:
        terms = [(getters[k], v, neg) for k, v, neg in fsel.terms]
    except KeyError:
        return None

    def matches(o) -> bool:
        for g, v, neg in terms:
            if (g(o) == v) == neg:
                return False
        return True
    return matches


def field_matcher(info: "ResourceInfo", fsel, fields_of_factory=None):
    """THE field-selector matcher: compiled attribute reads when every
    term has a getter, else the dict path. fields_of_factory (optional)
    supplies a memoized fields_of and is only invoked on the fallback,
    so compiled callers never build the memo. One helper so list(),
    watch(), and the reflector's client-side check cannot drift."""
    m = _compile_field_pred(info, fsel)
    if m is not None:
        return m
    fn = fields_of_factory() if fields_of_factory else info.fields_fn
    return lambda o: fsel.matches(fn(o))


# Per-kind field-label conversion (ref: pkg/api/v1/conversion.go:53-178
# AddFieldLabelConversionFunc — the apiserver rewrites legacy labels,
# e.g. the pre-v1 `spec.host` -> `spec.nodeName`, and rejects labels
# the kind does not support with "field label not supported" before
# the selector reaches storage). Each entry is (aliases, supported);
# kinds without an entry keep the permissive pass-through the generic
# metadata fields provide. The supported sets mirror the reference's
# switch arms exactly — including labels the conversion accepts but
# the selectable-fields set never populates (a pod selector on
# `metadata.labels` converts fine and then matches nothing, both
# there and here).
_FIELD_LABEL_CONVERSIONS: Dict[str, Tuple[Dict[str, str], frozenset]] = {
    "pods": ({"spec.host": "spec.nodeName"},
             frozenset({"metadata.name", "metadata.namespace",
                        "metadata.labels", "metadata.annotations",
                        "status.phase", "status.podIP", "spec.nodeName"})),
    "nodes": ({}, frozenset({"metadata.name", "spec.unschedulable"})),
    "replicationcontrollers": ({}, frozenset({"metadata.name",
                                              "status.replicas"})),
    # events: the reference's switch arm plus the ObjectMeta pair its
    # selectable set (event/strategy.go getAttrs ObjectMetaFieldsSet)
    # exposes — rejecting metadata.name would dead-end a selector the
    # storage layer can serve
    "events": ({}, frozenset({
        "metadata.name", "metadata.namespace",
        "involvedObject.kind", "involvedObject.namespace",
        "involvedObject.name", "involvedObject.uid",
        "involvedObject.apiVersion", "involvedObject.resourceVersion",
        "involvedObject.fieldPath", "reason", "source", "type"})),
    "namespaces": ({}, frozenset({"status.phase"})),
    "secrets": ({}, frozenset({"type"})),
    "serviceaccounts": ({}, frozenset({"metadata.name"})),
    "endpoints": ({}, frozenset({"metadata.name"})),
}


def convert_field_selector(resource: str,
                           fsel: fieldspkg.FieldSelector
                           ) -> fieldspkg.FieldSelector:
    """Apply the kind's field-label conversion to a parsed selector:
    legacy labels rewrite, unsupported labels raise BadRequest (the
    reference's conversion error surfaces as a 400 from the selector
    query parsing, pkg/apiserver/resthandler.go)."""
    conv = _FIELD_LABEL_CONVERSIONS.get(resource)
    if conv is None:
        return fsel
    aliases, supported = conv
    terms = []
    changed = False
    for k, v, neg in fsel.terms:
        nk = aliases.get(k, k)
        if nk not in supported:
            raise BadRequest(f"field label not supported: {k}")
        changed = changed or nk != k
        terms.append((nk, v, neg))
    return fieldspkg.FieldSelector(tuple(terms)) if changed else fsel


def _register(info: ResourceInfo) -> None:
    RESOURCES[info.name] = info


_register(ResourceInfo("pods", "Pod", api.Pod, True, api.pod_resource_fields,
                       validate_pod))
_register(ResourceInfo("nodes", "Node", api.Node, False,
                       api.node_resource_fields, validate_node))
_register(ResourceInfo("services", "Service", api.Service, True,
                       validate=validate_service))
_register(ResourceInfo("endpoints", "Endpoints", api.Endpoints, True,
                       has_status=False))
_register(ResourceInfo("replicationcontrollers", "ReplicationController",
                       api.ReplicationController, True))
_register(ResourceInfo("events", "Event", api.Event, True,
                       api.event_resource_fields,
                       ttl=DEFAULT_EVENT_TTL, has_status=False))
_register(ResourceInfo("namespaces", "Namespace", api.Namespace, False))
_register(ResourceInfo("secrets", "Secret", api.Secret, True, has_status=False))
_register(ResourceInfo("limitranges", "LimitRange", api.LimitRange, True,
                       has_status=False))
_register(ResourceInfo("resourcequotas", "ResourceQuota", api.ResourceQuota, True))
_register(ResourceInfo("serviceaccounts", "ServiceAccount", api.ServiceAccount,
                       True, has_status=False))
_register(ResourceInfo("persistentvolumes", "PersistentVolume",
                       api.PersistentVolume, False))
_register(ResourceInfo("persistentvolumeclaims", "PersistentVolumeClaim",
                       api.PersistentVolumeClaim, True))
_register(ResourceInfo("podtemplates", "PodTemplate", api.PodTemplate,
                       True, has_status=False))
# read-only, computed per request from component health probes
# (ref: pkg/registry/componentstatus — scheduler :10251, controller-
# manager :10252, etcd; master.go getServersToValidate)
_register(ResourceInfo("componentstatuses", "ComponentStatus",
                       api.ComponentStatus, False, has_status=False))
# extensions/v1beta1 group (ref: pkg/registry/{job,deployment,daemonset,
# horizontalpodautoscaler,ingress}; mounted master.go:1049-1091 — served
# under /apis/extensions/v1beta1 by the API server)
EXTENSIONS_RESOURCES = ("jobs", "deployments", "daemonsets",
                        "horizontalpodautoscalers", "ingresses",
                        "thirdpartyresources")


def validate_third_party_resource(tpr: api.ThirdPartyResource) -> None:
    """(ref: validation.ValidateThirdPartyResource + util.go
    ExtractApiGroupAndKind: name must be <kind>.<domain>.<tld>)"""
    validate_object_meta(tpr.metadata, True)
    if len(tpr.metadata.name.split(".")) < 3:
        raise Invalid(
            f"metadata.name: {tpr.metadata.name!r} must be "
            f"<kind>.<domain>.<tld>")
    if not tpr.versions:
        raise Invalid("versions: at least one version is required")
    seen = set()
    for v in tpr.versions:
        if not v.name:
            raise Invalid("versions[].name: required value")
        if v.name in seen:
            raise Invalid(f"versions[].name: duplicate {v.name!r}")
        seen.add(v.name)


def extract_group_and_kind(tpr: api.ThirdPartyResource):
    """-> (kind, group, plural) from `<kind-dashed>.<domain>...`
    (ref: thirdpartyresourcedata/util.go ExtractApiGroupAndKind)."""
    parts = tpr.metadata.name.split(".")
    kind = "".join(p[:1].upper() + p[1:] for p in parts[0].split("-"))
    group = ".".join(parts[1:])
    plural = parts[0].replace("-", "") + "s"
    return kind, group, plural


def encode_third_party(obj: api.ThirdPartyResourceData, kind: str,
                       group_version: str) -> dict:
    """The raw custom document back out (the reference stores the whole
    JSON and re-serves it)."""
    wire = dict(obj.data)
    wire["kind"] = kind
    wire["apiVersion"] = group_version
    meta = {"name": obj.metadata.name, "namespace": obj.metadata.namespace,
            "uid": obj.metadata.uid,
            "resourceVersion": obj.metadata.resource_version,
            "creationTimestamp": obj.metadata.creation_timestamp}
    if obj.metadata.labels:
        meta["labels"] = dict(obj.metadata.labels)
    if obj.metadata.annotations:
        meta["annotations"] = dict(obj.metadata.annotations)
    wire["metadata"] = meta
    return wire


def decode_third_party(data: dict) -> api.ThirdPartyResourceData:
    meta = data.get("metadata") or {}
    return api.ThirdPartyResourceData(
        metadata=api.ObjectMeta(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", ""),
            uid=meta.get("uid", ""),
            resource_version=meta.get("resourceVersion", ""),
            creation_timestamp=meta.get("creationTimestamp", ""),
            labels=dict(meta.get("labels") or {}),
            annotations=dict(meta.get("annotations") or {})),
        data={k: v for k, v in data.items()
              if k not in ("kind", "apiVersion", "metadata")})
_register(ResourceInfo("jobs", "Job", api.Job, True))
_register(ResourceInfo("deployments", "Deployment", api.Deployment, True,
                       validate=validate_deployment))
_register(ResourceInfo("daemonsets", "DaemonSet", api.DaemonSet, True))
_register(ResourceInfo("horizontalpodautoscalers", "HorizontalPodAutoscaler",
                       api.HorizontalPodAutoscaler, True))
_register(ResourceInfo("ingresses", "Ingress", api.Ingress, True))
_register(ResourceInfo("thirdpartyresources", "ThirdPartyResource",
                       api.ThirdPartyResource, True,
                       validate=validate_third_party_resource,
                       has_status=False))
# Virtual resource: POST /bindings assigns a pod to a node (no storage of its
# own; ref: pkg/registry/pod/etcd BindingREST).
_register(ResourceInfo("bindings", "Binding", api.Binding, True,
                       has_status=False))
# coordination/leases: the CAS-renewed leader-election record
# (utils/leaderelection.py). Forward-ported from the reference's master
# election seam into the typed Lease the later reference grew; served
# flat under api/v1 rather than a coordination.k8s.io group (the server
# mounts one registry — DIVERGENCES.md #25). Every PUT carries the
# elector's observed resourceVersion, so acquisition races resolve to
# exactly one winner per fencing term at the store's CAS.
_register(ResourceInfo("leases", "Lease", api.Lease, True,
                       has_status=False))


class Registry:
    """Generic REST verbs for every registered resource over one Store."""

    def __init__(self, store: Optional[Store] = None,
                 scheme: Scheme = default_scheme,
                 admission: Optional[
                     Callable[[str, str, Any, str, str], Any]] = None,
                 service_cidr: str = "10.0.0.0/24",
                 txn_commit: bool = True):
        self.store = store or Store()
        self.scheme = scheme
        # multi-key ledger transactions for the batched bind/status
        # verbs: one revision window + one WAL frame + one publish
        # batch per call (store.commit_txn) instead of one store.batch
        # window per caller-side chunk. txn_commit=False keeps the
        # per-chunk batch() path as the A/B control arm
        # (bench.py --txn-ab); stores without the verb degrade to it.
        self._txn_commit = txn_commit and hasattr(self.store, "commit_txn")
        # per-resource field-map memo shared by this registry's filtered
        # watch predicates (see watch()); entries are transient and
        # bounded by periodic clear
        self._fields_memo: Dict[str, dict] = {}
        # admission(operation, resource, obj, namespace, name) -> obj;
        # raises to reject (ref: pkg/admission chain invoked from
        # resthandler createHandler). Set after construction when plugins
        # need the registry itself (admission.new_from_plugins).
        self.admission = admission
        # service cluster-IP + node-port allocators (ref:
        # pkg/registry/service ipallocator/portallocator); repaired from
        # the store so a registry over pre-existing state stays coherent
        # componentstatus probes (ref: master.go getServersToValidate —
        # the store plays etcd-0; Master adds scheduler/controller-
        # manager probes at their conventional ports)
        self.component_probes: Dict[str, Callable] = {
            "etcd-0": lambda: (
                True, f"revision {self.store.current_revision}")}
        from .allocators import IPAllocator, PortAllocator
        self.ip_allocator = IPAllocator(service_cidr)
        self.port_allocator = PortAllocator()
        for svc in self.store.list(self.prefix("services"))[0]:
            if svc.spec.cluster_ip and svc.spec.cluster_ip != "None":
                try:
                    self.ip_allocator.allocate_specific(svc.spec.cluster_ip)
                except Invalid:
                    pass
            for port in svc.spec.ports:
                if port.node_port:
                    try:
                        self.port_allocator.allocate_specific(port.node_port)
                    except Invalid:
                        pass

    def _store_batch(self, ops) -> List[Any]:
        """Route one batched multi-key write: the txn verb when enabled
        (whole op list in one revision window) or the classic batch()
        (same semantics, per-record WAL frames) as the control arm."""
        if self._txn_commit:
            return self.store.commit_txn(ops)
        return self.store.batch(ops)

    # ------------------------------------------------------------- keys

    @staticmethod
    def info(resource: str) -> ResourceInfo:
        try:
            return RESOURCES[resource]
        except KeyError:
            raise NotFound(f'the server could not find resource "{resource}"')

    @staticmethod
    def key(resource: str, namespace: str, name: str) -> str:
        return f"/registry/{resource}/{namespace}/{name}"

    @staticmethod
    def prefix(resource: str, namespace: str = "") -> str:
        if namespace:
            return f"/registry/{resource}/{namespace}/"
        return f"/registry/{resource}/"

    def _namespace_for(self, info: ResourceInfo, obj: Any,
                       namespace: str) -> str:
        if not info.namespaced:
            return ""
        ns = obj.metadata.namespace or namespace or "default"
        if namespace and obj.metadata.namespace and namespace != obj.metadata.namespace:
            raise BadRequest(
                f"namespace in URL ({namespace}) differs from object "
                f"({obj.metadata.namespace})")
        return ns

    # ------------------------------------------------------------ verbs

    def create(self, resource: str, obj: Any, namespace: str = "") -> Any:
        if resource == "componentstatuses":
            raise MethodNotSupported("componentstatuses is read-only")
        if resource == "bindings":
            return self.bind(obj, namespace)
        if resource == "thirdpartyresources":
            # two TPRs must never map to one (group, plural) — they'd
            # silently share a storage prefix and the first one's Kind
            _, new_group, new_plural = extract_group_and_kind(obj)
            existing = self.third_party_groups().get(new_group, {})
            if new_plural in existing:
                raise Conflict(
                    f"a ThirdPartyResource already serves "
                    f"{new_group}/{new_plural}")
        info = self.info(resource)
        ns, name, obj = self._prepare_create(info, resource, obj, namespace)
        if resource == "services":
            obj, allocated_ip, allocated_ports = self._service_allocate(obj)
            try:
                return self.store.create(self.key(resource, ns, name), obj,
                                         ttl=info.ttl)
            except Exception:
                # roll the allocations back (ref: service REST releases on
                # failed create)
                if allocated_ip:
                    self.ip_allocator.release(allocated_ip)
                for port in allocated_ports:
                    self.port_allocator.release(port)
                raise
        if resource == "pods":
            # the "create" stage of the pod lifecycle model: the
            # server-side store commit (utils/metrics.OBS_STAGES)
            with obs.tracer().span("registry.create", stage="create"):
                return self.store.create(self.key(resource, ns, name),
                                         obj, ttl=info.ttl)
        return self.store.create(self.key(resource, ns, name), obj, ttl=info.ttl)

    def _prepare_create(self, info: "ResourceInfo", resource: str, obj: Any,
                        namespace: str) -> Tuple[str, str, Any]:
        """Everything create() does to one object before the store write:
        type check, namespace resolution, name generation, uid/timestamp
        stamping, per-kind defaulting, validation, admission.
        -> (namespace, name, prepared object)."""
        if not isinstance(obj, info.cls):
            raise BadRequest(f"expected {info.kind}, got {type(obj).__name__}")
        ns = self._namespace_for(info, obj, namespace)
        meta = obj.metadata
        name = meta.name
        if not name and meta.generate_name:
            # ref: pkg/api/rest names.SimpleNameGenerator (5 random chars)
            name = meta.generate_name + _name_suffix(5)
        # create-time trace context rides the object as an annotation:
        # through the store, the WAL, every watch replay/live delivery
        # and every wire serialization — how the scheduler's informer
        # links a tile back to the create that fed it (obs layer). A
        # client-stamped annotation wins (cross-process creates where
        # the caller owns the root span).
        annotations = meta.annotations
        ctx = obs.current()
        if ctx is not None and obs.tracer().enabled \
                and obs.TRACEPARENT_ANNOTATION not in annotations:
            annotations = {**annotations,
                           obs.TRACEPARENT_ANNOTATION:
                           obs.format_traceparent(ctx)}
        meta = api.fast_replace(
            meta, name=name, namespace=ns,
            uid=meta.uid or _new_uid(),
            creation_timestamp=meta.creation_timestamp or api.now_rfc3339(),
            annotations=annotations,
            resource_version="")
        obj = api.fast_replace(obj, metadata=meta)
        if resource == "namespaces" and not obj.spec.finalizers:
            # every namespace carries the kubernetes finalizer so deletion
            # is two-phase (ref: pkg/registry/namespace/strategy.go
            # PrepareForCreate)
            obj = replace(obj, spec=replace(obj.spec,
                                            finalizers=["kubernetes"]))
        if info.validate:
            info.validate(obj)
        if self.admission:
            obj = self.admission("CREATE", resource, obj, ns, name)
        return ns, name, obj

    def create_batch(self, resource: str, objs: List[Any],
                     namespace: str = "") -> List[Any]:
        """Create many objects of one resource in a single store pass:
        one lock window, one watch fan-out flush (the write-side
        analogue of bind_batch — SURVEY.md section 7 hard part 2's
        create storm). Per-object preparation (validation, admission,
        name generation) is byte-identical to create(). Resources with
        create-time side effects outside the store (services' IP/port
        allocators, bindings, TPR mounting) fall back to the serial
        path object-by-object."""
        if resource in CREATE_SIDE_EFFECT_RESOURCES:
            return [self.create(resource, o, namespace) for o in objs]
        info = self.info(resource)
        entries = []
        for obj in objs:
            ns, name, prepared = self._prepare_create(
                info, resource, obj, namespace)
            entries.append((self.key(resource, ns, name), prepared, info.ttl))
        # _prepare_create fresh-builds both the object and its metadata
        # (fast_replace x2) and admission plugins only ever swap
        # spec/status around that fresh metadata, so the store may
        # stamp the revision in place instead of re-cloning both per
        # object (the clone pair was most of the create storm's work
        # under the store lock, PROFILE_e2e.md)
        if resource == "pods":
            with obs.tracer().span("registry.create_batch", stage="create",
                                   attrs={"pods": len(entries)}):
                return self.store.create_batch(entries, owned_meta=True)
        return self.store.create_batch(entries, owned_meta=True)

    def create_from_template(self, resource: str, template: Any,
                             names: List[str], namespace: str = ""
                             ) -> List[Any]:
        """Columnar bulk create — the host half of the array-first
        design (SURVEY.md section 7 hard part 3; PROFILE_e2e.md's
        ~80us/pod interpreter floor). One validation pass on the
        template, then per name only a fresh ObjectMeta (name, uid,
        shared timestamp) around the template's spec/status, which the
        created objects SHARE. Sharing is safe under the framework's
        replace-don't-mutate contract: every write path (store rv
        stamping, binding assignment, status updates) clones via
        fast_replace and the store's owned_meta stamping touches only
        the per-object fresh metadata.

        Falls back to the per-object create path when admission chains
        or create-time side effects (services' allocators, TPRs) need
        to see each object individually."""
        info = self.info(resource)
        if self.admission or resource in TEMPLATE_FALLBACK_RESOURCES:
            return self.create_batch(
                resource, api.expand_template_rows(template, names),
                namespace)
        if not names:
            return []
        if not isinstance(template, info.cls):
            raise BadRequest(
                f"expected {info.kind}, got {type(template).__name__}")
        ns = self._namespace_for(info, template, namespace)
        ts = api.now_rfc3339()
        tm = template.metadata
        # same traceparent stamping as _prepare_create, once for the
        # whole batch: the rows share the creating span's context (one
        # logical create storm, one trace exemplar per template)
        ctx = obs.current()
        if ctx is not None and obs.tracer().enabled \
                and obs.TRACEPARENT_ANNOTATION not in tm.annotations:
            tm = api.fast_replace(
                tm, annotations={**tm.annotations,
                                 obs.TRACEPARENT_ANNOTATION:
                                 obs.format_traceparent(ctx)})
        # template-wide validation once, against a representative row
        rep = api.fast_replace(
            template, metadata=api.fast_replace(
                tm, name=names[0], namespace=ns, uid="template",
                creation_timestamp=ts, resource_version=""))
        if info.validate:
            info.validate(rep)
        # one RFC-4122-shaped random base, consecutive uids off it: the
        # per-row cost is one hex format instead of a fresh getrandbits
        base = _uid_rng().getrandbits(128)
        key_prefix = self.key(resource, ns, "")
        entries = []
        fr = api.fast_replace
        for i, name in enumerate(names):
            if not _dns1123(name):
                raise Invalid(f"metadata.name: invalid value {name!r}")
            bits = base + i
            bits = (bits & ~(0xF << 76)) | (0x4 << 76)
            bits = (bits & ~(0x3 << 62)) | (0x2 << 62)
            h = "%032x" % bits
            meta = fr(tm, name=name, namespace=ns,
                      uid=f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}",
                      creation_timestamp=ts, resource_version="")
            entries.append((key_prefix + name, fr(template, metadata=meta),
                            info.ttl))
        if resource == "pods":
            with obs.tracer().span("registry.create_from_template",
                                   stage="create",
                                   attrs={"pods": len(entries)}):
                return self.store.create_batch(entries, owned_meta=True)
        return self.store.create_batch(entries, owned_meta=True)

    def _service_allocate(self, obj: api.Service):
        """Assign cluster IP + node ports (ref: pkg/registry/service
        rest.go Create: headless "None" skips IP; explicit requests are
        honored or rejected; NodePort/LoadBalancer types get node ports)."""
        # an explicit JSON-null spec decodes to None: normalize to
        # defaults so the allocator (and every later reader of the
        # STORED object) sees a real ServiceSpec
        spec = obj.spec or api.ServiceSpec()
        allocated_ip = ""
        if spec.cluster_ip != "None":
            if spec.cluster_ip:
                self.ip_allocator.allocate_specific(spec.cluster_ip)
                allocated_ip = spec.cluster_ip
            else:
                allocated_ip = self.ip_allocator.allocate()
                spec = replace(spec, cluster_ip=allocated_ip)
        allocated_ports = []
        if spec.type in ("NodePort", "LoadBalancer"):
            try:
                ports = []
                for port in spec.ports:
                    if port.node_port:
                        self.port_allocator.allocate_specific(port.node_port)
                        allocated_ports.append(port.node_port)
                        ports.append(port)
                    else:
                        node_port = self.port_allocator.allocate()
                        allocated_ports.append(node_port)
                        ports.append(replace(port, node_port=node_port))
                spec = replace(spec, ports=ports)
            except Exception:
                if allocated_ip:
                    self.ip_allocator.release(allocated_ip)
                for port in allocated_ports:
                    self.port_allocator.release(port)
                raise
        return replace(obj, spec=spec), allocated_ip, allocated_ports

    def _service_update_ports(self, current: api.Service, obj: api.Service):
        """Reconcile node-port allocations on update: newly requested
        ports are claimed (or assigned when 0 on a NodePort service);
        ports the update drops are returned for release AFTER the store
        write lands (a failed write must leave the allocator matching
        storage). -> (obj, claimed, to_release_on_success)."""
        old_ports = {p.node_port for p in current.spec.ports if p.node_port}
        spec = obj.spec
        wants_node_ports = spec.type in ("NodePort", "LoadBalancer")
        claimed = []
        try:
            ports = []
            for port in spec.ports:
                if port.node_port and not wants_node_ports:
                    # type changed to ClusterIP: strip the node port so the
                    # stale allocation is released below (ref: service REST
                    # releases node ports when the type drops them).
                    ports.append(replace(port, node_port=0))
                elif port.node_port:
                    if port.node_port not in old_ports:
                        self.port_allocator.allocate_specific(port.node_port)
                        claimed.append(port.node_port)
                    ports.append(port)
                elif wants_node_ports:
                    node_port = self.port_allocator.allocate()
                    claimed.append(node_port)
                    ports.append(replace(port, node_port=node_port))
                else:
                    ports.append(port)
        except Exception:
            for port in claimed:
                self.port_allocator.release(port)
            raise
        new_ports = {p.node_port for p in ports if p.node_port}
        return (replace(obj, spec=replace(spec, ports=ports)), claimed,
                sorted(old_ports - new_ports))

    def _service_release(self, obj: api.Service) -> None:
        if obj.spec.cluster_ip and obj.spec.cluster_ip != "None":
            self.ip_allocator.release(obj.spec.cluster_ip)
        for port in obj.spec.ports:
            if port.node_port:
                self.port_allocator.release(port.node_port)

    def get(self, resource: str, name: str, namespace: str = "") -> Any:
        if resource == "componentstatuses":
            if name not in self.component_probes:
                raise NotFound(kind=resource, name=name)
            # only the requested component is probed — a down scheduler
            # must not slow a GET of etcd-0
            return self._component_statuses([name])[0]
        info = self.info(resource)
        # cluster-scoped resources ignore a caller-supplied namespace
        # (the CLI defaults one for every request; HttpClient._url
        # drops it, the in-proc path must too)
        ns = (namespace or "default") if info.namespaced else ""
        try:
            return self.store.get(self.key(resource, ns, name))
        except NotFound:
            raise NotFound(kind=resource, name=name)

    def _component_statuses(self, names: Optional[List[str]] = None
                            ) -> List[api.ComponentStatus]:
        """Computed per request from the registered probes, fanned out
        in parallel — one slow/down component costs one timeout, not a
        sum (ref: pkg/registry/componentstatus REST.List ->
        validator.Server, probed concurrently)."""
        from concurrent.futures import ThreadPoolExecutor

        wanted = sorted(names if names is not None
                        else self.component_probes)

        def run_probe(name):
            try:
                return self.component_probes[name]()
            except Exception as e:
                return False, repr(e)

        with ThreadPoolExecutor(max_workers=max(1, len(wanted))) as pool:
            results = list(pool.map(run_probe, wanted))
        return [api.ComponentStatus(
            metadata=api.ObjectMeta(name=name),
            conditions=[api.ComponentCondition(
                type="Healthy",
                status="True" if ok else "False",
                message=message if ok else "",
                error="" if ok else message)])
            for name, (ok, message) in zip(wanted, results)]

    def add_component_probe(self, name: str, probe) -> None:
        """probe() -> (healthy: bool, message: str)."""
        self.component_probes[name] = probe

    def list(self, resource: str, namespace: str = "",
             label_selector: str = "", field_selector: str = ""
             ) -> Tuple[List[Any], int]:
        info = self.info(resource)
        if not info.namespaced:
            namespace = ""  # cluster-scoped: a defaulted ns must not filter
        lsel = labelspkg.parse(label_selector) if label_selector else None
        fsel = fieldspkg.parse(field_selector) if field_selector else None
        if fsel is not None:
            fsel = convert_field_selector(resource, fsel)

        fmatch = field_matcher(info, fsel) if fsel is not None else None

        def pred(o: Any) -> bool:
            if lsel is not None and not lsel.matches(o.metadata.labels):
                return False
            if fmatch is not None and not fmatch(o):
                return False
            return True

        use_pred = pred if (lsel is not None or fsel is not None) else None
        if resource == "componentstatuses":
            statuses = self._component_statuses()
            if use_pred is not None:
                statuses = [s for s in statuses if pred(s)]
            return statuses, self.store.current_revision
        return self.store.list(self.prefix(resource, namespace), use_pred)

    def update(self, resource: str, obj: Any, namespace: str = "") -> Any:
        if resource == "componentstatuses":
            raise MethodNotSupported("componentstatuses is read-only")
        info = self.info(resource)
        ns = self._namespace_for(info, obj, namespace)
        if not obj.metadata.name:
            raise Invalid("metadata.name: required value")
        if resource == "namespaces":
            # finalizers/deletionTimestamp only move via DELETE and the
            # finalize subresource (ref: pkg/registry/namespace/strategy.go
            # PrepareForUpdate pins them on regular updates)
            current = self.store.get(self.key(resource, "", obj.metadata.name))
            obj = replace(
                obj,
                metadata=replace(obj.metadata,
                                 deletion_timestamp=(
                                     current.metadata.deletion_timestamp)),
                spec=replace(obj.spec,
                             finalizers=list(current.spec.finalizers)))
        if resource == "services":
            # clusterIP is immutable once assigned (ref:
            # pkg/registry/service/rest.go Update + api validation)
            current = self.store.get(self.key(resource, ns,
                                              obj.metadata.name))
            if not obj.spec.cluster_ip:
                obj = replace(obj, spec=replace(
                    obj.spec, cluster_ip=current.spec.cluster_ip))
            elif obj.spec.cluster_ip != current.spec.cluster_ip:
                raise Invalid("spec.clusterIP: field is immutable")
            obj, svc_claimed, svc_to_release = \
                self._service_update_ports(current, obj)
        else:
            svc_claimed, svc_to_release = [], []
        if info.validate:
            info.validate(obj)
        try:
            if self.admission:
                obj = self.admission("UPDATE", resource, obj, ns,
                                     obj.metadata.name)
            key = self.key(resource, ns, obj.metadata.name)
            if not obj.metadata.resource_version:
                # Unconditional update requires the object to exist
                # (PUT never creates in the reference's generic store).
                # One atomic read-modify-write: a get-then-set pair
                # would let a concurrent DELETE land between the two
                # lock acquisitions and the set would RESURRECT the
                # deleted object as a fresh ADDED event
                result = self.store.guaranteed_update(
                    key, lambda cur: obj, ttl=info.ttl)
            else:
                result = self.store.update(key, obj)
        except Exception:
            # the write never landed: newly claimed ports go back, dropped
            # ones stay owned by the stored object
            for port in svc_claimed:
                self.port_allocator.release(port)
            raise
        for port in svc_to_release:
            self.port_allocator.release(port)
        return result

    # Resources serving the scale subresource and how a Scale projects
    # onto them (ref: registry/experimental/controller/etcd/etcd.go
    # ScaleREST for replicationcontrollers, registry/deployment/etcd
    # for deployments).
    SCALABLE = ("replicationcontrollers", "deployments")

    @staticmethod
    def _project_scale(obj: Any) -> api.Scale:
        """RC/Deployment -> its Scale projection (shared by GET and the
        post-update read-back so the two cannot drift)."""
        return api.Scale(
            metadata=api.ObjectMeta(
                name=obj.metadata.name, namespace=obj.metadata.namespace,
                resource_version=obj.metadata.resource_version,
                creation_timestamp=obj.metadata.creation_timestamp),
            spec=api.ScaleSpec(replicas=obj.spec.replicas),
            status=api.ScaleStatus(replicas=obj.status.replicas,
                                   selector=dict(obj.spec.selector)))

    def get_scale(self, resource: str, name: str,
                  namespace: str = "") -> api.Scale:
        if resource not in self.SCALABLE:
            raise NotFound(f"{resource} has no scale subresource")
        return self._project_scale(self.get(resource, name, namespace))

    def update_scale(self, resource: str, name: str, scale: api.Scale,
                     namespace: str = "") -> api.Scale:
        """PUT .../{name}/scale: move ONLY spec.replicas, optimistic on
        the Scale's resourceVersion when it carries one (the reference's
        ScaleREST.Update runs the generic GuaranteedUpdate)."""
        if resource not in self.SCALABLE:
            raise NotFound(f"{resource} has no scale subresource")
        ns = namespace or "default"
        key = self.key(resource, ns, name)
        want = scale.spec.replicas
        if want < 0:
            raise Invalid("spec.replicas: must be non-negative")
        expect_rv = scale.metadata.resource_version

        def apply(cur: Any) -> Any:
            if expect_rv and cur.metadata.resource_version != expect_rv:
                raise Conflict(
                    f"scale update on {key} failed: object was modified "
                    f"(have {expect_rv}, current "
                    f"{cur.metadata.resource_version})")
            return replace(cur, spec=replace(cur.spec, replicas=want))

        return self._project_scale(self.store.guaranteed_update(key, apply))

    # Content types the PATCH verb accepts (ref: pkg/api/types.go:2065
    # PatchType; resthandler.go patchResource dispatches on them)
    PATCH_STRATEGIC = "application/strategic-merge-patch+json"
    PATCH_MERGE = "application/merge-patch+json"
    PATCH_JSON = "application/json-patch+json"

    def patch(self, resource: str, name: str, patch_body: Any,
              namespace: str = "",
              patch_type: str = PATCH_STRATEGIC) -> Any:
        """Server-side PATCH (ref: pkg/apiserver/resthandler.go
        patchResource): read the live object, apply the patch in wire
        space per content type, decode, and PUT — retrying the
        read-apply-write loop on optimistic-concurrency conflicts the
        way the reference's patch handler re-applies against a fresh
        read. The merged document carries the read's resourceVersion,
        so a racing writer surfaces as Conflict, never a lost update."""
        from ..utils.strategicpatch import (apply_json_patch,
                                            json_merge_patch,
                                            strategic_patch)
        info = self.info(resource)
        ns = (namespace or "default") if info.namespaced else ""
        last: Optional[Conflict] = None
        for _ in range(5):
            current = self.get(resource, name, ns)
            wire = self.scheme.encode_dict(current)
            if patch_type == self.PATCH_JSON:
                if not isinstance(patch_body, list):
                    raise BadRequest("json-patch body must be a list "
                                     "of operations")
                try:
                    merged = apply_json_patch(wire, patch_body)
                except (ValueError, KeyError, IndexError,
                        TypeError) as e:
                    raise BadRequest(f"json patch failed: {e}")
            elif patch_type == self.PATCH_MERGE:
                if not isinstance(patch_body, dict):
                    raise BadRequest("merge-patch body must be an object")
                merged = json_merge_patch(wire, patch_body)
            elif patch_type == self.PATCH_STRATEGIC:
                if not isinstance(patch_body, dict):
                    raise BadRequest(
                        "strategic-merge-patch body must be an object "
                        "(json-patch op arrays need the "
                        "application/json-patch+json content type)")
                try:
                    merged = strategic_patch(wire, patch_body)
                except ValueError as e:
                    # unknown $patch directive (patch.go's "Unknown
                    # patch type" surfaces as a 400)
                    raise BadRequest(f"strategic merge patch failed: {e}")
            else:
                raise BadRequest(
                    f"unsupported patch content type {patch_type!r}")
            if not isinstance(merged, dict):
                raise BadRequest("patch must produce an object")
            # identity is immutable under PATCH; the read's rv rides
            # along for the CAS unless the patch pinned one itself
            merged.setdefault("kind", wire.get("kind"))
            merged.setdefault("apiVersion", wire.get("apiVersion"))
            meta = merged.setdefault("metadata", {})
            if not isinstance(meta, dict):
                raise BadRequest("patch produced a non-object metadata")
            meta["name"] = current.metadata.name
            meta.setdefault("resourceVersion",
                            current.metadata.resource_version)
            obj = self.scheme.decode_dict(merged)
            try:
                return self.update(resource, obj, ns)
            except Conflict as e:
                last = e
                continue
        raise last if last is not None else Conflict(
            f"patch on {resource}/{name} could not land")

    def update_status(self, resource: str, obj: Any, namespace: str = "") -> Any:
        """Status subresource: replace only .status, keep spec/meta
        (ref: pkg/registry/pod/etcd statusStrategy)."""
        info = self.info(resource)
        if not info.has_status:
            raise BadRequest(f"{resource} has no status subresource")
        ns = self._namespace_for(info, obj, namespace)
        key = self.key(resource, ns, obj.metadata.name)
        new_status = obj.status
        expect_rv = obj.metadata.resource_version

        def apply(cur: Any) -> Any:
            # optimistic concurrency like every reference status write
            # (statusStrategy through the generic etcd update,
            # etcd.go:270-316): a writer carrying a stale rv must 409
            # and re-read, not silently resurrect what it saw before —
            # e.g. a delayed kubelet heartbeat overwriting the node
            # controller's Ready=Unknown with pre-outage conditions.
            # rv-less writes stay unconditional (the in-proc callers'
            # documented contract).
            if expect_rv and cur.metadata.resource_version != expect_rv:
                raise Conflict(
                    f"status update on {key} failed: object was "
                    f"modified (have {expect_rv}, current "
                    f"{cur.metadata.resource_version})")
            return replace(cur, status=new_status)

        return self.store.guaranteed_update(key, apply)

    def update_status_batch(self, resource: str, objs: List[Any],
                            namespace: str = "") -> List[Any]:
        """Many status writes in ONE store pass (single lock, batched
        watch fan-out; one revision window when the store's txn verb is
        routed — see _store_batch). The hollow fleet confirms a whole
        tile of pods Running this way; semantics per object match
        update_status. The batch is all-or-nothing — callers that need
        per-object NotFound tolerance catch and degrade to singles."""
        info = self.info(resource)
        if not info.has_status:
            raise BadRequest(f"{resource} has no status subresource")
        ops = []
        for obj in objs:
            ns = self._namespace_for(info, obj, namespace)

            def set_status(cur, rv="", s=obj.status,
                           expect=obj.metadata.resource_version):
                if expect and cur.metadata.resource_version != expect:
                    # same optimistic-concurrency contract as the
                    # single update_status above
                    raise Conflict(
                        f"status update failed: object was modified "
                        f"(have {expect}, current "
                        f"{cur.metadata.resource_version})")
                if rv:
                    return api.fast_replace(
                        cur, status=s, metadata=api.fast_replace(
                            cur.metadata, resource_version=rv))
                return replace(cur, status=s)

            set_status.wants_rv = True
            ops.append((self.key(resource, ns, obj.metadata.name),
                        set_status))
        return self._store_batch(ops)

    def guaranteed_update(self, resource: str, name: str, namespace: str,
                          fn) -> Any:
        """Retry-on-conflict read-modify-write through the store
        (GuaranteedUpdate semantics, etcd_helper.go:449), for callers that
        must be atomic against concurrent writers (quota admission)."""
        info = self.info(resource)
        ns = (namespace or "default") if info.namespaced else ""
        return self.store.guaranteed_update(self.key(resource, ns, name), fn)

    def delete(self, resource: str, name: str, namespace: str = "",
               grace_period_seconds: Optional[int] = None,
               uid: Optional[str] = None) -> Any:
        if resource == "componentstatuses":
            raise MethodNotSupported("componentstatuses is read-only")
        info = self.info(resource)
        ns = (namespace or "default") if info.namespaced else ""
        if self.admission:
            self.admission("DELETE", resource, None, ns, name)
        if resource == "namespaces":
            return self._delete_namespace(name)
        if resource == "pods":
            graceful = self._pod_graceful_delete(ns, name,
                                                 grace_period_seconds, uid)
            if graceful is not None:
                return graceful
        key = self.key(resource, ns, name)
        try:
            if uid:
                # Preconditions.UID (ref: pkg/api/types.go, honored by
                # rest/delete.go BeforeDelete): CAS on the rv observed
                # WITH the matching uid, so a same-name replacement
                # created between the check and the delete survives
                while True:
                    cur = self.store.get(key)
                    if cur.metadata.uid != uid:
                        raise Conflict(
                            f"uid precondition failed: have "
                            f"{uid}, current {cur.metadata.uid}")
                    try:
                        deleted = self.store.delete(
                            key, expect_rv=cur.metadata.resource_version)
                        break
                    except Conflict:
                        continue  # rv moved: re-read and re-check uid
            else:
                deleted = self.store.delete(key)
        except NotFound:
            raise NotFound(kind=resource, name=name)
        if resource == "services":
            self._service_release(deleted)
        if resource == "thirdpartyresources":
            # unmounting a kind removes its instance data too (ref:
            # master.go removeThirdPartyStorage) — otherwise stale
            # objects silently resurrect under a re-created TPR
            _, group, plural = extract_group_and_kind(deleted)
            prefix = f"/registry/thirdparty/{group}/{plural}/"
            for obj in self.store.list(prefix)[0]:
                try:
                    self.store.delete(self.third_party_key(
                        group, plural, obj.metadata.namespace,
                        obj.metadata.name))
                except NotFound:
                    pass
        return deleted

    def _pod_graceful_delete(self, ns: str, name: str,
                             grace: Optional[int],
                             uid: Optional[str] = None
                             ) -> Optional[api.Pod]:
        """Two-phase pod deletion (ref: pkg/api/rest/delete.go
        BeforeDelete + pkg/registry/pod/strategy.go CheckGracefulDelete):
        a running, scheduled pod with a grace period is MARKED
        (deletionTimestamp = now+grace, deletionGracePeriodSeconds) and
        stays in the store for the kubelet to drain and confirm with a
        grace-0 delete; unscheduled or already-terminal pods — and
        grace 0 — fall through to the immediate path (returns None).
        Repeated deletes may only SHORTEN the grace period.

        Divergence from the reference: an absent grace defaults to the
        pod's own spec.terminationGracePeriodSeconds OR immediate —
        not the reference's unconditional 30s (DIVERGENCES #20)."""
        key = self.key("pods", ns, name)
        try:
            pod = self.store.get(key)
        except NotFound:
            raise NotFound(kind="pods", name=name)
        if grace is None:
            grace = pod.spec.termination_grace_period_seconds or 0
        if grace < 0:
            raise Invalid("gracePeriodSeconds: must be non-negative")
        if (grace == 0 or not pod.spec.node_name
                or pod.status.phase in (api.POD_SUCCEEDED, api.POD_FAILED)):
            return None

        expires = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                time.gmtime(int(time.time()) + grace))

        class _AlreadyTerminating(Exception):
            def __init__(self, current):
                self.current = current

        def apply(cur: Any) -> Any:
            # the only-shorten check runs on the CURRENT object inside
            # the CAS closure — a racing longer-grace delete must not
            # re-lengthen a period another caller already shortened
            # (the pre-read outside the closure can be stale)
            if uid and cur.metadata.uid != uid:
                raise Conflict(f"uid precondition failed: have {uid}, "
                               f"current {cur.metadata.uid}")
            existing = cur.metadata.deletion_grace_period_seconds
            if (cur.metadata.deletion_timestamp is not None
                    and existing is not None and grace >= existing):
                raise _AlreadyTerminating(cur)  # no-op: don't re-stamp
            return replace(cur, metadata=replace(
                cur.metadata, deletion_timestamp=expires,
                deletion_grace_period_seconds=grace))

        try:
            return self.store.guaranteed_update(key, apply)
        except _AlreadyTerminating as e:
            return e.current

    # --------------------------------------------- namespace lifecycle

    def _delete_namespace(self, name: str) -> Any:
        """Two-phase: with finalizers present, DELETE only marks the
        namespace Terminating; the namespace controller empties it and
        finalizes, and the store drop happens once finalizers are gone
        (ref: pkg/registry/namespace/etcd/etcd.go Delete +
        namespace strategy)."""
        key = self.key("namespaces", "", name)
        try:
            current = self.store.get(key)
        except NotFound:
            raise NotFound(kind="namespaces", name=name)
        if not current.spec.finalizers:
            return self.store.delete(key)

        def mark(ns_obj):
            return replace(
                ns_obj,
                metadata=replace(ns_obj.metadata,
                                 deletion_timestamp=(
                                     ns_obj.metadata.deletion_timestamp
                                     or api.now_rfc3339())),
                status=replace(ns_obj.status, phase="Terminating"))

        return self.store.guaranteed_update(key, mark)

    def finalize_namespace(self, obj: api.Namespace) -> Any:
        """Replace spec.finalizers; if the namespace is terminating and no
        finalizers remain, remove it from storage (ref:
        pkg/registry/namespace/etcd FinalizeREST + etcd.go Delete)."""
        key = self.key("namespaces", "", obj.metadata.name)

        def swap(ns_obj):
            return replace(ns_obj, spec=replace(
                ns_obj.spec, finalizers=list(obj.spec.finalizers)))

        updated = self.store.guaranteed_update(key, swap)
        if (updated.metadata.deletion_timestamp is not None
                and not updated.spec.finalizers):
            try:
                return self.store.delete(key)
            except NotFound:
                pass
        return updated

    def delete_collection(self, resource: str, namespace: str = "",
                          label_selector: str = "",
                          field_selector: str = "") -> List[Any]:
        items, _ = self.list(resource, namespace, label_selector, field_selector)
        out = []
        for o in items:
            try:
                out.append(self.delete(resource, o.metadata.name,
                                       o.metadata.namespace))
            except NotFound:
                pass
        return out

    def watch(self, resource: str, namespace: str = "",
              since_rev: Optional[int] = None, label_selector: str = "",
              field_selector: str = "", shard: Any = None) -> Watcher:
        if resource == "componentstatuses":
            # computed per request, not stored: a watch would hang
            # forever with zero events (the reference rejects it too)
            raise MethodNotSupported("componentstatuses is not watchable")
        pred = None
        if label_selector or field_selector:
            # server-side watch filtering (the apiserver filters before
            # the wire; transition semantics live in store._filtered_event)
            info = self.info(resource)
            lsel = labelspkg.parse(label_selector) if label_selector else None
            fsel = fieldspkg.parse(field_selector) if field_selector else None
            if fsel is not None:
                fsel = convert_field_selector(resource, fsel)
            # The store's publisher fans one event out to every
            # filtered watcher in a single serialized pass (under its
            # publish lock — off the ledger lock since the two-phase
            # commit split, so this memo stays single-threaded);
            # without sharing, N watchers rebuild the same field map N
            # times per event (2N for MODIFIED: new + prev). Memo key
            # (id, resourceVersion) is collision-safe within this
            # registry — its rv strings are unique per committed write,
            # so an id reused by a later object of the SAME store can't
            # alias (the memo is per-Registry precisely because two
            # stores can mint equal rvs for different objects).
            def _memoized_fields_of():
                # memo'd dict path, built only when the selector didn't
                # compile (the common selectors all compile)
                memo = self._fields_memo.setdefault(resource, {})

                def fields_of(o: Any) -> Dict[str, str]:
                    key = (id(o), o.metadata.resource_version)
                    f = memo.get(key)
                    if f is None:
                        if len(memo) > 16:
                            memo.clear()
                        f = info.fields_fn(o)
                        memo[key] = f
                    return f
                return fields_of

            fmatch = (field_matcher(info, fsel, _memoized_fields_of)
                      if fsel is not None else None)

            def pred(o: Any) -> bool:
                if lsel is not None and not lsel.matches(o.metadata.labels):
                    return False
                if fmatch is not None and not fmatch(o):
                    return False
                return True
        if not self.info(resource).namespaced:
            namespace = ""  # cluster-scoped (same rule as list)
        if shard is not None:
            # worker fan-out shard routing (Fleet serving): the watcher
            # joins the serving worker's partition and is delivered by
            # that worker's pump. Passed through only when set, so any
            # duck-typed store without shard support keeps working.
            return self.store.watch(self.prefix(resource, namespace),
                                    since_rev, predicate=pred, shard=shard)
        return self.store.watch(self.prefix(resource, namespace), since_rev,
                                predicate=pred)

    # ------------------------------------------------- binding subresource

    @staticmethod
    def _binding_op(binding: api.Binding, namespace: str):
        """(store key, CAS update fn) for one binding — shared by bind and
        bind_batch so validation + annotation-merge semantics can't drift
        (ref: pkg/registry/pod/etcd/etcd.go:121 BindingREST.Create ->
        assignPod -> setPodHostAndAnnotations)."""
        return Registry._assign_op(
            binding.metadata.namespace or namespace or "default",
            binding.metadata.name, binding.target.name,
            dict(binding.metadata.annotations))

    @staticmethod
    def _assign_op(ns: str, name: str, host: str,
                   annotations: Dict[str, str]):
        if not name:
            raise Invalid("binding.metadata.name: required value")
        if not host:
            raise Invalid("binding.target.name: required value")

        def assign(pod: api.Pod, rv: str = "") -> api.Pod:
            """wants_rv: with a pre-assigned resourceVersion the stamped
            pod is built in one pass (store.batch fuses the rv clone)."""
            if pod.spec.node_name:
                raise Conflict(
                    f"pod {pod.metadata.name} is already assigned to a node")
            meta_fields: Dict[str, Any] = {}
            if annotations:
                meta_fields["annotations"] = {**pod.metadata.annotations,
                                              **annotations}
            if rv:
                meta_fields["resource_version"] = rv
            meta = (api.fast_replace(pod.metadata, **meta_fields)
                    if meta_fields else pod.metadata)
            return api.fast_replace(
                pod, metadata=meta,
                spec=api.fast_replace(pod.spec, node_name=host))

        assign.wants_rv = True
        return ns, name, assign

    def bind(self, binding: api.Binding, namespace: str = "") -> api.Pod:
        """POST bindings: set pod.spec.nodeName iff currently unset, merging
        binding annotations."""
        ns, name, assign = self._binding_op(binding, namespace)
        key = self.key("pods", ns, name)
        try:
            return self.store.guaranteed_update(key, assign)
        except NotFound:
            raise NotFound(kind="pods", name=name)

    def bind_batch(self, bindings: List[api.Binding],
                   namespace: str = "") -> List[api.Pod]:
        """Commit a tile of bindings in one store pass (all-or-nothing) —
        the batched-commit path the <1s/30k-pod north star requires
        (SURVEY.md section 7 hard part 2). Per-binding validation and
        conflict semantics are identical to bind()."""
        ops = []
        for b in bindings:
            ns, name, assign = self._binding_op(b, namespace)
            ops.append((self.key("pods", ns, name), assign))
        return self._store_batch(ops)

    def bind_batch_hosts(self, assignments: List[Tuple[str, str, str]]
                         ) -> List[api.Pod]:
        """bind_batch without the Binding carrier objects: (namespace,
        name, host) rows straight from the batch scheduler's tile —
        the columnar commit half of the host hot path. CAS/assignment
        semantics are _assign_op's, identical to bind()."""
        ops = []
        for ns, name, host in assignments:
            ns2, name2, assign = self._assign_op(ns or "default", name,
                                                 host, {})
            ops.append((self.key("pods", ns2, name2), assign))
        return self._store_batch(ops)

    # ------------------------------------------- third-party resources

    def third_party_groups(self) -> Dict[str, Dict[str, Tuple[str, str]]]:
        """group -> {plural: (Kind, version)} derived live from the
        stored ThirdPartyResources (a restarted apiserver re-mounts
        everything from the store, like master.go:972 on re-list).
        create() rejects new collisions on (group, plural); should
        pre-existing store state still contain any, the first TPR in
        (namespace, name) order wins deterministically."""
        out: Dict[str, Dict[str, Tuple[str, str]]] = {}
        tprs, _ = self.list("thirdpartyresources", "")
        for tpr in sorted(tprs, key=lambda t: (t.metadata.namespace,
                                               t.metadata.name)):
            kind, group, plural = extract_group_and_kind(tpr)
            version = tpr.versions[0].name if tpr.versions else "v1"
            out.setdefault(group, {}).setdefault(plural, (kind, version))
        return out

    def third_party_kind(self, group: str, plural: str,
                         groups: Optional[Dict] = None
                         ) -> Tuple[str, str]:
        """-> (Kind, version); NotFound when no TPR declares the pair.
        `groups`: a precomputed third_party_groups() map (the server
        resolves once per request instead of re-scanning per verb)."""
        kinds = (groups if groups is not None
                 else self.third_party_groups()).get(group, {})
        if plural not in kinds:
            raise NotFound(
                f'the server could not find resource "{plural}" '
                f'in group "{group}"')
        return kinds[plural]

    @staticmethod
    def third_party_key(group: str, plural: str, namespace: str,
                        name: str = "") -> str:
        base = f"/registry/thirdparty/{group}/{plural}/{namespace}/"
        return base + name if name else base

    def third_party_create(self, group: str, plural: str,
                           obj: api.ThirdPartyResourceData,
                           namespace: str, checked: bool = False
                           ) -> api.ThirdPartyResourceData:
        if not checked:
            self.third_party_kind(group, plural)
        name = obj.metadata.name
        if not _dns1123(name):
            raise Invalid(f"metadata.name: invalid value {name!r}")
        if obj.metadata.namespace and namespace \
                and obj.metadata.namespace != namespace:
            # the URL names the namespace the authorizer approved; the
            # body must not redirect the write (typed _namespace_for
            # enforces the same)
            raise BadRequest(
                f"namespace mismatch: body {obj.metadata.namespace!r} "
                f"vs request {namespace!r}")
        ns = obj.metadata.namespace or namespace or "default"
        if not _dns1123(ns):
            raise Invalid(f"metadata.namespace: invalid value {ns!r}")
        obj = api.fast_replace(obj, metadata=api.fast_replace(
            obj.metadata, namespace=ns, uid=obj.metadata.uid or _new_uid(),
            creation_timestamp=(obj.metadata.creation_timestamp
                                or api.now_rfc3339()),
            resource_version=""))
        return self.store.create(
            self.third_party_key(group, plural, ns, name), obj)

    def third_party_get(self, group: str, plural: str, name: str,
                        namespace: str, checked: bool = False
                        ) -> api.ThirdPartyResourceData:
        if not checked:
            self.third_party_kind(group, plural)
        try:
            return self.store.get(
                self.third_party_key(group, plural, namespace, name))
        except NotFound:
            raise NotFound(kind=plural, name=name)

    def third_party_list(self, group: str, plural: str,
                         namespace: str = "", checked: bool = False):
        if not checked:
            self.third_party_kind(group, plural)
        if namespace:
            return self.store.list(
                self.third_party_key(group, plural, namespace))
        return self.store.list(f"/registry/thirdparty/{group}/{plural}/")

    def third_party_update(self, group: str, plural: str,
                           obj: api.ThirdPartyResourceData,
                           namespace: str, checked: bool = False
                           ) -> api.ThirdPartyResourceData:
        if not checked:
            self.third_party_kind(group, plural)
        if not obj.metadata.name:
            raise Invalid("metadata.name: required value")
        if obj.metadata.namespace and namespace \
                and obj.metadata.namespace != namespace:
            raise BadRequest(
                f"namespace mismatch: body {obj.metadata.namespace!r} "
                f"vs request {namespace!r}")
        ns = obj.metadata.namespace or namespace or "default"
        return self.store.update(
            self.third_party_key(group, plural, ns, obj.metadata.name),
            obj)

    def third_party_delete(self, group: str, plural: str, name: str,
                           namespace: str, checked: bool = False
                           ) -> api.ThirdPartyResourceData:
        if not checked:
            self.third_party_kind(group, plural)
        try:
            return self.store.delete(
                self.third_party_key(group, plural, namespace, name))
        except NotFound:
            raise NotFound(kind=plural, name=name)

    def third_party_watch(self, group: str, plural: str,
                          namespace: str = "",
                          since_rev: Optional[int] = None,
                          checked: bool = False):
        if not checked:
            self.third_party_kind(group, plural)
        prefix = (self.third_party_key(group, plural, namespace)
                  if namespace
                  else f"/registry/thirdparty/{group}/{plural}/")
        return self.store.watch(prefix, since_rev)
