"""Admission plugins (ref: plugin/pkg/admission/*).

Each factory takes the Registry (the plugins' view of cluster state — the
reference wires a client + informers; in-proc the registry is both) and
returns an Interface. Register order matters: the chain runs in the order
names are given to new_from_plugins, mirroring --admission-control's
comma-ordered list (cmd/kube-apiserver/app/server.go:230).
"""

from __future__ import annotations

from typing import Callable, Dict, List

from ..core import types as api
from ..core.errors import BadRequest, NotFound
from ..core.quantity import Quantity
from .chain import Chain
from .interfaces import Attributes, Forbidden, Interface, Operation


_factories: Dict[str, Callable] = {}


def register_plugin(name: str, factory: Callable) -> str:
    _factories[name] = factory
    return name


def new_from_plugins(registry, names: List[str]) -> Chain:
    """(ref: pkg/admission/plugins.go NewFromPlugins)"""
    plugins: List[Interface] = []
    for name in names:
        if name not in _factories:
            raise BadRequest(f"unknown admission plugin {name!r}")
        plugins.append(_factories[name](registry))
    return Chain(plugins)


class AlwaysAdmit(Interface):
    """(ref: plugin/pkg/admission/admit)"""

    def admit(self, attributes: Attributes) -> None:
        return None


class AlwaysDeny(Interface):
    """(ref: plugin/pkg/admission/deny)"""

    def admit(self, attributes: Attributes) -> None:
        raise Forbidden("this action is not permitted (AlwaysDeny)")


class NamespaceLifecycle(Interface):
    """Block creates into missing or Terminating namespaces; block deleting
    the protected system namespaces (ref:
    plugin/pkg/admission/namespace/lifecycle)."""

    immortal = ("default",)

    def __init__(self, registry):
        self.registry = registry

    def admit(self, attributes: Attributes) -> None:
        if attributes.resource == "namespaces" and \
                attributes.operation == Operation.DELETE:
            if attributes.name in self.immortal:
                raise Forbidden(
                    f"namespace {attributes.name!r} cannot be deleted")
            return
        if attributes.operation != Operation.CREATE:
            return
        if not attributes.namespace or attributes.resource in ("namespaces",
                                                               "events"):
            # events stay recordable during teardown (dedup/TTL storage
            # makes them harmless; blocking them hides the teardown story)
            return
        try:
            ns = self.registry.get("namespaces", attributes.namespace)
        except NotFound:
            raise Forbidden(
                f"namespace {attributes.namespace!r} does not exist")
        if ns.status.phase == "Terminating":
            raise Forbidden(
                f"namespace {attributes.namespace!r} is terminating")


class NamespaceExists(Interface):
    """(ref: plugin/pkg/admission/namespace/exists)"""

    def __init__(self, registry):
        self.registry = registry

    def admit(self, attributes: Attributes) -> None:
        if not attributes.namespace or attributes.resource == "namespaces":
            return
        try:
            self.registry.get("namespaces", attributes.namespace)
        except NotFound:
            raise Forbidden(
                f"namespace {attributes.namespace!r} does not exist")


class NamespaceAutoProvision(Interface):
    """(ref: plugin/pkg/admission/namespace/autoprovision)"""

    def __init__(self, registry):
        self.registry = registry

    def admit(self, attributes: Attributes) -> None:
        if attributes.operation != Operation.CREATE:
            return
        if not attributes.namespace or attributes.resource == "namespaces":
            return
        try:
            self.registry.get("namespaces", attributes.namespace)
        except NotFound:
            try:
                self.registry.create("namespaces", api.Namespace(
                    metadata=api.ObjectMeta(name=attributes.namespace)))
            except Exception:
                pass  # raced with another provisioner: fine either way


class LimitRanger(Interface):
    """Apply LimitRange defaults and enforce min/max on pod containers
    (ref: plugin/pkg/admission/limitranger; container-type limits)."""

    def __init__(self, registry):
        self.registry = registry

    def handles(self, operation: str) -> bool:
        return operation in (Operation.CREATE, Operation.UPDATE)

    def admit(self, attributes: Attributes) -> None:
        if attributes.resource != "pods" or attributes.object is None:
            return
        ranges, _ = self.registry.list("limitranges", attributes.namespace)
        if not ranges:
            return
        pod: api.Pod = attributes.object
        for lr in ranges:
            for item in lr.spec.limits:
                if item.type and item.type != "Container":
                    continue
                for c in pod.spec.containers:
                    self._apply(c, item, pod.metadata.name)

    @staticmethod
    def _apply(container: api.Container, item, pod_name: str) -> None:
        requests = dict(container.resources.requests)
        for resource, default in item.default.items():
            requests.setdefault(resource, default)
        for resource, lo in item.min.items():
            got = requests.get(resource)
            if got is not None and got.milli < lo.milli:
                raise Forbidden(
                    f"pod {pod_name!r}: {resource} request {got} below "
                    f"minimum {lo}")
        for resource, hi in item.max.items():
            got = requests.get(resource)
            if got is not None and got.milli > hi.milli:
                raise Forbidden(
                    f"pod {pod_name!r}: {resource} request {got} above "
                    f"maximum {hi}")
        container.resources.requests = requests


def pod_usage(pod: api.Pod) -> Dict[str, int]:
    """Quota usage of one pod in Quantity milli units — the single
    formula shared by the admission increment and the quota controller's
    recalculation (controllers/resourcequota.py); keep them identical or
    the two paths drift."""
    cpu = 0
    mem = 0
    for c in pod.spec.containers:
        req = c.resources.requests
        if "cpu" in req:
            cpu += req["cpu"].milli
        if "memory" in req:
            mem += req["memory"].milli
    return {"pods": 1000, "cpu": cpu, "memory": mem}


class ResourceQuota(Interface):
    """Enforce ResourceQuota hard limits, incrementing status.used on
    admission (ref: plugin/pkg/admission/resourcequota). Decrements happen
    via controllers.resourcequota.ResourceQuotaController's periodic
    recalculation, like the reference's resourcequota controller resync —
    run it alongside this plugin or deletes never free quota."""

    COUNTED = {"pods": "pods", "services": "services",
               "replicationcontrollers": "replicationcontrollers",
               "secrets": "secrets", "resourcequotas": "resourcequotas"}

    def __init__(self, registry):
        self.registry = registry

    def handles(self, operation: str) -> bool:
        return operation == Operation.CREATE

    def admit(self, attributes: Attributes) -> None:
        count_key = self.COUNTED.get(attributes.resource)
        if count_key is None:
            return
        quotas, _ = self.registry.list("resourcequotas", attributes.namespace)
        for quota in quotas:
            self._charge(quota, attributes, count_key)

    def _charge(self, quota, attributes: Attributes, count_key: str) -> None:
        deltas: Dict[str, int] = {}
        hard = quota.spec.hard
        if count_key in hard:
            deltas[count_key] = 1000  # whole-unit Quantity milli
        if attributes.resource == "pods" and attributes.object is not None:
            usage = pod_usage(attributes.object)
            for resource in ("cpu", "memory"):
                if resource in hard:
                    deltas[resource] = usage[resource]
        if not deltas:
            return

        def apply(cur):
            used = dict(cur.status.used)
            for resource, delta in deltas.items():
                if resource not in cur.spec.hard:
                    # a concurrent writer dropped this resource from
                    # spec.hard; nothing to enforce or charge for it
                    continue
                limit = cur.spec.hard[resource].milli
                have = used.get(resource, Quantity(0)).milli
                if have + delta > limit:
                    raise Forbidden(
                        f"exceeded quota {cur.metadata.name!r}: "
                        f"{resource} used {have}m + {delta}m > hard "
                        f"{limit}m")
                used[resource] = Quantity(have + delta)
            from dataclasses import replace
            return replace(cur, status=api.ResourceQuotaStatus(
                hard=dict(cur.spec.hard), used=used))

        # CAS loop through the store (GuaranteedUpdate semantics,
        # etcd_helper.go:449): a concurrent admit retries, so two pods
        # can't both squeeze under the same last slot
        self.registry.guaranteed_update(
            "resourcequotas", quota.metadata.name, attributes.namespace,
            apply)


class ServiceAccountPlugin(Interface):
    """Default and validate pod service accounts, and mount the
    account's API token secret into every container
    (ref: plugin/pkg/admission/serviceaccount/admission.go:88,150,339;
    DefaultAPITokenMountPath :48)."""

    TOKEN_MOUNT_PATH = "/var/run/secrets/kubernetes.io/serviceaccount"

    def __init__(self, registry):
        self.registry = registry

    def handles(self, operation: str) -> bool:
        return operation == Operation.CREATE

    def admit(self, attributes: Attributes) -> None:
        if attributes.resource != "pods" or attributes.object is None:
            return
        pod: api.Pod = attributes.object
        if not pod.spec.service_account_name:
            pod.spec.service_account_name = "default"
        try:
            sa = self.registry.get("serviceaccounts",
                                   pod.spec.service_account_name,
                                   attributes.namespace)
        except NotFound:
            raise Forbidden(
                f"service account {attributes.namespace}/"
                f"{pod.spec.service_account_name} does not exist")
        self._mount_token(sa, pod)

    def _referenced_token(self, sa: api.ServiceAccount) -> str:
        """First referenced secret that exists AND is a
        service-account-token typed secret for this account
        (admission.go getReferencedServiceAccountToken /
        serviceaccount.IsServiceAccountToken) — a stray non-token
        reference must not get mounted at the credentials path."""
        for ref in sa.secrets:
            if not ref.name:
                continue
            try:
                secret = self.registry.get("secrets", ref.name,
                                           sa.metadata.namespace)
            except NotFound:
                continue
            if (secret.type == "kubernetes.io/service-account-token"
                    and secret.metadata.annotations.get(
                        "kubernetes.io/service-account.name")
                    == sa.metadata.name):
                return ref.name
        return ""

    def _mount_token(self, sa: api.ServiceAccount, pod: api.Pod) -> None:
        """(admission.go:339 mountServiceAccountToken) The first
        referenced token secret becomes a read-only secret volume
        mounted at the well-known path in every container that doesn't
        already mount something there. No token yet (the tokens
        controller hasn't caught up) -> admit without one, like the
        reference's MountServiceAccountToken w/o RequireAPIToken."""
        token = self._referenced_token(sa)
        if not token:
            return
        vol_name = ""
        names = set()
        for v in pod.spec.volumes:
            names.add(v.name)
            if v.secret is not None and v.secret.secret_name == token:
                vol_name = v.name
        if not vol_name:
            vol_name = token
            n = 0
            while vol_name in names:  # uniquify (SimpleNameGenerator)
                n += 1
                vol_name = f"{token}-{n}"
        mounted_any = False
        for c in pod.spec.containers:
            if any(m.mount_path == self.TOKEN_MOUNT_PATH
                   for m in c.volume_mounts):
                continue  # an existing mount at the path wins
            c.volume_mounts.append(api.VolumeMount(
                name=vol_name, mount_path=self.TOKEN_MOUNT_PATH,
                read_only=True))
            mounted_any = True
        if mounted_any and vol_name not in names:
            pod.spec.volumes.append(api.Volume(
                name=vol_name,
                secret=api.SecretVolumeSource(secret_name=token)))


class SecurityContextDeny(Interface):
    """Deny privilege escalation requests (ref:
    plugin/pkg/admission/securitycontext/scdeny, adapted to this schema:
    privileged containers and host-network pods)."""

    def __init__(self, registry):
        self.registry = registry

    def handles(self, operation: str) -> bool:
        return operation in (Operation.CREATE, Operation.UPDATE)

    def admit(self, attributes: Attributes) -> None:
        if attributes.resource != "pods" or attributes.object is None:
            return
        pod: api.Pod = attributes.object
        if pod.spec.host_network:
            raise Forbidden("pod.spec.hostNetwork is forbidden")
        if pod.spec.host_pid:
            raise Forbidden("pod.spec.hostPID is forbidden")
        if pod.spec.host_ipc:
            raise Forbidden("pod.spec.hostIPC is forbidden")
        from ..kubelet.securitycontext import effective_privileged
        for c in pod.spec.containers:
            sc = getattr(c, "security_context", None)
            # same flat-or-nested resolution the runtime grants by —
            # admission and enforcement must police one predicate
            if effective_privileged(c):
                raise Forbidden(
                    f"privileged container {c.name!r} is forbidden")
            # the reference's scdeny also rejects user/capability
            # requests (plugin/pkg/admission/securitycontext/scdeny:
            # SecurityContext.RunAsUser / SELinuxOptions are denied)
            if sc is not None and (sc.run_as_user is not None
                                   or sc.capabilities is not None):
                raise Forbidden(
                    f"container {c.name!r}: security context "
                    f"user/capability requests are forbidden")


# the InitialResources usage history: image -> {"cpu"|"memory": milli}.
# Process-global by design — it plays the reference's shared metrics DB
# (influxdb/GCM), not per-apiserver state.
usage_history: Dict[str, Dict[str, int]] = {}


def record_usage(image: str, resource: str, milli: int) -> None:
    """Feed the InitialResources history (the kubelet-stats role)."""
    usage_history.setdefault(image, {})[resource] = int(milli)


class DenyExecOnPrivileged(Interface):
    """Reject exec into pods that run privileged or host-network
    (ref: plugin/pkg/admission/exec/denyprivileged — intercepts the
    pods/exec CONNECT; our apiserver relay consults it before relaying
    to the kubelet)."""

    def __init__(self, registry):
        self.registry = registry

    def handles(self, operation: str) -> bool:
        return operation == Operation.CONNECT

    def admit(self, attributes: Attributes) -> None:
        if attributes.resource != "pods/exec":
            return
        try:
            pod = self.registry.get("pods", attributes.name,
                                    attributes.namespace)
        except NotFound:
            return  # missing pod fails later with a clean 404
        # any other lookup failure propagates: a security admission
        # plugin must fail CLOSED, not open
        from ..kubelet.securitycontext import effective_privileged
        if (pod.spec.host_network or pod.spec.host_pid or pod.spec.host_ipc
                or any(effective_privileged(c)
                       for c in pod.spec.containers)):
            # ref: plugin/pkg/admission/exec/admission.go:93-97 — the
            # deny-escalating-exec plugin blocks hostPID and hostIPC
            # pods alongside privileged and host-network ones
            raise Forbidden(
                f"cannot exec into privileged/host-namespace pod "
                f"{attributes.name!r}")


class InitialResources(Interface):
    """Fill absent container CPU/memory requests from observed usage
    (ref: plugin/pkg/admission/initialresources — the reference queries
    an influxdb/GCM history, a store shared by every consumer; the
    analogue here is the module-level `usage_history`, fed via
    `record_usage` by whatever meters containers, or a custom
    `estimator(image, resource) -> milli or None`)."""

    def __init__(self, registry, estimator=None):
        self.registry = registry
        self.estimator = estimator or (
            lambda image, resource:
            usage_history.get(image, {}).get(resource))

    def handles(self, operation: str) -> bool:
        return operation == Operation.CREATE

    def admit(self, attributes: Attributes) -> None:
        if attributes.resource != "pods" or attributes.object is None:
            return
        pod: api.Pod = attributes.object
        for c in pod.spec.containers:
            for resource in ("cpu", "memory"):
                if resource in c.resources.requests:
                    continue
                milli = self.estimator(c.image, resource)
                if milli is not None:
                    c.resources.requests[resource] = Quantity(int(milli))


register_plugin("AlwaysAdmit", lambda r: AlwaysAdmit())
register_plugin("AlwaysDeny", lambda r: AlwaysDeny())
register_plugin("NamespaceLifecycle", NamespaceLifecycle)
register_plugin("NamespaceExists", NamespaceExists)
register_plugin("NamespaceAutoProvision", NamespaceAutoProvision)
register_plugin("LimitRanger", LimitRanger)
register_plugin("ResourceQuota", ResourceQuota)
register_plugin("ServiceAccount", ServiceAccountPlugin)
register_plugin("SecurityContextDeny", SecurityContextDeny)
register_plugin("DenyExecOnPrivileged", DenyExecOnPrivileged)
register_plugin("InitialResources", InitialResources)
