"""Namespace controller: cascade delete + finalization.

Reference: pkg/controller/namespace/namespace_controller.go — a namespace
whose deletionTimestamp is set has phase Terminating; syncNamespace
(:95-120) deletes every namespaced resource inside it (deleteAllContent
:163-230), then clears the "kubernetes" finalizer (finalizeNamespaceFunc
:128-150); storage drops the namespace once no finalizers remain (that
last step lives in our registry.finalize_namespace)."""

from __future__ import annotations

from dataclasses import replace

from ..api.cache import Informer
from ..api.registry import RESOURCES
from ..core import types as api
from ..core.errors import NotFound
from .framework import QueueWorkers

# content is removed in the reference's fixed order (deleteAllContent);
# bindings is virtual (no storage), events go last like the reference
_CONTENT_RESOURCES = [
    # workload owners before their products (deployments create RCs,
    # jobs/daemonsets/RCs create pods), then the rest, events last
    "deployments", "horizontalpodautoscalers", "jobs", "daemonsets",
    "replicationcontrollers", "pods", "podtemplates", "serviceaccounts",
    "services", "ingresses", "persistentvolumeclaims", "secrets",
    "limitranges", "resourcequotas", "thirdpartyresources", "endpoints",
    "events",
]


class NamespaceController:
    def __init__(self, client, workers: int = 2):
        self.client = client
        self.workers = QueueWorkers(self._sync, workers, name="namespace")
        self.informer = Informer(
            client, "namespaces",
            on_add=self._enqueue,
            on_update=lambda old, new: self._enqueue(new))

    def _enqueue(self, ns: api.Namespace) -> None:
        if ns.metadata.deletion_timestamp is not None:
            self.workers.enqueue(ns.metadata.name)

    def _delete_all_content(self, name: str) -> None:
        """Raises on any failure so the sync is retried rather than
        finalizing a namespace that still has content (the reference
        aborts syncNamespace on deleteAllContent error)."""
        for resource in _CONTENT_RESOURCES:
            if resource not in RESOURCES:
                continue
            items, _ = self.client.list(resource, name)
            for obj in items:
                try:
                    self.client.delete(resource, obj.metadata.name, name)
                except NotFound:
                    pass

    def _sync(self, name: str) -> None:
        try:
            ns = self.client.get("namespaces", name)
        except NotFound:
            return
        if ns.metadata.deletion_timestamp is None:
            return
        if ns.status.phase != "Terminating":
            # registry normally stamps this; belt-and-braces for objects
            # marked by other paths (syncNamespace :101-106)
            try:
                self.client.update_status(
                    "namespaces",
                    replace(ns, status=replace(ns.status,
                                               phase="Terminating")))
            except Exception:
                pass
        self._delete_all_content(name)  # raises -> QueueWorkers retries
        finalized = replace(ns, spec=replace(
            ns.spec, finalizers=[f for f in ns.spec.finalizers
                                 if f != "kubernetes"]))
        try:
            self.client.finalize_namespace(finalized)
        except NotFound:
            pass  # already gone, life is good (finalizeNamespaceFunc :145)

    def run(self) -> "NamespaceController":
        self.informer.start()
        self.workers.start()
        return self

    def stop(self) -> None:
        self.workers.stop()
        self.informer.stop()
