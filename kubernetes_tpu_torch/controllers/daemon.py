"""DaemonSet controller.

Reference: pkg/controller/daemon/controller.go — per daemon set: every
schedulable, ready node should run exactly one pod from the template
(pods are created pre-bound via spec.nodeName, bypassing the scheduler,
which is how the reference's daemon controller places them); extra or
misscheduled pods are deleted.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List

from ..api.cache import Informer, meta_namespace_key
from ..core import types as api
from ..core.labels import selector_from_set
from .framework import ControllerExpectations, QueueWorkers, filter_active_pods


def node_should_run_daemon_pod(node: api.Node,
                               ds: "api.DaemonSet | None" = None) -> bool:
    """Schedulable + Ready (the scheduler's node filter applied here
    because daemon pods never pass through it) + the template's
    nodeSelector against the node's labels (ref:
    pkg/controller/daemon/controller.go:534-535 — also what makes the
    DaemonSetReaper's unmatchable-selector drain work)."""
    if node.spec.unschedulable:
        return False
    for cond in node.status.conditions:
        if cond.type == api.NODE_READY and cond.status != api.CONDITION_TRUE:
            return False
    if ds is not None:
        sel = ds.spec.template.spec.node_selector
        if sel and not selector_from_set(sel).matches(node.metadata.labels):
            return False
    return True


class DaemonSetController:
    def __init__(self, client, workers: int = 5):
        self.client = client
        self.expectations = ControllerExpectations()
        self.workers = QueueWorkers(self._sync, workers, name="daemon-sets")
        self.ds_informer = Informer(
            client, "daemonsets",
            on_add=self._enqueue,
            on_update=lambda old, new: self._enqueue(new),
            on_delete=self._enqueue)
        self.pod_informer = Informer(
            client, "pods",
            on_add=self._pod_event(adds=True),
            on_update=lambda old, new: self._enqueue_pod_ds(new),
            on_delete=self._pod_event(adds=False))
        self.node_informer = Informer(
            client, "nodes",
            on_add=lambda n: self._enqueue_all(),
            on_update=lambda old, new: self._enqueue_all(),
            on_delete=lambda n: self._enqueue_all())

    def _enqueue(self, ds: api.DaemonSet) -> None:
        self.workers.enqueue(meta_namespace_key(ds))

    def _enqueue_all(self) -> None:
        for ds in self.ds_informer.cache.list():
            self._enqueue(ds)

    def _ds_for_pod(self, pod: api.Pod):
        for ds in self.ds_informer.cache.list():
            if ds.metadata.namespace != pod.metadata.namespace:
                continue
            if ds.spec.selector and selector_from_set(
                    ds.spec.selector).matches(pod.metadata.labels):
                return ds
        return None

    def _enqueue_pod_ds(self, pod: api.Pod) -> None:
        ds = self._ds_for_pod(pod)
        if ds is not None:
            self._enqueue(ds)

    def _pod_event(self, adds: bool):
        def handler(pod: api.Pod) -> None:
            ds = self._ds_for_pod(pod)
            if ds is None:
                return
            key = meta_namespace_key(ds)
            if adds:
                self.expectations.creation_observed(key)
            else:
                self.expectations.deletion_observed(key)
            self._enqueue(ds)
        return handler

    # ----------------------------------------------------------- sync

    def _sync(self, key: str) -> None:
        ds = self.ds_informer.cache.get_by_key(key)
        if ds is None:
            self.expectations.delete(key)
            return
        sel = selector_from_set(ds.spec.selector)
        by_node: Dict[str, List[api.Pod]] = {}
        for pod in self.pod_informer.cache.list():
            if pod.metadata.namespace != ds.metadata.namespace:
                continue
            if not sel.matches(pod.metadata.labels):
                continue
            by_node.setdefault(pod.spec.node_name, []).append(pod)

        nodes = self.node_informer.cache.list()
        eligible = {n.metadata.name for n in nodes
                    if node_should_run_daemon_pod(n, ds)}

        to_create: List[str] = []
        to_delete: List[api.Pod] = []
        for node_name in eligible:
            running = filter_active_pods(by_node.get(node_name, []))
            if not running:
                to_create.append(node_name)
            else:
                # one daemon pod per node; extras die oldest-last
                running.sort(key=lambda p: (p.metadata.creation_timestamp,
                                            p.metadata.name))
                to_delete.extend(running[1:])
        for node_name, pods in by_node.items():
            if node_name not in eligible:
                to_delete.extend(filter_active_pods(pods))

        if self.expectations.satisfied(key):
            if to_create:
                self.expectations.expect_creations(key, len(to_create))
                for node_name in to_create:
                    self._create_pod(ds, key, node_name)
            if to_delete:
                self.expectations.expect_deletions(key, len(to_delete))
                for pod in to_delete:
                    self._delete_pod(key, pod)

        scheduled = sum(1 for node_name, pods in by_node.items()
                        if node_name in eligible
                        and filter_active_pods(pods))
        misscheduled = sum(len(filter_active_pods(pods))
                           for node_name, pods in by_node.items()
                           if node_name not in eligible)
        self._update_status(ds, scheduled, misscheduled, len(eligible))

    def _create_pod(self, ds: api.DaemonSet, key: str,
                    node_name: str) -> None:
        tpl = ds.spec.template
        pod = api.Pod(
            metadata=api.ObjectMeta(
                generate_name=f"{ds.metadata.name}-",
                namespace=ds.metadata.namespace,
                labels=dict(tpl.metadata.labels),
                annotations={"kubernetes.io/created-by":
                             f"DaemonSet/{ds.metadata.name}"}),
            spec=replace(tpl.spec, node_name=node_name),
            status=api.PodStatus(phase="Pending"))
        try:
            self.client.create("pods", pod, ds.metadata.namespace)
        except Exception:
            self.expectations.creation_observed(key)

    def _delete_pod(self, key: str, pod: api.Pod) -> None:
        try:
            self.client.delete("pods", pod.metadata.name,
                               pod.metadata.namespace)
        except Exception:
            self.expectations.deletion_observed(key)

    def _update_status(self, ds: api.DaemonSet, scheduled: int,
                       misscheduled: int, desired: int) -> None:
        if (ds.status.current_number_scheduled == scheduled
                and ds.status.number_misscheduled == misscheduled
                and ds.status.desired_number_scheduled == desired):
            return
        try:
            self.client.update_status("daemonsets", replace(
                ds, status=api.DaemonSetStatus(
                    current_number_scheduled=scheduled,
                    number_misscheduled=misscheduled,
                    desired_number_scheduled=desired)),
                ds.metadata.namespace)
        except Exception:
            pass

    def run(self) -> "DaemonSetController":
        self.ds_informer.start()
        self.pod_informer.start()
        self.node_informer.start()
        self.workers.start()
        return self

    def stop(self) -> None:
        self.workers.stop()
        self.ds_informer.stop()
        self.pod_informer.stop()
        self.node_informer.stop()
