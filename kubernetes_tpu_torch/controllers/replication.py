"""ReplicationController manager.

Reference: pkg/controller/replication/replication_controller.go —
syncReplicationController (:401-446), manageReplicas (:339-396, burst cap
500, delete-preference sort, per-failure expectation rollback),
getPodController overlap resolution by oldest creationTimestamp (:203-219),
pod events adjusting expectations (addPod/updatePod/deletePod :221-280).
"""

from __future__ import annotations

import logging
import threading
from dataclasses import replace
from typing import List, Optional

from ..api.cache import Informer, meta_namespace_key
from ..core import types as api
from ..core.labels import selector_from_set
from .framework import (ControllerExpectations, QueueWorkers,
                        active_pods_sort_key, filter_active_pods)

logger = logging.getLogger(__name__)

BURST_REPLICAS = 500  # replication_controller.go:64
#: threads that carry a burst's creates or deletes (_spawn_all)
SPAWN_THREADS = 16


class ReplicationManager:
    def __init__(self, client, burst_replicas: int = BURST_REPLICAS,
                 workers: int = 5, recorder=None):
        self.client = client
        self.burst_replicas = burst_replicas
        self.recorder = recorder
        self.expectations = ControllerExpectations()
        self.workers = QueueWorkers(self._sync, workers, name="rc-manager")
        # resync re-drives every RC periodically: "next sync retries"
        # in _update_status is a lie without it — a status write that
        # failed after the last pod event (e.g. under injected API
        # faults) would otherwise leave status.replicas stale forever,
        # wedging any controller layered on RC status (the Deployment
        # rollout waits on old-RC status reaching 0; the trace replay
        # shook this out). The reference runs the RC manager on a full
        # resync for the same reason.
        self.rc_informer = Informer(
            client, "replicationcontrollers",
            on_add=self._enqueue_rc,
            on_update=lambda old, new: self._enqueue_rc(new),
            on_delete=self._delete_rc,
            resync_period=5.0)
        self.pod_informer = Informer(
            client, "pods",
            on_add=self._add_pod, on_update=self._update_pod,
            on_delete=self._delete_pod)

    # -- event handlers ---------------------------------------------------

    def _enqueue_rc(self, rc: api.ReplicationController) -> None:
        self.workers.enqueue(meta_namespace_key(rc))

    def _delete_rc(self, rc: api.ReplicationController) -> None:
        key = meta_namespace_key(rc)
        self.expectations.delete(key)
        self.workers.enqueue(key)

    def _pod_controller(self, pod: api.Pod
                        ) -> Optional[api.ReplicationController]:
        """Oldest matching RC wins on overlap
        (replication_controller.go:203-219)."""
        matching = [
            rc for rc in self.rc_informer.cache.list()
            if rc.metadata.namespace == pod.metadata.namespace
            and rc.spec.selector
            and selector_from_set(rc.spec.selector).matches(
                pod.metadata.labels)]
        if not matching:
            return None
        matching.sort(key=lambda rc: (rc.metadata.creation_timestamp,
                                      rc.metadata.name))
        return matching[0]

    def _add_pod(self, pod: api.Pod) -> None:
        rc = self._pod_controller(pod)
        if rc is None:
            return
        self.expectations.creation_observed(meta_namespace_key(rc))
        self._enqueue_rc(rc)

    def _update_pod(self, old: api.Pod, pod: api.Pod) -> None:
        rc = self._pod_controller(pod)
        if rc is not None:
            self._enqueue_rc(rc)
        if old.metadata.labels != pod.metadata.labels:
            old_rc = self._pod_controller(old)
            if old_rc is not None and (rc is None or
                                       old_rc.metadata.name !=
                                       rc.metadata.name):
                self._enqueue_rc(old_rc)

    def _delete_pod(self, pod: api.Pod) -> None:
        rc = self._pod_controller(pod)
        if rc is None:
            return
        self.expectations.deletion_observed(meta_namespace_key(rc))
        self._enqueue_rc(rc)

    # -- sync -------------------------------------------------------------

    def _rc_pods(self, rc: api.ReplicationController) -> List[api.Pod]:
        sel = selector_from_set(rc.spec.selector)
        return [p for p in self.pod_informer.cache.list()
                if p.metadata.namespace == rc.metadata.namespace
                and sel.matches(p.metadata.labels)]

    def _sync(self, key: str) -> None:
        rc = self.rc_informer.cache.get_by_key(key)
        if rc is None:
            self.expectations.delete(key)
            return
        filtered = filter_active_pods(self._rc_pods(rc))
        if self.expectations.satisfied(key):
            self._manage_replicas(filtered, rc)
        self._update_status(rc, len(filtered))

    def _manage_replicas(self, filtered: List[api.Pod],
                         rc: api.ReplicationController) -> None:
        key = meta_namespace_key(rc)
        diff = len(filtered) - rc.spec.replicas
        if diff < 0:
            diff = min(-diff, self.burst_replicas)
            self.expectations.expect_creations(key, diff)
            self._spawn_all([lambda: self._create_pod(rc, key)] * diff)
        elif diff > 0:
            diff = min(diff, self.burst_replicas)
            self.expectations.expect_deletions(key, diff)
            if rc.spec.replicas != 0:
                filtered = sorted(filtered, key=active_pods_sort_key)
            self._spawn_all([
                (lambda p: lambda: self._delete_one(rc, key, p))(pod)
                for pod in filtered[:diff]])

    @staticmethod
    def _spawn_all(fns) -> None:
        # the reference fans these out on goroutines + WaitGroup
        # (manageReplicas :352-365); here at most SPAWN_THREADS threads
        # run them, each taking the next until none is left: a burst of
        # 500 threads, each with its HTTP request, left every other
        # client of the interpreter (binds, lease renewals, status
        # confirms) waiting seconds a call
        fns = list(fns)
        lock = threading.Lock()

        def worker():
            while True:
                with lock:
                    if not fns:
                        return
                    fn = fns.pop()
                try:
                    fn()
                except Exception:      # a thread of its own would die
                    logger.exception("replication burst call failed")
        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(min(SPAWN_THREADS, len(fns)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def _create_pod(self, rc: api.ReplicationController, key: str) -> None:
        tpl = rc.spec.template
        pod = api.Pod(
            metadata=api.ObjectMeta(
                generate_name=f"{rc.metadata.name}-",
                namespace=rc.metadata.namespace,
                labels=dict(tpl.metadata.labels),
                annotations={
                    "kubernetes.io/created-by":
                        f"ReplicationController/{rc.metadata.name}"}),
            spec=tpl.spec,
            status=api.PodStatus(phase="Pending"))
        try:
            self.client.create("pods", pod, rc.metadata.namespace)
            if self.recorder:
                self.recorder.eventf(rc, "Normal", "SuccessfulCreate",
                                     "Created pod")
        except Exception:
            # informer will never observe this pod: roll back expectation
            self.expectations.creation_observed(key)
            if self.recorder:
                self.recorder.eventf(rc, "Warning", "FailedCreate",
                                     "Error creating pod")

    def _delete_one(self, rc: api.ReplicationController, key: str,
                    pod: api.Pod) -> None:
        try:
            self.client.delete("pods", pod.metadata.name,
                               pod.metadata.namespace)
            if self.recorder:
                self.recorder.eventf(rc, "Normal", "SuccessfulDelete",
                                     "Deleted pod %s", pod.metadata.name)
        except Exception:
            self.expectations.deletion_observed(key)
            if self.recorder:
                self.recorder.eventf(rc, "Warning", "FailedDelete",
                                     "Error deleting pod %s",
                                     pod.metadata.name)

    def _update_status(self, rc: api.ReplicationController,
                       num_replicas: int) -> None:
        """(replication_controller.go updateReplicaCount retry loop)"""
        if rc.status.replicas == num_replicas:
            return
        try:
            fresh = self.client.get("replicationcontrollers",
                                    rc.metadata.name, rc.metadata.namespace)
            updated = replace(fresh, status=replace(
                fresh.status, replicas=num_replicas,
                observed_generation=fresh.metadata.generation))
            self.client.update_status("replicationcontrollers", updated,
                                      rc.metadata.namespace)
        except Exception:
            pass  # next sync retries

    # -- lifecycle --------------------------------------------------------

    def run(self) -> "ReplicationManager":
        self.rc_informer.start()
        self.pod_informer.start()
        self.workers.start()
        return self

    def stop(self) -> None:
        self.workers.stop()
        self.rc_informer.stop()
        self.pod_informer.stop()
