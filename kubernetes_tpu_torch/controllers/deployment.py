"""Deployment controller: declarative rollouts over ReplicationControllers.

Reference: pkg/controller/deployment/deployment_controller.go (v1.1) —
a Deployment owns RCs distinguished by a pod-template hash label
(getNewRC/getOldRCs); RollingUpdate reconciliation scales the new RC up
(bounded by maxSurge) and old RCs down (bounded by maxUnavailable) until
the new RC carries spec.replicas; Recreate scales old RCs to zero first.
The RC manager (replication.py) does the actual pod management — this
controller only moves RC replica counts, exactly the reference's
division of labor.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import replace
from typing import List, Optional, Tuple

from ..api.cache import Informer, meta_namespace_key
from ..core import types as api
from ..core.intstr import resolve_int_or_percent
from ..core.labels import selector_from_set
from ..core.serde import to_wire
from .framework import QueueWorkers


def pod_template_hash(template: api.PodTemplateSpec) -> str:
    """Deterministic hash of the template (the reference hashes the
    api.PodTemplateSpec with adler32; any stable digest serves)."""
    wire = json.dumps(to_wire(template), sort_keys=True)
    return hashlib.sha1(wire.encode()).hexdigest()[:10]


class DeploymentController:
    def __init__(self, client, workers: int = 5):
        self.client = client
        self.workers = QueueWorkers(self._sync, workers, name="deployment")
        # resync re-drives every deployment periodically: rollout
        # progress can hinge on POD readiness, which produces no event
        # on the deployments (or even RC) watch — edge-triggering alone
        # deadlocks mid-rollout (the reference runs this controller on
        # a 30s full resync for the same reason)
        self.deploy_informer = Informer(
            client, "deployments",
            on_add=self._enqueue,
            on_update=lambda old, new: self._enqueue(new),
            on_delete=self._enqueue,
            resync_period=5.0)
        self.rc_informer = Informer(
            client, "replicationcontrollers",
            on_add=self._enqueue_rc_deployment,
            on_update=lambda old, new: self._enqueue_rc_deployment(new),
            on_delete=self._enqueue_rc_deployment)

    def _enqueue(self, d: api.Deployment) -> None:
        self.workers.enqueue(meta_namespace_key(d))

    def _enqueue_rc_deployment(self, rc: api.ReplicationController) -> None:
        for d in self.deploy_informer.cache.list():
            if d.metadata.namespace != rc.metadata.namespace:
                continue
            if d.spec.selector and selector_from_set(
                    d.spec.selector).matches(rc.spec.template.metadata.labels
                                             if rc.spec.template else {}):
                self._enqueue(d)

    # ----------------------------------------------------------- sync

    def _deployment_rcs(self, d: api.Deployment
                        ) -> Tuple[Optional[api.ReplicationController],
                                   List[api.ReplicationController]]:
        """(new_rc, old_rcs) split by template hash (getNewRC/getOldRCs).

        Listed LIVE through the client, not the informer cache: the sync
        itself creates RCs, and acting on a cache that hasn't observed
        them yet would create duplicates every pass (the v1.1 reference
        also lists RCs through the client in its sync). The informer only
        drives enqueues."""
        hash_key = d.spec.unique_label_key
        _, want = self._hashed_template(d)
        matches: List[api.ReplicationController] = []
        old: List[api.ReplicationController] = []
        sel = selector_from_set(d.spec.selector)
        rcs, _ = self.client.list("replicationcontrollers",
                                  d.metadata.namespace)
        for rc in rcs:
            tpl_labels = (rc.spec.template.metadata.labels
                          if rc.spec.template else {})
            if not sel.matches(tpl_labels):
                continue
            if tpl_labels.get(hash_key) == want:
                matches.append(rc)
            else:
                old.append(rc)
        if not matches:
            return None, old
        # oldest same-hash RC is THE new RC; duplicates (from a crashed
        # sync or racing controllers) drain like old RCs
        matches.sort(key=lambda rc: (rc.metadata.creation_timestamp,
                                     rc.metadata.name))
        return matches[0], old + matches[1:]

    def _hashed_template(self, d: api.Deployment):
        """-> (template carrying the hash label, digest). The digest is of
        the BASE template (hash label stripped) — the same value the label
        stores, so lookups and creation agree (deployment_controller.go
        getNewRC: the RC's selector and template carry podTemplateHash)."""
        tpl = d.spec.template
        labels = dict(tpl.metadata.labels)
        labels.pop(d.spec.unique_label_key, None)
        base = api.PodTemplateSpec(
            metadata=replace(tpl.metadata, labels=labels), spec=tpl.spec)
        digest = pod_template_hash(base)
        labels = dict(labels)
        labels[d.spec.unique_label_key] = digest
        return api.PodTemplateSpec(
            metadata=replace(tpl.metadata, labels=labels),
            spec=tpl.spec), digest

    def _sync(self, key: str) -> None:
        d = self.deploy_informer.cache.get_by_key(key)
        if d is None:
            return
        try:
            new_rc, old_rcs = self._deployment_rcs(d)
        except Exception:
            return  # apiserver hiccup: informer events re-drive
        if new_rc is None:
            new_rc = self._create_new_rc(d)
            if new_rc is None:
                return
        if (d.spec.strategy or api.DeploymentStrategy()).type == "Recreate":
            for rc in old_rcs:
                if rc.spec.replicas != 0:
                    self._scale(rc, 0)
            if all(rc.status.replicas == 0 for rc in old_rcs):
                if new_rc.spec.replicas != d.spec.replicas:
                    self._scale(new_rc, d.spec.replicas)
        else:
            self._rolling_update(d, new_rc, old_rcs)
        self._cleanup_and_status(d, new_rc, old_rcs)

    def _rolling_update(self, d: api.Deployment,
                        new_rc: api.ReplicationController,
                        old_rcs: List[api.ReplicationController]) -> None:
        """(reconcileNewRC/reconcileOldRCs: surge and unavailable bounds)"""
        strategy = d.spec.strategy or api.DeploymentStrategy()
        ru = strategy.rolling_update or api.RollingUpdateDeployment()
        max_surge = resolve_int_or_percent(ru.max_surge, d.spec.replicas)
        max_unavailable = resolve_int_or_percent(ru.max_unavailable,
                                                 d.spec.replicas)
        old_total = sum(rc.spec.replicas for rc in old_rcs)
        total = new_rc.spec.replicas + old_total
        max_total = d.spec.replicas + max_surge
        min_available = d.spec.replicas - max_unavailable

        if new_rc.spec.replicas < d.spec.replicas and total < max_total:
            grow = min(d.spec.replicas - new_rc.spec.replicas,
                       max_total - total)
            self._scale(new_rc, new_rc.spec.replicas + grow)
        elif new_rc.spec.replicas > d.spec.replicas:
            # deployment scaled down: the new RC tracks spec directly
            # (reconcileNewRC's scale-down branch)
            self._scale(new_rc, d.spec.replicas)
        # availability means READY pods, not active pod count — scaling
        # old RCs down against status.replicas would count the new RC's
        # still-unready surge pods as available and let a rollout with
        # maxUnavailable=0 delete every ready old pod before a single
        # new one passes readiness (reconcileOldRCs scales by
        # GetAvailablePodsForRCs, deployment/deployment.go)
        # both counts share ONE pod snapshot: a deletion landing
        # between two separate LISTs would inflate the removal budget
        snapshot: dict = {}
        available = self._ready_pod_count([new_rc] + list(old_rcs),
                                          snapshot)
        # deletions already scheduled but not yet executed (a prior
        # sync shrank an old RC whose manager hasn't killed the pod
        # yet) still read as available — budget them as spent, or two
        # back-to-back syncs double-delete past the maxUnavailable
        # floor (the availability-gate test catches this race)
        pending_deletes = max(0, self._ready_pod_count(old_rcs, snapshot)
                              - old_total)
        can_remove = available - pending_deletes - min_available
        for rc in sorted(old_rcs, key=lambda r: (r.metadata.creation_timestamp,
                                                 r.metadata.name)):
            if can_remove <= 0:
                break
            if rc.spec.replicas == 0:
                continue
            shrink = min(rc.spec.replicas, can_remove)
            self._scale(rc, rc.spec.replicas - shrink)
            can_remove -= shrink

    def _ready_pod_count(self, rcs, by_ns: Optional[dict] = None) -> int:
        """Ready pods across the RCs' selectors (the reference's
        GetAvailablePodsForRCs, minus minReadySeconds which v1.1's
        Deployment does not surface). TERMINATING pods are excluded: a
        pod whose deletion has started still reports Ready until its
        kubelet tears it down, and counting it would let the rollout
        scale old RCs below the maxUnavailable floor (the trace
        replay's availability gate caught exactly this)."""
        from .framework import is_pod_ready
        counted = set()
        total = 0
        by_ns = {} if by_ns is None else by_ns
        for rc in rcs:
            ns = rc.metadata.namespace
            if ns not in by_ns:
                try:
                    by_ns[ns], _ = self.client.list("pods", ns)
                except Exception:
                    by_ns[ns] = []
            sel = selector_from_set(rc.spec.selector)
            for pod in by_ns[ns]:
                key = (ns, pod.metadata.name)
                if key in counted:
                    continue
                if (pod.metadata.deletion_timestamp is None
                        and sel.matches(pod.metadata.labels)
                        and is_pod_ready(pod)):
                    counted.add(key)
                    total += 1
        return total

    def _create_new_rc(self, d: api.Deployment
                       ) -> Optional[api.ReplicationController]:
        tpl, digest = self._hashed_template(d)
        selector = dict(d.spec.selector)
        selector[d.spec.unique_label_key] = digest
        rc = api.ReplicationController(
            metadata=api.ObjectMeta(
                generate_name=f"{d.metadata.name}-",
                namespace=d.metadata.namespace,
                labels=dict(tpl.metadata.labels),
                annotations={"kubernetes.io/created-by":
                             f"Deployment/{d.metadata.name}"}),
            spec=api.ReplicationControllerSpec(
                replicas=0,  # rolled up by the rolling-update loop
                selector=selector, template=tpl))
        try:
            return self.client.create("replicationcontrollers", rc,
                                      d.metadata.namespace)
        except Exception:
            return None

    def _scale(self, rc: api.ReplicationController, replicas: int) -> None:
        try:
            fresh = self.client.get("replicationcontrollers",
                                    rc.metadata.name, rc.metadata.namespace)
            self.client.update(
                "replicationcontrollers",
                replace(fresh, spec=replace(fresh.spec, replicas=replicas)),
                rc.metadata.namespace)
        except Exception:
            pass  # next sync retries

    def _cleanup_and_status(self, d: api.Deployment,
                            new_rc: api.ReplicationController,
                            old_rcs: List[api.ReplicationController]) -> None:
        # drained old RCs are deleted (cleanupOldRCs)
        for rc in old_rcs:
            if rc.spec.replicas == 0 and rc.status.replicas == 0:
                try:
                    self.client.delete("replicationcontrollers",
                                       rc.metadata.name,
                                       rc.metadata.namespace)
                except Exception:
                    pass
        total = (new_rc.status.replicas
                 + sum(rc.status.replicas for rc in old_rcs))
        # surfaced for the rollout availability gate (the trace replay
        # asserts the rolling-update invariant off these fields):
        # available counts READY pods, unavailable the gap to the
        # larger of desired and present totals
        available = self._ready_pod_count([new_rc] + list(old_rcs))
        unavailable = max(0, max(d.spec.replicas, total) - available)
        if (d.status.replicas == total
                and d.status.updated_replicas == new_rc.status.replicas
                and d.status.available_replicas == available
                and d.status.unavailable_replicas == unavailable):
            return
        try:
            self.client.update_status("deployments", replace(
                d, status=api.DeploymentStatus(
                    replicas=total,
                    updated_replicas=new_rc.status.replicas,
                    available_replicas=available,
                    unavailable_replicas=unavailable,
                    observed_generation=d.metadata.generation)),
                d.metadata.namespace)
        except Exception:
            pass

    def run(self) -> "DeploymentController":
        self.deploy_informer.start()
        self.rc_informer.start()
        self.workers.start()
        return self

    def stop(self) -> None:
        self.workers.stop()
        self.deploy_informer.stop()
        self.rc_informer.stop()
