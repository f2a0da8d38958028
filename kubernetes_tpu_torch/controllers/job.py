"""Job controller.

Reference: pkg/controller/job/controller.go — syncJob: count active/
succeeded/failed pods by phase, run up to `parallelism` active pods until
`succeeded >= completions`, then mark the Complete condition and delete
leftover active pods. Defaulting follows the reference's api defaults:
parallelism nil -> 1; completions nil -> "any single success completes"
(treated as 1 for the done-check but parallelism still bounds actives).

Failure backoff: replacements for FAILED pods are requeued under a
capped, jittered exponential backoff (escalating while the failure
count keeps growing) instead of recreated on every sync — a
crash-looping Job wave in the trace replay would otherwise turn the
controller into a create-storm against the apiserver. The later
reference grows this as the Job BackoffLimit/failure backoff
(job_controller.go); v1.1 recreates immediately. Blocked requeues are
counted by `job_backoff_requeues_total`.
"""

from __future__ import annotations

import random
import threading
from dataclasses import replace
from typing import Dict, List, Optional, Tuple

from ..api.cache import Informer, meta_namespace_key
from ..core import types as api
from ..core.labels import selector_from_set
from ..utils.clock import Clock, RealClock
from ..utils.metrics import global_metrics
from .framework import (ControllerExpectations, QueueWorkers,
                        active_pods_sort_key)


class JobController:
    def __init__(self, client, workers: int = 5, recorder=None,
                 failure_backoff_initial: float = 0.1,
                 failure_backoff_cap: float = 10.0,
                 clock: Optional[Clock] = None):
        self.client = client
        self.recorder = recorder
        self.failure_backoff_initial = failure_backoff_initial
        self.failure_backoff_cap = failure_backoff_cap
        self.clock = clock or RealClock()
        # key -> (failed count last seen, current delay, not-before)
        self._backoff: Dict[str, Tuple[int, float, float]] = {}
        # keys with a wakeup timer already armed (at most one per key,
        # or a crash-looping wave would breed timers on every sync)
        self._backoff_armed: set = set()
        self._backoff_lock = threading.Lock()
        self.expectations = ControllerExpectations()
        self.workers = QueueWorkers(self._sync, workers, name="job-controller")
        # resync re-drives every job periodically: the controller is
        # otherwise edge-triggered, and a failed status write after the
        # last pod went terminal would leave the job un-Completed
        # forever (no further pod event arrives to re-drive the sync —
        # the trace replay under 5% API faults shook this out)
        self.job_informer = Informer(
            client, "jobs",
            on_add=self._enqueue,
            on_update=lambda old, new: self._enqueue(new),
            on_delete=self._enqueue,
            resync_period=5.0)
        self.pod_informer = Informer(
            client, "pods",
            on_add=self._pod_event(adds=True),
            on_update=lambda old, new: self._enqueue_pod_job(new),
            on_delete=self._pod_event(adds=False))

    def _enqueue(self, job: api.Job) -> None:
        self.workers.enqueue(meta_namespace_key(job))

    def _job_for_pod(self, pod: api.Pod):
        for job in self.job_informer.cache.list():
            if job.metadata.namespace != pod.metadata.namespace:
                continue
            if job.spec.selector and selector_from_set(
                    job.spec.selector).matches(pod.metadata.labels):
                return job
        return None

    def _enqueue_pod_job(self, pod: api.Pod) -> None:
        job = self._job_for_pod(pod)
        if job is not None:
            self._enqueue(job)

    def _pod_event(self, adds: bool):
        def handler(pod: api.Pod) -> None:
            job = self._job_for_pod(pod)
            if job is None:
                return
            key = meta_namespace_key(job)
            if adds:
                self.expectations.creation_observed(key)
            else:
                self.expectations.deletion_observed(key)
            self._enqueue(job)
        return handler

    # ----------------------------------------------------------- sync

    def _job_pods(self, job: api.Job) -> List[api.Pod]:
        sel = selector_from_set(job.spec.selector)
        return [p for p in self.pod_informer.cache.list()
                if p.metadata.namespace == job.metadata.namespace
                and sel.matches(p.metadata.labels)]

    def _sync(self, key: str) -> None:
        job = self.job_informer.cache.get_by_key(key)
        if job is None:
            self.expectations.delete(key)
            with self._backoff_lock:
                self._backoff.pop(key, None)
            return
        pods = self._job_pods(job)
        active = [p for p in pods
                  if p.status.phase in (api.POD_PENDING, api.POD_RUNNING,
                                        api.POD_UNKNOWN, "")
                  and p.metadata.deletion_timestamp is None]
        succeeded = sum(1 for p in pods
                        if p.status.phase == api.POD_SUCCEEDED)
        failed = sum(1 for p in pods if p.status.phase == api.POD_FAILED)

        parallelism = job.spec.parallelism if job.spec.parallelism is not None else 1
        completions = job.spec.completions
        done = (succeeded >= completions if completions is not None
                else succeeded > 0)

        if self.expectations.satisfied(key):
            if done:
                # job finished: tear down still-active pods (controller.go
                # syncJob completion path)
                if active:
                    self.expectations.expect_deletions(key, len(active))
                    for pod in active:
                        self._delete_pod(job, key, pod)
                active = []
            else:
                remaining = (completions - succeeded
                             if completions is not None else parallelism)
                want_active = min(parallelism, remaining)
                diff = want_active - len(active)
                if diff > 0 and self._failure_backoff_active(key, failed):
                    diff = 0  # cooling down; the timer re-drives us
                if diff > 0:
                    self.expectations.expect_creations(key, diff)
                    threads = [threading.Thread(
                        target=self._create_pod, args=(job, key),
                        daemon=True) for _ in range(diff)]
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join()
                elif diff < 0:
                    # delete-preference order (controller.ActivePods:
                    # unscheduled < scheduled, Pending < Running,
                    # not-ready < ready) so scale-down discards pods
                    # that have done the least work — the same sort the
                    # RC manager applies (manageJob sorts by ActivePods
                    # before deleting, job/controller.go)
                    active = sorted(active, key=active_pods_sort_key)
                    self.expectations.expect_deletions(key, -diff)
                    for pod in active[:(-diff)]:
                        self._delete_pod(job, key, pod)
                    active = active[(-diff):]

        self._update_status(job, len(active), succeeded, failed, done)

    def _failure_backoff_active(self, key: str, failed: int) -> bool:
        """True while replacements for failed pods must wait. Escalates
        (doubles, capped) each time the failure count grows; a job with
        no failed pods pays nothing. Blocked syncs arm a timer so the
        key re-drives itself when the window expires."""
        now = self.clock.monotonic()
        with self._backoff_lock:
            if failed <= 0:
                self._backoff.pop(key, None)
                return False
            seen, delay, not_before = self._backoff.get(
                key, (0, 0.0, 0.0))
            if failed > seen:
                delay = (self.failure_backoff_initial if delay <= 0
                         else min(delay * 2, self.failure_backoff_cap))
                # full jitter on the top quarter: a wave of jobs
                # failing together must not retry in one synchronized
                # spike (the retry-policy lesson, api/retry.py)
                not_before = now + delay * (0.75 + random.random() * 0.25)
                self._backoff[key] = (failed, delay, not_before)
            remaining = not_before - now
            if remaining <= 0:
                return False
            if key in self._backoff_armed:
                return True  # the armed timer will re-drive this key
            self._backoff_armed.add(key)
        global_metrics.inc("job_backoff_requeues_total",
                           {"job": key})

        def fire():
            with self._backoff_lock:
                self._backoff_armed.discard(key)
            self.workers.enqueue(key)

        timer = threading.Timer(remaining, fire)
        timer.daemon = True
        timer.start()
        return True

    def _create_pod(self, job: api.Job, key: str) -> None:
        tpl = job.spec.template
        pod = api.Pod(
            metadata=api.ObjectMeta(
                generate_name=f"{job.metadata.name}-",
                namespace=job.metadata.namespace,
                labels=dict(tpl.metadata.labels),
                annotations={"kubernetes.io/created-by":
                             f"Job/{job.metadata.name}"}),
            spec=tpl.spec,
            status=api.PodStatus(phase="Pending"))
        try:
            self.client.create("pods", pod, job.metadata.namespace)
            if self.recorder:
                self.recorder.eventf(job, "Normal", "SuccessfulCreate",
                                     "Created pod")
        except Exception:
            self.expectations.creation_observed(key)
            if self.recorder:
                self.recorder.eventf(job, "Warning", "FailedCreate",
                                     "Error creating pod")

    def _delete_pod(self, job: api.Job, key: str, pod: api.Pod) -> None:
        try:
            self.client.delete("pods", pod.metadata.name,
                               pod.metadata.namespace)
            if self.recorder:
                self.recorder.eventf(job, "Normal", "SuccessfulDelete",
                                     "Deleted pod %s", pod.metadata.name)
        except Exception:
            self.expectations.deletion_observed(key)
            if self.recorder:
                self.recorder.eventf(job, "Warning", "FailedDelete",
                                     "Error deleting pod %s",
                                     pod.metadata.name)

    def _update_status(self, job: api.Job, active: int, succeeded: int,
                       failed: int, done: bool) -> None:
        conditions = list(job.status.conditions)
        complete_already = any(c.type == "Complete" and c.status == "True"
                               for c in conditions)
        changed = (job.status.active != active
                   or job.status.succeeded != succeeded
                   or job.status.failed != failed
                   or (done and not complete_already))
        if not changed:
            return
        if done and not complete_already:
            conditions.append(api.JobCondition(type="Complete",
                                               status="True"))
        status = api.JobStatus(
            conditions=conditions,
            start_time=job.status.start_time or api.now_rfc3339(),
            completion_time=(job.status.completion_time
                             or (api.now_rfc3339() if done else None)),
            active=active, succeeded=succeeded, failed=failed)
        try:
            self.client.update_status(
                "jobs", replace(job, status=status), job.metadata.namespace)
        except Exception:
            pass  # next sync retries

    def run(self) -> "JobController":
        self.job_informer.start()
        self.pod_informer.start()
        self.workers.start()
        return self

    def stop(self) -> None:
        self.workers.stop()
        self.job_informer.stop()
        self.pod_informer.stop()
