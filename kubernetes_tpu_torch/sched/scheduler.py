"""The scheduler control loop.

Reference: plugin/pkg/scheduler/scheduler.go:110-165 — `scheduleOne` is
strictly serial: NextPod (blocking FIFO pop) -> rate limit -> Schedule ->
Binding POST under the modeler lock -> AssumePod; errors go to the Error
func (backoff + requeue). Metrics names match metrics/metrics.go:30-80.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)

from ..core import types as api
from ..utils.metrics import MetricsRegistry, global_metrics


class SchedulerConfig:
    def __init__(self, algorithm, next_pod: Callable[[], Optional[api.Pod]],
                 binder, node_lister, modeler,
                 error: Callable[[api.Pod, Exception], None],
                 recorder=None, bind_pods_rate_limiter=None,
                 metrics: Optional[MetricsRegistry] = None,
                 on_assume: Optional[Callable[[api.Pod], None]] = None):
        self.algorithm = algorithm
        self.next_pod = next_pod
        self.binder = binder
        self.node_lister = node_lister
        self.modeler = modeler
        self.error = error
        self.recorder = recorder
        self.bind_pods_rate_limiter = bind_pods_rate_limiter
        self.metrics = metrics or global_metrics
        # extra assume observer (the mixed-mode device state joins the
        # modeler at the AssumePod moment)
        self.on_assume = on_assume


class Scheduler:
    """(ref: scheduler.go:80 Scheduler + Run/scheduleOne)"""

    def __init__(self, config: SchedulerConfig):
        self.config = config
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def run(self) -> "Scheduler":
        self._thread = threading.Thread(target=self._loop, name="scheduler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                busy = self.schedule_one()
            except Exception:
                # pod-level failures are routed inside schedule_one;
                # anything escaping would otherwise kill the daemon
                # thread and stall scheduling cluster-wide. Treat the
                # round as idle so a persistent failure backs off
                # instead of busy-spinning the log.
                logger.exception("schedule_one failed")
                busy = False
            if not busy:
                # no pod this round (timeout or closed queue): back off a
                # touch so a closed factory doesn't turn this into a busy-spin
                self._stop.wait(0.01)

    def schedule_one(self) -> bool:
        """(ref: scheduler.go:120 scheduleOne). Returns True if a pod was
        processed."""
        c = self.config
        pod = c.next_pod()
        if pod is None:  # queue closed / timed out — loop re-checks stop
            return False
        if c.bind_pods_rate_limiter is not None:
            c.bind_pods_rate_limiter.accept()
        start = time.monotonic()
        try:
            dest = c.algorithm.schedule(pod, c.node_lister)
        except Exception as e:
            c.metrics.observe("scheduling_algorithm_latency_microseconds",
                              (time.monotonic() - start) * 1e6)
            # ref: E2eSchedulingLatency is deferred, so it observes failed
            # attempts too
            c.metrics.observe("scheduler_e2e_scheduling_latency_microseconds",
                              (time.monotonic() - start) * 1e6)
            try:
                if c.recorder is not None:
                    c.recorder.eventf(pod, "Warning", "FailedScheduling",
                                      str(e))
            finally:
                # the requeue must not be lost to a recorder failure —
                # the pod is already consumed from the FIFO
                c.error(pod, e)
            return True
        c.metrics.observe("scheduling_algorithm_latency_microseconds",
                          (time.monotonic() - start) * 1e6)

        binding = api.Binding(
            metadata=api.ObjectMeta(namespace=pod.metadata.namespace,
                                    name=pod.metadata.name),
            target=api.ObjectReference(kind="Node", name=dest))

        def bind_and_assume():
            bind_start = time.monotonic()
            try:
                c.binder.bind(binding)
            except Exception as e:
                c.metrics.observe("binding_latency_microseconds",
                                  (time.monotonic() - bind_start) * 1e6)
                if c.recorder is not None:
                    c.recorder.eventf(pod, "Normal", "FailedScheduling",
                                      f"Binding rejected: {e}")
                c.error(pod, e)
                return
            c.metrics.observe("binding_latency_microseconds",
                              (time.monotonic() - bind_start) * 1e6)
            if c.recorder is not None:
                c.recorder.eventf(
                    pod, "Normal", "Scheduled",
                    f"Successfully assigned {pod.metadata.name} to {dest}")
            from dataclasses import replace
            assumed = replace(pod, spec=replace(pod.spec, node_name=dest))
            # the bind already landed: a failure in the assume tail must
            # not escape and kill the scheduler thread — the watch echo
            # re-syncs whatever the caches missed
            try:
                c.modeler.assume_pod(assumed)
                if c.on_assume is not None:
                    c.on_assume(assumed)
            except Exception:
                logger.exception("assume after bind failed for %s",
                                 pod.metadata.name)

        c.modeler.locked_action(bind_and_assume)
        c.metrics.observe("scheduler_e2e_scheduling_latency_microseconds",
                          (time.monotonic() - start) * 1e6)
        return True
