"""Horizontal pod autoscaler.

Reference: pkg/controller/podautoscaler/horizontal.go — every sync period
(default 30s) compute desired replicas from observed CPU utilization vs
the target: desired = ceil(current * actual/target), with a 10% tolerance
band, clamped to [min, max]; scale the referenced RC. The reference reads
utilization from heapster; here the metrics source is injectable
(fn(namespace, selector_labels) -> average utilization percent or None),
with the same semantics: no metrics -> no scaling.

Downscale stabilization (the later reference's
--horizontal-pod-autoscaler-downscale-stabilization, backported for the
trace-replay soak): with a window of N seconds, the effective desired
count is the MAX recommendation over the last N seconds — upscales act
immediately, downscales only once every recommendation in the window
agrees. A diurnal replay's metric dips then stop flapping replica
counts (tests/test_workload_controllers.py pins flap vs genuine
ramp-down)."""

from __future__ import annotations

import math
import threading
from dataclasses import replace
from typing import Callable, Dict, List, Optional, Tuple

from ..core import types as api
from ..core.errors import ApiError, NotFound
from ..utils.clock import Clock, RealClock

SYNC_PERIOD = 30.0        # horizontal.go default --horizontal-pod-autoscaler-sync-period
TOLERANCE = 0.1           # horizontal.go tolerance

MetricsSource = Callable[[str, Dict[str, str]], Optional[float]]


class HorizontalController:
    def __init__(self, client, metrics: MetricsSource,
                 sync_period: float = SYNC_PERIOD, recorder=None,
                 downscale_stabilization: float = 0.0,
                 clock: Optional[Clock] = None):
        self.client = client
        self.metrics = metrics
        self.recorder = recorder
        self.sync_period = sync_period
        self.downscale_stabilization = downscale_stabilization
        self.clock = clock or RealClock()
        # per-HPA (ns/name) recommendation history inside the window
        self._recommendations: Dict[str, List[Tuple[float, int]]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def reconcile_once(self) -> int:
        """Sync every HPA; returns how many scaled."""
        try:
            hpas, _ = self.client.list("horizontalpodautoscalers")
        except Exception:
            return 0
        scaled = 0
        for hpa in hpas:
            try:
                if self._reconcile(hpa):
                    scaled += 1
            except Exception:
                # one broken HPA (bad scaleRef, metrics source raising,
                # transport error) must not kill the reconcile thread
                continue
        return scaled

    # scaleRef kind -> registry resource (horizontal.go scales through
    # the extensions Scale subresource, never the full object)
    _SCALE_KINDS = {"ReplicationController": "replicationcontrollers",
                    "Deployment": "deployments"}

    def _reconcile(self, hpa: api.HorizontalPodAutoscaler) -> bool:
        ref = hpa.spec.scale_ref
        ns = ref.namespace or hpa.metadata.namespace
        resource = self._SCALE_KINDS.get(ref.kind)
        if resource is None:
            return False
        # read and write through the scale subresource, the reference's
        # contract (horizontal.go reconcileAutoscaler: scales.Get ->
        # compute -> scales.Update; the selector for the metrics query
        # comes from scale.status.selector)
        scale = self.client.get_scale(resource, ref.name, ns)
        current = scale.spec.replicas
        target = hpa.spec.cpu_utilization_target_percentage
        utilization = None
        desired = current
        if target and current > 0:
            utilization = self.metrics(ns, scale.status.selector)
            if utilization is not None:
                ratio = utilization / target
                # inside the tolerance band nothing moves (horizontal.go)
                if abs(ratio - 1.0) > TOLERANCE:
                    desired = int(math.ceil(current * ratio))
        desired = max(hpa.spec.min_replicas,
                      min(hpa.spec.max_replicas, desired))
        desired = self._stabilized(hpa, desired)
        did_scale = desired != current
        if did_scale:
            try:
                self.client.update_scale(
                    resource, ref.name,
                    replace(scale, spec=api.ScaleSpec(replicas=desired)),
                    ns)
            except Exception as e:
                # ref: horizontal.go:145 — a failed rescale records and
                # propagates (the reconcile loop isolates per HPA)
                if self.recorder:
                    self.recorder.eventf(
                        hpa, "Warning", "FailedRescale",
                        "New size: %d; error: %s", desired, e)
                raise
            if self.recorder:
                self.recorder.eventf(hpa, "Normal", "SuccessfulRescale",
                                     "New size: %d", desired)
        self._update_status(hpa, current, desired, utilization, did_scale)
        return did_scale

    def _stabilized(self, hpa: api.HorizontalPodAutoscaler,
                    desired: int) -> int:
        """Damped desired count: the max recommendation over the
        stabilization window. A single-dip recommendation can never
        shrink the fleet; a ramp-down that outlives the window can."""
        if self.downscale_stabilization <= 0:
            return desired
        key = f"{hpa.metadata.namespace}/{hpa.metadata.name}"
        now = self.clock.monotonic()
        floor = now - self.downscale_stabilization
        window = [(ts, d) for ts, d in self._recommendations.get(key, [])
                  if ts >= floor]
        window.append((now, desired))
        self._recommendations[key] = window
        return max(d for _, d in window)

    def _update_status(self, hpa, current, desired, utilization,
                       did_scale) -> None:
        status = api.HorizontalPodAutoscalerStatus(
            observed_generation=hpa.metadata.generation,
            last_scale_time=(api.now_rfc3339() if did_scale
                             else hpa.status.last_scale_time),
            current_replicas=current, desired_replicas=desired,
            current_cpu_utilization_percentage=(
                int(utilization) if utilization is not None else None))
        try:
            self.client.update_status(
                "horizontalpodautoscalers", replace(hpa, status=status),
                hpa.metadata.namespace)
        except (ApiError, NotFound):
            pass

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.reconcile_once()
            self._stop.wait(self.sync_period)

    def run(self) -> "HorizontalController":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="horizontal-pod-autoscaler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
