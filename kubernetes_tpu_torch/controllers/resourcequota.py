"""ResourceQuota controller: periodic usage recalculation.

Reference: pkg/controller/resourcequota/resource_quota_controller.go —
every full-resync period, recompute each quota's status.used from the live
objects in its namespace and write it back when it drifted. This is the
decrement path: admission (admission/plugins.py ResourceQuota) only ever
increments used; deletes are reconciled here, exactly like the
reference's controller-resync division of labor.

Terminated pods don't count (the reference skips Succeeded/Failed pods in
its pod usage calculation), so pod churn can't exhaust a namespace.
"""

from __future__ import annotations

import threading
from dataclasses import replace
from typing import Dict, Optional

from ..core import types as api
from ..core.errors import ApiError
from ..core.quantity import Quantity

FULL_RESYNC_PERIOD = 10.0  # ref default --resource-quota-sync-period=10s

COUNTED_RESOURCES = ("pods", "services", "replicationcontrollers",
                     "secrets", "resourcequotas")


def calculate_usage(client, quota: api.ResourceQuota) -> Dict[str, Quantity]:
    """Live usage for every resource the quota bounds (milli units)."""
    ns = quota.metadata.namespace
    hard = quota.spec.hard
    used: Dict[str, Quantity] = {}
    pods = None
    if {"pods", "cpu", "memory"} & set(hard):
        all_pods, _ = client.list("pods", ns)
        pods = [p for p in all_pods
                if p.status.phase not in (api.POD_SUCCEEDED, api.POD_FAILED)]
    if "pods" in hard:
        used["pods"] = Quantity(1000 * len(pods))
    if "cpu" in hard or "memory" in hard:
        from ..admission.plugins import pod_usage
        cpu = 0
        mem = 0
        for p in pods:
            u = pod_usage(p)
            cpu += u["cpu"]
            mem += u["memory"]
        if "cpu" in hard:
            used["cpu"] = Quantity(cpu)
        if "memory" in hard:
            used["memory"] = Quantity(mem)
    for resource in COUNTED_RESOURCES:
        if resource in ("pods",) or resource not in hard:
            continue
        items, _ = client.list(resource, ns)
        used[resource] = Quantity(1000 * len(items))
    return used


class ResourceQuotaController:
    def __init__(self, client, sync_period: float = FULL_RESYNC_PERIOD):
        self.client = client
        self.sync_period = sync_period
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sync_once(self) -> int:
        """Recalculate every quota; returns how many were rewritten."""
        try:
            quotas, _ = self.client.list("resourcequotas")
        except Exception:
            return 0
        rewritten = 0
        for quota in quotas:
            try:
                used = calculate_usage(self.client, quota)
            except Exception:
                continue
            current = {k: v for k, v in quota.status.used.items()}
            if current == used and dict(quota.status.hard) == dict(
                    quota.spec.hard):
                continue
            updated = replace(quota, status=api.ResourceQuotaStatus(
                hard=dict(quota.spec.hard), used=used))
            try:
                self.client.update_status("resourcequotas", updated,
                                          quota.metadata.namespace)
                rewritten += 1
            except ApiError:
                pass  # raced with admission's CAS increment: next resync
        return rewritten

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.sync_once()
            self._stop.wait(self.sync_period)

    def run(self) -> "ResourceQuotaController":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="resourcequota-controller")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
