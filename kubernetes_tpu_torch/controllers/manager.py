"""Controller manager: start every controller with one call.

Reference: cmd/kube-controller-manager/app/controllermanager.go:284-443 —
endpoints :284, RC manager :287, node controller :303, resourcequota
:327, namespace :351, HPA :368, daemonset :374, job :380, PV binder
:407, serviceaccount + tokens :433-443 (plus pod GC). Each controller is
independent; the manager only owns their lifecycle.

HA: pass `elect=LeaderElectionConfig(...)` and the manager becomes a
CANDIDATE — controllers are built and started only when its elector
wins the lease, and torn down when leadership is lost, so N replicas
run with exactly one acting controller-manager (the reference's
--leader-elect flag, forward-ported from its master election seam onto
the typed Lease; utils/leaderelection.py). Controllers are rebuilt
fresh on every leadership session: a re-elected manager re-lists
through its informers rather than trusting any pre-demotion carry.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from ..utils.leaderelection import LeaderElectionConfig, LeaderElector
from .daemon import DaemonSetController
from .deployment import DeploymentController
from .endpoint import EndpointsController
from .gc import PodGCController
from .job import JobController
from .namespace import NamespaceController
from .node import NodeController
from .persistentvolume import PersistentVolumeClaimBinder
from .podautoscaler import HorizontalController
from .replication import ReplicationManager
from .resourcequota import ResourceQuotaController
from .service import RouteController, ServiceController
from .serviceaccount import ServiceAccountsController, TokensController


class ControllerManager:
    def __init__(self, client, metrics_source=None, recorder=None,
                 pod_gc_threshold: int = 12500, cloud=None,
                 allocate_node_cidrs: bool = False,
                 cluster_cidr: str = "10.244.0.0/16",
                 elect: Optional[LeaderElectionConfig] = None):
        self._build_args = dict(
            client=client, metrics_source=metrics_source,
            recorder=recorder, pod_gc_threshold=pod_gc_threshold,
            cloud=cloud, allocate_node_cidrs=allocate_node_cidrs,
            cluster_cidr=cluster_cidr)
        self.controllers: List = []
        self.term = 0
        # serializes build/teardown against elector transitions
        self._lifecycle = threading.Lock()
        self.elector: Optional[LeaderElector] = None
        if elect is not None:
            self.elector = LeaderElector(
                client, elect,
                on_started_leading=self._on_started_leading,
                on_stopped_leading=self._stop_controllers)
        else:
            self.controllers = self._build()

    def _build(self) -> List:
        a = self._build_args
        client, recorder = a["client"], a["recorder"]
        controllers: List = [
            EndpointsController(client),
            ReplicationManager(client, recorder=recorder),
            NodeController(client, recorder=recorder,
                           allocate_node_cidrs=a["allocate_node_cidrs"],
                           cluster_cidr=a["cluster_cidr"]),
            PodGCController(client, threshold=a["pod_gc_threshold"]),
            NamespaceController(client),
            ResourceQuotaController(client),
            JobController(client, recorder=recorder),
            DaemonSetController(client),
            DeploymentController(client),
            PersistentVolumeClaimBinder(client),
            ServiceAccountsController(client),
            TokensController(client),
        ]
        if a["metrics_source"] is not None:
            controllers.append(
                HorizontalController(client, a["metrics_source"],
                                     recorder=recorder))
        if a["cloud"] is not None:
            controllers.append(ServiceController(client, a["cloud"],
                                                 recorder=recorder))
            controllers.append(RouteController(
                client, a["cloud"], cluster_cidr=a["cluster_cidr"]))
        return controllers

    # --------------------------------------------------- leadership hooks

    def _on_started_leading(self, term: int) -> None:
        """Fresh controllers per leadership session (see class doc);
        the fencing term rides on the instance for observability."""
        with self._lifecycle:
            self.term = term
            self.controllers = self._build()
            for c in self.controllers:
                c.run()

    def _stop_controllers(self) -> None:
        with self._lifecycle:
            for c in reversed(self.controllers):
                try:
                    c.stop()
                except Exception:
                    pass
            self.controllers = []

    # ------------------------------------------------------------- run

    @property
    def is_leader(self) -> bool:
        return self.elector is None or self.elector.is_leader

    def run(self) -> "ControllerManager":
        if self.elector is not None:
            self.elector.run()
        else:
            for c in self.controllers:
                c.run()
        return self

    def stop(self) -> None:
        if self.elector is not None:
            self.elector.stop()  # demotes -> _stop_controllers
        else:
            for c in reversed(self.controllers):
                try:
                    c.stop()
                except Exception:
                    pass

    def kill(self) -> None:
        """Simulated process death (chaos/crash.py): controllers halt
        and the lease is NOT released — the standby must wait out the
        expiry and take over under a new fencing term, exactly the
        wire a real crash leaves behind."""
        if self.elector is not None:
            self.elector.kill()
        # a dead process runs nothing: hard-stop the controller threads
        # (without the elector's clean on_stopped_leading semantics)
        self._stop_controllers()
