"""Control-plane reconcilers (ref: pkg/controller/*).

Each controller follows the reference pattern: informer caches feed a
deduplicating work queue, worker threads sync one key at a time, all
state re-derivable from the API (crash-only).

The port's copy holds every controller of the JAX package and the
manager that builds them under leader election (manager.py), which the
controller-manager component (hyperkube.py) and the process-crash soak
(kubemark/crash_soak.py) run."""

from .framework import (ControllerExpectations, QueueWorkers,
                        active_pods_sort_key, filter_active_pods)
from .replication import ReplicationManager
from .node import NodeController
from .endpoint import EndpointsController
from .gc import PodGCController
from .namespace import NamespaceController
from .resourcequota import ResourceQuotaController
from .persistentvolume import PersistentVolumeClaimBinder
from .job import JobController
from .daemon import DaemonSetController
from .deployment import DeploymentController
from .podautoscaler import HorizontalController
from .serviceaccount import ServiceAccountsController, TokensController
from .service import RouteController, ServiceController
from .manager import ControllerManager

__all__ = [
    "ControllerExpectations", "QueueWorkers", "active_pods_sort_key",
    "filter_active_pods", "ReplicationManager", "NodeController",
    "EndpointsController", "PodGCController", "NamespaceController",
    "ResourceQuotaController", "PersistentVolumeClaimBinder",
    "JobController", "DaemonSetController", "DeploymentController",
    "HorizontalController", "ServiceAccountsController",
    "TokensController", "ServiceController", "RouteController",
    "ControllerManager",
]
