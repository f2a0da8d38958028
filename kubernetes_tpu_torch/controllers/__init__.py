"""Control-plane reconcilers (ref: pkg/controller/*).

Each controller follows the reference pattern: informer caches feed a
deduplicating work queue, worker threads sync one key at a time, all
state re-derivable from the API (crash-only).

The port's copy holds the shared machinery, the replication manager and
the node lifecycle controller: what the node-kill soak
(kubemark/node_chaos.py) runs. The other controllers of the JAX package
are not ported yet (ROADMAP.md Queue 1)."""

from .framework import (ControllerExpectations, QueueWorkers,
                        active_pods_sort_key, filter_active_pods)
from .node import NodeController
from .replication import ReplicationManager

__all__ = [
    "ControllerExpectations", "QueueWorkers", "active_pods_sort_key",
    "filter_active_pods", "ReplicationManager", "NodeController",
]
