"""Node lifecycle controller: heartbeat monitoring + rate-limited pod
eviction.

Reference: pkg/controller/node/nodecontroller.go — monitorNodeStatus
(:380-460): per monitor tick, mark nodes whose heartbeat is older than the
grace period Ready=Unknown; once a node has been not-ready/unknown longer
than podEvictionTimeout, queue it on a rate-limited eviction queue
(RateLimitedTimedQueue, pkg/controller/node/rate_limited_queue.go); a node
going Ready again cancels its eviction; eviction deletes every pod bound
to the node and records events. Nodes that vanish from the API get their
pods evicted too (:378-382).

Defaults mirror the reference flags (controllermanager.go):
--node-monitor-period=5s, --node-monitor-grace-period=40s,
--pod-eviction-timeout=5m, --deleting-pods-qps=0.1 burst 10.

Forward-ported beyond the v1.1 reference (DIVERGENCES.md):

- Partition safety valve: when more than `unhealthy_threshold` of the
  fleet is NotReady/Unknown simultaneously, the likeliest explanation
  is a MASTER-side partition (the controller can't reach anything, or
  the apiserver lost the kubelets), not half the datacenter dying at
  once — so evictions HALT (queue freezes, drain stops) and resume
  only when the unhealthy fraction drops back under the threshold.
  This is the later reference's --unhealthy-zone-threshold=0.55
  collapsed to one zone.
- Flap damping: a node bouncing Ready<->NotReady inside the damping
  window (a sick kubelet, a lossy link) is never queued for eviction
  while flapping — without it, each bounce queues/cancels the node and
  a drain racing a flap evicts pods off a node that is Ready again.
- Evictions delete pods with a uid precondition, so a racing
  same-name replacement pod is never killed by a stale drain.
"""

from __future__ import annotations

import threading
from dataclasses import replace
from typing import Dict, List, Optional, Set

from ..core import types as api
from ..core.errors import Conflict, NotFound
from ..utils.clock import Clock, RealClock
from ..utils.ratelimit import TokenBucketRateLimiter


class _NodeHealth:
    __slots__ = ("probe_timestamp", "ready_transition_timestamp", "status",
                 "last_heartbeat", "transitions")

    def __init__(self, probe: float, transition: float, status: str,
                 heartbeat: Optional[str] = None):
        self.probe_timestamp = probe
        self.ready_transition_timestamp = transition
        self.status = status
        self.last_heartbeat = heartbeat
        # recent Ready-status transition times (flap detection); pruned
        # to the damping window on every observation
        self.transitions: List[float] = []


class NodeController:
    def __init__(self, client, monitor_period: float = 5.0,
                 monitor_grace_period: float = 40.0,
                 pod_eviction_timeout: float = 300.0,
                 eviction_qps: float = 0.1, eviction_burst: int = 10,
                 clock: Optional[Clock] = None, recorder=None,
                 allocate_node_cidrs: bool = False,
                 cluster_cidr: str = "",
                 unhealthy_threshold: float = 0.55,
                 partition_min_cluster: int = 3,
                 flap_threshold: int = 3,
                 flap_window: Optional[float] = None):
        """allocate_node_cidrs + cluster_cidr: assign each node a /24
        pod CIDR from the cluster range (nodecontroller.go:62,137
        --allocate-node-cidrs; the route controller consumes
        node.spec.pod_cidr).

        unhealthy_threshold: when MORE than this fraction of the fleet
        is NotReady/Unknown at once, suspect a master-side partition
        and halt all evictions until the fraction recovers. Only
        applies once the fleet has at least partition_min_cluster
        observed nodes (a 1-node cluster losing its node is not a
        partition signal).

        flap_threshold / flap_window: a node with >= flap_threshold
        Ready-status transitions inside flap_window seconds is
        'flapping' and is not queued for eviction until it settles
        (window defaults to the monitor grace period)."""
        if allocate_node_cidrs:
            if not cluster_cidr:
                raise ValueError(
                    "allocate_node_cidrs requires cluster_cidr "
                    "(nodecontroller.go:137-139)")
            import ipaddress
            # fail at construction, not in the monitor thread — a lazy
            # ValueError would kill health monitoring cluster-wide
            ipaddress.ip_network(cluster_cidr)
        self.allocate_node_cidrs = allocate_node_cidrs
        self.cluster_cidr = cluster_cidr
        self.client = client
        self.monitor_period = monitor_period
        self.monitor_grace_period = monitor_grace_period
        self.pod_eviction_timeout = pod_eviction_timeout
        self.clock = clock or RealClock()
        self.recorder = recorder
        self.eviction_limiter = TokenBucketRateLimiter(
            eviction_qps, eviction_burst, self.clock)
        self.unhealthy_threshold = unhealthy_threshold
        self.partition_min_cluster = partition_min_cluster
        self.flap_threshold = flap_threshold
        self.flap_window = (flap_window if flap_window is not None
                            else monitor_grace_period)
        # node name -> health bookkeeping (nodeStatusMap :95)
        self._health: Dict[str, _NodeHealth] = {}
        self._known_nodes: Set[str] = set()
        self._eviction_queue: Set[str] = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # observability: the chaos soak / bench read these
        self.evictions_halted = False      # partition valve engaged
        self.evictions_total = 0           # pods deleted by eviction
        self.eviction_drains_total = 0     # nodes fully drained
        self.partition_halts_total = 0     # valve engage count
        self.flap_damped_total = 0         # evictions deferred by damping

    # -- status monitoring ------------------------------------------------

    @staticmethod
    def _ready_condition(node: api.Node) -> Optional[api.NodeCondition]:
        for c in node.status.conditions:
            if c.type == "Ready":
                return c
        return None

    def _observe(self, node: api.Node) -> str:
        """Update health bookkeeping; mark stale heartbeats Unknown.
        Returns the effective ready status (tryUpdateNodeStatus)."""
        name = node.metadata.name
        now = self.clock.now()
        ready = self._ready_condition(node)
        status = ready.status if ready else "Unknown"
        heartbeat = (ready.last_heartbeat_time if ready else "")
        prior = self._health.get(name)
        if prior is None:
            self._health[name] = _NodeHealth(now, now, status, heartbeat)
            return status
        if status != prior.status:
            prior.ready_transition_timestamp = now
            prior.status = status
            prior.transitions.append(now)
        if heartbeat != prior.last_heartbeat:
            prior.probe_timestamp = now
            prior.last_heartbeat = heartbeat

        if (status != "Unknown"
                and now - prior.probe_timestamp > self.monitor_grace_period):
            # heartbeat went stale: the node agent is gone. Any last
            # reported status goes Unknown — a kubelet that reported
            # Ready=False and then died must not leave its stale
            # diagnosis standing (monitorNodeStatus marks every
            # stale-heartbeat node Unknown, nodecontroller.go)
            status = "Unknown"
            prior.ready_transition_timestamp = now
            prior.status = status
            prior.transitions.append(now)
            self._mark_unknown(node)
            if self.recorder:
                self.recorder.eventf(node, "Normal", "NodeNotReady",
                                     "Node %s status is now: NodeNotReady",
                                     name)
        return status

    def _mark_unknown(self, node: api.Node) -> None:
        conds = [replace(c, status="Unknown",
                         reason="NodeStatusUnknown",
                         message="Kubelet stopped posting node status.")
                 if c.type in ("Ready", "OutOfDisk") else c
                 for c in node.status.conditions]
        try:
            fresh = self.client.get("nodes", node.metadata.name)
            self.client.update_status(
                "nodes", replace(fresh, status=replace(fresh.status,
                                                       conditions=conds)))
        except Exception:
            pass  # retried next tick (nodeStatusUpdateRetry)

    def _is_flapping(self, health: _NodeHealth, now: float) -> bool:
        """>= flap_threshold Ready-status transitions inside the damping
        window: the node is bouncing, not dead — deferring its eviction
        beats the queue/cancel churn (and the drain-races-a-recovery
        eviction) each bounce would cause."""
        cutoff = now - self.flap_window
        health.transitions = [t for t in health.transitions if t >= cutoff]
        return len(health.transitions) >= self.flap_threshold

    # -- eviction ---------------------------------------------------------

    def _queue_eviction(self, name: str) -> None:
        with self._lock:
            self._eviction_queue.add(name)

    def _cancel_eviction(self, name: str) -> None:
        with self._lock:
            self._eviction_queue.discard(name)

    def _drain_eviction_queue(self) -> None:
        """Rate-limited: one node's pods per token. A still-dead node is
        re-queued by the next monitor tick, so pods bound to it later are
        evicted too — the reference's RateLimitedTimedQueue keeps
        processing a node until it goes Ready."""
        failed: set = set()   # per-drain: skip, retry next drain
        while True:
            with self._lock:
                pending = self._eviction_queue - failed
                if not pending:
                    return
                name = min(pending)  # deterministic order
            if not self.eviction_limiter.try_accept():
                return
            if self.evictions_halted:
                # the partition valve can engage between drains (the
                # monitor tick runs on the same thread, but tests and
                # embedders may drive drains directly)
                return
            if not self._evict_pods(name):
                # keep the entry (a node DELETED from the API is only
                # ever queued once, so a transient failure must not
                # discard its eviction forever — the reference's
                # RateLimitedTimedQueue keeps entries until their work
                # succeeds) but move PAST it this drain: one
                # persistently failing node must not head-of-line
                # block every other node's eviction
                failed.add(name)
                continue
            self.eviction_drains_total += 1
            with self._lock:
                self._eviction_queue.discard(name)

    def _evict_pods(self, node_name: str) -> bool:
        """True when the node's pods were listed and every delete was
        accepted (NotFound counts as done); False requeues the node."""
        try:
            pods, _ = self.client.list(
                "pods", field_selector=f"spec.nodeName={node_name}")
        except Exception:
            return False
        ok = True
        for pod in pods:
            try:
                # grace 0: the node's kubelet is gone, so nobody would
                # ever confirm a graceful mark — a graced pod would sit
                # Terminating forever (the reference's eviction relies
                # on the kubelet; with the node dead, force is the only
                # terminal option). uid precondition: this drain kills
                # exactly the pod it LISTED — a same-name replacement
                # created in between (RC recreate racing a stale drain)
                # must survive.
                self.client.delete("pods", pod.metadata.name,
                                   pod.metadata.namespace,
                                   grace_period_seconds=0,
                                   uid=pod.metadata.uid or None)
                self.evictions_total += 1
                if self.recorder:
                    self.recorder.eventf(
                        pod, "Normal", "NodeControllerEviction",
                        "Marking for deletion Pod %s from Node %s",
                        pod.metadata.name, node_name)
            except NotFound:
                continue  # someone else deleted it: done is done
            except Conflict:
                continue  # uid moved: a replacement took the name —
                          # the pod this drain observed is gone
            except Exception:
                ok = False  # retried when the node drains again
        return ok

    # -- pod CIDR allocation ----------------------------------------------

    def reconcile_node_cidrs(self, nodes) -> None:
        """Assign a free /24 from the cluster CIDR to every node that
        lacks one (nodecontroller.go:476 reconcileNodeCIDRs). Unlike
        the reference — which regenerates len(nodes) candidate CIDRs
        each sync and pops from a random set — allocation here walks
        the subnets in address order, so assignments are deterministic
        and the pool isn't capped at the current node count."""
        import ipaddress
        used = {n.spec.pod_cidr for n in nodes if n.spec.pod_cidr}
        free = None  # lazy: the common case is every node assigned
        for node in nodes:
            if node.spec.pod_cidr:
                continue
            if free is None:
                cluster = ipaddress.ip_network(self.cluster_cidr)
                subnets = (cluster.subnets(new_prefix=24)
                           if cluster.prefixlen <= 24 else iter(()))
                free = (str(s) for s in subnets if str(s) not in used)
            cidr = next(free, None)
            if cidr is None:
                if self.recorder:
                    self.recorder.eventf(
                        node, "Normal", "CIDRNotAvailable",
                        "Node %s status is now: CIDRNotAvailable",
                        node.metadata.name)
                continue
            node.spec.pod_cidr = cidr
            try:
                self.client.update("nodes", node)
            except Exception:
                node.spec.pod_cidr = ""
                if self.recorder:
                    self.recorder.eventf(
                        node, "Normal", "CIDRAssignmentFailed",
                        "Node %s status is now: CIDRAssignmentFailed",
                        node.metadata.name)

    # -- control loop -----------------------------------------------------

    def monitor_once(self) -> None:
        try:
            nodes, _ = self.client.list("nodes")
        except Exception:
            return
        if self.allocate_node_cidrs:
            self.reconcile_node_cidrs(nodes)
        now = self.clock.now()
        names = {n.metadata.name for n in nodes}
        # deleted nodes: evict their pods (monitorNodeStatus :378-382)
        for gone in self._known_nodes - names:
            self._queue_eviction(gone)
            self._health.pop(gone, None)
        self._known_nodes = names

        observed = [(node, self._observe(node)) for node in nodes]

        # -- partition safety valve -----------------------------------
        # the whole fleet going NotReady/Unknown at once looks like a
        # master-side partition, not mass hardware death: halt all
        # evictions (queueing AND draining) until the unhealthy
        # fraction drops back under the threshold
        unhealthy = sum(1 for _, status in observed if status != "True")
        if (len(observed) >= self.partition_min_cluster
                and unhealthy > self.unhealthy_threshold * len(observed)):
            if not self.evictions_halted:
                self.evictions_halted = True
                self.partition_halts_total += 1
        elif self.evictions_halted:
            self.evictions_halted = False

        for node, status in observed:
            health = self._health[node.metadata.name]
            if status == "True":
                self._cancel_eviction(node.metadata.name)
            elif (now - health.ready_transition_timestamp
                  > self.pod_eviction_timeout):
                if self.evictions_halted:
                    continue
                if self._is_flapping(health, now):
                    self.flap_damped_total += 1
                    continue
                self._queue_eviction(node.metadata.name)
        if not self.evictions_halted:
            self._drain_eviction_queue()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.monitor_once()
            self._stop.wait(self.monitor_period)

    def run(self) -> "NodeController":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="node-controller")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
