"""Multiplexed hollow-node fleet.

One object simulates N hollow kubelets against the apiserver:

- registers N Node objects (capacity + Ready/OutOfDisk conditions, the
  fields the scheduler's node filter reads, factory.go:241-256)
- heartbeats all of them on one timer (NodeStatus updates, the signal the
  node-lifecycle controller watches)
- watches ALL pods on one informer and dispatches by spec.nodeName,
  confirming each bound pod Running through one batched status pump —
  the hollow kubelet contract (pkg/kubemark/hollow_kubelet.go: fake
  runtime, instant success)

The per-node agent (agents.HollowKubelet) stays the faithful single-node
implementation; this fleet is the scale harness (5k nodes in one process,
the start-kubemark.sh role).
"""

from __future__ import annotations

import queue
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from typing import Dict, Iterable, List, Optional, Set

from .. import obs
from ..api.cache import Informer, meta_namespace_key
from ..api.client import confirm_pod_deletion
from ..core import types as api
from ..core.errors import AlreadyExists, Conflict, NotFound
from ..core.quantity import parse_quantity
from ..utils.metrics import global_metrics


class HollowFleet:
    def __init__(self, client, n_nodes: int, name_prefix: str = "hollow-",
                 cpu: str = "4", memory: str = "32Gi", max_pods: int = 40,
                 heartbeat_interval: float = 10.0,
                 labels_for=None, jitter_seed: Optional[int] = None,
                 confirm_workers: int = 1):
        """labels_for: optional fn(index) -> labels dict (zones etc.).
        jitter_seed: seeds the heartbeat-phase RNG so a chaos/soak
        harness's beat schedule is reproducible; None keeps the
        process RNG (beats must decohere, not share a phase).
        confirm_workers: how many status calls confirm a burst of pods
        Running at once (the burst split into that many slices, each
        one update_status_batch). 1 is the JAX fleet's single pump; a
        client that cannot batch (HTTP: one PUT a pod) confirms a burst
        pod after pod, where the kubelets of a real fleet confirm side
        by side."""
        self.client = client
        self._jitter_rng = (random.Random(f"{jitter_seed}:heartbeat")
                            if jitter_seed is not None else random.Random())
        self.n_nodes = n_nodes
        self.name_prefix = name_prefix
        self.cpu = cpu
        self.memory = memory
        self.max_pods = max_pods
        self.heartbeat_interval = heartbeat_interval
        self.labels_for = labels_for or (lambda i: {})
        self._names = [f"{name_prefix}{i:05d}" for i in range(n_nodes)]
        self._running: Dict[str, str] = {}  # pod key -> node
        # chaos surfaces (chaos.nodes.NodeChaos drives these):
        # dead      — the host died: no heartbeats, no pod confirms
        # frozen    — heartbeats suppressed (partition sim); kubelet alive
        # not_ready — heartbeats continue but report Ready=False (flap sim)
        self._dead: Set[str] = set()
        self._frozen: Set[str] = set()
        self._not_ready: Set[str] = set()
        self._lock = threading.Lock()
        self._status_q: "queue.Queue[Optional[api.Pod]]" = queue.Queue()
        # (ts, shared Ready conditions, shared running state) — see
        # _running_status
        self._status_shared = None
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._informer: Optional[Informer] = None
        self.confirm_workers = max(1, int(confirm_workers))
        self._confirm_pool = None

    # ---------------------------------------------------------- node side

    def _node_object(self, i: int) -> api.Node:
        ts = api.now_rfc3339()
        name = self._names[i]
        with self._lock:
            ready = "False" if name in self._not_ready else "True"
        return api.Node(
            metadata=api.ObjectMeta(name=name,
                                    labels=self.labels_for(i)),
            status=api.NodeStatus(
                capacity={"cpu": parse_quantity(self.cpu),
                          "memory": parse_quantity(self.memory),
                          "pods": parse_quantity(str(self.max_pods))},
                conditions=[
                    api.NodeCondition(type="Ready", status=ready,
                                      reason=("KubeletReady" if ready == "True"
                                              else "KubeletNotReady"),
                                      last_heartbeat_time=ts),
                    api.NodeCondition(type="OutOfDisk", status="False",
                                      reason="KubeletHasSufficientDisk",
                                      last_heartbeat_time=ts)],
                node_info=api.NodeSystemInfo(
                    kubelet_version="hollow-fleet",
                    container_runtime_version="fake://0")))

    def register_all(self) -> None:
        for i in range(self.n_nodes):
            for attempt in range(5):
                try:
                    self.client.create("nodes", self._node_object(i))
                    break
                except AlreadyExists:
                    break  # already registered from a prior life
                except Exception:
                    # transient (connection loss, injected fault): the
                    # heartbeat's NotFound path would heal this, but a
                    # long heartbeat interval must not leave the node
                    # unregistered for minutes — retry here first
                    self._stop.wait(0.05 * (attempt + 1))
                    if self._stop.is_set():
                        return

    def _heartbeat_one(self, i: int, retries: int = 2) -> None:
        name = self._names[i]
        with self._lock:
            if name in self._dead or name in self._frozen:
                return  # a dead/partitioned kubelet posts nothing
        for attempt in range(retries + 1):
            try:
                node = self.client.get("nodes", name)
                fresh = self._node_object(i)
                self.client.update_status("nodes", replace(
                    node, status=replace(node.status,
                                         conditions=fresh.status.conditions)))
                return
            except NotFound:
                # re-register a node the apiserver lost (or whose
                # registration never landed). ANY failure here must be
                # swallowed — an exception raised inside this handler
                # would escape the outer try and kill the fleet's one
                # heartbeat thread (a transient create fault at 1k
                # nodes under injected chaos did exactly that); the
                # next beat retries the heal
                try:
                    self.client.create("nodes", self._node_object(i))
                except AlreadyExists:
                    pass  # the heal (or a replayed create) landed
                except Exception:
                    pass
                return
            except Exception:
                # transient (injected fault, connection loss): retry
                # with a short backoff instead of leaving the heartbeat
                # stale a whole period — at 5k nodes and 5% faults,
                # period-long gaps push healthy nodes over the
                # controller's grace window
                if attempt >= retries or self._stop.is_set():
                    return
                self._stop.wait(0.05 * (attempt + 1))

    def _heartbeat_loop(self) -> None:
        # staggered: real kubelets beat independently, not in one
        # synchronized wave — a multiplexed fleet that updated all N
        # node statuses at once invalidated every cached node encoding
        # in the same instant, turning the next LIST into a full
        # re-encode spike (1.9s at 5k nodes, over the 1s API SLO). Beat
        # one shard per tick so each node still beats once per
        # heartbeat_interval; each tick draws full jitter (uniform over
        # [0.5, 1.5) of the nominal tick) so shards decohere over time
        # instead of 5k nodes settling into one phase-locked wave.
        shards = 10
        tick = self.heartbeat_interval / shards
        shard = 0
        rng = self._jitter_rng
        while not self._stop.is_set():
            self._stop.wait(tick * rng.uniform(0.5, 1.5))
            if self._stop.is_set():
                return
            self._heartbeat_shard(shard, shards)
            shard = (shard + 1) % shards

    def _heartbeat_shard(self, shard: int, shards: int) -> None:
        for i in range(shard, len(self._names), shards):
            if self._stop.is_set():
                return
            self._heartbeat_one(i)

    # ----------------------------------------------------- chaos surface

    def node_names(self) -> List[str]:
        return list(self._names)

    def kill_nodes(self, names: Iterable[str]) -> List[str]:
        """Hard-kill these hollow hosts: heartbeats stop, bound pods are
        never confirmed Running again, deletion marks are never acked.
        The Node API objects stay behind with stale heartbeats — exactly
        the wire a dead machine leaves."""
        names = [n for n in names if n in set(self._names)]
        with self._lock:
            self._dead.update(names)
        return names

    def dead_nodes(self) -> Set[str]:
        with self._lock:
            return set(self._dead)

    def live_nodes(self) -> List[str]:
        with self._lock:
            return [n for n in self._names if n not in self._dead]

    def freeze_heartbeats(self, names: Iterable[str]) -> None:
        """Suppress heartbeats (master-side partition sim): the kubelet
        is alive — pods still confirm — but its status updates never
        arrive, so the controller sees the heartbeat go stale."""
        with self._lock:
            self._frozen.update(names)

    def thaw_heartbeats(self, names: Optional[Iterable[str]] = None) -> None:
        with self._lock:
            if names is None:
                self._frozen.clear()
            else:
                self._frozen.difference_update(names)

    def set_not_ready(self, names: Iterable[str], not_ready: bool) -> None:
        """Flap surface: keep heartbeating but report Ready=False (a
        sick-but-alive kubelet). Toggling this is how NodeChaos bounces
        a node Ready<->NotReady inside the controller's grace window."""
        with self._lock:
            if not_ready:
                self._not_ready.update(names)
            else:
                self._not_ready.difference_update(names)

    # ----------------------------------------------------------- pod side

    def _on_pod(self, pod: api.Pod) -> None:
        node = pod.spec.node_name
        if not node or not node.startswith(self.name_prefix):
            return
        with self._lock:
            if node in self._dead:
                # a dead kubelet neither confirms Running nor acks
                # deletion marks — the pod object just sits there until
                # the NodeController evicts it
                return
        if pod.metadata.deletion_timestamp is not None:
            # graceful deletion's node half (hollow: nothing to drain):
            # confirm with the grace-0 uid-guarded delete so marked
            # pods terminate instead of sitting Terminating forever
            # (transient failures retry off-thread — no further watch
            # event will re-drive a marked pod)
            self._on_pod_delete(pod)
            confirm_pod_deletion(self.client, pod)
            return
        if pod.status.phase in ("Running", "Succeeded", "Failed"):
            return
        key = meta_namespace_key(pod)
        with self._lock:
            if key in self._running:
                return
            self._running[key] = node
        self._status_q.put(pod)

    def _on_pod_delete(self, pod: api.Pod) -> None:
        with self._lock:
            self._running.pop(meta_namespace_key(pod), None)

    def _running_status(self, pod: api.Pod, ts: str) -> api.PodStatus:
        # batch-invariant sub-objects (Ready condition, running state at
        # ts) are built once per timestamp and SHARED across the pods of
        # a status tile — the framework's replace-don't-mutate contract
        # makes that safe, and it drops ~4 dataclass constructions per
        # pod off the confirm-Running whale (PROFILE_e2e.md). Per-pod
        # data (uid-bearing container_id, start_time) stays per-pod.
        shared = self._status_shared
        if shared is None or shared[0] != ts:
            shared = (ts,
                      [api.PodCondition(type="Ready", status="True")],
                      api.ContainerState(
                          running=api.ContainerStateRunning(started_at=ts)))
            self._status_shared = shared
        _, conditions, state = shared
        return api.PodStatus(
            phase="Running",
            conditions=conditions,
            host_ip="10.0.0.1", pod_ip="10.244.0.2",
            start_time=pod.status.start_time or ts,
            container_statuses=[api.ContainerStatus(
                name=c.name, ready=True, image=c.image,
                container_id=f"fake://{pod.metadata.uid}/{c.name}",
                state=state)
                for c in pod.spec.containers])

    def _status_pump(self) -> None:
        while True:
            pod = self._status_q.get()
            if pod is None:
                return
            # drain a whole burst: under a scheduler tile-commit, the
            # watch hands this queue thousands of freshly-bound pods —
            # confirm them Running in ONE batched store pass instead of
            # per-pod writes fighting the GIL (per-object semantics are
            # unchanged; see registry.update_status_batch). The whole
            # burst lands in one revision window under one ledger-lock
            # acquisition (commit_txn routing), so it is not capped.
            batch = [pod]
            while True:
                try:
                    nxt = self._status_q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._status_q.put(None)  # re-arm shutdown sentinel
                    break
                batch.append(nxt)
            with self._lock:
                if self._dead:
                    # nodes killed after their pods were queued: the
                    # dead kubelet must not confirm them
                    batch = [p for p in batch
                             if p.spec.node_name not in self._dead]
            if not batch:
                continue
            # the echo's host cost per burst (status build + commit):
            # the benchmark's "confirm" layer
            t0 = time.monotonic()
            ts = api.now_rfc3339()
            updated = [api.fast_replace(p,
                                        status=self._running_status(p, ts))
                       for p in batch]
            tr = obs.tracer()
            span = obs.NOOP
            if tr.enabled:
                # "confirm" stage, burst-granular (first pod's
                # annotation context as exemplar parent): fleet status
                # batch -> committed closes the pod's e2e decomposition
                span = tr.start_span("fleet.confirm",
                                     parent=obs.ctx_of(batch[0]),
                                     stage="confirm",
                                     attrs={"pods": len(batch)})
            try:
                with obs.use(span):
                    n = min(self.confirm_workers, len(batch))
                    if n > 1:
                        list(self._confirm_pool.map(
                            lambda i: self._confirm(batch[i::n],
                                                    updated[i::n]),
                            range(n)))
                    else:
                        self._confirm(batch, updated)
            finally:
                tr.end(span)
                global_metrics.observe(
                    "fleet_status_batch_latency_microseconds",
                    (time.monotonic() - t0) * 1e6)

    def _confirm(self, batch: List[api.Pod], updated: List[api.Pod]
                 ) -> None:
        batched = False
        if len(updated) > 1:
            try:
                self.client.update_status_batch("pods", updated)
                batched = True
            except Exception:
                # degrade to singles: per-pod NotFound handling
                pass
        if not batched:
            for p, u in zip(batch, updated):
                self._status_one(p, u)

    def _status_one(self, pod: api.Pod, updated: api.Pod) -> None:
        try:
            try:
                self.client.update_status(
                    "pods", updated, pod.metadata.namespace)
            except Conflict:
                # stale rv (a writer landed between our bind event and
                # this confirm): re-read and re-stamp like the real
                # kubelet's status manager — retrying the ORIGINAL
                # object would 409 forever (the store rev only
                # advances)
                fresh = self.client.get("pods", pod.metadata.name,
                                        pod.metadata.namespace)
                self.client.update_status(
                    "pods", api.fast_replace(
                        fresh, status=updated.status),
                    pod.metadata.namespace)
        except NotFound:
            self._on_pod_delete(pod)
        except Exception:
            # transient: retry unless the fleet is shutting down
            if not self._stop.is_set():
                with self._lock:
                    wanted = meta_namespace_key(pod) in self._running
                if wanted:
                    self._status_q.put(pod)

    # ---------------------------------------------------------- lifecycle

    def running_count(self) -> int:
        with self._lock:
            return len(self._running)

    def run(self) -> "HollowFleet":
        self.register_all()
        # assigned pods only — the same spec.nodeName watch a real
        # kubelet makes (its field selector names one node; the fleet's
        # dispatch-by-nodeName covers all of its nodes with one stream),
        # and the server-side filter keeps the firehose of pending-pod
        # ADDED events out of this informer's queue entirely
        self._informer = Informer(
            self.client, "pods", field_selector="spec.nodeName!=",
            on_add=self._on_pod,
            on_update=lambda old, new: self._on_pod(new),
            on_delete=self._on_pod_delete).start()
        if self.confirm_workers > 1:
            self._confirm_pool = ThreadPoolExecutor(
                self.confirm_workers, thread_name_prefix="fleet-confirm")
        hb = threading.Thread(target=self._heartbeat_loop, daemon=True,
                              name="fleet-heartbeat")
        pump = threading.Thread(target=self._status_pump, daemon=True,
                                name="fleet-status-pump")
        self._threads = [hb, pump]
        hb.start()
        pump.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._informer:
            self._informer.stop()
        self._status_q.put(None)
        if self._confirm_pool is not None:
            # the pump hands the pool its last burst before it exits
            for t in self._threads:
                if t.name == "fleet-status-pump":
                    t.join(timeout=5.0)
            self._confirm_pool.shutdown(wait=False)
