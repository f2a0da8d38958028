"""Scheduler config factory: watch wiring + algorithm assembly.

Reference: plugin/pkg/scheduler/factory/factory.go:47-452 —
  - unassigned pods (spec.nodeName= field selector, :260-262) -> FIFO queue
  - assigned pods (spec.nodeName!=) -> ScheduledPodLister; informer handlers
    forget modeler assumptions (:92-115)
  - nodes with spec.unschedulable=false (:281-285) further filtered by the
    readiness condition predicate (Ready==True && OutOfDisk==False,
    :241-256)
  - services + RCs for the spreading priorities
  - binder POSTs Bindings (:353-364)
  - default error func: 1s->60s exponential pod backoff + requeue
    (:376-452)
"""

from __future__ import annotations

import time
import threading
from typing import Callable, List, Optional

from ..api.cache import (FIFO, Informer, ObjectCache, Reflector,
                         StoreToPodLister, StoreToReplicationControllerLister,
                         StoreToServiceLister, meta_namespace_key)
from ..core import types as api
from ..utils.backoff import Backoff
from ..utils.ratelimit import TokenBucketRateLimiter
from . import plugins
from .api import Policy
from .extender import HTTPExtender
from .generic import GenericScheduler
from .modeler import SimpleModeler
from .predicates import node_schedulable
from .scheduler import Scheduler, SchedulerConfig

DEFAULT_BIND_PODS_QPS = 50.0   # ref: plugin/cmd/kube-scheduler/app/server.go:69
DEFAULT_BIND_PODS_BURST = 100  # ref: server.go:70


def node_condition_predicate(node: api.Node) -> bool:
    """(ref: factory.go:241 getNodeConditionPredicate; the
    spec.unschedulable check stands in for createNodeLW's server-side
    field selector — the informer is deliberately UNfiltered here, see
    ConfigFactory). Delegates to predicates.node_schedulable so the
    candidate filter, the serial NodeSchedulable predicate and the
    device encoders' sched_ok mask cannot drift."""
    return node_schedulable(node)


class ReadyNodeLister:
    """Node lister filtered to schedulable+ready nodes; get() looks up any
    cached node by name (the NodeInfo role for ServiceAffinity)."""

    def __init__(self, cache: ObjectCache):
        self.cache = cache

    def list(self) -> List[api.Node]:
        return [n for n in self.cache.list() if node_condition_predicate(n)]

    def get(self, name: str) -> Optional[api.Node]:
        return self.cache.get_by_key(name)


class Binder:
    """(ref: factory.go:353 binder — POST bindings)"""

    def __init__(self, client):
        self.client = client

    def bind(self, binding: api.Binding):
        return self.client.bind(binding)


class PodQueueLister:
    """Lister view over the pending FIFO (modeler's queuedPods)."""

    def __init__(self, fifo: FIFO):
        self.fifo = fifo

    def list(self, selector=None) -> List[api.Pod]:
        pods = self.fifo.list()
        if selector is not None and not selector.empty():
            pods = [p for p in pods if selector.matches(p.metadata.labels)]
        return pods

    def exists(self, pod: api.Pod) -> bool:
        return self.fifo.contains(meta_namespace_key(pod))


# engine core predicates: always enforced by the device scan (1.0 alias
# PodFitsPorts accepted); a policy must name all of them to be eligible
_ENGINE_CORE_PREDICATES = {"PodFitsResources", "NoDiskConflict",
                           "MatchNodeSelector", "HostName"}


def _translate_policy(policy):
    """Policy -> (weights, DevicePolicy) for the device engine, or None if
    the policy needs the serial path. See ConfigFactory.create_batch."""
    from .device import DevicePolicy
    if policy is None:
        return (1, 1, 1), None
    if policy.extenders:
        return None
    dev = DevicePolicy()
    if policy.predicates:
        named = set()
        for p in policy.predicates:
            if p.service_affinity is not None:
                return None  # peer-inherited node affinity: serial only
            if p.labels_presence is not None:
                dev.label_presence.append(
                    (tuple(p.labels_presence.labels),
                     p.labels_presence.presence))
                continue
            named.add("PodFitsHostPorts" if p.name == "PodFitsPorts"
                      else p.name)
        # InterPodAffinity is required too: the engine enforces the
        # affinity mask unconditionally, so a policy omitting it would get
        # a stricter engine than its serial counterpart
        required = _ENGINE_CORE_PREDICATES | {"PodFitsHostPorts",
                                              "InterPodAffinity"}
        # NodeSchedulable is enforced unconditionally by the engine's
        # sched_ok mask (and by the serial path's candidate filter), so
        # a policy may name it but never has to
        if not required <= named or named - (required | {"NodeSchedulable"}):
            return None  # dropped core predicate / unknown name
    weights = [1, 1, 1]
    if policy.priorities:
        weights = [0, 0, 0]
        slot = {"LeastRequestedPriority": 0,
                "BalancedResourceAllocation": 1,
                "SelectorSpreadPriority": 2}
        for p in policy.priorities:
            if p.service_anti_affinity is not None:
                if dev.needs_anti_affinity:
                    return None  # engine encodes one zone label
                dev.anti_affinity_label = p.service_anti_affinity.label
                dev.anti_affinity_weight = p.weight
                continue
            if p.label_preference is not None:
                dev.label_priorities.append(
                    (p.label_preference.label, p.label_preference.presence,
                     p.weight))
                continue
            if p.name in slot:
                weights[slot[p.name]] += p.weight
            elif p.name == "EqualPriority":
                pass  # constant shift across nodes: argmax-invariant
            else:
                return None  # e.g. ServiceSpreadingPriority (services-only)
    dev_needed = (dev.needs_anti_affinity or dev.label_presence
                  or dev.label_priorities)
    return tuple(weights), (dev if dev_needed else None)


class ConfigFactory:
    """(ref: factory.go:72 NewConfigFactory)"""

    def __init__(self, client, bind_qps: float = DEFAULT_BIND_PODS_QPS,
                 bind_burst: int = DEFAULT_BIND_PODS_BURST,
                 rate_limit: bool = True, recorder=None):
        self.client = client
        self.pod_queue = FIFO()
        self.recorder = recorder

        # unassigned pods -> FIFO (ref: createUnassignedPodLW :260)
        self.unassigned_reflector = Reflector(
            client, "pods", field_selector="spec.nodeName=",
            store=self.pod_queue)

        # assigned pods -> ScheduledPodLister; forget modeler assumptions on
        # add/delete (ref: factory.go:92-115 scheduledPodPopulator).
        # scheduled_observers: external hooks (kubemark benchmark / SLO
        # probes) ride THIS informer instead of opening their own watch —
        # the reference benchmark likewise watches completion through the
        # scheduler's ScheduledPodLister (scheduler_test.go:278), and a
        # duplicate pods watch costs a per-event fan-out at 30k scale
        self.scheduled_observers: List[Callable] = []
        self.scheduled_cache = ObjectCache()
        self.scheduled_reflector = Reflector(
            client, "pods", field_selector="spec.nodeName!=",
            store=self.scheduled_cache,
            on_add=self._scheduled_added, on_delete=self._forget)
        self.scheduled_pod_lister = StoreToPodLister(self.scheduled_cache)

        # nodes: UNfiltered, unlike createNodeLW's
        # spec.unschedulable=false selector (:281) — the reference pairs
        # that filtered watch with a NodeInfo that hits the live nodes
        # API (factory.go CreateFromKeys: f.Client.Nodes()), so
        # ServiceAffinity/anti-affinity still resolve CORDONED nodes'
        # labels. One unfiltered cache lands the same observable
        # semantics: candidate lists apply node_condition_predicate
        # (which now covers unschedulable), while get() — the NodeInfo
        # role — resolves any cached node, so pods on cordoned nodes
        # keep occupying their topology domains instead of silently
        # vanishing from affinity math
        self.node_informer = Informer(client, "nodes")
        self.node_lister = ReadyNodeLister(self.node_informer.cache)

        # services + RCs (ref: createServiceLW/createControllerLW :288-295)
        self.service_informer = Informer(client, "services")
        self.service_lister = StoreToServiceLister(self.service_informer.cache)
        self.controller_informer = Informer(client, "replicationcontrollers")
        self.controller_lister = StoreToReplicationControllerLister(
            self.controller_informer.cache)

        self.modeler = SimpleModeler(PodQueueLister(self.pod_queue),
                                     self.scheduled_pod_lister)
        self.pod_lister = self.modeler  # the merged view the algorithm sees
        self.backoff = Backoff(1.0, 60.0)  # ref: factory.go podBackoff
        # shared delayed-requeue machinery (see _requeue_worker)
        self._requeue_heap: list = []
        self._requeue_cond = threading.Condition()
        self._requeue_thread: Optional[threading.Thread] = None
        self._requeue_seq = 0
        self.rate_limiter = TokenBucketRateLimiter(bind_qps, bind_burst) \
            if rate_limit else None
        self._started = False
        self._error_func = None

    def _forget(self, pod: api.Pod) -> None:
        self.modeler.locked_action(lambda: self.modeler.forget_pod(pod))

    def _scheduled_added(self, pod: api.Pod) -> None:
        self._forget(pod)
        for cb in self.scheduled_observers:
            cb(pod)

    # ------------------------------------------------------------- wiring

    def start(self) -> "ConfigFactory":
        if not self._started:
            self.unassigned_reflector.start()
            self.scheduled_reflector.start()
            self.node_informer.start()
            self.service_informer.start()
            self.controller_informer.start()
            self._started = True
        return self

    def stop(self) -> None:
        self.pod_queue.close()
        self.unassigned_reflector.stop()
        self.scheduled_reflector.stop()
        self.node_informer.stop()
        self.service_informer.stop()
        self.controller_informer.stop()

    def plugin_args(self) -> plugins.PluginFactoryArgs:
        return plugins.PluginFactoryArgs(
            pod_lister=self.pod_lister,
            service_lister=self.service_lister,
            controller_lister=self.controller_lister,
            node_lister=self.node_lister)

    # ----------------------------------------------------------- assembly

    def create(self) -> SchedulerConfig:
        """Default algorithm provider (ref: factory.go Create)."""
        return self.create_from_provider(plugins.DEFAULT_PROVIDER)

    def create_from_provider(self, provider_name: str) -> SchedulerConfig:
        predicate_keys, priority_keys = plugins.get_algorithm_provider(
            provider_name)
        args = self.plugin_args()
        return self._create(
            plugins.get_fit_predicates(predicate_keys, args),
            plugins.get_priority_configs(priority_keys, args),
            extenders=[])

    def create_from_config(self, policy: Policy) -> SchedulerConfig:
        """(ref: factory.go:137 CreateFromConfig — empty lists fall back to
        the provider defaults)."""
        args = self.plugin_args()
        if policy.predicates:
            # key collisions (e.g. two unnamed labelsPresence entries) must
            # not drop predicates — the device engine enforces all of them
            predicates = {}
            for p in policy.predicates:
                key = p.name
                while key in predicates:
                    key += "#"
                predicates[key] = plugins.predicate_from_policy(p, args)
        else:
            keys, _ = plugins.get_algorithm_provider(plugins.DEFAULT_PROVIDER)
            predicates = plugins.get_fit_predicates(keys, args)
        if policy.priorities:
            priorities = [plugins.priority_from_policy(p, args)
                          for p in policy.priorities]
        else:
            _, keys = plugins.get_algorithm_provider(plugins.DEFAULT_PROVIDER)
            priorities = plugins.get_priority_configs(keys, args)
        extenders = [HTTPExtender(cfg) for cfg in policy.extenders]
        return self._create(predicates, priorities, extenders)

    def _create(self, predicates, priorities, extenders,
                algorithm=None, on_assume=None) -> SchedulerConfig:
        if algorithm is None:
            algorithm = GenericScheduler(predicates, priorities,
                                         self.pod_lister, extenders)
        return SchedulerConfig(
            algorithm=algorithm,
            next_pod=self._next_pod,
            binder=Binder(self.client),
            node_lister=self.node_lister,
            modeler=self.modeler,
            error=self.make_default_error_func(),
            recorder=self.recorder,
            bind_pods_rate_limiter=self.rate_limiter,
            on_assume=on_assume)

    def _next_pod(self) -> Optional[api.Pod]:
        """(ref: factory.go:230 NextPod — blocking FIFO pop)"""
        return self.pod_queue.pop(timeout=0.5)

    @property
    def error_func(self) -> Callable:
        """Shared backoff+requeue error handler (batch path)."""
        if self._error_func is None:
            self._error_func = self.make_default_error_func()
        return self._error_func

    def create_batch(self, policy: Optional[Policy] = None, **kw):
        """Device fast-path config, or None if the policy needs the serial
        path. The engine covers the default provider's predicate/priority
        set plus the policy-file customs it can encode statically
        (CheckNodeLabelPresence, CalculateNodeLabelPriority,
        ServiceAntiAffinity — device.DevicePolicy). Anything else
        (ServiceAffinity predicates, HTTP extenders, a policy that drops
        one of the engine's core predicates) must use
        create()/create_from_config() — the provable serial fallback the
        BASELINE requires."""
        from .batch import BatchSchedulerConfig
        from .device import BatchEngine
        translated = _translate_policy(policy)
        if translated is None:
            return None
        weights, device_policy = translated
        if device_policy is not None or weights != (1, 1, 1):
            if "engine" in kw:
                raise ValueError(
                    "create_batch: cannot combine an explicit engine with "
                    "a policy that needs engine configuration")
            kw["engine"] = BatchEngine(weights, policy=device_policy,
                                       device=kw.get("device"),
                                       mesh=kw.get("mesh"))
        return BatchSchedulerConfig(self, **kw)

    def create_mixed(self, policy: Optional[Policy], device=None):
        """Mixed-mode config (device probe + HTTP extenders), or None if
        the policy doesn't qualify: it must carry extenders (otherwise
        create_batch is strictly better) and its predicate/priority set
        must map onto the engine without DevicePolicy tiers (the
        incremental encoder's domain). The middle rung of the ladder
        batch > mixed > serial. device: where the engine's probe runs
        (None = the CUDA device, which raises without one)."""
        if policy is None or not policy.extenders:
            return None
        stripped = Policy(predicates=policy.predicates,
                          priorities=policy.priorities, extenders=[])
        translated = _translate_policy(stripped)
        if translated is None:
            return None
        weights, device_policy = translated
        if device_policy is not None:
            return None
        from .device import BatchEngine
        from .device_assist import DeviceAssistedAlgorithm
        engine = BatchEngine(weights, device=device)
        serial = self.create_from_config(policy)
        algorithm = DeviceAssistedAlgorithm(
            self, engine, extenders=serial.algorithm.extenders,
            serial_fallback=serial.algorithm)
        return self._create({}, [], [], algorithm=algorithm,
                            on_assume=algorithm.assume)

    def _requeue_worker(self) -> None:
        """ONE thread drains the time-ordered requeue heap — a
        goroutine-per-pod translation of makeDefaultErrorFunc would
        spawn an OS thread per failed pod and, on a cluster-full 30k-pod
        tile, exhaust the process thread limit (after which the silent
        Thread.start() failures strand pods Pending forever)."""
        import heapq
        while True:
            with self._requeue_cond:
                while not self._requeue_heap:
                    self._requeue_cond.wait()
                due, _seq, pod = self._requeue_heap[0]
                delay = due - time.monotonic()
                if delay > 0:
                    self._requeue_cond.wait(delay)
                    continue
                heapq.heappop(self._requeue_heap)
            self.backoff.gc()
            try:
                fresh = self.client.get("pods", pod.metadata.name,
                                        pod.metadata.namespace)
            except Exception:
                continue
            if not fresh.spec.node_name:
                self.pod_queue.add(fresh)

    def make_default_error_func(self) -> Callable:
        """(ref: factory.go:297 makeDefaultErrorFunc — backoff + requeue)"""
        import heapq

        def error_func(pod: api.Pod, err: Exception) -> None:
            # ref requeues with backoff for ALL errors — including
            # ErrNoNodesAvailable, which it only logs differently; the pod
            # was consumed from the FIFO, so skipping the requeue would
            # strand it Pending forever
            key = meta_namespace_key(pod)
            due = time.monotonic() + self.backoff.get(key)
            with self._requeue_cond:
                if self._requeue_thread is None:
                    self._requeue_thread = threading.Thread(
                        target=self._requeue_worker, daemon=True,
                        name="sched-requeue")
                    self._requeue_thread.start()
                self._requeue_seq += 1
                heapq.heappush(self._requeue_heap,
                               (due, self._requeue_seq, pod))
                self._requeue_cond.notify()
        return error_func
