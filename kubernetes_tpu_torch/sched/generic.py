"""The generic scheduler: filter -> score -> select.

Reference: plugin/pkg/scheduler/generic_scheduler.go:65-236.

Deliberate divergence (documented per SURVEY.md section 7 step 4): the
reference breaks score ties with `rand.Int() % len(best)`
(generic_scheduler.go:105); we default to a DETERMINISTIC tie-break — the
first host in the reference's sorted order (score desc, host name desc, per
api/types.go Less + sort.Reverse) — and optionally accept an RNG for
replicating the reference's distribution. "Identical bindings" for the
parity gate means: chosen host is a member of the reference's max-score set.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core import types as api
from .api import HostPriority
from .predicates import map_pods_to_machines
from .priorities import equal_priority


class NoNodesAvailable(Exception):
    """(ref: generic_scheduler.go ErrNoNodesAvailable)"""
    def __str__(self) -> str:
        return "no nodes available to schedule pods"


class FitError(Exception):
    """(ref: generic_scheduler.go FitError)"""

    def __init__(self, pod: api.Pod, failed_predicates: Dict[str, set]):
        self.pod = pod
        self.failed_predicates = failed_predicates
        super().__init__(self._message())

    def _message(self) -> str:
        # ref: FitError.Error "failed to fit in any node"
        reasons = {r for rs in self.failed_predicates.values() for r in rs}
        return ("pod (%s) failed to fit in any node\n" % self.pod.metadata.name
                + "\n".join(f"fit failure on node: {r}" for r in sorted(reasons)))


# Predicate: fn(pod, existing_pods, node) -> (bool, Optional[str])
# Priority:  fn(pod, pod_lister, node_lister) -> List[HostPriority]
PriorityConfig = Tuple[Callable, int]  # (function, weight)


class _StaticNodeLister:
    def __init__(self, nodes: Sequence[api.Node]):
        self._nodes = list(nodes)

    def list(self) -> List[api.Node]:
        return list(self._nodes)


def find_nodes_that_fit(pod: api.Pod, pod_lister,
                        predicates: Dict[str, Callable],
                        nodes: Sequence[api.Node],
                        extenders: Sequence = ()
                        ) -> Tuple[List[api.Node], Dict[str, set]]:
    """(ref: generic_scheduler.go:111 findNodesThatFit) — the serial
    O(nodes x predicates x pods) hot loop the TPU engine replaces."""
    machine_to_pods = map_pods_to_machines(pod_lister)
    filtered: List[api.Node] = []
    failed: Dict[str, set] = {}
    for node in nodes:
        name = node.metadata.name
        fits = True
        for pred_name, predicate in predicates.items():
            fit, reason = predicate(pod, machine_to_pods.get(name, []), node)
            if not fit:
                fits = False
                failed.setdefault(name, set()).add(reason or pred_name)
                break  # ref: short-circuits per node on first failure
        if fits:
            filtered.append(node)
    if filtered and extenders:
        for extender in extenders:
            filtered = extender.filter(pod, filtered)
            if not filtered:
                break
    return filtered, failed


def prioritize_nodes(pod: api.Pod, pod_lister,
                     priority_configs: Sequence[PriorityConfig],
                     node_lister, extenders: Sequence = ()
                     ) -> List[HostPriority]:
    """(ref: generic_scheduler.go:164 PrioritizeNodes)"""
    if not priority_configs and not extenders:
        return equal_priority(pod, pod_lister, node_lister)
    combined: Dict[str, int] = {}
    for func, weight in priority_configs:
        if weight == 0:
            continue
        for entry in func(pod, pod_lister, node_lister):
            combined[entry.host] = combined.get(entry.host, 0) \
                + entry.score * weight
    if extenders and node_lister is not None:
        nodes = node_lister.list()
        for extender in extenders:
            try:
                prioritized, weight = extender.prioritize(pod, nodes)
            except Exception:
                # ref: generic_scheduler.go:197-199 — extender prioritize
                # errors are ignored
                continue
            for entry in prioritized:
                combined[entry.host] = combined.get(entry.host, 0) \
                    + entry.score * weight
    return [HostPriority(host, score) for host, score in combined.items()]


def sort_host_priorities(priority_list: List[HostPriority]) -> List[HostPriority]:
    """Reference order: score descending, then host name DESCENDING
    (sort.Reverse over Less comparing (score, host) ascending,
    api/types.go:164-169 + generic_scheduler.go:98)."""
    return sorted(priority_list, key=lambda h: (h.score, h.host), reverse=True)


def get_best_hosts(priority_list: List[HostPriority]) -> List[str]:
    """All hosts tied at the top score, in sorted order
    (ref: generic_scheduler.go:214 getBestHosts)."""
    ordered = sort_host_priorities(priority_list)
    best = [h.host for h in ordered if h.score == ordered[0].score]
    return best


class GenericScheduler:
    """(ref: generic_scheduler.go:50 genericScheduler struct + Schedule)"""

    def __init__(self, predicates: Dict[str, Callable],
                 prioritizers: Sequence[PriorityConfig],
                 pod_lister, extenders: Sequence = (),
                 rng: Optional[random.Random] = None):
        self.predicates = predicates
        self.prioritizers = list(prioritizers)
        self.pod_lister = pod_lister
        self.extenders = list(extenders)
        # None -> deterministic tie-break (documented divergence)
        self.rng = rng

    def schedule(self, pod: api.Pod, node_lister) -> str:
        return self.select_host(self._prioritized(pod, node_lister))

    def _prioritized(self, pod: api.Pod, node_lister) -> List[HostPriority]:
        """Shared filter->score pipeline for schedule() and tie_set()."""
        nodes = node_lister.list()
        if not nodes:
            raise NoNodesAvailable()
        filtered, failed = find_nodes_that_fit(
            pod, self.pod_lister, self.predicates, nodes, self.extenders)
        priority_list = prioritize_nodes(
            pod, self.pod_lister, self.prioritizers,
            _StaticNodeLister(filtered), self.extenders)
        if not priority_list:
            raise FitError(pod, failed)
        return priority_list

    def select_host(self, priority_list: List[HostPriority]) -> str:
        """(ref: generic_scheduler.go:95 selectHost)"""
        if not priority_list:
            raise ValueError("empty priority list")
        best = get_best_hosts(priority_list)
        if self.rng is not None:
            return best[self.rng.randrange(0, 1 << 62) % len(best)]
        return best[0]

    def tie_set(self, pod: api.Pod, node_lister) -> List[str]:
        """The max-score host set — what binding parity is judged against."""
        return get_best_hosts(self._prioritized(pod, node_lister))
