"""Predicate/priority provider registry.

Reference: plugin/pkg/scheduler/factory/plugins.go:55-315 (global maps of
named FitPredicateFactory / PriorityConfigFactory, RegisterCustomFitPredicate
:91, RegisterCustomPriorityFunction :158, provider sets :68-71) and
algorithmprovider/defaults/defaults.go:34-96 (DefaultProvider + 1.0-compat
aliases).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..core.errors import BadRequest
from . import predicates as preds
from . import priorities as prios
from .api import Policy, PredicatePolicy, PriorityPolicy


@dataclass
class PluginFactoryArgs:
    """(ref: plugins.go PluginFactoryArgs)"""
    pod_lister: object = None
    service_lister: object = None
    controller_lister: object = None
    node_lister: object = None


PredicateFactory = Callable[[PluginFactoryArgs], Callable]
PriorityFactory = Callable[[PluginFactoryArgs], Tuple[Callable, int]]

_fit_predicate_factories: Dict[str, PredicateFactory] = {}
_priority_factories: Dict[str, Callable[[PluginFactoryArgs], Callable]] = {}
_default_priority_weights: Dict[str, int] = {}
_algorithm_providers: Dict[str, Tuple[Set[str], Set[str]]] = {}


def register_fit_predicate(name: str, factory: PredicateFactory) -> str:
    _fit_predicate_factories[name] = factory
    return name


def register_priority(name: str, factory, weight: int = 1) -> str:
    _priority_factories[name] = factory
    _default_priority_weights[name] = weight
    return name


def register_algorithm_provider(name: str, predicate_keys: Set[str],
                                priority_keys: Set[str]) -> str:
    _algorithm_providers[name] = (set(predicate_keys), set(priority_keys))
    return name


def get_algorithm_provider(name: str) -> Tuple[Set[str], Set[str]]:
    try:
        return _algorithm_providers[name]
    except KeyError:
        raise BadRequest(f"plugin {name!r} has not been registered")


def get_fit_predicates(names: Set[str],
                       args: PluginFactoryArgs) -> Dict[str, Callable]:
    out = {}
    for name in names:
        if name not in _fit_predicate_factories:
            raise BadRequest(f"invalid predicate name {name!r}")
        out[name] = _fit_predicate_factories[name](args)
    return out


def get_priority_configs(names: Set[str], args: PluginFactoryArgs,
                         weights: Optional[Dict[str, int]] = None
                         ) -> List[Tuple[Callable, int]]:
    out = []
    for name in sorted(names):
        if name not in _priority_factories:
            raise BadRequest(f"invalid priority name {name!r}")
        weight = (weights or {}).get(name, _default_priority_weights.get(name, 1))
        out.append((_priority_factories[name](args), weight))
    return out


# ------------------------------------------------------- custom (policy)

def predicate_from_policy(policy: PredicatePolicy,
                          args: PluginFactoryArgs) -> Callable:
    """(ref: plugins.go:91 RegisterCustomFitPredicate)"""
    if policy.service_affinity is not None:
        node_by_name = getattr(args.node_lister, "get", None)
        return preds.new_service_affinity_predicate(
            args.pod_lister, args.service_lister,
            policy.service_affinity.labels, node_by_name)
    if policy.labels_presence is not None:
        return preds.new_node_label_predicate(
            policy.labels_presence.labels, policy.labels_presence.presence)
    if policy.name in _fit_predicate_factories:
        return _fit_predicate_factories[policy.name](args)
    raise BadRequest(f"invalid predicate policy {policy.name!r}")


def priority_from_policy(policy: PriorityPolicy,
                         args: PluginFactoryArgs) -> Tuple[Callable, int]:
    """(ref: plugins.go:158 RegisterCustomPriorityFunction)"""
    if policy.service_anti_affinity is not None:
        fn = prios.ServiceAntiAffinity(
            args.service_lister,
            policy.service_anti_affinity.label).calculate_anti_affinity_priority
        return fn, policy.weight
    if policy.label_preference is not None:
        fn = prios.new_node_label_priority(
            policy.label_preference.label, policy.label_preference.presence)
        return fn, policy.weight
    if policy.name in _priority_factories:
        return _priority_factories[policy.name](args), policy.weight
    raise BadRequest(f"invalid priority policy {policy.name!r}")


# --------------------------------------------------------- registrations
# (ref: defaults.go:54-96 defaultPredicates/defaultPriorities and the
#  1.0-compatibility aliases :34-52)

register_fit_predicate("PodFitsHostPorts",
                       lambda args: preds.pod_fits_host_ports)
register_fit_predicate("PodFitsPorts",  # 1.0 alias
                       lambda args: preds.pod_fits_host_ports)
register_fit_predicate("PodFitsResources",
                       lambda args: preds.pod_fits_resources)
register_fit_predicate("NoDiskConflict",
                       lambda args: preds.no_disk_conflict)
register_fit_predicate("MatchNodeSelector",
                       lambda args: preds.pod_selector_matches)
register_fit_predicate("HostName", lambda args: preds.pod_fits_host)
register_fit_predicate("NodeSchedulable",
                       lambda args: preds.pod_fits_node_schedulable)


def _inter_pod_affinity_factory(args: PluginFactoryArgs) -> Callable:
    # BASELINE config 4 extension (the quadratic pod x pod term). The
    # node lister MUST resolve arbitrary cached nodes by name — anything
    # less silently disables anti-affinity, so fail loudly at wiring time.
    if not hasattr(args.node_lister, "get"):
        raise BadRequest(
            "InterPodAffinity requires a node lister with get(name)")
    return preds.new_inter_pod_affinity_predicate(
        args.pod_lister, args.node_lister.get)


register_fit_predicate("InterPodAffinity", _inter_pod_affinity_factory)

register_priority(
    "LeastRequestedPriority",
    lambda args: prios.least_requested_priority, 1)
register_priority(
    "BalancedResourceAllocation",
    lambda args: prios.balanced_resource_allocation, 1)
register_priority(
    "SelectorSpreadPriority",
    lambda args: prios.SelectorSpread(
        args.service_lister, args.controller_lister).calculate_spread_priority, 1)
register_priority(
    "ServiceSpreadingPriority",  # 1.0 alias: services only
    lambda args: prios.SelectorSpread(
        args.service_lister, None).calculate_spread_priority, 1)
register_priority("EqualPriority", lambda args: prios.equal_priority, 1)

DEFAULT_PROVIDER = "DefaultProvider"

# Deliberate divergence from defaults.go:54-96: InterPodAffinity joins the
# default predicate set (the reference has no inter-pod affinity at v1.1;
# the batch engine enforces it unconditionally for pods that carry
# spec.affinity, so the serial fallback must too — path-independent
# bindings). Pods without affinity specs are unaffected. NodeSchedulable
# joins too: the reference leans on the filtered node watch alone, but a
# node that dies between the informer's candidate filter and the
# predicate walk (or a static node lister that never filtered) must not
# receive bindings — the device engine enforces the same via its
# sched_ok mask column, so the serial provider must match.
register_algorithm_provider(
    DEFAULT_PROVIDER,
    {"PodFitsHostPorts", "PodFitsResources", "NoDiskConflict",
     "MatchNodeSelector", "HostName", "InterPodAffinity",
     "NodeSchedulable"},
    {"LeastRequestedPriority", "BalancedResourceAllocation",
     "SelectorSpreadPriority"})
