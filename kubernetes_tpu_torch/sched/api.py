"""Scheduler policy API — config-as-API-object.

Reference: plugin/pkg/scheduler/api/{types,v1,validation} — the versioned
Policy kind decoded from a JSON --policy-config-file, listing predicate /
priority names (with per-plugin arguments) and HTTP extenders
(examples/scheduler-policy-config.json,
 examples/scheduler-policy-config-with-extender.json).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..core.errors import Invalid


@dataclass(frozen=True)
class HostPriority:
    """(ref: plugin/pkg/scheduler/api/types.go:150 HostPriority)"""
    host: str
    score: int


@dataclass
class ServiceAffinityArgs:
    labels: List[str] = field(default_factory=list)


@dataclass
class LabelsPresenceArgs:
    labels: List[str] = field(default_factory=list)
    presence: bool = False


@dataclass
class PredicatePolicy:
    name: str = ""
    # argument variants (ref: api/types.go PredicateArgument)
    service_affinity: Optional[ServiceAffinityArgs] = None
    labels_presence: Optional[LabelsPresenceArgs] = None


@dataclass
class ServiceAntiAffinityArgs:
    label: str = ""


@dataclass
class LabelPreferenceArgs:
    label: str = ""
    presence: bool = False


@dataclass
class PriorityPolicy:
    name: str = ""
    weight: int = 1
    service_anti_affinity: Optional[ServiceAntiAffinityArgs] = None
    label_preference: Optional[LabelPreferenceArgs] = None


@dataclass
class ExtenderConfig:
    """(ref: api/types.go:114 ExtenderConfig)"""
    url_prefix: str = ""
    filter_verb: str = ""
    prioritize_verb: str = ""
    weight: int = 1
    api_version: str = "v1"
    http_timeout: float = 5.0  # ref: extender.go:33 DefaultExtenderTimeout
    enable_https: bool = False


@dataclass
class Policy:
    predicates: List[PredicatePolicy] = field(default_factory=list)
    priorities: List[PriorityPolicy] = field(default_factory=list)
    extenders: List[ExtenderConfig] = field(default_factory=list)


def policy_from_json(raw: str) -> Policy:
    """Decode + validate a policy config file
    (ref: api/validation/validation.go:43 — extender weight must be
    positive)."""
    try:
        data = json.loads(raw)
    except json.JSONDecodeError as e:
        raise Invalid(f"invalid policy JSON: {e}")
    pol = Policy()
    for p in data.get("predicates", []):
        pp = PredicatePolicy(name=p.get("name", ""))
        arg = p.get("argument") or {}
        if "serviceAffinity" in arg:
            pp.service_affinity = ServiceAffinityArgs(
                labels=arg["serviceAffinity"].get("labels", []))
        if "labelsPresence" in arg:
            pp.labels_presence = LabelsPresenceArgs(
                labels=arg["labelsPresence"].get("labels", []),
                presence=arg["labelsPresence"].get("presence", False))
        pol.predicates.append(pp)
    for p in data.get("priorities", []):
        pr = PriorityPolicy(name=p.get("name", ""),
                            weight=p.get("weight", 1))
        # ref: validation.go ValidatePolicy — priorities need positive weight
        if pr.weight <= 0:
            raise Invalid(
                f"Priority {pr.name} should have a positive weight applied to it")
        arg = p.get("argument") or {}
        if "serviceAntiAffinity" in arg:
            pr.service_anti_affinity = ServiceAntiAffinityArgs(
                label=arg["serviceAntiAffinity"].get("label", ""))
        if "labelPreference" in arg:
            pr.label_preference = LabelPreferenceArgs(
                label=arg["labelPreference"].get("label", ""),
                presence=arg["labelPreference"].get("presence", False))
        pol.priorities.append(pr)
    for e in data.get("extenders", []):
        weight = e.get("weight", 1)
        # ref: validation.go — extender weight must be non-negative
        if weight < 0:
            raise Invalid(
                f"Priority for extender {e.get('urlPrefix', '')} should have "
                f"a non negative weight applied to it")
        pol.extenders.append(ExtenderConfig(
            url_prefix=e.get("urlPrefix", ""),
            filter_verb=e.get("filterVerb", ""),
            prioritize_verb=e.get("prioritizeVerb", ""),
            weight=weight,
            api_version=e.get("apiVersion", "v1"),
            http_timeout=e.get("httpTimeout", 5.0),
            enable_https=e.get("enableHttps", False)))
        if not pol.extenders[-1].url_prefix:
            raise Invalid("extender urlPrefix is required")
    return pol
