"""Request authorizers (ref: pkg/auth/authorizer + the ABAC file authorizer
pkg/auth/authorizer/abac: one JSON policy per line, empty/"*" fields match
everything, readonly restricts to GET/list/watch).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional, Sequence

from .authenticate import UserInfo


@dataclass
class AuthorizerAttributes:
    """(ref: authorizer.AttributesRecord)"""
    user: Optional[UserInfo] = None
    read_only: bool = False
    resource: str = ""
    namespace: str = ""


class AlwaysAllowAuthorizer:
    def authorize(self, attributes: AuthorizerAttributes) -> bool:
        return True


class AlwaysDenyAuthorizer:
    def authorize(self, attributes: AuthorizerAttributes) -> bool:
        return False


@dataclass
class ABACPolicy:
    """(ref: pkg/auth/authorizer/abac/types.go Policy)"""
    user: str = ""
    group: str = ""
    resource: str = ""
    namespace: str = ""
    readonly: bool = False

    def matches(self, attributes: AuthorizerAttributes) -> bool:
        info = attributes.user or UserInfo()
        if self.user and self.user != "*" and self.user != info.name:
            return False
        if self.group and self.group != "*" and \
                self.group not in info.groups:
            return False
        if self.readonly and not attributes.read_only:
            return False
        if self.resource and self.resource != "*" and \
                self.resource != attributes.resource:
            return False
        if self.namespace and self.namespace != "*" and \
                self.namespace != attributes.namespace:
            return False
        return True


class ABACAuthorizer:
    def __init__(self, policies: Sequence[ABACPolicy]):
        self.policies = list(policies)

    def authorize(self, attributes: AuthorizerAttributes) -> bool:
        return any(p.matches(attributes) for p in self.policies)


def abac_from_lines(lines: Sequence[str]) -> ABACAuthorizer:
    """One JSON object per non-blank, non-comment line (ref: abac/abac.go
    NewFromFile)."""
    policies: List[ABACPolicy] = []
    for i, line in enumerate(lines):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            data = json.loads(line)
        except json.JSONDecodeError as e:
            raise ValueError(f"policy line {i + 1}: {e}")
        policies.append(ABACPolicy(
            user=data.get("user", ""),
            group=data.get("group", ""),
            resource=data.get("resource", ""),
            namespace=data.get("namespace", ""),
            readonly=bool(data.get("readonly", False))))
    return ABACAuthorizer(policies)


class UnionAuthorizer:
    """Any allow wins."""

    def __init__(self, authorizers: Sequence):
        self.authorizers = list(authorizers)

    def authorize(self, attributes: AuthorizerAttributes) -> bool:
        return any(a.authorize(attributes) for a in self.authorizers)
