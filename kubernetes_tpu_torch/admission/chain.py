"""Ordered admission chain (ref: pkg/admission/chain.go)."""

from __future__ import annotations

from typing import List

from .interfaces import Attributes, Interface


class Chain(Interface):
    def __init__(self, plugins: List[Interface]):
        self.plugins = list(plugins)

    def admit(self, attributes: Attributes) -> None:
        for plugin in self.plugins:
            if not plugin.handles(attributes.operation):
                continue
            plugin.admit(attributes)

    def handles(self, operation: str) -> bool:
        return any(p.handles(operation) for p in self.plugins)
