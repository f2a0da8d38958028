"""Field selectors.

Reference: pkg/fields. The grammar is a comma-joined list of key=value /
key==value / key!=value terms over a flat map of field names. The scheduler's
load-bearing use is `spec.nodeName=` to watch only unassigned pods
(reference: plugin/pkg/scheduler/factory/factory.go:260-262); nodes use
`spec.unschedulable=false` (factory.go:281-285).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class FieldSelector:
    # tuples of (key, value, negate)
    terms: Tuple[Tuple[str, str, bool], ...] = ()

    def matches(self, fields: Dict[str, str]) -> bool:
        for key, value, negate in self.terms:
            actual = fields.get(key, "")
            if (actual == value) == negate:
                return False
        return True

    def empty(self) -> bool:
        return not self.terms

    def __str__(self) -> str:
        return ",".join(
            f"{k}!={v}" if neg else f"{k}={v}" for k, v, neg in self.terms
        )


def parse(s: Optional[str]) -> FieldSelector:
    s = (s or "").strip()
    if not s:
        return FieldSelector()
    terms = []
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        if "!=" in part:
            k, v = part.split("!=", 1)
            terms.append((k.strip(), v.strip(), True))
        elif "==" in part:
            k, v = part.split("==", 1)
            terms.append((k.strip(), v.strip(), False))
        elif "=" in part:
            k, v = part.split("=", 1)
            terms.append((k.strip(), v.strip(), False))
        else:
            raise ValueError(f"invalid field selector term {part!r}")
    return FieldSelector(tuple(terms))
