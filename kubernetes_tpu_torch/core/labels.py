"""Label sets and selectors.

Reference: pkg/labels (Set, Selector, Parse). Supports the v1.1 selector
grammar: equality ops (=, ==, !=), set ops (in, notin), existence (key, !key),
comma-joined requirements. `SelectorFromSet` builds the conjunction of
equality requirements used by services/RCs (pkg/labels/selector.go).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

EQUALS = "="
DOUBLE_EQUALS = "=="
NOT_EQUALS = "!="
IN = "in"
NOT_IN = "notin"
EXISTS = "exists"
DOES_NOT_EXIST = "!"


@dataclass(frozen=True)
class Requirement:
    key: str
    op: str
    values: Tuple[str, ...] = ()

    def matches(self, labels: Dict[str, str]) -> bool:
        if self.op in (EQUALS, DOUBLE_EQUALS, IN):
            return self.key in labels and labels[self.key] in self.values
        if self.op in (NOT_EQUALS, NOT_IN):
            # Reference semantics: absent key satisfies != / notin.
            return self.key not in labels or labels[self.key] not in self.values
        if self.op == EXISTS:
            return self.key in labels
        if self.op == DOES_NOT_EXIST:
            return self.key not in labels
        raise ValueError(f"unknown operator {self.op!r}")

    def __str__(self) -> str:
        if self.op == EXISTS:
            return self.key
        if self.op == DOES_NOT_EXIST:
            return f"!{self.key}"
        if self.op in (IN, NOT_IN):
            return f"{self.key} {self.op} ({','.join(sorted(self.values))})"
        return f"{self.key}{self.op}{self.values[0]}"


@dataclass(frozen=True)
class Selector:
    requirements: Tuple[Requirement, ...] = ()

    def matches(self, labels: Optional[Dict[str, str]]) -> bool:
        labels = labels or {}
        return all(r.matches(labels) for r in self.requirements)

    def empty(self) -> bool:
        return not self.requirements

    def __str__(self) -> str:
        return ",".join(str(r) for r in self.requirements)


def everything() -> Selector:
    return Selector()


def selector_from_set(labels: Optional[Dict[str, str]]) -> Selector:
    """Conjunction of equality requirements; empty set selects everything."""
    reqs = tuple(
        Requirement(k, EQUALS, (v,)) for k, v in sorted((labels or {}).items())
    )
    return Selector(reqs)


_TOKEN_RE = re.compile(
    r"\s*(?:"
    r"(?P<op>==|=|!=)|"
    r"(?P<comma>,)|"
    r"(?P<lparen>\()|(?P<rparen>\))|"
    r"(?P<bang>!)|"
    r"(?P<word>[A-Za-z0-9_./-]+)"
    r")\s*"
)


def parse(s: str) -> Selector:
    """Parse the selector grammar, e.g. "a=b,env in (prod,dev),!beta"."""
    s = s.strip()
    if not s:
        return Selector()
    tokens: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m or m.end() == pos:
            raise ValueError(f"invalid selector {s!r} at {pos}")
        pos = m.end()
        for name, val in m.groupdict().items():
            if val is not None:
                tokens.append((name, val))
    reqs: List[Requirement] = []
    i = 0

    def peek(k: int = 0):
        return tokens[i + k] if i + k < len(tokens) else (None, None)

    while i < len(tokens):
        kind, val = tokens[i]
        if kind == "comma":
            i += 1
            continue
        if kind == "bang":
            nk, nv = peek(1)
            if nk != "word":
                raise ValueError(f"expected key after ! in {s!r}")
            reqs.append(Requirement(nv, DOES_NOT_EXIST))
            i += 2
            continue
        if kind != "word":
            raise ValueError(f"unexpected token {val!r} in {s!r}")
        key = val
        nk, nv = peek(1)
        if nk == "op":
            vk, vv = peek(2)
            if vk != "word":
                raise ValueError(f"expected value after {nv} in {s!r}")
            op = EQUALS if nv in ("=", "==") else NOT_EQUALS
            reqs.append(Requirement(key, op, (vv,)))
            i += 3
        elif nk == "word" and nv in (IN, NOT_IN):
            # key in (a,b,c)
            if peek(2)[0] != "lparen":
                raise ValueError(f"expected ( after {nv} in {s!r}")
            j = i + 3
            vals: List[str] = []
            while j < len(tokens) and tokens[j][0] != "rparen":
                if tokens[j][0] == "word":
                    vals.append(tokens[j][1])
                elif tokens[j][0] != "comma":
                    raise ValueError(f"unexpected token in value list of {s!r}")
                j += 1
            if j >= len(tokens):
                raise ValueError(f"unclosed ( in {s!r}")
            reqs.append(Requirement(key, nv, tuple(vals)))
            i = j + 1
        else:
            reqs.append(Requirement(key, EXISTS))
            i += 1
    return Selector(tuple(reqs))
