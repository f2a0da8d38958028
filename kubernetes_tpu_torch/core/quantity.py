"""Resource quantities.

The reference models resource amounts as `resource.Quantity` strings
("100m" CPU, "32Gi" memory) and the scheduler immediately reduces them to
integer milli-CPU and bytes (reference: plugin/pkg/scheduler/algorithm/
predicates/predicates.go:140-146 getResourceRequest, pkg/api/resource).
We normalise at parse time: a Quantity is an exact integer in a canonical
unit (milliunits for CPU-like values, plain units for everything else),
remembering the original string for round-tripping.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from fractions import Fraction

_BIN_SUFFIX = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}
_QTY_RE = re.compile(r"^([+-]?[0-9]+(?:\.[0-9]+)?)(Ki|Mi|Gi|Ti|Pi|Ei|[numkMGTPE]?)$")


@dataclass(frozen=True, eq=False)
class Quantity:
    """An exact resource amount.

    `milli` is the value in thousandths (so "100m" -> 100, "2" -> 2000);
    `value` rounds up to whole units the way the reference's Quantity.Value()
    does (ceil), which predicates use for memory/pod counts.

    Equality/hash are by `milli` only — `text` is presentational, so
    "1000m" == "1" and arithmetic-derived quantities compare equal to
    parsed ones (controllers rely on old == new to suppress writes).
    """

    milli: int
    text: str = ""

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Quantity):
            return self.milli == other.milli
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.milli)

    @property
    def value(self) -> int:
        # ceil division, matching resource.Quantity.Value() rounding up.
        return -((-self.milli) // 1000)

    def __str__(self) -> str:
        return self.text or format_quantity(self)

    def __add__(self, other: "Quantity") -> "Quantity":
        return Quantity(self.milli + other.milli)

    def __bool__(self) -> bool:
        return self.milli != 0


def parse_quantity(s) -> Quantity:
    if isinstance(s, Quantity):
        return s
    if isinstance(s, (int, float)):
        return Quantity(int(round(float(s) * 1000)), str(s))
    s = s.strip()
    m = _QTY_RE.match(s)
    if not m:
        raise ValueError(f"invalid quantity {s!r}")
    num, suffix = m.groups()
    # Exact integer arithmetic via Fraction (floats corrupt values >= 2^53,
    # e.g. large byte counts with Ei suffixes).
    if suffix in _BIN_SUFFIX:
        factor = Fraction(_BIN_SUFFIX[suffix])
    else:
        factor = Fraction(10) ** {"n": -9, "u": -6, "m": -3, "": 0, "k": 3,
                                  "M": 6, "G": 9, "T": 12, "P": 15, "E": 18}[suffix]
    milli = int(Fraction(num) * factor * 1000)
    return Quantity(milli, s)


def format_quantity(q: Quantity) -> str:
    if q.milli % 1000 == 0:
        return str(q.milli // 1000)
    return f"{q.milli}m"
