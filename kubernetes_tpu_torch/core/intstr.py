"""IntOrString: a value that is either an absolute count or a
"25%"-style percentage string (ref: pkg/util/intstr + pkg/util/util.go
GetIntOrPercentValue/GetValueFromPercent). Deployment rollout bounds
and ingress/service backend ports ride the wire in this shape."""

from __future__ import annotations

import math


def resolve_int_or_percent(v, total: int) -> int:
    """IntOrString -> absolute count against `total` (v1.1 ceils BOTH
    maxSurge and maxUnavailable percentages, pkg/util/util.go:151).
    Invalid strings raise ValueError; callers either surface it as a
    validation error (registry) or retry with backoff (controllers)."""
    if isinstance(v, str):
        return math.ceil(int(v.replace("%", "").strip()) * total / 100)
    return int(v)
