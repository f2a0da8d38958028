"""Generic dataclass <-> JSON-dict serde.

The reference generates conversion/deep-copy code per type
(pkg/api/deep_copy_generated.go, pkg/api/v1/conversion_generated.go); here a
single reflective codec handles all API types: snake_case python fields map to
camelCase wire keys, nested dataclasses / lists / dicts / Quantity recurse,
and unset (None / empty) fields are omitted on the wire like Go's
`json:",omitempty"` tags.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, Optional, Type, TypeVar, get_args, get_origin, get_type_hints

from .quantity import Quantity, parse_quantity

T = TypeVar("T")

_hints_cache: Dict[type, Dict[str, Any]] = {}

# Deprecated wire-key aliases, per dataclass: alias wire key -> python
# field name. The one the reference carries in v1 is
# `serviceAccount` <-> `serviceAccountName` (pkg/api/v1/types.go
# PodSpec.DeprecatedServiceAccount). On decode the alias fills the
# field only when the canonical key is absent or empty
# (pkg/api/v1/defaults.go copies DeprecatedServiceAccount into
# ServiceAccountName when the latter is unset); on encode the alias is
# emitted alongside the canonical key whenever the value is non-empty
# (conversion.go convert_api_PodSpec_To_v1_PodSpec mirrors the value
# into both). Populated by core.types at import.
WIRE_ALIASES: Dict[type, Dict[str, str]] = {}


def _camel(name: str) -> str:
    parts = name.split("_")
    out = parts[0] + "".join(p[:1].upper() + p[1:] for p in parts[1:])
    # Wire names like hostIP / podIP / clusterIP / externalID / podCIDR.
    for suf, rep in (("Ip", "IP"), ("Ips", "IPs"), ("Id", "ID"),
                     ("Cidr", "CIDR"), ("Uid", "UID"),
                     ("Url", "URL"), ("Tcp", "TCP"), ("Udp", "UDP"),
                     ("Pid", "PID"), ("Ipc", "IPC")):
        if out.endswith(suf):
            out = out[: -len(suf)] + rep
    return out


def _hints(cls: type) -> Dict[str, Any]:
    h = _hints_cache.get(cls)
    if h is None:
        h = get_type_hints(cls)
        _hints_cache[cls] = h
    return h


def _unwrap_optional(tp: Any) -> Any:
    if get_origin(tp) is typing.Union:
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def to_wire(obj: Any) -> Any:
    """Dataclass instance -> plain JSON-able structure, omitting empties."""
    if obj is None:
        return None
    if isinstance(obj, Quantity):
        return str(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out: Dict[str, Any] = {}
        hints = _hints(type(obj))
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is None:
                continue
            # Optional[...] fields use None for absence, so a non-None
            # value is PRESENT even when all-default: `emptyDir: {}` on a
            # volume selects the volume type by existing. Dropping it
            # would decode back as None — lossy, unlike the cases below.
            optional = (get_origin(hints.get(f.name)) is typing.Union
                        and type(None) in get_args(hints[f.name]))
            if optional:
                out[_camel(f.name)] = to_wire(v)
                continue
            # omitempty relative to the declared default: a field at its
            # default decodes back identically, so dropping it is lossless
            # (and `replicas=0` still serializes, since its default is 1).
            if f.default is not dataclasses.MISSING and v == f.default:
                continue
            w = to_wire(v)
            if w is None or w == {} or w == []:
                continue
            out[_camel(f.name)] = w
        aliases = WIRE_ALIASES.get(type(obj))
        if aliases:
            for alias, fname in aliases.items():
                v = getattr(obj, fname)
                if v:
                    out[alias] = to_wire(v)
        return out
    if isinstance(obj, dict):
        return {k: to_wire(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_wire(v) for v in obj]
    if isinstance(obj, bool) or isinstance(obj, (int, float, str)):
        return obj
    raise TypeError(f"cannot serialize {type(obj)!r}")


def from_wire(cls: Type[T], data: Any) -> T:
    """Plain JSON structure -> typed dataclass instance (lenient: unknown
    wire keys are ignored, missing keys take dataclass defaults)."""
    return _from_wire(cls, data)


def _from_wire(tp: Any, data: Any) -> Any:
    tp = _unwrap_optional(tp)
    if data is None:
        return None
    if tp is Quantity:
        return parse_quantity(data)
    if tp is Any:
        return data
    origin = get_origin(tp)
    if origin in (list, tuple):
        (elem,) = get_args(tp) or (Any,)
        vals = [_from_wire(elem, v) for v in data]
        return tuple(vals) if origin is tuple else vals
    if origin is dict:
        args = get_args(tp)
        vtp = args[1] if len(args) == 2 else Any
        return {k: _from_wire(vtp, v) for k, v in data.items()}
    if dataclasses.is_dataclass(tp):
        hints = _hints(tp)
        kwargs: Dict[str, Any] = {}
        wire_map = {_camel(f.name): f.name for f in dataclasses.fields(tp)}
        for wk, wv in (data or {}).items():
            fname = wire_map.get(wk)
            if fname is None:
                continue
            kwargs[fname] = _from_wire(hints[fname], wv)
        aliases = WIRE_ALIASES.get(tp)
        if aliases and isinstance(data, dict):
            for alias, fname in aliases.items():
                if alias in data and not kwargs.get(fname):
                    kwargs[fname] = _from_wire(hints[fname], data[alias])
        return tp(**kwargs)
    if tp is float and isinstance(data, int):
        return float(data)
    if tp is int and isinstance(data, float) and data == int(data):
        return int(data)
    return data


def wire_json(obj: Any) -> str:
    """JSON fragment for one API object, cached on the object keyed by
    its resourceVersion — the serialization row of the watch cache's
    job (pkg/storage/cacher.go keeps decoded objects; one hot LIST of
    5k nodes was ~1.9s of reflective re-walk per request without this,
    over the 1s API SLO all by itself).

    Safe because stored objects are frozen by the store contract and a
    non-empty resourceVersion changes on every store write. The two
    clone paths cannot serve stale fragments: dataclasses.replace
    reruns __init__ (no private attrs survive) and types.fast_replace
    strips the cache attribute explicitly (a modified clone shares its
    metadata/rv until the store restamps it, so the rv alone would not
    invalidate)."""
    import json as _json
    meta = getattr(obj, "metadata", None)
    rv = getattr(meta, "resource_version", "") if meta is not None else ""
    if rv:
        c = obj.__dict__.get("_wire_json")
        if c is not None and c[0] == rv:
            return c[1]
    s = _json.dumps(to_wire(obj))
    if rv:
        obj.__dict__["_wire_json"] = (rv, s)
    return s
