"""Scheme and codec: kind <-> type registry, JSON encode/decode.

Reference: pkg/runtime/scheme.go:241 (NewScheme), pkg/runtime/codec.go:27.
The reference maintains internal + versioned types with generated conversions;
we serve a single version ("v1") and convert reflectively (core.serde), so the
scheme is a kind registry plus encode/decode that injects/strips
kind/apiVersion, exactly the contract consumers of runtime.Codec rely on.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Type

from . import types as api
from .errors import BadRequest
from .serde import from_wire, to_wire, watch_decoder, wire_json

API_VERSION = "v1"


class Scheme:
    def __init__(self) -> None:
        self._kind_to_type: Dict[str, type] = {}
        self._type_to_kind: Dict[type, str] = {}

    def register(self, kind: str, cls: type) -> None:
        self._kind_to_type[kind] = cls
        self._type_to_kind[cls] = kind

    def kind_for(self, obj: Any) -> str:
        try:
            return self._type_to_kind[type(obj)]
        except KeyError:
            raise BadRequest(f"unregistered type {type(obj).__name__}")

    def type_for(self, kind: str) -> type:
        try:
            return self._kind_to_type[kind]
        except KeyError:
            raise BadRequest(f"no kind {kind!r} is registered")

    # -- codec ------------------------------------------------------------

    def encode_dict(self, obj: Any) -> Dict[str, Any]:
        wire = to_wire(obj)
        wire["kind"] = self.kind_for(obj)
        wire["apiVersion"] = API_VERSION
        return wire

    def encode(self, obj: Any) -> str:
        return json.dumps(self.encode_dict(obj))

    def decode_dict(self, data: Dict[str, Any], expect: Optional[type] = None) -> Any:
        kind = data.get("kind", "")
        if not kind:
            if expect is None:
                raise BadRequest("object has no kind")
            cls = expect
        else:
            cls = self.type_for(kind)
        if expect is not None and cls is not expect:
            raise BadRequest(
                f"expected {self._type_to_kind.get(expect, expect.__name__)}, got {kind}"
            )
        return from_wire(cls, data)

    def decode_watched(self, data: Dict[str, Any]) -> Any:
        """decode_dict for a watch stream's object (serde.watch_decoder:
        the same decode, each type's plan worked out once)."""
        kind = data.get("kind", "")
        if not kind:
            raise BadRequest("object has no kind")
        return watch_decoder(self.type_for(kind))(data)

    def decode(self, raw: str, expect: Optional[type] = None) -> Any:
        try:
            data = json.loads(raw)
        except json.JSONDecodeError as e:
            raise BadRequest(f"invalid JSON: {e}")
        return self.decode_dict(data, expect)

    def encode_list(self, kind: str, items, resource_version: str = "") -> Dict[str, Any]:
        return {
            "kind": kind + "List",
            "apiVersion": API_VERSION,
            "metadata": {"resourceVersion": resource_version},
            "items": [to_wire(i) for i in items],
        }

    def encode_list_bytes(self, kind: str, items,
                          resource_version: str = "") -> bytes:
        """encode_list, bytes-for-the-wire, assembled from per-object
        cached JSON fragments (serde.wire_json): a repeat LIST of an
        unchanged 5k-node fleet reuses 5k cached strings instead of
        5k reflective walks. Byte-identical to
        json.dumps(encode_list(...)) (tests pin it)."""
        head = json.dumps({
            "kind": kind + "List",
            "apiVersion": API_VERSION,
            "metadata": {"resourceVersion": resource_version}})
        return (head[:-1] + ', "items": ['
                + ", ".join(wire_json(i) for i in items)
                + "]}").encode()

    def deep_copy(self, obj: Any) -> Any:
        """Round-trip copy (the reference uses generated deep-copy; a codec
        round-trip gives identical semantics for registered types)."""
        return from_wire(type(obj), to_wire(obj))


def new_scheme() -> Scheme:
    s = Scheme()
    s.register("Pod", api.Pod)
    s.register("Node", api.Node)
    s.register("Service", api.Service)
    s.register("Endpoints", api.Endpoints)
    s.register("ReplicationController", api.ReplicationController)
    s.register("Binding", api.Binding)
    s.register("Lease", api.Lease)
    s.register("Event", api.Event)
    s.register("Namespace", api.Namespace)
    s.register("Secret", api.Secret)
    s.register("LimitRange", api.LimitRange)
    s.register("ResourceQuota", api.ResourceQuota)
    s.register("ServiceAccount", api.ServiceAccount)
    s.register("PersistentVolume", api.PersistentVolume)
    s.register("PersistentVolumeClaim", api.PersistentVolumeClaim)
    s.register("PodTemplate", api.PodTemplate)
    s.register("ComponentStatus", api.ComponentStatus)
    # extensions/v1beta1 group (master.go:1049-1091)
    s.register("Scale", api.Scale)
    s.register("DeleteOptions", api.DeleteOptions)
    s.register("Job", api.Job)
    s.register("Deployment", api.Deployment)
    s.register("DaemonSet", api.DaemonSet)
    s.register("HorizontalPodAutoscaler", api.HorizontalPodAutoscaler)
    s.register("Ingress", api.Ingress)
    s.register("ThirdPartyResource", api.ThirdPartyResource)
    # the storage form of custom objects (dynamic kinds encode through
    # encode_third_party on the wire, but stores serialize the carrier)
    s.register("ThirdPartyResourceData", api.ThirdPartyResourceData)
    return s


#: process-wide default scheme, like the reference's api.Scheme singleton
default_scheme = new_scheme()
