"""Swagger API discovery + the minimal UI page.

Reference: pkg/apiserver InstallSwaggerAPI (go-restful swagger at
/swaggerapi) and pkg/ui (the bundled dashboard at /ui; its 17k LoC of
go-bindata'd JS is replaced by one reflective page — the reference's
generated datafile.go is exactly the kind of artifact this design
obviates). Models are derived from the dataclass schema the same way
the serde is, so the docs can never drift from the wire format.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, get_args, get_origin

from ..core.quantity import Quantity
from ..core.serde import _camel
from .registry import RESOURCES


def _type_name(tp: Any) -> str:
    tp_origin = get_origin(tp)
    if tp_origin is typing.Union:
        args = [a for a in get_args(tp) if a is not type(None)]
        return _type_name(args[0]) if args else "any"
    if tp_origin in (list, tuple):
        (elem,) = get_args(tp) or (Any,)
        return f"array[{_type_name(elem)}]"
    if tp_origin is dict:
        args = get_args(tp)
        vtp = args[1] if len(args) == 2 else Any
        return f"map[string,{_type_name(vtp)}]"
    if tp is Quantity:
        return "string"
    if dataclasses.is_dataclass(tp):
        return tp.__name__
    return getattr(tp, "__name__", "any")


def _collect_models(cls: type, models: Dict[str, dict]) -> None:
    if not dataclasses.is_dataclass(cls) or cls.__name__ in models:
        return
    props: Dict[str, dict] = {}
    models[cls.__name__] = {"id": cls.__name__, "properties": props}
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        tp = hints[f.name]
        props[_camel(f.name)] = {"type": _type_name(tp)}
        # recurse into nested dataclasses (incl. through containers)
        stack = [tp]
        while stack:
            t = stack.pop()
            origin = get_origin(t)
            if origin is not None:
                stack.extend(get_args(t))
            elif dataclasses.is_dataclass(t):
                _collect_models(t, models)


def swagger_api(base_url: str = "") -> dict:
    """The /swaggerapi document: one api entry per REST resource plus
    the reflected model schemas."""
    apis = []
    models: Dict[str, dict] = {}
    for name, info in sorted(RESOURCES.items()):
        prefix = ("/apis/extensions/v1beta1" if _is_extensions(name)
                  else "/api/v1")
        path = (f"{prefix}/namespaces/{{namespace}}/{name}"
                if info.namespaced else f"{prefix}/{name}")
        apis.append({
            "path": path,
            "description": f"API for {info.kind} ({name})",
            "operations": [
                {"method": m, "type": info.kind}
                for m in ("GET", "POST", "PUT", "DELETE")],
        })
        _collect_models(info.cls, models)
    return {
        "swaggerVersion": "1.2",
        "basePath": base_url,
        "apiVersion": "v1",
        "apis": apis,
        "models": models,
    }


def _is_extensions(resource: str) -> bool:
    from .registry import EXTENSIONS_RESOURCES
    return resource in EXTENSIONS_RESOURCES


def _esc(s: Any) -> str:
    return (str(s).replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))


def _node_ready(node) -> str:
    for c in node.status.conditions:
        if c.type == "Ready":
            return "Ready" if c.status == "True" else "NotReady"
    return "Unknown"


def ui_page(registry=None, namespace: str = "", limit: int = 500) -> str:
    """The /ui dashboard (pkg/ui's role): a live server-rendered view of
    nodes, pods (phase/host), and recent events straight from the watch
    cache (the in-process store IS the cache), refreshing every 5s —
    the reference's 17k-LoC go-bindata'd JS dashboard replaced by one
    reflective page over the same data."""
    index_rows = "\n".join(
        f'<tr><td><a href="{_href(name, info)}">{name}</a></td>'
        f"<td>{info.kind}</td>"
        f"<td>{'namespaced' if info.namespaced else 'cluster'}</td></tr>"
        for name, info in sorted(RESOURCES.items()))
    cluster = ""
    if registry is not None:
        nodes, _ = registry.list("nodes", "")
        pods, _ = registry.list("pods", namespace)
        events, _ = registry.list("events", namespace)
        phases: Dict[str, int] = {}
        for p in pods:
            phases[p.status.phase or "Unknown"] = \
                phases.get(p.status.phase or "Unknown", 0) + 1
        ready = sum(1 for n in nodes if _node_ready(n) == "Ready")
        phase_sum = ", ".join(f"{_esc(k)}: {v}"
                              for k, v in sorted(phases.items()))
        pods_by_node: Dict[str, int] = {}
        for p in pods:
            if p.spec.node_name:
                pods_by_node[p.spec.node_name] = \
                    pods_by_node.get(p.spec.node_name, 0) + 1
        node_rows = "\n".join(
            f"<tr><td>{_esc(n.metadata.name)}</td>"
            f"<td>{_node_ready(n)}</td>"
            f"<td>{_esc(n.status.capacity.get('cpu', ''))}</td>"
            f"<td>{_esc(n.status.capacity.get('memory', ''))}</td>"
            f"<td>{pods_by_node.get(n.metadata.name, 0)}</td></tr>"
            for n in nodes[:limit])
        pod_rows = "\n".join(
            f"<tr><td>{_esc(p.metadata.namespace)}</td>"
            f"<td>{_esc(p.metadata.name)}</td>"
            f"<td>{_esc(p.status.phase)}</td>"
            f"<td>{_esc(p.spec.node_name) if p.spec.node_name else '&mdash;'}"
            f"</td></tr>"
            for p in pods[:limit])
        recent = sorted(events, key=lambda e: e.last_timestamp or "",
                        reverse=True)[:30]
        event_rows = "\n".join(
            f"<tr><td>{_esc(e.type)}</td><td>{_esc(e.reason)}</td>"
            f"<td>{_esc(e.involved_object.kind)}/"
            f"{_esc(e.involved_object.name)}</td>"
            f"<td>{_esc(e.message)}</td><td>{e.count}</td></tr>"
            for e in recent)
        trunc_pods = (f"<p>showing {limit} of {len(pods)} pods</p>"
                      if len(pods) > limit else "")
        trunc_nodes = (f"<p>showing {limit} of {len(nodes)} nodes</p>"
                       if len(nodes) > limit else "")
        cluster = f"""
<h2>Cluster</h2>
<p>nodes: {ready}/{len(nodes)} ready &middot; pods: {len(pods)}
 ({phase_sum or "none"})</p>
<h2>Nodes</h2>
<table><tr><th>name</th><th>status</th><th>cpu</th><th>memory</th>
<th>pods</th></tr>
{node_rows}
</table>{trunc_nodes}
<h2>Pods</h2>
<table><tr><th>namespace</th><th>name</th><th>phase</th><th>node</th></tr>
{pod_rows}
</table>{trunc_pods}
<h2>Recent events</h2>
<table><tr><th>type</th><th>reason</th><th>object</th><th>message</th>
<th>count</th></tr>
{event_rows}
</table>"""
    return f"""<!DOCTYPE html>
<html><head><title>kubernetes_tpu</title>
<meta http-equiv="refresh" content="5">
<style>
 body {{ font-family: sans-serif; margin: 2em; }}
 table {{ border-collapse: collapse; }}
 td, th {{ border: 1px solid #ccc; padding: 4px 12px; }}
 h2 {{ margin-top: 1.2em; }}
</style></head>
<body>
<h1>kubernetes_tpu</h1>
<p>(<a href="/swaggerapi">swagger</a>,
<a href="/metrics">metrics</a>, <a href="/healthz">healthz</a>)</p>
{cluster}
<h2>API resources</h2>
<table><tr><th>resource</th><th>kind</th><th>scope</th></tr>
{index_rows}
</table></body></html>"""


def _href(name: str, info) -> str:
    prefix = ("/apis/extensions/v1beta1" if _is_extensions(name)
              else "/api/v1")
    return f"{prefix}/{name}"
