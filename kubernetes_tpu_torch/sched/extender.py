"""Scheduler extender — the reference's HTTP RPC seam, client side.

Reference: plugin/pkg/scheduler/extender.go:38-172 and api/types.go:27-158.
Wire protocol (kept verbatim so our TPU backend can also bolt onto a stock
kube-scheduler, and so stock extenders can bolt onto us):

    POST {urlPrefix}/{apiVersion}/{filterVerb}
        body: ExtenderArgs{"pod": <Pod>, "nodes": <NodeList>}
        resp: ExtenderFilterResult{"nodes": <NodeList>, "error": str}
    POST {urlPrefix}/{apiVersion}/{prioritizeVerb}
        body: ExtenderArgs
        resp: HostPriorityList [{"host": str, "score": int}]

Filter errors fail the pod; prioritize errors are ignored by the caller
(generic_scheduler.go:197-199). Default timeout 5s (extender.go:33).
"""

from __future__ import annotations

import json
import urllib.request
from typing import List, Sequence, Tuple

from ..core import types as api
from ..core.scheme import Scheme, default_scheme
from .api import ExtenderConfig, HostPriority


class ExtenderError(Exception):
    pass


class HTTPExtender:
    """(ref: extender.go:52 HTTPExtender)"""

    def __init__(self, config: ExtenderConfig,
                 scheme: Scheme = default_scheme):
        self.config = config
        self.scheme = scheme

    def _url(self, verb: str) -> str:
        return "/".join(
            [self.config.url_prefix.rstrip("/"), self.config.api_version, verb])

    def _post(self, verb: str, args: dict) -> dict:
        req = urllib.request.Request(
            self._url(verb), data=json.dumps(args).encode(),
            headers={"Content-Type": "application/json",
                     "Accept": "application/json"}, method="POST")
        with urllib.request.urlopen(req,
                                    timeout=self.config.http_timeout) as resp:
            return json.loads(resp.read().decode())

    def _extender_args(self, pod: api.Pod,
                       nodes: Sequence[api.Node]) -> dict:
        return {
            "pod": self.scheme.encode_dict(pod),
            "nodes": self.scheme.encode_list("Node", nodes),
        }

    def filter(self, pod: api.Pod,
               nodes: Sequence[api.Node]) -> List[api.Node]:
        """(ref: extender.go:95 Filter — errors fail the pod)"""
        if not self.config.filter_verb:
            return list(nodes)
        result = self._post(self.config.filter_verb,
                            self._extender_args(pod, nodes))
        if result.get("error"):
            raise ExtenderError(result["error"])
        items = (result.get("nodes") or {}).get("items") or []
        return [self.scheme.decode_dict({**n, "kind": "Node"}) for n in items]

    def prioritize(self, pod: api.Pod, nodes: Sequence[api.Node]
                   ) -> Tuple[List[HostPriority], int]:
        """(ref: extender.go:119 Prioritize)"""
        if not self.config.prioritize_verb:
            return [], 1
        result = self._post(self.config.prioritize_verb,
                            self._extender_args(pod, nodes))
        return ([HostPriority(e["host"], int(e["score"])) for e in result],
                self.config.weight)
