"""Clients: one interface; the port carries the in-process transport.

Reference: pkg/client/unversioned (fluent REST client, request.go). Agents,
controllers and the scheduler are written against `Client`; the kubemark-style
in-process harness wires them straight to the Registry (zero serialization),
while real deployments go over HTTP with identical semantics — mirroring how
the reference's integration tests wire components directly to an in-process
master (test/integration/framework/master_utils.go:92).

The port's copy holds `Client`, `InProcClient` and
`confirm_pod_deletion`. The HTTP transport (`HttpClient`) and the
kubelet relay paths of InProcClient (logs, exec, attach, port-forward)
are not ported yet (ROADMAP.md Queue 1, 'Harness and entry points');
their verbs raise NotImplementedError through `Client`.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, List, Optional, Tuple

from ..core import types as api
from ..core.watch import Watcher
from .registry import Registry

logger = logging.getLogger("kubernetes_tpu_torch.client")


class Client:
    """Verb interface over resources. Implementation in the port:
    InProcClient."""

    def create(self, resource: str, obj: Any, namespace: str = "") -> Any:
        raise NotImplementedError

    def create_batch(self, resource: str, objs: List[Any],
                     namespace: str = "") -> List[Any]:
        """Create many objects of one resource in a single apiserver
        round-trip / store window (the write-side analogue of
        bind_batch). Default: sequential creates."""
        return [self.create(resource, o, namespace) for o in objs]

    def create_from_template(self, resource: str, template: Any,
                             names: List[str], namespace: str = ""
                             ) -> List[Any]:
        """Columnar bulk create: one template object, many names
        (registry.create_from_template). Default: expand client-side
        into a create_batch — any Client gets the semantics, the
        in-proc registry gets the fast path."""
        from ..core.types import expand_template_rows
        return self.create_batch(resource,
                                 expand_template_rows(template, names),
                                 namespace)

    def get(self, resource: str, name: str, namespace: str = "") -> Any:
        raise NotImplementedError

    def list(self, resource: str, namespace: str = "",
             label_selector: str = "", field_selector: str = ""
             ) -> Tuple[List[Any], int]:
        raise NotImplementedError

    def update(self, resource: str, obj: Any, namespace: str = "") -> Any:
        raise NotImplementedError

    def update_status(self, resource: str, obj: Any, namespace: str = "") -> Any:
        raise NotImplementedError

    def patch(self, resource: str, name: str, patch_body: Any,
              namespace: str = "",
              patch_type: str = "application/strategic-merge-patch+json"
              ) -> Any:
        """Server-side PATCH with the reference's three content types
        (ref: client/unversioned request.go Patch)."""
        raise NotImplementedError

    def get_scale(self, resource: str, name: str,
                  namespace: str = "") -> Any:
        """GET .../{name}/scale (ref: client/unversioned Scales getter)."""
        raise NotImplementedError

    def update_scale(self, resource: str, name: str, scale: Any,
                     namespace: str = "") -> Any:
        raise NotImplementedError

    def update_status_batch(self, resource: str, objs: List[Any],
                            namespace: str = "") -> List[Any]:
        # Default: sequential (the reference wire protocol has no status
        # batching; the in-proc client overrides with one store pass).
        return [self.update_status(resource, o, namespace) for o in objs]

    def delete(self, resource: str, name: str, namespace: str = "",
               grace_period_seconds: Optional[int] = None,
               uid: Optional[str] = None) -> Any:
        raise NotImplementedError

    def watch(self, resource: str, namespace: str = "",
              since_rev: Optional[int] = None, label_selector: str = "",
              field_selector: str = "") -> Watcher:
        raise NotImplementedError

    def bind(self, binding: api.Binding, namespace: str = "") -> Any:
        raise NotImplementedError

    def bind_batch(self, bindings: List[api.Binding],
                   namespace: str = "") -> List[Any]:
        # Default: sequential binds (HTTP transport can't batch in the
        # reference wire protocol; the in-proc client overrides this).
        return [self.bind(b, namespace) for b in bindings]

    def bind_batch_hosts(self, assignments: List[Tuple[str, str, str]]
                         ) -> List[Any]:
        """Columnar bind: (namespace, name, host) rows. Default:
        expand into Binding objects; the in-proc client hands the rows
        straight to the registry."""
        return self.bind_batch([api.Binding(
            metadata=api.ObjectMeta(namespace=ns, name=name),
            target=api.ObjectReference(kind="Node", name=host))
            for ns, name, host in assignments])

    def finalize_namespace(self, obj: api.Namespace) -> Any:
        raise NotImplementedError

    def pod_logs(self, name: str, namespace: str = "default",
                 container: str = "", tail_lines: int = 0,
                 previous: bool = False) -> str:
        """Container logs via the pod `log` subresource (the apiserver
        relays to the node's kubelet server)."""
        raise NotImplementedError

    def node_proxy(self, node_name: str, path: str) -> bytes:
        """GET a kubelet-server path through the node proxy."""
        raise NotImplementedError

    def pod_logs_stream(self, name: str, namespace: str = "default",
                        container: str = ""):
        """Follow a container's log (kubectl logs -f): yields text
        pieces until the container exits or the caller stops."""
        raise NotImplementedError


class InProcClient(Client):
    def __init__(self, registry: Registry):
        self.registry = registry

    def create(self, resource, obj, namespace=""):
        return self.registry.create(resource, obj, namespace)

    def create_batch(self, resource, objs, namespace=""):
        return self.registry.create_batch(resource, objs, namespace)

    def create_from_template(self, resource, template, names, namespace=""):
        return self.registry.create_from_template(resource, template,
                                                  names, namespace)

    def get(self, resource, name, namespace=""):
        return self.registry.get(resource, name, namespace)

    def list(self, resource, namespace="", label_selector="", field_selector=""):
        return self.registry.list(resource, namespace, label_selector,
                                  field_selector)

    def update(self, resource, obj, namespace=""):
        return self.registry.update(resource, obj, namespace)

    def update_status(self, resource, obj, namespace=""):
        return self.registry.update_status(resource, obj, namespace)

    def update_status_batch(self, resource, objs, namespace=""):
        return self.registry.update_status_batch(resource, objs, namespace)

    def patch(self, resource, name, patch_body, namespace="",
              patch_type="application/strategic-merge-patch+json"):
        return self.registry.patch(resource, name, patch_body, namespace,
                                   patch_type=patch_type)

    def get_scale(self, resource, name, namespace=""):
        return self.registry.get_scale(resource, name, namespace)

    def update_scale(self, resource, name, scale, namespace=""):
        return self.registry.update_scale(resource, name, scale, namespace)

    def delete(self, resource, name, namespace="",
               grace_period_seconds=None, uid=None):
        return self.registry.delete(
            resource, name, namespace,
            grace_period_seconds=grace_period_seconds, uid=uid)

    def watch(self, resource, namespace="", since_rev=None,
              label_selector="", field_selector=""):
        return self.registry.watch(resource, namespace, since_rev,
                                   label_selector, field_selector)

    def bind(self, binding, namespace=""):
        return self.registry.bind(binding, namespace)

    def bind_batch(self, bindings, namespace=""):
        return self.registry.bind_batch(bindings, namespace)

    def bind_batch_hosts(self, assignments):
        return self.registry.bind_batch_hosts(assignments)

    def finalize_namespace(self, obj):
        return self.registry.finalize_namespace(obj)


def confirm_pod_deletion(client: Client, pod: Any, attempts: int = 8,
                         backoff_s: float = 0.5,
                         clock=None, rng=None) -> None:
    """The grace-0, uid-guarded delete that completes a graceful pod
    deletion from the node side (real kubelet, hollow kubelet, fleet).
    NotFound/Conflict are terminal — the pod is gone, or a same-name
    replacement took the name; transient API errors retry off-thread
    with jittered backoff, because a marked pod emits no further watch
    events and a dropped confirm would leave it Terminating forever.
    Exhaustion is loud: the pod will sit Terminating until something
    else (a fleet/kubelet restart's re-list) re-drives it, so the
    operator must hear about it.

    clock (utils/clock.Clock) and rng (random.Random) are injectable
    for deterministic harnesses; the defaults are the real clock and
    the process RNG."""
    import random as _random

    from ..core.errors import Conflict, NotFound
    from ..utils.clock import REAL

    clock = clock or REAL
    rng = rng or _random

    def attempt() -> bool:
        try:
            client.delete("pods", pod.metadata.name,
                          pod.metadata.namespace,
                          grace_period_seconds=0, uid=pod.metadata.uid)
        except (NotFound, Conflict):
            pass  # outcome reached (gone or replaced)
        except Exception:
            return False
        return True

    if attempt():
        return

    def retry_loop():
        delay = backoff_s
        for _ in range(attempts - 1):
            # jittered: a fleet confirming thousands of pods against a
            # restarting apiserver must not replay them in one wave
            clock.sleep(delay * (0.5 + rng.random()))
            if attempt():
                return
            delay = min(delay * 2, 5.0)
        logger.warning(
            "confirm_pod_deletion: giving up on %s/%s after %d "
            "attempts; pod stays Terminating until a re-list re-drives "
            "the confirm", pod.metadata.namespace, pod.metadata.name,
            attempts)

    threading.Thread(target=retry_loop, daemon=True,
                     name=f"confirm-del-{pod.metadata.name}").start()
