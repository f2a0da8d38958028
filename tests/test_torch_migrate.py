"""The port's storage migration (kubernetes_tpu_torch/core/migrate.py)
against the JAX package's.

tests/test_migrate.py's five cases run on the port as they stand: the
source is compiled here with every `kubernetes_tpu.` import pointed at
`kubernetes_tpu_torch.` (the port builds its native store or raises, so
the file's `native_available` probe is always true here). Then both
packages migrate the same registry contents and report alike."""

import os
import re

from kubernetes_tpu.api.client import InProcClient as JaxClient
from kubernetes_tpu.api.registry import Registry as JaxRegistry
from kubernetes_tpu.core import migrate as jax_migrate
from kubernetes_tpu.core.scheme import default_scheme as jax_scheme
from kubernetes_tpu_torch.api.client import InProcClient as PortClient
from kubernetes_tpu_torch.api.registry import Registry as PortRegistry
from kubernetes_tpu_torch.core import migrate as port_migrate
from kubernetes_tpu_torch.core.scheme import default_scheme as port_scheme

_JAX_TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "test_migrate.py")
with open(_JAX_TESTS) as _f:
    _SOURCE = _f.read()
assert _SOURCE.count("from kubernetes_tpu.") >= 5
_SOURCE = re.sub(r",\s*native_available\)", ")", _SOURCE)
assert "native_available)" not in _SOURCE


def native_available():
    return True


exec(compile(_SOURCE.replace("from kubernetes_tpu.",
                             "from kubernetes_tpu_torch."),
             _JAX_TESTS, "exec"))


def test_migration_reports_alike():
    """The same objects in both packages' registries: migrate_store and
    migrate_via_api report the same counts, prefixes and failures, and
    leave wire-equal objects behind (resourceVersions included)."""
    from kubernetes_tpu.core import types as jax_api
    objs = [("pods", jax_api.Pod(
        metadata=jax_api.ObjectMeta(name=f"p{i}", namespace="default",
                                    labels={"tier": "web"}),
        spec=jax_api.PodSpec(containers=[jax_api.Container(
            name="c", image="i")]))) for i in range(3)]
    objs.append(("nodes", jax_api.Node(metadata=jax_api.ObjectMeta(
        name="n1"))))
    reports, states = {}, {}
    for pkg, (reg_cls, client_cls, mig, scheme) in {
            "jax": (JaxRegistry, JaxClient, jax_migrate, jax_scheme),
            "port": (PortRegistry, PortClient, port_migrate,
                     port_scheme)}.items():
        registry = reg_cls()
        client = client_cls(registry)
        for resource, obj in objs:
            wire = jax_scheme.encode_dict(obj)
            client.create(resource, scheme.decode_dict(wire))
        a = mig.migrate_store(registry.store).as_dict()
        b = mig.migrate_via_api(client).as_dict()
        reports[pkg] = (a, b)
        pods, rev = client.list("pods", "default")
        states[pkg] = (rev, [scheme.encode_dict(p) for p in pods])
    assert reports["port"] == reports["jax"]
    mask = lambda s: [(p["metadata"]["name"],  # noqa: E731
                       p["metadata"]["resourceVersion"]) for p in s[1]]
    assert states["port"][0] == states["jax"][0]
    assert mask(states["port"]) == mask(states["jax"])
