"""The port's wire codec (kubernetes_tpu_torch/core/serde.py) against the
JAX package's: the wire must not tell the two packages apart, and the
port's watch decoder (serde.watch_decoder, each type's plan worked out
once) must decode every wire value as from_wire does. tests/test_serde.py and
tests/test_serde_fuzz.py run on the port as they stand (their sources
compiled into a namespace each with every `kubernetes_tpu.` import
pointed at `kubernetes_tpu_torch.`). Then the two packages side by side:
fuzzed instances of every kind the registry serves, and of the request
kinds, made with the JAX types, encode to the same JSON text (key order
included) in both packages once carried over the wire, and decode back
alike; and hand-made wire values that take the codec's edges (an int in
a float field, an integral float in an int field, a bool in a float
field, null and absent fields, unknown keys, the deprecated
`serviceAccount` alias, Optional fields present but empty) decode to
objects whose re-encoding is the JAX package's."""

import json
import os
import random
import zlib

import pytest

from kubernetes_tpu.api.registry import RESOURCES as JAX_RESOURCES
from kubernetes_tpu.core import serde as jax_serde
from kubernetes_tpu.core import types as jax_api
from kubernetes_tpu.core.scheme import default_scheme as jax_scheme
from kubernetes_tpu_torch.core import serde as port_serde
from kubernetes_tpu_torch.core import types as port_api
from kubernetes_tpu_torch.core.scheme import default_scheme as port_scheme

HERE = os.path.dirname(os.path.abspath(__file__))


def _port_namespace(name):
    path = os.path.join(HERE, name)
    with open(path) as f:
        src = f.read()
    assert "from kubernetes_tpu." in src
    ns = {"__name__": f"port_{name[:-3]}", "__file__": path}
    exec(compile(src.replace("from kubernetes_tpu.",
                             "from kubernetes_tpu_torch."), path, "exec"),
         ns)
    return ns


_SUITES = [_port_namespace("test_serde.py"),
           _port_namespace("test_serde_fuzz.py")]
_COLLECTED = {}
for _ns in _SUITES:
    for _name, _obj in list(_ns.items()):
        if _name.startswith("test_") and callable(_obj):
            assert _name not in _COLLECTED, _name
            _COLLECTED[_name] = _obj
globals().update(_COLLECTED)

# the JAX fuzzer itself, for the side-by-side cases
_jax_fuzz = {}
with open(os.path.join(HERE, "test_serde_fuzz.py")) as _f:
    exec(compile(_f.read(), os.path.join(HERE, "test_serde_fuzz.py"),
                 "exec"), _jax_fuzz)


def _same_text(wire_jax):
    """JAX wire -> port object -> port wire, as JSON text; and the
    JAX object decoded from the same wire, re-encoded. The port decodes
    both ways, as a REST body (decode_dict) and as a watch event
    (decode_watched); both objects must be equal."""
    text = json.dumps(wire_jax)
    port_obj = port_scheme.decode_dict(json.loads(text))
    assert port_scheme.decode_watched(json.loads(text)) == port_obj
    jax_obj = jax_scheme.decode_dict(json.loads(text))
    return (json.dumps(port_scheme.encode_dict(port_obj)),
            json.dumps(jax_scheme.encode_dict(jax_obj)))


@pytest.mark.parametrize("resource", sorted(JAX_RESOURCES))
def test_fuzzed_kinds_encode_alike(resource):
    cls = JAX_RESOURCES[resource].cls
    rng = random.Random(zlib.crc32(resource.encode()) & 0xFFFF)
    for trial in range(12):
        obj = _jax_fuzz["_rand_instance"](cls, rng)
        wire = jax_scheme.encode_dict(obj)
        port_text, jax_text = _same_text(wire)
        assert port_text == jax_text == json.dumps(wire), (resource, trial)


def test_fuzzed_request_kinds_encode_alike():
    rng = random.Random(11)
    for name in ("Binding", "PodTemplateSpec"):
        jcls, pcls = getattr(jax_api, name), getattr(port_api, name)
        for _ in range(12):
            obj = _jax_fuzz["_rand_instance"](jcls, rng)
            text = json.dumps(jax_serde.to_wire(obj))
            back = port_serde.from_wire(pcls, json.loads(text))
            assert port_serde.watch_decoder(pcls)(json.loads(text)) == back
            assert json.dumps(port_serde.to_wire(back)) == text
            assert json.dumps(jax_serde.to_wire(
                jax_serde.from_wire(jcls, json.loads(text)))) == text


EDGE_WIRES = [
    # an int in a float field, an integral float in an int field
    {"kind": "Pod", "apiVersion": "v1",
     "metadata": {"name": "p", "namespace": "default",
                  "deletionGracePeriodSeconds": 30.0,
                  "labels": {"a": "b"}, "unknownKey": 1},
     "spec": {"terminationGracePeriodSeconds": 5.0,
              "activeDeadlineSeconds": 7,
              "serviceAccount": "legacy",
              "containers": [{"name": "c", "image": "i",
                              "resources": {"requests": {"cpu": "100m"}},
                              "ports": [{"containerPort": 80.0}]}],
              "volumes": [{"name": "v", "emptyDir": {}}]},
     "status": {"phase": "Pending", "conditions": None}},
    {"kind": "Node", "apiVersion": "v1",
     "metadata": {"name": "n"},
     "spec": {"unschedulable": True, "podCIDR": "10.0.0.0/24"},
     "status": {"capacity": {"cpu": "4", "memory": "8Gi", "pods": "110"},
                "conditions": [{"type": "Ready", "status": "True"}]}},
    {"kind": "ReplicationController", "apiVersion": "v1",
     "metadata": {"name": "rc", "namespace": "default"},
     "spec": {"replicas": 0, "selector": {"app": "x"}}},
    {"kind": "Service", "apiVersion": "v1",
     "metadata": {"name": "s", "namespace": "default"},
     "spec": {"deprecatedPublicIPs": ["1.2.3.4"],
              "ports": [{"port": 80, "targetPort": 8080}]}},
    {"kind": "HorizontalPodAutoscaler", "apiVersion": "extensions/v1beta1",
     "metadata": {"name": "h", "namespace": "default"},
     "spec": {"minReplicas": 1, "maxReplicas": 4,
              "cpuUtilization": {"targetPercentage": 50}}},
]


@pytest.mark.parametrize("i", range(len(EDGE_WIRES)))
def test_edge_wires_decode_alike(i):
    port_text, jax_text = _same_text(EDGE_WIRES[i])
    assert port_text == jax_text


def test_bool_in_a_float_field_widens_alike():
    """The JAX codec widens any int, bool included, into a float field,
    and narrows an integral float into an int field; the port's must
    too."""
    import typing
    for value in (True, 3, 2.5, None, "x"):
        for tp in (float, typing.Optional[int]):
            want = jax_serde._from_wire(tp, value)
            assert port_serde._from_wire(tp, value) == want
            assert port_serde._decoder(tp)(value) == want
    assert type(port_serde._decoder(float)(True)) is float
