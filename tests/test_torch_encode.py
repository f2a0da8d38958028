"""The port's snapshot encoder (kubernetes_tpu_torch.sched.device.tables)
gives numpy arrays byte-identical to the JAX package's encoder.

Objects cross between the packages only through the wire format: the
JAX scheme's encode_dict goes to the port's decode_dict. The helpers
here are shared by the other port test files."""

import dataclasses
import random

import numpy as np
import pytest

from kubernetes_tpu.core.quantity import Quantity as JaxQuantity
from kubernetes_tpu.core.scheme import default_scheme as jax_scheme
from kubernetes_tpu.sched.device import DevicePolicy as JaxDevicePolicy
from kubernetes_tpu.sched.device import encode_snapshot as jax_encode
from kubernetes_tpu_torch.core.scheme import default_scheme as port_scheme
from kubernetes_tpu_torch.sched.device import (ClusterSnapshot, DevicePolicy,
                                               encode_snapshot)

from test_affinity import with_random_affinity
from test_device_parity import rand_cluster
from test_pallas_filter import _snapshot as filter_snapshot

POLICY = JaxDevicePolicy(anti_affinity_label="zone", anti_affinity_weight=2,
                         label_presence=[(("zone",), True)],
                         label_priorities=[("disk", True, 3)])

FILTER_SHAPES = [(7, 3, 5, 1), (137, 53, 200, 7), (512, 16, 64, 3),
                 (60, 129, 0, 5)]


def cross(objs):
    return [port_scheme.decode_dict(jax_scheme.encode_dict(o)) for o in objs]


def to_port(snap) -> ClusterSnapshot:
    """A JAX-package ClusterSnapshot -> the port's, through the wire."""
    return ClusterSnapshot(
        nodes=cross(snap.nodes), existing_pods=cross(snap.existing_pods),
        services=cross(snap.services), controllers=cross(snap.controllers),
        pending_pods=cross(snap.pending_pods),
        all_nodes=None if snap.all_nodes is None else cross(snap.all_nodes))


def port_policy(policy):
    return None if policy is None else DevicePolicy(
        **dataclasses.asdict(policy))


def wide_snapshot():
    """A prime-byte memory request breaks the gcd rescale: i64 layout."""
    snap = filter_snapshot(random.Random(17), 10, 4, 0)
    snap.pending_pods[0].spec.containers[0].resources.requests[
        "memory"] = JaxQuantity((1 << 40) + 7)
    return snap


def encodings(snap, policy=None, **kw):
    """-> (JAX encode, port encode) of one JAX-package snapshot."""
    return (jax_encode(snap, policy=policy, **kw),
            encode_snapshot(to_port(snap), policy=port_policy(policy), **kw))


def enc_fields(enc):
    out = {}
    for part in ("node_tab", "pod_batch", "init_state"):
        for f in dataclasses.fields(getattr(enc, part)):
            out[f"{part}.{f.name}"] = getattr(getattr(enc, part), f.name)
    out["offgrid_max"] = enc.offgrid_max
    return out


def assert_enc_equal(want, got):
    assert (got.node_names, got.n_nodes, got.n_pods, got.mem_scale) == \
        (want.node_names, want.n_nodes, want.n_pods, want.mem_scale)
    w, g = enc_fields(want), enc_fields(got)
    assert sorted(w) == sorted(g)
    for name in w:
        a, b = np.asarray(w[name]), np.asarray(g[name])
        assert (a.dtype, a.shape) == (b.dtype, b.shape), name
        assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("seed", range(6))
def test_encode_matches_jax_rand_cluster(seed):
    assert_enc_equal(*encodings(rand_cluster(seed)))


@pytest.mark.parametrize("n_nodes,n_pods,n_existing,seed", FILTER_SHAPES)
def test_encode_matches_jax_filter_snapshot(n_nodes, n_pods, n_existing,
                                            seed):
    snap = filter_snapshot(random.Random(seed), n_nodes, n_pods, n_existing)
    want, got = encodings(snap)
    assert want.node_tab.cpu_cap.dtype == np.int32
    assert_enc_equal(want, got)


def test_encode_matches_jax_wide_layout():
    want, got = encodings(wide_snapshot())
    assert got.node_tab.cpu_cap.dtype == np.int64
    assert_enc_equal(want, got)


@pytest.mark.parametrize("seed", range(2))
def test_encode_matches_jax_affinity_and_policy(seed):
    snap = with_random_affinity(rand_cluster(seed + 100), seed)
    want, got = encodings(snap, policy=POLICY, node_pad_to=4, pod_pad_to=64)
    assert got.pod_batch.aff_req.any() and (got.node_tab.zone_id >= 0).any()
    assert_enc_equal(want, got)
