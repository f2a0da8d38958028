"""Pins kubernetes_tpu_torch.kubemark.fixtures.SMOKE_DIGESTS to the JAX
engine's answer at full size (5000 nodes x 30000 plain pods, 5000 x 8192
spread pods): the JAX BatchEngine.run_chunked(enc, 8192) gives exactly
those sha256 digests and bound counts. chip_smoke.py holds the port on
the card, which has no JAX, to the same digests. The port's fixture is
also checked to encode byte-identically to bench.py's.

It also pins E2E_COUNTS, the per-node counts digest the card's e2e phase
(the live pipeline under the kubemark benchmark, 5000 nodes x 30000
pods) must reproduce: one uninterrupted JAX engine run over the JAX
fleet's nodes and benchmark pods, which the port's fleet and benchmark
pods encode byte-identically to."""

import pytest

import bench
from kubernetes_tpu.kubemark.benchmark import _bench_pod as jax_bench_pod
from kubernetes_tpu.kubemark.fleet import HollowFleet as JaxFleet
from kubernetes_tpu.sched.device import ClusterSnapshot as JaxSnapshot
from kubernetes_tpu.sched.device import BatchEngine as JaxEngine
from kubernetes_tpu.sched.device import encode_snapshot as jax_encode
from kubernetes_tpu_torch.kubemark.benchmark import _bench_pod
from kubernetes_tpu_torch.kubemark.fixtures import (E2E_COUNTS, SMOKE_CHUNK,
                                                    SMOKE_DIGESTS,
                                                    assigned_digest,
                                                    engine_snapshot,
                                                    node_counts_digest,
                                                    smoke_pod_pad)
from kubernetes_tpu_torch.kubemark.fleet import HollowFleet
from kubernetes_tpu_torch.sched.device import ClusterSnapshot, encode_snapshot

from test_torch_encode import assert_enc_equal


@pytest.mark.parametrize("name", sorted(SMOKE_DIGESTS))
def test_smoke_digests_are_the_jax_engines(name):
    want = SMOKE_DIGESTS[name]
    n, p, plain = want["n_nodes"], want["n_pods"], want["plain"]
    jax_enc = jax_encode(bench._engine_snapshot(n, p, plain=plain),
                         pod_pad_to=smoke_pod_pad(p))
    port_enc = encode_snapshot(engine_snapshot(n, p, plain=plain),
                               pod_pad_to=smoke_pod_pad(p))
    assert_enc_equal(jax_enc, port_enc)
    assigned, _ = JaxEngine().run_chunked(jax_enc, SMOKE_CHUNK)
    assert assigned_digest(assigned, jax_enc.n_pods) == \
        (want["sha256"], want["bound"])


def test_e2e_counts_are_the_jax_engines():
    want = E2E_COUNTS
    n, p = want["n_nodes"], want["n_pods"]
    kw = dict(cpu="4", memory="32Gi", max_pods=want["max_pods"])
    jax_fleet, fleet = JaxFleet(None, n, **kw), HollowFleet(None, n, **kw)
    jax_enc = jax_encode(JaxSnapshot(
        nodes=[jax_fleet._node_object(i) for i in range(n)],
        pending_pods=[jax_bench_pod(i) for i in range(p)]),
        pod_pad_to=smoke_pod_pad(p))
    port_enc = encode_snapshot(ClusterSnapshot(
        nodes=[fleet._node_object(i) for i in range(n)],
        pending_pods=[_bench_pod(i) for i in range(p)]),
        pod_pad_to=smoke_pod_pad(p))
    assert_enc_equal(jax_enc, port_enc)
    assigned, _ = JaxEngine().run_chunked(jax_enc, SMOKE_CHUNK)
    hosts = [jax_enc.node_names[i] if i >= 0 else None
             for i in assigned[:jax_enc.n_pods]]
    assert node_counts_digest(jax_fleet.node_names(), hosts) == \
        (want["sha256"], want["bound"])
