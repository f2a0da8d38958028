"""Pins kubernetes_tpu_torch.kubemark.fixtures.SMOKE_DIGESTS to the JAX
engine's answer at full size (5000 nodes x 30000 plain pods, 5000 x 8192
spread pods): the JAX BatchEngine.run_chunked(enc, 8192) gives exactly
those sha256 digests and bound counts. chip_smoke.py holds the port on
the card, which has no JAX, to the same digests. The port's fixture is
also checked to encode byte-identically to bench.py's."""

import pytest

import bench
from kubernetes_tpu.sched.device import BatchEngine as JaxEngine
from kubernetes_tpu.sched.device import encode_snapshot as jax_encode
from kubernetes_tpu_torch.kubemark.fixtures import (SMOKE_CHUNK,
                                                    SMOKE_DIGESTS,
                                                    assigned_digest,
                                                    engine_snapshot,
                                                    smoke_pod_pad)
from kubernetes_tpu_torch.sched.device import encode_snapshot

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
