"""The port's profiling hook (kubernetes_tpu_torch/utils/profiling.py,
torch.profiler in the place of jax.profiler): `profiled_schedule` on the
CPU writes a Chrome trace holding the `batch-schedule` span, and its
assignment equals an untraced run's and the JAX engine's on the same
snapshot."""

import json
import os

import numpy as np
import pytest

from kubernetes_tpu.sched.device import BatchEngine as JaxEngine
from kubernetes_tpu.sched.device import encode_snapshot as jax_encode
from kubernetes_tpu_torch.sched.device import BatchEngine, encode_snapshot
from kubernetes_tpu_torch.utils import profiling

from test_device_parity import rand_cluster
from test_torch_encode import to_port


@pytest.mark.parametrize("chunk", [None, 8])
def test_profiled_schedule_writes_the_span(tmp_path, chunk):
    jax_snap = rand_cluster(3)
    enc = encode_snapshot(to_port(jax_snap))
    engine = BatchEngine(device="cpu")
    logdir = str(tmp_path / "trace")
    assigned, out = profiled_schedule_twice(engine, enc, logdir, chunk)
    assert out == logdir
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == "batch-schedule"]
    assert len(spans) == 1 and spans[0]["dur"] > 0
    plain = (engine.run_chunked(enc, chunk) if chunk
             else engine.run(enc))[0]
    assert np.array_equal(np.asarray(assigned), np.asarray(plain))
    jax_enc = jax_encode(jax_snap)
    want = (JaxEngine().run_chunked(jax_enc, chunk) if chunk
            else JaxEngine().run(jax_enc))[0]
    assert np.array_equal(np.asarray(assigned)[:enc.n_pods],
                          np.asarray(want)[:jax_enc.n_pods])


def profiled_schedule_twice(engine, enc, logdir, chunk):
    """The hook, with an annotate() span outside the engine run too: a
    nested span must not be taken for the engine's."""
    with profiling.annotate("outer"):
        return profiling.profiled_schedule(engine, enc, logdir, chunk)
