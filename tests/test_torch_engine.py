"""The port's BatchEngine (PyTorch, on the CPU here) assigns every pod to
the same node as the JAX BatchEngine on the same EncodeResult: run,
run_chunked at several chunk sizes (including a padded tail chunk),
chained run_chunked(state_override=...), and the probe's mask and
totals — across the node-local, SelectorSpread, inter-pod affinity and
ServiceAntiAffinity tiers. Every quantity is an integer or an f64
floor, so the tolerance is 0."""

import dataclasses

import numpy as np
import pytest
import torch

from kubernetes_tpu.sched.device import BatchEngine as JaxEngine
from kubernetes_tpu.sched.device import ClusterSnapshot as JaxSnapshot
from kubernetes_tpu_torch.sched.device import BatchEngine, schedule_batch
from kubernetes_tpu_torch.sched.device import scan_kernel
from kubernetes_tpu_torch.sched.device.engine import PendingAssignment

from test_affinity import with_random_affinity
from test_device_parity import rand_cluster
from test_torch_encode import POLICY, encodings, port_policy, to_port


def _plain(snap):
    """No services / controllers: the node-local tier only."""
    return JaxSnapshot(nodes=snap.nodes, existing_pods=snap.existing_pods,
                       pending_pods=snap.pending_pods)


TIERS = {
    "node_local": lambda s: (_plain(rand_cluster(s)), None),
    "spread": lambda s: (rand_cluster(s), None),
    "affinity": lambda s: (with_random_affinity(rand_cluster(s + 100), s),
                           None),
    "service_anti": lambda s: (rand_cluster(s), POLICY),
}


def engines(policy):
    return (JaxEngine(policy=policy),
            BatchEngine(policy=port_policy(policy), device="cpu"))


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_run_matches_jax(tier, seed):
    snap, policy = TIERS[tier](seed)
    jax_enc, enc = encodings(snap, policy=policy)
    je, te = engines(policy)
    want, _ = je.run(jax_enc)
    got, state = te.run(enc)
    assert got.dtype == np.int32
    assert np.array_equal(got, np.asarray(want))
    # the port also takes the JAX package's EncodeResult as it is
    got2, _ = te.run(jax_enc)
    assert np.array_equal(got2, got)
    assert (got >= 0).any() and isinstance(state.cpu_used, torch.Tensor)


def test_tiers_are_active():
    flags = {}
    for tier, make in TIERS.items():
        snap, policy = make(0)
        _, enc = encodings(snap, policy=policy)
        e = BatchEngine(policy=port_policy(policy), device="cpu")
        flags[tier] = (e._enc_flags(enc), e._anti_weight)
    assert flags["node_local"] == ((False, False), 0)
    assert flags["spread"] == ((False, True), 0)
    assert flags["affinity"][0][0]
    assert flags["service_anti"][1] == POLICY.anti_affinity_weight


# 7: a padded tail chunk; 40: the batch in exactly one chunk
@pytest.mark.parametrize("chunk", [7, 40])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_run_chunked_matches_jax(tier, chunk):
    snap, policy = TIERS[tier](11)
    jax_enc, enc = encodings(snap, policy=policy)
    je, te = engines(policy)
    want, _ = je.run_chunked(jax_enc, chunk)
    got, _ = te.run_chunked(enc, chunk)
    assert np.array_equal(got, np.asarray(want))
    one, _ = te.run(enc)
    assert np.array_equal(got, one)


def _pod_range(enc, lo, hi):
    """The encoded batch's pods [lo, hi): tiles that share the whole
    batch's dictionaries and groups, as a tile loop's do."""
    pb = enc.pod_batch
    sliced = {f.name: getattr(pb, f.name)[lo:hi]
              for f in dataclasses.fields(pb)}
    return dataclasses.replace(enc, pod_batch=type(pb)(**sliced),
                               n_pods=hi - lo)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_chained_run_chunked_matches_jax(tier):
    """Tile k+1 starts from tile k's final carry on the device; the chain
    equals the JAX engine's chain and one uninterrupted run, and the
    override is not mutated."""
    snap, policy = TIERS[tier](5)
    jax_enc, enc = encodings(snap, policy=policy)
    je, te = engines(policy)
    half = enc.n_pods // 2
    j1, jstate = je.run_chunked(_pod_range(jax_enc, 0, half), 8)
    j2, _ = je.run_chunked(_pod_range(jax_enc, half, enc.n_pods), 8,
                           state_override=jstate)
    a1, state = te.run_chunked(_pod_range(enc, 0, half), 8)
    carry = [t.clone() for t in state]
    a2, _ = te.run_chunked(_pod_range(enc, half, enc.n_pods), 8,
                           state_override=state)
    assert all(torch.equal(x, y) for x, y in zip(carry, state))
    got = np.concatenate([a1, a2])
    assert np.array_equal(got, np.concatenate([j1, j2]))
    assert np.array_equal(got, te.run(enc)[0])


def test_block_false_returns_device_tensor():
    """block=False hands back a PendingAssignment: the i32 result tensor
    on the engine's device (on the card with the CUDA event recorded
    after the last chunk; on the CPU there is nothing to wait for)."""
    _, enc = encodings(rand_cluster(2))
    te = BatchEngine(device="cpu")
    pending, _ = te.run_chunked(enc, 16, block=False)
    flat = pending.tensor
    assert isinstance(flat, torch.Tensor) and flat.dtype == torch.int32
    assert flat.device == te.device and pending.event is None
    assert pending.is_ready()
    assert np.array_equal(pending.result(), te.run_chunked(enc, 16)[0])


def test_pending_assignment_runs_its_callback_once_on_the_first_read():
    """run_chunked on the card hands PendingAssignment the callback that
    adds the run's K1 device time to scan_stats: it runs when the
    result is first read, once. On the CPU there is no device time."""
    calls = []
    pending = PendingAssignment(torch.arange(4, dtype=torch.int32),
                                lambda: calls.append(1))
    assert calls == []
    assert np.array_equal(pending.result(), np.arange(4))
    pending.result()
    assert calls == [1]
    _, enc = encodings(rand_cluster(2))
    te = BatchEngine(device="cpu")
    te.run_chunked(enc, 16, block=False)[0].result()
    assert te.scan_stats["device_ms"] == 0.0


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_probe_matches_jax(tier, monkeypatch):
    snap, policy = TIERS[tier](3)
    jax_enc, enc = encodings(snap, policy=policy)
    je, te = engines(policy)
    want_mask, want_total = je.probe(jax_enc)
    # a block smaller than the batch exercises the blocked pod dimension
    monkeypatch.setattr(scan_kernel, "PROBE_BLOCK", 16)
    mask, total = te.probe(enc)
    assert mask.dtype == np.bool_ and total.dtype == want_total.dtype
    assert np.array_equal(mask, np.asarray(want_mask))
    assert np.array_equal(total, np.asarray(want_total))


def test_wide_layout_matches_jax():
    from test_torch_encode import wide_snapshot
    jax_enc, enc = encodings(wide_snapshot())
    assert enc.node_tab.cpu_cap.dtype == np.int64
    je, te = engines(None)
    assert np.array_equal(te.run(enc)[0], np.asarray(je.run(jax_enc)[0]))
    assert np.array_equal(te.probe(enc)[1], np.asarray(je.probe(jax_enc)[1]))


def test_large_weights_rewiden_like_jax():
    """Weights too large for the i32 composite force the i64 re-widen
    (_ensure_safe_dtypes), identically in both engines."""
    snap = rand_cluster(4)
    jax_enc, enc = encodings(snap)
    weights = (1 << 25, 3, 2)
    je = JaxEngine(weights)
    te = BatchEngine(weights, device="cpu")
    assert te._ensure_safe_dtypes(enc).node_tab.cpu_cap.dtype == np.int64
    assert np.array_equal(te.run(enc)[0], np.asarray(je.run(jax_enc)[0]))


def test_schedule_batch_matches_jax_names():
    from kubernetes_tpu.sched.device import schedule_batch as jax_schedule
    snap = rand_cluster(1)
    assert schedule_batch(to_port(snap), device="cpu") == jax_schedule(snap)


def test_engine_requires_explicit_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchEngine()


def test_upload_and_scan_stats_count_every_run_in_full():
    """A one-shot encode carries no TableDelta journal, so the table
    mirror never takes it: every run_chunked uploads the node tables
    (and the State init unless chained) and upload_stats says so under
    the JAX engine's keys, and never reports a delta upload."""
    _, enc = encodings(rand_cluster(3))
    te = BatchEngine(device="cpu")
    assert te.n_shards == 1
    node, state, pods = te.device_args(enc)
    nb = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    _, carry = te.run_chunked(enc, 16)
    te.run_chunked(enc, 16, state_override=carry)
    st = te.upload_stats
    assert set(st) == {"full_tiles", "delta_tiles", "reuse_tiles",
                       "full_bytes", "delta_bytes", "pod_bytes",
                       "table_bytes"}
    assert st["full_tiles"] == 2
    assert st["delta_tiles"] == st["reuse_tiles"] == st["delta_bytes"] == 0
    assert st["full_bytes"] == 2 * nb(node) + nb(state)
    assert st["pod_bytes"] == 2 * nb(pods)
    assert st["table_bytes"] == nb(node) + nb(state)
    p = enc.pod_batch.valid.shape[0]
    assert te.scan_stats["runs"] == 2
    assert te.scan_stats["steps"] == 2 * (p + (-p) % 16)
    assert te.scan_stats["seconds"] > 0
