"""The port's device table mirror (engine._TableCache, _fetch_tables and
the dirty-row scatter, sched/device/scatter_kernel.py) against the JAX
engine's, on the CPU.

A JAX encoder and the port's are fed the same churn (pod waves, a node
condition flip, a node arrival, chained and unchained tiles); the port's
delta arm (mirror + scatter) must bind bit-identically to its full-upload
arm and to the JAX engine's delta arm, and count the same full / delta /
reuse tiles. A mirror from another encoder or another shard-epoch vector
must miss. The scan commits into its State in place, so a run must
start from a clone of the mirror's State: two unchained tiles off the
mirror in a row must equal the full-upload arm. Tolerance 0: every
quantity here is an integer."""

import dataclasses

import numpy as np
import pytest

from kubernetes_tpu.sched.device import BatchEngine as JaxEngine
from kubernetes_tpu.sched.device.incremental import \
    IncrementalEncoder as JaxIncremental
from kubernetes_tpu_torch.kubemark.benchmark import run_scheduling_benchmark
from kubernetes_tpu_torch.sched.device import BatchEngine, scatter_kernel
from kubernetes_tpu_torch.sched.device import engine as port_engine
from kubernetes_tpu_torch.sched.device.incremental import IncrementalEncoder

from test_incremental import mk_node, mk_pod
from test_torch_encode import cross
from test_torch_kubemark import counts

TILE_KEYS = ("full_tiles", "delta_tiles", "reuse_tiles")


def _pow2(r: int) -> int:
    return 1 << max(0, (r - 1).bit_length())


class Arms:
    """One JAX encoder and one port encoder fed the same events, a JAX
    engine and two port engines (the mirror, and full uploads)."""

    def __init__(self, n_nodes=50, **kw):
        self.jax_inc = JaxIncremental(**kw)
        self.inc = IncrementalEncoder(**kw)
        self.jax = JaxEngine()
        self.delta = BatchEngine(device="cpu")
        self.full = BatchEngine(device="cpu")
        self.full.delta_uploads = False
        self.carry = {}
        for i in range(n_nodes):
            self.event("on_node_add", mk_node(f"n-{i:03d}", cpu=2000))

    def event(self, name, *objs):
        getattr(self.jax_inc, name)(*objs)
        getattr(self.inc, name)(*cross(objs))

    def tile(self, pods, chained=False, chunk=32, assume=True):
        """Encode `pods` in both encoders, run every arm (off the last
        tile's carry when chained), hold them equal, assume them back."""
        je = self.jax_inc.encode_tile(pods, [], [])
        pe = self.inc.encode_tile(cross(pods), [], [])
        out = {}
        for name, eng, enc in (("jax", self.jax, je),
                               ("delta", self.delta, pe),
                               ("full", self.full, pe)):
            prev = self.carry.get(name) if chained else None
            a, self.carry[name] = eng.run_chunked(enc, chunk,
                                                  state_override=prev)
            out[name] = np.asarray(a)
        assert np.array_equal(out["delta"], out["full"])
        assert np.array_equal(out["delta"], out["jax"])
        if assume:
            self.jax_inc.assume_assigned(je, pods, out["jax"])
            self.inc.assume_assigned(pe, cross(pods), out["delta"])
        return out["delta"]


def _record_scatters(monkeypatch):
    """Record (rows, bytes a row summed over the columns) of every
    scatter the engine makes."""
    seen = []
    real = scatter_kernel.scatter_rows

    def recording(columns, idx, rows):
        seen.append((int(idx.size), sum(r[0].nbytes if len(r) else 0
                                        for r in rows)))
        return real(columns, idx, rows)

    monkeypatch.setattr(port_engine.scatter_kernel, "scatter_rows",
                        recording)
    return seen


@pytest.mark.parametrize("chain", [False, True], ids=["unchained",
                                                      "alternate"])
def test_delta_uploads_bit_equal_to_full_uploads_under_churn(monkeypatch,
                                                             chain):
    """The JAX package's mirror A/B (tests/test_incremental.py) on the
    port: delta == full == the JAX engine under churn, the same tile
    counts as the JAX engine, the same full bytes, and delta bytes that
    are the JAX engine's formula without its power-of-two pad."""
    seen = _record_scatters(monkeypatch)
    arms = Arms()
    for tick in range(6):
        pods = [mk_pod(f"p-{tick}-{j}", phase="Pending") for j in range(20)]
        arms.tile(pods, chained=chain and tick % 2 == 1)
        if tick == 1:  # condition flip mid-stream
            arms.event("on_node_update", mk_node("n-003", cpu=2000),
                       mk_node("n-003", cpu=2000, ready=False))
        if tick == 2:  # node arrival mid-stream
            arms.event("on_node_add", mk_node("n-060", cpu=2000))
        if tick == 3:  # a bound pod leaves
            arms.event("on_pod_delete", mk_pod("p-0-0", node="n-000"))
    ds, fs, js = (arms.delta.upload_stats, arms.full.upload_stats,
                  arms.jax.upload_stats)
    assert {k: ds[k] for k in TILE_KEYS} == {k: js[k] for k in TILE_KEYS}
    assert ds["delta_tiles"] + ds["reuse_tiles"] >= 3, ds
    assert fs["full_tiles"] == 6 and fs["delta_tiles"] == 0, fs
    assert ds["full_bytes"] == js["full_bytes"]
    assert ds["table_bytes"] == js["table_bytes"] == fs["table_bytes"]
    assert ds["pod_bytes"] == js["pod_bytes"]
    assert ds["full_bytes"] + ds["delta_bytes"] < fs["full_bytes"] / 2
    assert seen and all(r > 0 for r, _ in seen)
    assert ds["delta_bytes"] == sum(r * (8 + b) for r, b in seen)
    assert js["delta_bytes"] == sum(_pow2(r) * (8 + b) for r, b in seen)


def test_two_unchained_tiles_off_the_mirror_equal_full_uploads():
    """The scan commits into its State in place: if a run scanned on the
    mirror's State, the next tile would start from that run's post-scan
    state and double-book every node it used. Nothing is assumed between
    the tiles, so no dirty row would cover it up; the first tile seeds
    the mirror, the next two run off it."""
    arms = Arms(n_nodes=8)
    pods = [mk_pod(f"q-{j}", cpu=500, phase="Pending") for j in range(12)]
    first = arms.tile(pods, assume=False)
    for _ in range(2):
        assert np.array_equal(arms.tile(pods, assume=False), first)
    assert arms.delta.upload_stats["full_tiles"] == 1
    assert arms.delta.upload_stats["reuse_tiles"] == 2


def _fresh_encoder(n=16):
    inc = IncrementalEncoder()
    for i in range(n):
        inc.on_node_add(cross([mk_node(f"n-{i:03d}")])[0])
    return inc


def test_table_cache_misses_across_encoder_instances():
    """A same-shaped tile from a second encoder misses the mirror (the
    JAX package's test of the same name)."""
    pods = cross([mk_pod(f"p-{j}", cpu=1000, phase="Pending")
                  for j in range(8)])
    engine = BatchEngine(device="cpu")
    inc_a = _fresh_encoder()
    enc_a = inc_a.encode_tile(pods, [], [])
    a_first, _ = engine.run_chunked(enc_a, 8)
    inc_a.assume_assigned(enc_a, pods, a_first)
    engine.run_chunked(inc_a.encode_tile(pods, [], []), 8)
    assert engine.upload_stats["delta_tiles"] == 1

    enc_b = _fresh_encoder().encode_tile(pods, [], [])
    a_b, _ = engine.run_chunked(enc_b, 8)
    ref, _ = BatchEngine(device="cpu").run_chunked(enc_b, 8)
    assert np.array_equal(a_b, ref), \
        "encoder B's tile ran against encoder A's device mirror"
    assert engine.upload_stats["full_tiles"] == 2


@pytest.mark.parametrize("how", ["vector", "reshard"])
def test_table_cache_misses_on_changed_shard_epochs(how):
    """A mirror seeded under one shard-epoch vector misses for a tile
    stamped with another: alone (the vector swapped in the delta), and
    after a survivor re-shard (which also invalidates in full)."""
    pods = cross([mk_pod(f"p-{j}", cpu=1000, phase="Pending")
                  for j in range(8)])
    engine = BatchEngine(device="cpu")
    inc = _fresh_encoder()
    enc = inc.encode_tile(pods, [], [])
    engine.run_chunked(enc, 8)
    engine.run_chunked(inc.encode_tile(pods, [], []), 8)
    assert engine.upload_stats["reuse_tiles"] == 1
    if how == "vector":
        enc2 = inc.encode_tile(pods, [], [])
        enc2 = dataclasses.replace(enc2, delta=dataclasses.replace(
            enc2.delta, shard_epochs=(7,)))
    else:
        inc.reshard(1)
        enc2 = inc.encode_tile(pods, [], [])
        assert enc2.delta.shard_epochs != enc.delta.shard_epochs
    got, _ = engine.run_chunked(enc2, 8)
    ref, _ = BatchEngine(device="cpu").run_chunked(enc2, 8)
    assert np.array_equal(got, ref)
    assert engine.upload_stats["full_tiles"] == 2
    assert engine._table_cache.epochs == enc2.delta.shard_epochs


def test_one_shot_encodes_upload_in_full():
    """No journal, no mirror: a one-shot encode always uploads in full
    and leaves no mirror behind."""
    from kubernetes_tpu_torch.kubemark.fixtures import mixed_snapshot
    from kubernetes_tpu_torch.sched.device import encode_snapshot
    engine = BatchEngine(device="cpu")
    enc = encode_snapshot(mixed_snapshot(3, 12, 6, 5))
    engine.run_chunked(enc, 8)
    engine.run_chunked(enc, 8)
    assert engine.upload_stats["full_tiles"] == 2
    assert engine._table_cache is None


def test_benchmark_delta_uploads_ab_binds_equal_counts():
    """run_scheduling_benchmark(delta_uploads=): both arms bind every pod
    with the same per-node counts, and only the mirror arm reuses or
    scatters."""
    out = {}
    for arm in (True, False):
        from kubernetes_tpu_torch.api.registry import Registry
        registry = Registry()
        r = run_scheduling_benchmark(200, 2000, registry=registry,
                                     device="cpu", delta_uploads=arm)
        assert r.scheduled == 2000
        out[arm] = (counts(registry), r.upload_stats)
    assert out[True][0] == out[False][0]
    assert out[True][0][1] == 2000
    mirror, full = out[True][1], out[False][1]
    assert mirror["delta_tiles"] + mirror["reuse_tiles"] >= 1
    assert full["delta_tiles"] == full["reuse_tiles"] == 0
