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
import torch

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
    scatter group the engine adds to a tile's prologue."""
    seen = []
    real = scatter_kernel.Prologue.scatter

    def recording(self, columns, idx, rows, also=None):
        seen.append((int(idx.size), sum(r[0].nbytes if len(r) else 0
                                        for r in rows)))
        return real(self, columns, idx, rows, also)

    monkeypatch.setattr(scatter_kernel.Prologue, "scatter", recording)
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


# ---------------------------------------------------------------------------
# the one-buffer prologue (scatter_kernel.Prologue): both tables' dirty
# rows, the run's State and the pods in one staging buffer, one launch


def _tables(seed, n, wide, words):
    from kubernetes_tpu_torch.kubemark.fixtures import scan_tables
    return scan_tables(seed, 4, n, wide=wide, groups=2, terms=1,
                       services=1, words=words)


def _bytes(t):
    return t.contiguous().view(-1).view(torch.uint8)


@pytest.mark.parametrize("wide,words,r_node,r_state", [
    (False, 1, 5, 7), (True, 3, 64, 1), (False, 2, 0, 30), (True, 1, 30, 0),
    (False, 1, 200, 200), (True, 2, 0, 0)])
def test_prologue_plain_equals_two_scatters_and_clone_state(
        wide, words, r_node, r_state):
    """The plain version of one tile's prologue (both tables' dirty rows
    spread over the whole table, the run's State from the mirror's) is
    byte-equal to the two one-table scatters followed by _clone_state,
    from a run State that starts as garbage: every byte of it is written
    once, by the copy or by the scatter. The skip bitmap marks exactly
    the dirty State rows, and the prologue's bytes are counted as
    bounds.prologue_bytes counts them."""
    from kubernetes_tpu_torch.sched.device import bounds
    n = 200
    node_h, state_h, _ = _tables(21, n, wide, words)
    new_node, new_state, _ = _tables(22, n, wide, words)
    cpu = torch.device("cpu")
    mirror_node = port_engine._upload(node_h, cpu)
    mirror_state = port_engine._upload(state_h, cpu)
    ref_node = port_engine._upload(node_h, cpu)
    ref_state = port_engine._upload(state_h, cpu)
    rng = np.random.default_rng(r_node * 1000 + r_state)
    node_rows = np.sort(rng.choice(n, r_node, replace=False))
    state_rows = np.sort(rng.choice(n, r_state, replace=False))

    pro = scatter_kernel.Prologue()
    run = port_engine._alloc_like(mirror_state)
    for t in run:
        _bytes(t).fill_(0xA5)
    if r_node:
        BatchEngine._scatter_rows(pro, mirror_node,
                                  port_engine._NODE_ROW_FIELDS, new_node,
                                  node_rows)
    group = None
    if r_state:
        BatchEngine._scatter_rows(pro, mirror_state,
                                  port_engine._STATE_ROW_FIELDS, new_state,
                                  state_rows, also=run)
        group = len(pro.scatters) - 1
    for f in port_engine.State._fields:
        pro.copy(getattr(run, f), getattr(mirror_state, f),
                 skip=group if f in port_engine._STATE_ROW_FIELDS else None)
    staged = pro.stage(cpu)
    assert staged.n_desc == 12 * bool(r_node) + 8 * bool(r_state) + 13
    assert staged.rows == r_node + r_state
    scatter_kernel.apply_staged(staged)

    for tab, fields, host, rows in (
            (ref_node, port_engine._NODE_ROW_FIELDS, new_node, node_rows),
            (ref_state, port_engine._STATE_ROW_FIELDS, new_state,
             state_rows)):
        if rows.size:
            scatter_kernel.scatter_rows(
                [getattr(tab, f) for f in fields], rows.astype(np.int64),
                [getattr(host, f)[rows] for f in fields])
    ref_run = port_engine._clone_state(ref_state)
    for got, want in zip(mirror_node, ref_node):
        assert torch.equal(_bytes(got), _bytes(want))
    for got, want in zip(mirror_state, ref_state):
        assert torch.equal(_bytes(got), _bytes(want))
    for f, got, want in zip(run._fields, run, ref_run):
        assert torch.equal(_bytes(got), _bytes(want)), f

    marked = set()
    for op in staged.ops:
        if op[0] == "copy" and op[3] is not None:
            words_ = staged.host[op[3]:op[3] + 4 * -(-n // 32)].numpy()
            bits = np.unpackbits(words_, bitorder="little")[:n]
            marked.add(tuple(np.nonzero(bits)[0]))
    assert marked == ({tuple(state_rows)} if r_state else set())

    def row_bytes(tab, fields):
        return [scatter_kernel._row_bytes(getattr(tab, f)) for f in fields]
    slot_b = sum(row_bytes(mirror_state, port_engine._STATE_ROW_FIELDS))
    state_b = sum(t.numel() * t.element_size() for t in mirror_state)
    groups = [(r_node, row_bytes(mirror_node, port_engine._NODE_ROW_FIELDS),
               1)] * bool(r_node) + [(r_state, row_bytes(
                   mirror_state, port_engine._STATE_ROW_FIELDS), 2)] \
        * bool(r_state)
    assert staged.nbytes == bounds.prologue_bytes(
        groups, state_b - r_state * slot_b, 0)


@pytest.mark.parametrize("chunk", [1, 7, 32])
def test_prologue_pod_views_equal_upload_and_pad(chunk):
    """The pods carried in the staging buffer, read as typed views, equal
    what _upload and a zero pad to the chunk multiple gave: the same
    dtypes, shapes and values, the padded pods invalid."""
    from kubernetes_tpu_torch.kubemark.fixtures import mixed_snapshot
    from kubernetes_tpu_torch.sched.device import encode_snapshot
    engine = BatchEngine(device="cpu")
    _, _, pods_h = engine.host_args(encode_snapshot(
        mixed_snapshot(4, 12, 45, 5)))
    p = pods_h.valid.shape[0]
    pad = (-p) % chunk
    pro = scatter_kernel.Prologue()
    slots = [pro.carry(a, p + pad) for a in pods_h]
    staged = pro.stage("cpu")
    assert staged.n_desc == 0
    want = port_engine._upload(pods_h, torch.device("cpu"))
    for f, got, w in zip(pods_h._fields, staged.views(slots), want):
        padded = torch.cat([w, torch.zeros((pad,) + tuple(w.shape[1:]),
                                           dtype=w.dtype)])
        assert got.dtype == w.dtype and got.shape == padded.shape, f
        assert torch.equal(got, padded), f
        assert got.data_ptr() % 16 == 0
    assert not staged.views(slots[:1])[0][p:].any()


@pytest.mark.parametrize("seed", range(4))
def test_carve_gives_the_layout_views(seed):
    """scatter_kernel.carve (one view of the buffer a dtype, each array
    sliced out of it) gives the views the slice-then-view construction
    gave: same dtypes, shapes, addresses and values, zero-size arrays
    and every dtype the engine carries included; Staged.views and
    _alloc_like go through it."""
    rng = np.random.default_rng(seed)
    dtypes = [torch.bool, torch.int32, torch.int64, torch.float64,
              torch.uint8]
    layout, off = [], 0
    for _ in range(12):
        dt = dtypes[rng.integers(len(dtypes))]
        shape = tuple(int(x) for x in rng.integers(0, 5, size=rng.integers(
            1, 3)))
        layout.append((off, dt, shape))
        off += -(-int(np.prod(shape)) * dt.itemsize // 16) * 16
    buf = torch.from_numpy(rng.integers(0, 256, size=max(off, 16),
                                        dtype=np.uint8))
    for (o, dt, shape), got in zip(layout, scatter_kernel.carve(buf,
                                                                layout)):
        n = int(np.prod(shape)) * dt.itemsize
        want = buf[o:o + n].view(dt).view(shape)
        assert got.dtype == dt and got.shape == want.shape
        assert torch.equal(got, want)
        if n:
            assert got.data_ptr() == want.data_ptr()
    state = port_engine._upload(BatchEngine(device="cpu").host_args(
        port_encode_snapshot())[1], torch.device("cpu"))
    run = port_engine._alloc_like(state)
    base = run[0].data_ptr()
    for f, a, b in zip(state._fields, run, state):
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.data_ptr() >= base and a.data_ptr() % 16 == 0, f


def port_encode_snapshot():
    from kubernetes_tpu_torch.kubemark.fixtures import mixed_snapshot
    from kubernetes_tpu_torch.sched.device import encode_snapshot
    return encode_snapshot(mixed_snapshot(4, 12, 45, 5))


def test_magic_division_is_exact():
    """The kernel's row of element t, umulhi(t, m) >> s, equals t // d
    for every t below 2^31, at the edges and at random, for the words a
    row of any column."""
    rng = np.random.default_rng(0)
    divisors = list(range(1, 600)) + [1000, 4095, 4096, 65535, 2 ** 20 + 7,
                                      2 ** 30 + 3, 2 ** 31 - 1]
    for d in divisors:
        m, s = scatter_kernel.magic(d)
        assert 0 <= m < 2 ** 32
        ts = [0, 1, d - 1, d, d + 1, 2 * d - 1, 2 ** 31 - 1, 2 ** 31 - 2,
              (2 ** 31 - 1) // d * d, (2 ** 31 - 1) // d * d - 1]
        ts += [int(x) for x in rng.integers(0, 2 ** 31, 200)]
        for t in ts:
            if not 0 <= t < 2 ** 31:
                continue
            got = t if d == 1 else (t * m >> 32) >> s
            assert got == t // d, (d, t)


def test_one_staging_and_one_launch_a_delta_tile(monkeypatch):
    """run_chunked stages once a tile. A mirror seed copies the mirror's
    State into the run's (13 copies); an unchained tile with both tables
    dirty is one prologue of every node and State row column and the 13
    copies; a chained tile copies the carry and scatters only its node
    rows; a full upload without a carry needs no descriptor, only the
    pods' copy. Every arm binds as the full-upload engine."""
    calls = []
    real = scatter_kernel.Prologue.stage

    def recording(self, device):
        staged = real(self, device)
        calls.append((staged.n_desc, len(self.scatters), len(self.copies)))
        return staged

    inc = _fresh_encoder(20)
    engine = BatchEngine(device="cpu")

    def tile(tick, carry=None, node=None):
        if node is not None:
            old = cross([mk_node(node)])[0]
            new = cross([mk_node(node, cpu=3000)])[0]
            inc.on_node_update(old, new)
        pods = cross([mk_pod(f"s-{tick}-{j}", cpu=300, phase="Pending")
                      for j in range(6)])
        enc = inc.encode_tile(pods, [], [])
        monkeypatch.setattr(scatter_kernel.Prologue, "stage", recording)
        got, state = engine.run_chunked(enc, 4, state_override=carry)
        monkeypatch.setattr(scatter_kernel.Prologue, "stage", real)
        full = BatchEngine(device="cpu")
        full.delta_uploads = False
        want, _ = full.run_chunked(enc, 4, state_override=carry)
        assert np.array_equal(got, want) and (got >= 0).all()
        inc.assume_assigned(enc, pods, got)
        return state

    tile(0)
    assert calls == [(13, 0, 13)]
    state = tile(1, node="n-003")
    assert calls[-1] == (12 + 8 + 13, 2, 13)
    tile(2, carry=state, node="n-007")
    assert calls[-1] == (12 + 13, 1, 13)
    engine.delta_uploads = False
    tile(3)
    assert calls[-1] == (0, 0, 0)
    assert len(calls) == 4
    stats = engine.upload_stats
    assert (stats["full_tiles"], stats["delta_tiles"]) == (2, 2)
