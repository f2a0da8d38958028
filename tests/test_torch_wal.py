"""The port's write-ahead log and Store recovery (kubernetes_tpu_torch/
core/wal.py, core/store.py) against the JAX package's.

tests/test_wal.py runs on the port as it stands: its source is compiled
here with every `kubernetes_tpu.` import pointed at
`kubernetes_tpu_torch.` (the port builds its native store or raises, so
the JAX file's `native_available` probe is always true here), less the
test of `NativeStore(native_publish=False)`, an option the port does not
have. Then the
two packages side by side on one seeded script of creates, sets,
updates, guaranteed updates, deletes, TTLs, batches and `commit_txn`
tiles: the WAL files are byte-equal; a WAL written by either package is
recovered by the other into wire-equal objects at the same revision; a
torn final TXN frame truncates on both sides; rotation and snapshots at
small `wal_segment_records` / `wal_snapshot_records` agree file for
file. The durable e2e (kubemark/deployment.run_durable_e2e) runs small
on the CPU over both backends."""

import os
import random
import re
import time
from dataclasses import replace as dc_replace

import pytest

from kubernetes_tpu.core import store as jax_store
from kubernetes_tpu.core import types as jax_api
from kubernetes_tpu.core import wal as jax_wal
from kubernetes_tpu.core.scheme import default_scheme as jax_scheme
from kubernetes_tpu.utils.clock import FakeClock as JaxClock
from kubernetes_tpu_torch.core import store as port_store
from kubernetes_tpu_torch.core import wal as port_wal
from kubernetes_tpu_torch.core.scheme import default_scheme as port_scheme
from kubernetes_tpu_torch.utils.clock import FakeClock as PortClock

_JAX_TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "test_wal.py")
with open(_JAX_TESTS) as _f:
    _SOURCE = _f.read()
assert _SOURCE.count("from kubernetes_tpu.") >= 5
_SOURCE = re.sub(r",\s*native_available\)", ")", _SOURCE)
assert "native_available)" not in _SOURCE
# The port's NativeStore has one commit path (kv_commit_txn) and no
# `native_publish` option, so the JAX test that the option's control arm
# refuses a WAL has no behaviour to test here.
_SOURCE, _n = re.subn(
    r"\n    def test_native_wal_requires_commit_path\(self, tmp_path\):\n"
    r"(?:        .*\n|\n(?=        ))*", "\n", _SOURCE)
assert _n == 1 and "native_publish" not in _SOURCE


def native_available():
    return True


exec(compile(_SOURCE.replace("from kubernetes_tpu.",
                             "from kubernetes_tpu_torch."),
             _JAX_TESTS, "exec"))

PKGS = {"jax": (jax_store, jax_wal, jax_scheme, JaxClock),
        "port": (port_store, port_wal, port_scheme, PortClock)}
EPOCH = time.time()   # both stores' clocks start here: equal expiries


def seeded_script(seed, n=30):
    """A list of ops as plain data (objects as wire dicts made with the
    JAX package), so that either package can play it."""
    rng = random.Random(seed)

    def wire(name, node=""):
        pod = jax_api.Pod(
            metadata=jax_api.ObjectMeta(
                name=name, namespace="default",
                labels={"app": f"a{rng.randrange(3)}"}),
            spec=jax_api.PodSpec(node_name=node, containers=[
                jax_api.Container(name="c", image=f"img{rng.randrange(4)}")]))
        return jax_scheme.encode_dict(pod)

    ops, live, serial = [], [], 0
    for _ in range(n):
        kind = rng.choice(["create", "create", "create", "ttl", "set",
                           "update", "bind", "delete", "batch", "txn",
                           "create_batch"])
        if kind in ("create", "ttl") or len(live) < 4:
            name = f"p{serial}"
            serial += 1
            ttl = 3600.0 if kind == "ttl" else None
            ops.append(("create", name, wire(name), ttl))
            live.append(name)
        elif kind == "create_batch":
            names = [f"p{serial + i}" for i in range(3)]
            serial += 3
            ops.append(("create_batch", [(x, wire(x)) for x in names]))
            live += names
        elif kind == "set":
            name = rng.choice(live)
            ops.append(("set", name, wire(name)))
        elif kind == "update":
            ops.append(("update", rng.choice(live), f"v{rng.randrange(9)}"))
        elif kind == "bind":
            ops.append(("bind", rng.choice(live), f"n{rng.randrange(5)}"))
        elif kind == "delete":
            name = live.pop(rng.randrange(len(live)))
            ops.append(("delete", name))
        else:
            names = rng.sample(live, min(len(live), rng.randrange(2, 6)))
            ops.append((kind, names, f"n{rng.randrange(5)}"))
    return ops


def key(name):
    return f"/registry/pods/default/{name}"


def play(pkg, ops, wal_dir, **kw):
    """Run the script on a fresh Store of `pkg` journaling to wal_dir."""
    store_mod, _wal, scheme, clock = PKGS[pkg]
    s = store_mod.Store(wal_dir=wal_dir, clock=clock(start=EPOCH), **kw)

    def bind(node):
        return lambda p: dc_replace(p, spec=dc_replace(p.spec,
                                                       node_name=node))
    for op in ops:
        if op[0] == "create":
            s.create(key(op[1]), scheme.decode_dict(op[2]), ttl=op[3])
        elif op[0] == "create_batch":
            s.create_batch([(key(n), scheme.decode_dict(w), None)
                            for n, w in op[1]])
        elif op[0] == "set":
            s.set(key(op[1]), scheme.decode_dict(op[2]))
        elif op[0] == "update":
            cur = s.get(key(op[1]))
            s.update(key(op[1]), dc_replace(cur, metadata=dc_replace(
                cur.metadata, labels={"u": op[2]})))
        elif op[0] == "bind":
            s.guaranteed_update(key(op[1]), bind(op[2]))
        elif op[0] == "delete":
            s.delete(key(op[1]))
        elif op[0] == "batch":
            s.batch([(key(n), bind(op[2])) for n in op[1]])
        else:
            s.commit_txn([(key(n), bind(op[2])) for n in op[1]])
    s.wal_close()
    return s


def files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def ledger(pkg, store):
    """The store's state as plain data: revision, then each live key's
    mod revision, expiry and wire object, in the store's order."""
    scheme = PKGS[pkg][2]
    return (store.current_revision,
            [(k, rev, exp, scheme.encode_dict(obj))
             for k, (obj, rev, exp) in store._data.items()],
            dict(store._seg_writes), sorted(store._ttl_segs))


SEEDS = [0, 1, 2, 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_wal_frames_byte_equal(tmp_path, seed):
    ops = seeded_script(seed)
    play("jax", ops, str(tmp_path / "jax"))
    play("port", ops, str(tmp_path / "port"))
    fj, fp = files(str(tmp_path / "jax")), files(str(tmp_path / "port"))
    assert list(fj) == list(fp) and len(fj) >= 1
    assert fj == fp


def test_frame_codec_byte_equal():
    rng = random.Random(9)
    for _ in range(20):
        rec = [rng.randrange(1, 10**6), rng.choice(["ADDED", "MODIFIED",
                                                    "DELETED"]),
               f"/registry/pods/ns/p{rng.randrange(99)}",
               rng.choice([None, 1.5e9 + rng.random()]),
               {"metadata": {"name": "x", "labels": {"k": "é"}}}]
        assert port_wal.record_payload(*rec) == jax_wal.record_payload(*rec)
        assert port_wal.encode_record(*rec) == jax_wal.encode_record(*rec)
        assert port_wal.frame(b"abc") == jax_wal.frame(b"abc")
        txn = [rec, [rec[0] + 1] + rec[1:]]
        assert port_wal.txn_payload(txn) == jax_wal.txn_payload(txn)
        assert port_wal.encode_txn(txn) == jax_wal.encode_txn(txn)
    assert (port_wal._SEG_FMT, port_wal._SNAP_FMT) == (jax_wal._SEG_FMT,
                                                      jax_wal._SNAP_FMT)


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
@pytest.mark.parametrize("seed", SEEDS)
def test_cross_recovery(tmp_path, seed, writer, reader):
    """A WAL one package writes, the other recovers: wire-equal objects,
    the same revision, mod revisions, expiries and segment tokens."""
    ops = seeded_script(seed)
    d = str(tmp_path / "wal")
    live = play(writer, ops, d)
    got = PKGS[reader][0].Store.recover(d)
    assert ledger(reader, got) == ledger(writer, live)
    # the grouped reader sees the same frames in both packages
    assert port_wal.read_wal_grouped(d) == jax_wal.read_wal_grouped(d)
    got.wal_close()


@pytest.mark.parametrize("torn_by", ["jax", "port"])
def test_torn_final_txn_frame_truncates_on_both_sides(tmp_path, torn_by):
    """A TXN frame cut short at the tail drops whole on recovery, in
    either package, and the reader repairs the file for the other."""
    d = str(tmp_path / "wal")
    ops = [("create", f"t{i}", seeded_wire(f"t{i}"), None)
           for i in range(4)] + [("txn", [f"t{i}" for i in range(4)], "n1")]
    play(torn_by, ops, d)
    seg = sorted(f for f in os.listdir(d) if f.endswith(".seg"))[-1]
    path = os.path.join(d, seg)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 5)
    first, second = (("port", "jax") if torn_by == "jax"
                     else ("jax", "port"))
    r1 = PKGS[first][0].Store.recover(d)
    assert r1.current_revision == 4
    assert all(not o.spec.node_name for o, _r, _e in r1._data.values())
    r1.wal_close()
    r2 = PKGS[second][0].Store.recover(d)
    assert r2.current_revision == 4
    r2.wal_close()


def seeded_wire(name):
    return jax_scheme.encode_dict(jax_api.Pod(
        metadata=jax_api.ObjectMeta(name=name, namespace="default"),
        spec=jax_api.PodSpec(containers=[jax_api.Container(name="c",
                                                           image="i")])))


@pytest.mark.parametrize("seg,snap", [(3, 10), (4, 17), (7, 1000)])
def test_rotation_and_snapshot_agree(tmp_path, seg, snap):
    ops = seeded_script(5, n=40)
    kw = dict(wal_segment_records=seg, wal_snapshot_records=snap)
    play("jax", ops, str(tmp_path / "jax"), **kw)
    live = play("port", ops, str(tmp_path / "port"), **kw)
    fj, fp = files(str(tmp_path / "jax")), files(str(tmp_path / "port"))
    assert fj == fp
    if snap < 40:
        # compacted: a snapshot, and only the segments after it
        assert any(f.startswith("snap-") for f in fp)
    else:
        assert sum(f.endswith(".seg") for f in fp) >= 2
    for pkg in ("jax", "port"):
        r = PKGS[pkg][0].Store.recover(str(tmp_path / "port"))
        assert ledger(pkg, r) == ledger("port", live)
        r.wal_close()


@pytest.mark.parametrize("backend", ["python", "native"])
def test_durable_e2e_on_the_cpu(backend):
    """chip_smoke's durable and native phases, small: the live pipeline
    over a journaled store, every pod bound, the recovered store equal
    to the live one."""
    from kubernetes_tpu_torch.kubemark.deployment import run_durable_e2e
    r = run_durable_e2e(12, 60, backend, device="cpu", timeout_s=120)
    assert r["scheduled"] == 60 and r["pods_unbound"] == 0
    assert r["recovered_equal"] and r["pods_live"] == 60
    assert r["wal_frames"] >= 1 and r["wal_bytes"] >= r["wal_frames"]
    assert r["replayed_records"] + r["snapshot_rev"] >= r["revision"] > 0
