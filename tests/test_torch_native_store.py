"""The port's native store (kubernetes_tpu_torch/core/native_store.py,
native/kvstore.cc, native/build.py) against the JAX package's.

tests/test_native_store.py runs on the port as it stands (its source
compiled with every `kubernetes_tpu.` import pointed at
`kubernetes_tpu_torch.`), all but its build-staleness class: the
port's builder keys the library by a hash of the source and raises on
any failure, tested below. Then the two packages' NativeStores answer
one seeded op script (CRUD, CAS, TTL, watch replay and window expiry,
`create_batch`, `commit_txn`) alike; the port's library is built under
`kubernetes_tpu_torch/_build/` and no `kubernetes_tpu/native/` path is
among a process's loaded libraries (in a subprocess: this one has the
JAX package loaded); and a failed build raises with the compiler's
output."""

import json
import os
import random
import re
import subprocess
import sys
import time
from dataclasses import replace as dc_replace

import pytest

from kubernetes_tpu.core import native_store as jax_ns
from kubernetes_tpu.core import types as jax_api
from kubernetes_tpu.core.errors import ApiError as JaxApiError
from kubernetes_tpu.core.scheme import default_scheme as jax_scheme
from kubernetes_tpu_torch.core import native_store as port_ns
from kubernetes_tpu_torch.core.errors import ApiError as PortApiError
from kubernetes_tpu_torch.core.scheme import default_scheme as port_scheme
from kubernetes_tpu_torch.native import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JAX_TESTS = os.path.join(REPO, "tests", "test_native_store.py")
with open(_JAX_TESTS) as _f:
    _SOURCE = _f.read()
assert _SOURCE.count("from kubernetes_tpu.") >= 4
_SOURCE = re.sub(r",\s*native_available\n", "\n", _SOURCE)
assert "import NativeStore, native_available" not in _SOURCE


def native_available():
    return True


exec(compile(_SOURCE.replace("from kubernetes_tpu.",
                             "from kubernetes_tpu_torch."),
             _JAX_TESTS, "exec"))
del TestBuildStaleness  # noqa: F821 (the JAX builder's contract)

PKGS = {"jax": (jax_ns, jax_scheme, JaxApiError),
        "port": (port_ns, port_scheme, PortApiError)}


def _wire(rng, name):
    return jax_scheme.encode_dict(jax_api.Pod(
        metadata=jax_api.ObjectMeta(name=name, namespace="default",
                                    labels={"a": str(rng.randrange(3))}),
        spec=jax_api.PodSpec(containers=[jax_api.Container(
            name="c", image=f"i{rng.randrange(4)}")])))


def play(pkg, seed, n=60):
    """One seeded op script on a fresh NativeStore of `pkg` -> the list
    of answers, each a plain value (wire dicts, revisions, error kinds),
    plus the final listing and a watch replayed from revision 0."""
    ns, scheme, api_error = PKGS[pkg]
    rng = random.Random(seed)
    s = ns.NativeStore(window=40)
    out, names, serial = [], [], 0

    def key(x):
        return f"/registry/pods/default/{x}"

    def bind(node):
        return lambda p: dc_replace(p, spec=dc_replace(p.spec,
                                                       node_name=node))

    def answer(fn):
        try:
            r = fn()
        except api_error as e:
            return ["error", type(e).__name__]
        if isinstance(r, list):
            return [scheme.encode_dict(o) for o in r]
        return scheme.encode_dict(r) if r is not None else None

    for _ in range(n):
        op = rng.choice(["create", "create", "dup", "get", "cas",
                         "stale_cas", "bind", "delete", "missing",
                         "batch", "txn", "txn_missing", "create_batch",
                         "ttl"])
        if op in ("create", "ttl") or len(names) < 3:
            name = f"p{serial}"
            serial += 1
            ttl = 3600.0 if op == "ttl" else None
            names.append(name)
            w = _wire(rng, name)
            out.append(answer(lambda: s.create(key(name),
                                               scheme.decode_dict(w),
                                               ttl=ttl)))
        elif op == "dup":
            name = rng.choice(names)
            w = _wire(rng, name)
            out.append(answer(lambda: s.create(key(name),
                                               scheme.decode_dict(w))))
        elif op == "get":
            out.append(answer(lambda: s.get(key(rng.choice(names)))))
        elif op in ("cas", "stale_cas"):
            name = rng.choice(names)
            cur = s.get(key(name))
            if op == "stale_cas":
                cur = dc_replace(cur, metadata=dc_replace(
                    cur.metadata, resource_version="1"))
            new = dc_replace(cur, metadata=dc_replace(
                cur.metadata, labels={"u": str(rng.randrange(9))}))
            out.append(answer(lambda: s.update(key(name), new)))
        elif op == "bind":
            name, node = rng.choice(names), f"n{rng.randrange(4)}"
            out.append(answer(lambda: s.guaranteed_update(key(name),
                                                          bind(node))))
        elif op == "delete":
            name = names.pop(rng.randrange(len(names)))
            out.append(answer(lambda: s.delete(key(name))))
        elif op == "missing":
            out.append(answer(lambda: s.delete(key("ghost"))))
        elif op in ("batch", "txn", "txn_missing"):
            pick = rng.sample(names, min(len(names), 3))
            if op == "txn_missing":
                pick.append("ghost")
            node = f"n{rng.randrange(4)}"
            verb = s.batch if op == "batch" else s.commit_txn
            out.append(answer(lambda: verb([(key(x), bind(node))
                                            for x in pick])))
        else:
            batch = [f"p{serial + i}" for i in range(3)]
            if rng.random() < 0.3:
                batch.append(batch[0])      # intra-batch duplicate
            serial += 3
            wires = [_wire(rng, x) for x in batch]
            out.append(answer(lambda: s.create_batch(
                [(key(x), scheme.decode_dict(w), None)
                 for x, w in zip(batch, wires)])))
            if len(set(batch)) == len(batch):
                names += batch
        out.append(s.current_revision)
    s.publish_flush()
    items, rev = s.list("/registry/pods/")
    listing = [rev, [scheme.encode_dict(o) for o in items]]
    # watch replay from inside the window, and from before it (window 40)
    w = s.watch("/registry/pods/", since_rev=rev - 10)
    replay = []
    for _ in range(10):
        ev = w.next(timeout=2)
        replay.append([ev.type, scheme.encode_dict(ev.object)])
    w.stop()
    try:
        s.watch("/registry/pods/", since_rev=1)
        expired = None
    except api_error as e:
        expired = type(e).__name__
    s.close()
    return out, listing, replay, expired


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_seeded_op_script_answers_alike(seed):
    j, p = play("jax", seed), play("port", seed)
    assert p[0] == j[0]
    assert p[1] == j[1]
    assert p[2] == j[2]
    assert p[3] == j[3] == "Expired"


def test_ttl_expiry_alike():
    """A key past its TTL is gone in both, and the read that found it
    dead committed the expiry as a revision in both."""
    revs = {}
    for pkg, (ns, scheme, api_error) in PKGS.items():
        s = ns.NativeStore()
        s.create("/registry/events/default/e",
                 scheme.decode_dict(jax_scheme.encode_dict(jax_api.Event(
                     metadata=jax_api.ObjectMeta(name="e",
                                                 namespace="default")))),
                 ttl=0.05)
        time.sleep(0.08)
        with pytest.raises(api_error):
            s.get("/registry/events/default/e")
        revs[pkg] = s.current_revision
        s.close()
    assert revs["jax"] == revs["port"] == 2


def test_port_library_is_its_own_build():
    """The port loads the library it built from its own kvstore.cc under
    kubernetes_tpu_torch/_build/, never the JAX package's."""
    child = (
        "import json\n"
        "from kubernetes_tpu_torch.core.native_store import NativeStore\n"
        "s = NativeStore()\n"
        "maps = [l.split()[-1] for l in open('/proc/self/maps')\n"
        "        if 'kvstore' in l]\n"
        "print(json.dumps({'lib': s._lib._name, 'maps': sorted(set(maps))}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", child], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    build_dir = os.path.join(REPO, "kubernetes_tpu_torch", "_build")
    assert res["lib"] == build.library_path(port_ns._SRC)
    assert os.path.dirname(res["lib"]) == build_dir
    assert res["maps"] == [res["lib"]]
    assert not any(os.path.join("kubernetes_tpu", "native") in m
                   for m in res["maps"])
    # the source is the port's own copy of the JAX package's engine
    assert port_ns._SRC == os.path.join(REPO, "kubernetes_tpu_torch",
                                        "native", "kvstore.cc")


def test_build_failure_raises_with_compiler_output(tmp_path):
    bad = tmp_path / "bad.cc"
    bad.write_text("int main( { return 0; }\n")
    with pytest.raises(build.NativeBuildError) as e:
        build.build_native(str(bad), build_dir=str(tmp_path / "out"))
    assert "bad.cc" in str(e.value) and "error" in str(e.value)
    assert not os.listdir(tmp_path / "out")   # no torn library left
    with pytest.raises(build.NativeBuildError):
        build.build_native(str(tmp_path / "absent.cc"),
                           build_dir=str(tmp_path / "out"))
    with pytest.raises(build.NativeBuildError):
        build.build_native(str(bad), compiler="no-such-compiler",
                           build_dir=str(tmp_path / "out"))


def test_build_is_keyed_by_the_source(tmp_path):
    """A changed source builds a new library; an unchanged one is not
    compiled again (the key is a hash of the source and the flags)."""
    log = tmp_path / "compiles.log"
    fake = tmp_path / "fake-cc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import shutil, sys\n"
        f"open({str(log)!r}, 'a').write('x\\n')\n"
        "shutil.copyfile(sys.argv[-3], sys.argv[-1])\n")
    fake.chmod(0o755)
    src = tmp_path / "x.cc"
    src.write_text("v1")
    out_dir = str(tmp_path / "out")
    a = build.build_native(str(src), compiler=str(fake), build_dir=out_dir)
    assert build.build_native(str(src), compiler=str(fake),
                              build_dir=out_dir) == a
    assert len(log.read_text().splitlines()) == 1
    src.write_text("v2")
    b = build.build_native(str(src), compiler=str(fake), build_dir=out_dir)
    assert b != a and open(b).read() == "v2"
    assert len(log.read_text().splitlines()) == 2


@pytest.mark.parametrize("journaled", [False, True])
def test_commit_windows_survive_concurrent_writers(tmp_path, journaled):
    """A bind tile's commit_txn and a journaled create_batch pre-assign
    their revision windows; writers hammering other keys (status
    updates, heartbeats, creates) must not claim those windows until
    the commit gives up: every tile commits, whole, at consecutive
    revisions. The interpreter's switch interval is shortened so the
    writers interleave with the staging."""
    import threading
    from kubernetes_tpu_torch.core.native_store import NativeStore
    s = NativeStore(wal_dir=str(tmp_path / "wal") if journaled else None)
    scheme = port_scheme
    wire = jax_scheme.encode_dict(jax_api.Pod(
        metadata=jax_api.ObjectMeta(name="x", namespace="default"),
        spec=jax_api.PodSpec(containers=[jax_api.Container(name="c",
                                                           image="i")])))

    def pod(name):
        p = scheme.decode_dict(wire)
        return dc_replace(p, metadata=dc_replace(p.metadata, name=name))

    s.create_batch([(f"/registry/pods/default/t{i}", pod(f"t{i}"), None)
                    for i in range(600)])
    for w in range(4):
        s.create(f"/registry/pods/default/w{w}", pod(f"w{w}"))
    stop = threading.Event()
    errors = []

    def writer(w):
        key, i = f"/registry/pods/default/w{w}", 0
        try:
            while not stop.is_set():
                i += 1
                s.guaranteed_update(key, lambda p: dc_replace(
                    p, metadata=dc_replace(p.metadata,
                                           labels={"n": str(i)})))
                s.create_batch([(f"/registry/pods/default/c{w}-{i}",
                                 pod(f"c{w}-{i}"), None)])
        except Exception as e:            # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=writer, args=(w,))
               for w in range(4)]
    try:
        for t in threads:
            t.start()
        for node in ("n1", "n2", "n3"):
            out = s.commit_txn([
                (f"/registry/pods/default/t{i}",
                 lambda p, node=node: dc_replace(
                     p, spec=dc_replace(p.spec, node_name=node)))
                for i in range(600)])
            revs = [int(o.metadata.resource_version) for o in out]
            assert revs == list(range(revs[0], revs[0] + 600))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert all(s.get(f"/registry/pods/default/t{i}").spec.node_name == "n3"
               for i in range(600))
    s.close()


@pytest.mark.parametrize("journaled", [False, True])
def test_commit_txn_takes_the_native_commit_path(tmp_path, journaled):
    """commit_txn has one path, journaled or not: a tile is one
    kv_commit_txn (the engine's commit counter moves by one a tile; a
    journal gains one TXN frame a tile), and its events reach a watcher
    through the publisher ring in revision order."""
    from kubernetes_tpu_torch.core.native_store import NativeStore
    s = NativeStore(wal_dir=str(tmp_path / "wal") if journaled else None)
    wire = jax_scheme.encode_dict(jax_api.Pod(
        metadata=jax_api.ObjectMeta(name="x", namespace="default"),
        spec=jax_api.PodSpec(containers=[jax_api.Container(name="c",
                                                           image="i")])))
    keys = [f"/registry/pods/default/t{i}" for i in range(5)]
    for i, key in enumerate(keys):
        p = port_scheme.decode_dict(wire)
        s.create(key, dc_replace(p, metadata=dc_replace(p.metadata,
                                                        name=f"t{i}")))
    w = s.watch("/registry/pods/", since_rev=s.current_revision)
    before = s.publish_stats()
    for node in ("n1", "n2"):
        out = s.commit_txn([(k, lambda p, node=node: dc_replace(
            p, spec=dc_replace(p.spec, node_name=node))) for k in keys])
        assert [o.spec.node_name for o in out] == [node] * 5
    after = s.publish_stats()
    assert after["commits"] - before["commits"] == 2
    assert after["wal_frames"] - before["wal_frames"] == (2 if journaled
                                                          else 0)
    s.publish_flush()
    got = []
    deadline = time.monotonic() + 10
    while len(got) < 10 and time.monotonic() < deadline:
        ev = w.next(timeout=1.0)
        if ev is not None:
            got.append(ev)
    w.stop()
    assert [int(e.object.metadata.resource_version) for e in got] == \
        list(range(before["revision"] + 1, before["revision"] + 11))
    assert [e.object.spec.node_name for e in got] == ["n1"] * 5 + ["n2"] * 5
    s.close()


def test_profile_window_arms_run_on_the_cpu(capsys):
    """kubemark/profile_window.py at a small size on the CPU: both arms
    run the durable e2e over the native store and bind every pod, and
    the store keeps its lock afterwards."""
    from kubernetes_tpu_torch.core.native_store import NativeStore
    from kubernetes_tpu_torch.kubemark import profile_window
    init = NativeStore.__init__
    assert profile_window.main(["--cpu", "--nodes", "10", "--pods", "60",
                                "--rounds", "1"]) == 0
    assert NativeStore.__init__ is init
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["arm"] for r in lines[:4]] == ["lock", "open", "open", "lock"]
    assert all(r["ok"] and r["scheduled"] == 60 for r in lines[:4])
    summary = lines[4]
    assert summary["device"] == "cpu" and "card" not in summary
    assert summary["lock"]["runs"] == summary["open"]["runs"] == 2
    s = NativeStore()
    assert isinstance(s._window, type(__import__("threading").RLock()))
    s.close()


@pytest.mark.parametrize("verb", ["guaranteed_update", "batch"])
def test_unjournaled_cas_writers_never_run_out_of_retries(verb):
    """The unjournaled guaranteed_update and batch read, apply fn, encode
    and CAS under one hold of the store's lock: four threads of 25
    writes each reach 100 on one key in every one of 50 rounds (a writer
    that read outside the lock queued on it with a stale revision, and
    some rounds ran out of retries)."""
    import threading
    from kubernetes_tpu_torch.core.native_store import NativeStore
    wire = jax_scheme.encode_dict(jax_api.Pod(
        metadata=jax_api.ObjectMeta(name="ctr", namespace="default"),
        spec=jax_api.PodSpec(containers=[jax_api.Container(name="c",
                                                           image="i")])))
    key = "/registry/pods/default/ctr"

    def bump(cur):
        labels = dict(cur.metadata.labels)
        labels["n"] = str(int(labels.get("n", "0")) + 1)
        return dc_replace(cur, metadata=dc_replace(cur.metadata,
                                                   labels=labels))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    lost = []
    try:
        for rnd in range(50):
            s = NativeStore()
            s.create(key, port_scheme.decode_dict(wire))
            errors = []

            def worker():
                try:
                    for _ in range(25):
                        if verb == "batch":
                            s.batch([(key, bump)])
                        else:
                            s.guaranteed_update(key, bump)
                except Exception as e:        # counted below
                    errors.append(e)
            threads = [threading.Thread(target=worker) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors or s.get(key).metadata.labels["n"] != "100":
                lost.append((rnd, [type(e).__name__ for e in errors]))
            s.close()
    finally:
        sys.setswitchinterval(old)
    assert lost == []
