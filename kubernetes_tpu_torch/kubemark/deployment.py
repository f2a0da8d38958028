"""The durable store and the split-process deployment, driven end to end.

`run_durable_e2e` runs the kubemark benchmark's live pipeline
(gpu_evidence.section_e2e) over a store that writes a WAL — the
pure-Python Store or the native C++ store — then closes the journal,
recovers a second store from the directory and holds it to the live one:
the same revision, and every pod's node and resourceVersion (every
acknowledged bind is read back).

`run_split` runs the deployment the north star describes, one OS process
a component (`python -m kubernetes_tpu_torch`): an apiserver over the
native store, a hollow fleet and the batch scheduler, all over HTTP. It
writes identical pods in batch POSTs of 128 (kubemark/slo.py's writer),
waits for every pod to be Running, checks the bindings and stops each
child with SIGTERM.

Both take `device`/`cpu` like the port's other entry points: the batch
engine runs on the CUDA device unless the CPU is asked for.
"""

from __future__ import annotations

import json
import os
import select
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
POD_PREFIX = "/registry/pods/default/"


def _bindings(store) -> Dict[str, tuple]:
    items, _rev = store.list(POD_PREFIX)
    return {p.metadata.name: (p.spec.node_name,
                              p.metadata.resource_version) for p in items}


def _settle(store, quiet_s: float = 1.0, timeout_s: float = 60.0) -> int:
    """Wait until the store's revision has not moved for quiet_s: the
    benchmark's components stop when it returns, but a fleet's status
    pump may still drain its queue for a moment. -> the revision."""
    deadline = time.monotonic() + timeout_s
    rev, since = store.current_revision, time.monotonic()
    while time.monotonic() < deadline:
        time.sleep(0.1)
        now = store.current_revision
        if now != rev:
            rev, since = now, time.monotonic()
        elif time.monotonic() - since >= quiet_s:
            return rev
    raise AssertionError(f"the store kept writing past {timeout_s}s "
                         f"(revision {rev})")


def run_durable_e2e(n_nodes: int, n_pods: int, backend: str = "python",
                    device=None, timeout_s: float = 900.0) -> dict:
    """The live pipeline over a journaled store, then its recovery.

    backend: "python" (Store(wal_dir, fsync_policy="batch")) or "native"
    (NativeStore(wal_dir, fsync_policy="batch")); the same backend
    recovers, from a temporary directory removed afterwards.
    -> section_e2e's record plus the journal's
    frames and bytes, the recovery's seconds and records, and
    `recovered_equal` (raises if the recovered store differs)."""
    from ..api.registry import Registry
    from ..core.native_store import NativeStore
    from ..core.store import Store
    from .gpu_evidence import section_e2e

    wal_dir = tempfile.mkdtemp(prefix="wal-")
    try:
        if backend == "python":
            cls, store = Store, Store(wal_dir=wal_dir, fsync_policy="batch")
        elif backend == "native":
            cls = NativeStore
            store = NativeStore(wal_dir=wal_dir, fsync_policy="batch")
        else:
            raise ValueError(f"unknown backend {backend!r}")
        sec = section_e2e(n_nodes, n_pods, device=device,
                          timeout_s=timeout_s,
                          registry=Registry(store=store))
        # let the last writes land, then close the journal: every
        # acknowledged write is on disk
        _settle(store)
        if backend == "python":
            live = _bindings(store)
            live_rev = store.current_revision
            frames = store._wal.frames_written
            wal_bytes = store._wal.bytes_written
            store.wal_close()
        else:
            store.publish_flush()
            live = _bindings(store)
            live_rev = store.current_revision
            stats = store.publish_stats()
            frames, wal_bytes = stats["wal_frames"], stats["wal_bytes"]
            store.close()
        disk = sum(os.path.getsize(os.path.join(wal_dir, f))
                   for f in os.listdir(wal_dir))
        t0 = time.monotonic()
        rec = cls.recover(wal_dir)
        seconds = time.monotonic() - t0
        got = _bindings(rec)
        rec_rev = rec.current_revision
        stats = rec.recovery_stats
        if backend == "python":
            rec.wal_close()
        else:
            rec.close()
        if rec_rev != live_rev or got != live:
            differ = sorted(k for k in set(live) | set(got)
                            if live.get(k) != got.get(k))
            raise AssertionError(
                f"{backend} recovery: revision {rec_rev} against "
                f"{live_rev}, {len(differ)} pods differ: {differ[:5]}")
        unbound = sum(1 for node, _rv in live.values() if not node)
        return {**sec, "backend": backend, "revision": live_rev,
                "pods_live": len(live), "pods_unbound": unbound,
                "wal_frames": frames, "wal_bytes": wal_bytes,
                "wal_disk_bytes": disk,
                "snapshot_rev": stats["snapshot_rev"],
                "replayed_records": stats["replayed_records"],
                "recovery_s": seconds,
                "replayed_per_s": stats["replayed_records"] / seconds,
                "recovered_equal": True}
    finally:
        shutil.rmtree(wal_dir, ignore_errors=True)


# ----------------------------------------------------------- split run

class Child:
    """One component process: started, waited on for its READY line,
    its output drained into `lines` (a chatty child must never block on
    a full pipe), stopped with SIGTERM."""

    def __init__(self, component: str, *flags: str, log_dir: str):
        self.component = component
        self.err_path = os.path.join(log_dir, f"{component}.err")
        self._err = open(self.err_path, "w")
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kubernetes_tpu_torch", component,
             *flags],
            stdout=subprocess.PIPE, stderr=self._err, text=True, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": ROOT,
                 "PYTHONFAULTHANDLER": "1"})
        self.ready_line = ""
        self.startup_s = None
        self.lines: List[str] = []
        self._drain = None

    @property
    def pid(self) -> int:
        return self.proc.pid

    def stderr_tail(self, n: int = 2000) -> str:
        if not self._err.closed:
            self._err.flush()
        with open(self.err_path) as f:
            return f.read()[-n:]

    def wait_ready(self, timeout_s: float = 300.0) -> str:
        ready, _, _ = select.select([self.proc.stdout], [], [], timeout_s)
        line = self.proc.stdout.readline() if ready else ""
        if " ready" not in line:
            self.proc.kill()
            self.proc.wait(timeout=10)
            raise RuntimeError(
                f"{self.component}: no READY line within {timeout_s}s "
                f"(exit {self.proc.returncode}): {self.stderr_tail()}")
        self.startup_s = time.monotonic() - self.t0
        self.ready_line = line.strip()

        def drain():
            for line in self.proc.stdout:
                self.lines.append(line.strip())
        self._drain = threading.Thread(target=drain, daemon=True)
        self._drain.start()
        return self.ready_line

    def terminate(self, timeout_s: float = 120.0) -> int:
        """SIGTERM -> the exit code; a child that does not exit in time
        gets SIGABRT (PYTHONFAULTHANDLER dumps its stacks to stderr)
        and then SIGKILL, and is reported as a failure."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.proc.send_signal(signal.SIGABRT)
                try:
                    self.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    self.proc.kill()
                    self.proc.wait(timeout=10)
                self._err.close()
                raise RuntimeError(
                    f"{self.component} did not exit within {timeout_s}s "
                    f"of SIGTERM: {self.stderr_tail(4000)}")
        if self._drain is not None:
            self._drain.join(timeout=10)   # its last lines, to EOF
        self._err.close()
        return self.proc.returncode

    def exit_record(self, tag: str):
        """The JSON object on the child's last stdout line that starts
        with `<component> <tag> ` (read after terminate), or None."""
        head = f"{self.component} {tag} "
        for line in reversed(self.lines):
            if line.startswith(head):
                return json.loads(line[len(head):])
        return None


def gpu_processes() -> List[List[int]]:
    """nvidia-smi's compute processes on the card: [pid, used MiB] each.
    In a container the pids are the host's view (a process of another
    pid namespace may be listed under a pid that is not its own here),
    so a caller also counts the entries."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30, check=True)
    return [[int(f) for f in line.split(",")]
            for line in out.stdout.splitlines() if line.strip()]


def _node_capacity(node) -> tuple:
    cap = node.status.allocatable or node.status.capacity
    return cap["pods"].value, cap["cpu"].milli, cap["memory"].value


def _pod_requests(pod) -> tuple:
    cpu = mem = 0
    for c in pod.spec.containers:
        req = c.resources.requests or {}
        if "cpu" in req:
            cpu += req["cpu"].milli
        if "memory" in req:
            mem += req["memory"].value
    return cpu, mem


def run_split(n_nodes: int, n_pods: int, cpu: bool = False,
              timeout_s: float = 600.0) -> dict:
    """The split deployment: apiserver (native store, namespace
    auto-provisioning) | hollow-fleet (its default node: 4 CPU, 32Gi,
    40 pods) | scheduler (batch mode, no bind rate limit; `--cpu` when
    cpu), started in that order, each after the previous one's READY
    line; then n_pods identical bench pods POSTed in batches of 128.
    Raises unless every pod is bound once and Running on a node that
    exists, no node over its capacity, every child exits 0 on SIGTERM,
    and the scheduler ran where it was asked to: its READY line names
    the device (`device=cpu` with cpu, else `device=cuda`), and on the
    card its exit line (`scheduler launches {...}`) counts at least one
    launch of K1 (scan_chunk) and of K3 (scatter_prologue), and
    nvidia-smi lists its pid among the compute processes or one more of
    them than before it started (in a container nvidia-smi may list the
    host's pids).
    -> the record: seconds from the first POST to the last POST
    returned, to the last binding seen and to the last pod Running,
    pods/s (to Running), each component's start-up seconds, the
    scheduler's kernel launches, the per-node counts digest
    (fixtures.node_counts_digest)."""
    from ..api.client import HttpClient
    from .benchmark import _bench_pod
    from .fixtures import node_counts_digest

    log_dir = tempfile.mkdtemp(prefix="split-")
    children: List[Child] = []
    watcher = None
    out: dict = {"nodes": n_nodes, "pods": n_pods, "cpu": cpu}
    try:
        api = Child("apiserver", "--port", "0", "--storage-backend",
                    "native", "--admission-control",
                    "NamespaceAutoProvision", log_dir=log_dir)
        children.append(api)
        url = api.wait_ready().split()[-1]
        fleet = Child("hollow-fleet", "--master", url, "--num-nodes",
                      str(n_nodes), "--heartbeat-interval", "60",
                      log_dir=log_dir)
        children.append(fleet)
        fleet.wait_ready()
        before = [] if cpu else gpu_processes()
        sched = Child("scheduler", "--master", url, "--mode", "batch",
                      "--no-rate-limit", *(["--cpu"] if cpu else []),
                      log_dir=log_dir)
        children.append(sched)
        sched.wait_ready()

        client = HttpClient(url)
        running_at: Dict[str, float] = {}
        bound_to: Dict[str, str] = {}
        bound_at: Dict[str, float] = {}
        rebinds: List[str] = []
        all_running = threading.Event()
        watcher = client.watch("pods", "default")

        def track():
            for ev in watcher:
                pod = ev.object
                if ev.type in ("DELETED", "ERROR"):
                    continue
                name, node = pod.metadata.name, pod.spec.node_name
                if node:
                    prev = bound_to.setdefault(name, node)
                    if prev != node:
                        rebinds.append(name)
                    bound_at.setdefault(name, time.monotonic())
                if pod.status.phase == "Running" and name not in running_at:
                    running_at[name] = time.monotonic()
                    if len(running_at) >= n_pods:
                        all_running.set()

        threading.Thread(target=track, daemon=True).start()
        start = time.monotonic()
        for base in range(0, n_pods, 128):
            client.create_batch(
                "pods", [_bench_pod(i) for i in range(
                    base, min(base + 128, n_pods))], "default")
        posted = time.monotonic() - start
        all_running.wait(timeout=timeout_s)
        elapsed = (max(running_at.values()) - start) if running_at else None
        bound_s = (max(bound_at.values()) - start) if bound_at else None
        if not cpu:
            # the scheduler holds a CUDA context: its pid is listed, or,
            # where nvidia-smi cannot name this namespace's pids, one
            # more compute process than before it started (alone this
            # would not tell the scheduler from any other CUDA process:
            # its own launch counts, read at its exit, do)
            after = gpu_processes()
            out["gpu_processes"] = {"before": before, "after": after}
            out["scheduler_on_card"] = (
                sched.pid in [p for p, _mib in after]
                or len(after) == len(before) + 1)
        watcher.stop()
        watcher = None

        pods, _ = client.list("pods", "default")
        nodes, _ = client.list("nodes")
        by_name = {n.metadata.name: n for n in nodes}
        used: Dict[str, list] = {}
        missing = []
        for p in pods:
            node = p.spec.node_name
            if node not in by_name:
                missing.append(p.metadata.name)
                continue
            u = used.setdefault(node, [0, 0, 0])
            c, m = _pod_requests(p)
            u[0] += 1
            u[1] += c
            u[2] += m
        over = [n for n, u in used.items()
                if any(a > b for a, b in zip(u, _node_capacity(by_name[n])))]
        running = sum(1 for p in pods if p.status.phase == "Running")
        sha, counted = node_counts_digest(
            list(by_name), [p.spec.node_name for p in pods])
        out.update({
            "post_s": posted, "bound_s": bound_s, "elapsed_s": elapsed,
            "pods_per_sec": (n_pods / elapsed) if elapsed else None,
            "startup_s": {c.component: c.startup_s for c in children},
            "scheduler_ready": sched.ready_line,
            "pods_listed": len(pods), "running": running,
            "bound_seen": len(bound_to), "rebinds": len(rebinds),
            "unknown_node": len(missing), "over_capacity": len(over),
            "nodes_listed": len(nodes), "counts_sha256": sha,
            "counts_bound": counted})
    finally:
        if watcher is not None:
            watcher.stop()
        codes, errors = {}, []
        for c in reversed(children):
            try:
                codes[c.component] = c.terminate()
                if codes[c.component] != 0:
                    errors.append(f"{c.component} exited "
                                  f"{codes[c.component]}: "
                                  f"{c.stderr_tail()}")
            except Exception as e:
                errors.append(repr(e))
        out["exit_codes"] = codes
        if children and children[-1].component == "scheduler":
            out["scheduler_launches"] = children[-1].exit_record(
                "launches")
        tails = {c.component: c.stderr_tail(1500) for c in children}
        shutil.rmtree(log_dir, ignore_errors=True)
    if errors:
        raise AssertionError(f"split: {errors}")
    bad = (out["pods_listed"] != n_pods or out["running"] != n_pods
           or out["bound_seen"] != n_pods or out["rebinds"]
           or out["unknown_node"] or out["over_capacity"]
           or out["nodes_listed"] != n_nodes
           or out["counts_bound"] != n_pods
           or not out["scheduler_ready"].endswith(
               "device=cpu" if cpu else "device=cuda")
           or out["scheduler_launches"] is None
           or not (cpu or (out["scheduler_on_card"]
                           and out["scheduler_launches"]["scan_chunk"] >= 1
                           and out["scheduler_launches"][
                               "scatter_prologue"] >= 1)))
    if bad:
        raise AssertionError(f"split: {out}; the children's stderr: "
                             f"{tails}")
    return out
