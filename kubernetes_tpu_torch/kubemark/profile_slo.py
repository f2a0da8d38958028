"""Where the density SLO run's time goes (kubemark/slo.py), on the card.

The run is host-bound: the API server's handler threads, the probers,
the pod writer, the hollow fleet, the informers and the batch scheduler
share one interpreter at a 1 ms switch interval. This tool runs
`run_density_slo` in arms, each in a child process of its own (a fresh
interpreter: neither the collector's state nor the kernels' load carries
over from one arm to the next), and reads in each:

- the run's result (`SLOResult.as_dict()`);
- the batch engine's host steps a tile: `run_chunked`, its `_prologue`
  and the staging buffer's typed views (`Staged.views`), calls, seconds
  and the longest;
- every GET of the node list the server served, split into the
  registry's list, the encode and the send, the warm-up LIST before the
  window marked as such (the window opens where the run enters
  `tuned_gc`);
- the collector's pauses (`gc.callbacks`), in the window (from the
  collector's tuning to the run's stop) and all;
- the GIL's wake lag: a thread that sleeps 1 ms and records how much
  later it runs again.

An arm is `VIEWS/COLLECTOR`: VIEWS `carve` (the tile's views carved once
a dtype, scatter_kernel.carve) or `per-array` (each array viewed from
the buffer by itself: a slice, a dtype view, a shape view); COLLECTOR
`tuned` (the run's own `tuned_gc` window) or `default` (the
interpreter's collector left as it is).

    python -m kubernetes_tpu_torch.kubemark.profile_slo
    python -m kubernetes_tpu_torch.kubemark.profile_slo --cpu --nodes 200 \\
        --pods 800 --arms carve/tuned

prints one JSON object with a record an arm. The default arms are
`per-array/tuned`, `carve/default` and `carve/tuned` at 5000 x 15000.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
from typing import List

ARMS = ("per-array/tuned", "carve/default", "carve/tuned")


def _per_array(buf, layout) -> List:
    """Each array viewed from the buffer by itself (three view ops)."""
    return [buf[off:off + math.prod(shape) * dtype.itemsize]
            .view(dtype).view(shape) for off, dtype, shape in layout]


class _Timer:
    def __init__(self):
        self.lock = threading.Lock()
        self.steps = {}

    def wrap(self, owner, name):
        fn = getattr(owner, name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                with self.lock:
                    rec = self.steps.setdefault(name, [0, 0.0, 0.0])
                    rec[0] += 1
                    rec[1] += dt
                    rec[2] = max(rec[2], dt)
        setattr(owner, name, timed)


def run_arm(arm: str, n_nodes: int, n_pods: int, device) -> dict:
    """One arm, in this process -> its record."""
    from ..api import server as server_mod
    from ..api.registry import Registry
    from ..core.scheme import Scheme
    from ..sched.device import engine, scatter_kernel
    from . import slo

    views, collector = arm.split("/")
    if views == "per-array":
        scatter_kernel.carve = _per_array
    elif views != "carve":
        raise ValueError(f"views {views!r}: carve or per-array")
    if collector not in ("tuned", "default"):
        raise ValueError(f"collector {collector!r}: tuned or default")

    t_base = time.perf_counter()
    window = {}
    real_tuned = slo.tuned_gc

    @contextlib.contextmanager
    def window_scope():
        # the window: from the collector's tuning (its own collection
        # done) to the run's stop (before the scope's closing one)
        with (real_tuned() if collector == "tuned"
              else contextlib.nullcontext()):
            window["open"] = time.perf_counter() - t_base
            try:
                yield
            finally:
                window["close"] = time.perf_counter() - t_base

    slo.tuned_gc = window_scope

    timer = _Timer()
    timer.wrap(engine.BatchEngine, "run_chunked")
    timer.wrap(engine.BatchEngine, "_prologue")
    timer.wrap(scatter_kernel.Staged, "views")

    # GET nodes: the handler's time split into list, encode and send
    local = threading.local()
    lists = []
    handle = server_mod.ApiServer.handle

    def handle_timed(self, h, method):
        if method != "GET" or not h.path.startswith("/api/v1/nodes"):
            return handle(self, h, method)
        local.rec = {"t": time.perf_counter() - t_base}
        t0 = time.perf_counter()
        try:
            return handle(self, h, method)
        finally:
            local.rec["total"] = time.perf_counter() - t0
            local.rec["warm_up"] = "open" not in window
            lists.append(local.rec)
            local.rec = None

    def part(fn, key):
        def timed(*a, **kw):
            rec = getattr(local, "rec", None)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if rec is not None:
                    rec[key] = rec.get(key, 0.0) + time.perf_counter() - t0
        return timed

    server_mod.ApiServer.handle = handle_timed
    Registry.list = part(Registry.list, "list")
    Scheme.encode_list_bytes = part(Scheme.encode_list_bytes, "encode")
    server_mod.ApiServer._send_raw = staticmethod(
        part(server_mod.ApiServer._send_raw, "send"))

    pauses = []
    started = {}

    def on_gc(phase, info):
        if phase == "start":
            started[threading.get_ident()] = time.perf_counter()
            return
        t0 = started.pop(threading.get_ident(), None)
        if t0 is not None:
            pauses.append((t0 - t_base, time.perf_counter() - t0,
                           info["generation"]))

    lags = []
    done = threading.Event()

    def probe():
        while not done.is_set():
            t0 = time.perf_counter()
            time.sleep(0.001)
            lags.append((t0 - t_base, time.perf_counter() - t0 - 0.001))

    gc.callbacks.append(on_gc)
    threading.Thread(target=probe, daemon=True).start()
    try:
        r = slo.run_density_slo(n_nodes, n_pods, device=device)
    finally:
        done.set()
        gc.callbacks.remove(on_gc)
    t_open = window.get("open", 0.0)
    t_close = window.get("close", time.perf_counter() - t_base)
    in_window = [p for p in pauses if t_open <= p[0] <= t_close]
    lag = sorted(d for t, d in lags if t_open <= t <= t_close)

    def q(v, f):
        return v[int(f * (len(v) - 1))] if v else None

    return {
        "arm": arm, "nodes": n_nodes, "pods": n_pods,
        "result": r.as_dict(),
        "steps": {k: {"calls": v[0], "seconds": v[1], "longest_s": v[2]}
                  for k, v in timer.steps.items()},
        "node_lists": lists,
        "gc": {"window": {"count": len(in_window),
                          "seconds": sum(p[1] for p in in_window),
                          "longest_s": max((p[1] for p in in_window),
                                           default=0.0),
                          "full": sum(1 for p in in_window if p[2] == 2)},
               "all": {"count": len(pauses),
                       "seconds": sum(p[1] for p in pauses)}},
        "gil_lag_ms": {"p50": q(lag, 0.5) * 1e3 if lag else None,
                       "p90": q(lag, 0.9) * 1e3 if lag else None,
                       "p99": q(lag, 0.99) * 1e3 if lag else None,
                       "max": lag[-1] * 1e3 if lag else None,
                       "samples": len(lag)},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--pods", type=int, default=15000)
    ap.add_argument("--arms", default=",".join(ARMS),
                    help="comma-separated VIEWS/COLLECTOR arms")
    ap.add_argument("--cpu", action="store_true",
                    help="run the engine on the CPU (default: the CUDA "
                         "device, which must be present)")
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from ..utils.platform import pick_device
    device = pick_device(args.cpu)
    if args.child:
        if device.type == "cuda":
            # the kernels build before the run, so no arm bills the
            # build to its window (_build keys them by their source)
            from ..sched.device import _build, scan_kernel, scatter_kernel
            _build.build_all([scan_kernel.SOURCE, scatter_kernel.SOURCE])
        print(json.dumps(run_arm(args.child, args.nodes, args.pods,
                                 device)), flush=True)
        return 0
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    out = []
    for arm in args.arms.split(","):
        cmd = [sys.executable, "-m", "kubernetes_tpu_torch.kubemark."
               "profile_slo", "--child", arm, "--nodes", str(args.nodes),
               "--pods", str(args.pods)] + (["--cpu"] if args.cpu else [])
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            raise SystemExit(f"arm {arm} failed ({proc.returncode})")
        out.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(json.dumps({"metric": "profile_slo", "arms": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
