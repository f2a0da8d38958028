"""A delta tile's prologue on the card, this checkout against another.

    python -m kubernetes_tpu_torch.kubemark.profile_prologue [--against DIR]

The prologue is everything `BatchEngine.run_chunked` does on a delta
tile before its first scan launch: the mirror's dirty rows, the run's
own State and the pods on the device. The tile is chip_smoke's mirror
tile: 8192 bench pods on the e2e fleet (5000 nodes, 5120 slots) after a
first tile and a heartbeat of one 500-node shard. For each checkout, in
a process of its own whose `kubernetes_tpu_torch` is that checkout's,
torch.profiler counts the kernels and host-to-device copies of one
prologue (device events) and the launches and copies the host queued
(runtime calls), and the host clock times the prologue to its completion
(the median of 20, the mirror's generations set back before each so that
each repeats the same tile). A checkout with `BatchEngine._prologue`
runs it; an older one runs what its `run_chunked` did before the scan:
`_fetch_tables` (two scatter launches and a clone of the State) and the
pods' upload and pad. Both must leave the same tables and pods (sha256
over their bytes). Prints one JSON object; needs the card.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))


def _counts(fn) -> dict:
    """torch.profiler over one call of fn (then a synchronise)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"kernels": 0, "h2d_copies": 0, "other_copies": 0,
           "launch_calls": 0, "copy_calls": 0}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith("Memcpy HtoD"):
                out["h2d_copies"] += 1
            elif e.name.startswith(("Memcpy", "Memset")):
                out["other_copies"] += 1
            else:
                out["kernels"] += 1
        elif e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            out["launch_calls"] += 1
        elif e.name.startswith(("cudaMemcpy", "cuMemcpy")):
            out["copy_calls"] += 1
    return out


def _host_ms(fn, reps: int = 20) -> float:
    import torch
    times = []
    for _ in range(reps + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[3:])


def _digest(tensors) -> str:
    import torch
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def child(root: str) -> dict:
    """This process's measurement of the checkout at `root`."""
    sys.path.insert(0, root)
    import torch

    from kubernetes_tpu_torch.kubemark.benchmark import _bench_pod
    from kubernetes_tpu_torch.kubemark.fixtures import (E2E_COUNTS,
                                                        SMOKE_CHUNK,
                                                        fleet_encoder)
    from kubernetes_tpu_torch.kubemark.fleet import HollowFleet
    from kubernetes_tpu_torch.sched.device import BatchEngine
    from kubernetes_tpu_torch.sched.device import engine as eng
    n = E2E_COUNTS["n_nodes"]
    fleet = HollowFleet(None, n, cpu="4", memory="32Gi",
                        max_pods=E2E_COUNTS["max_pods"])
    inc = fleet_encoder()
    engine = BatchEngine()
    pods = [_bench_pod(j) for j in range(SMOKE_CHUNK)]
    enc = inc.encode_tile(pods, [], [])
    got, _ = engine.run_chunked(enc, SMOKE_CHUNK)
    inc.assume_assigned(enc, pods, got)
    for i in range(min(500, n)):
        inc.on_node_update(fleet._node_object(i), fleet._node_object(i))
    enc = inc.encode_tile([_bench_pod(SMOKE_CHUNK + j)
                           for j in range(SMOKE_CHUNK)], [], [])
    enc = engine._ensure_safe_dtypes(enc)
    flags = engine._enc_flags(enc)
    cache = engine._table_cache
    gens = (cache.node_gen, cache.state_gen)
    d = enc.delta
    rows = [int((d.node_dirty_gen > gens[0]).sum()),
            int((d.state_dirty_gen > gens[1]).sum())]
    if hasattr(engine, "_prologue"):
        design = "one staging buffer, one copy, one launch"

        def prologue():
            cache.node_gen, cache.state_gen = gens
            node, state, pods, _ = engine._prologue(enc, flags, SMOKE_CHUNK)
            return node, state, pods
    else:
        design = "two scatters, a State clone, the pods' uploads and pad"

        def prologue():
            cache.node_gen, cache.state_gen = gens
            node_h, state_h, pods_h = engine.host_args(enc)
            node, state = engine._fetch_tables(enc, node_h, state_h, flags,
                                               True)
            pods = eng._upload(pods_h, engine.device)
            pad = (-pods.valid.shape[0]) % SMOKE_CHUNK
            if pad:
                pods = eng.PodXs(*(torch.cat([a, torch.zeros(
                    (pad,) + tuple(a.shape[1:]), dtype=a.dtype,
                    device=a.device)]) for a in pods))
            return node, state, pods

    counts = _counts(prologue)
    host_ms = _host_ms(prologue)
    node, state, pods = prologue()
    torch.cuda.synchronize()
    return {"root": root, "design": design, "rows": rows, **counts,
            "host_ms": host_ms, "tables_sha256": _digest(
                list(node) + list(state) + list(pods))}


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--against", default="", metavar="DIR")
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child)))
        return 0
    out = {}
    roots = {"this": ROOT}
    if args.against:
        roots["other"] = os.path.abspath(args.against)
    for who, root in roots.items():
        res = subprocess.run([sys.executable, HERE, "--child", root],
                             capture_output=True, text=True, check=True)
        out[who] = json.loads(res.stdout.strip().splitlines()[-1])
    if "other" in out and (out["this"]["tables_sha256"]
                           != out["other"]["tables_sha256"]):
        raise AssertionError("the two prologues leave different tables")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
