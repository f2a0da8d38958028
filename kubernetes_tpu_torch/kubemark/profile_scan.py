"""Where the engine's scan spends its time on one CUDA device.

    python -m kubernetes_tpu_torch.kubemark.profile_scan [--nodes 5000]
        [--pods 512] [--spread]

Runs BatchEngine.run_chunked over the smoke's engine fixture (5000
kubemark-shape nodes; `--spread` adds the `web` service) in chunks of
`--pods` (one launch of the scan kernel a chunk) twice: once timed
without instrumentation, once under torch.profiler. Prints one JSON
line: host ms per scan step (the call's host time, uploads included,
over the pods), device ms per step (every kernel's summed device time
over the steps; the scan kernel's alone in `scan_kernel_ms_per_step`),
the device's busy share of an unprofiled call, device launches per
chunk and the scan kernel's launches, the top kernels by device time,
and the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--pods", type=int, default=512)
    ap.add_argument("--spread", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..sched.device import BatchEngine, encode_snapshot, scan_kernel
    from .fixtures import engine_snapshot

    enc = encode_snapshot(engine_snapshot(args.nodes, args.pods,
                                          plain=not args.spread))
    engine = BatchEngine()
    chunk = args.pods
    engine.run_chunked(enc, chunk)             # warm-up: allocator, kernels
    torch.cuda.synchronize()
    t0 = time.monotonic()
    engine.run_chunked(enc, chunk)
    host_ms = (time.monotonic() - t0) * 1e3 / args.pods

    launches = scan_kernel.scan_chunk.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.run_chunked(enc, chunk)
        torch.cuda.synchronize()
    launches = scan_kernel.scan_chunk.launches - launches
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    scan_us = sum(t for name, (_, t) in by_name.items()
                  if name.startswith("void scan_kernel"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "nodes": args.nodes, "pods": args.pods, "spread": args.spread,
        "host_ms_per_step": host_ms,
        "device_ms_per_step": device_us / 1e3 / args.pods,
        "scan_kernel_ms_per_step": scan_us / 1e3 / args.pods,
        "device_busy_share": device_us / 1e3 / args.pods / host_ms,
        "kernels_per_chunk": len(kernels), "scan_kernel_launches": launches,
        "top_kernels": [{"name": name[:80], "launches": n,
                         "device_ms": t / 1e3} for name, (n, t) in top],
        "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
