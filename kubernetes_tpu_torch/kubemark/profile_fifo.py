"""Time draining the scheduler's pending queue (api/cache.FIFO) pop by pop.

The batch loop drains its tiles from this FIFO one `pop` at a time
(sched/batch.py `_drain_tile`). `pop` is priority-then-FIFO over a heap
with lazy deletion, so one pop costs O(log queue) and draining n pods
O(n log n) (the JAX package's copy sweeps the whole queue on every pop:
O(n^2) a drain). The benchmark's 30000 pods sit in it at once. This is
host code, so it runs anywhere:

    python -m kubernetes_tpu_torch.kubemark.profile_fifo --pods 10000 30000

prints one JSON line per size: seconds to drain and microseconds per pop.
"""

from __future__ import annotations

import argparse
import json
import platform
import time

from ..api.cache import FIFO
from .benchmark import _bench_pod


def drain_seconds(n_pods: int) -> float:
    fifo = FIFO()
    for i in range(n_pods):
        fifo.add(_bench_pod(i))
    t0 = time.monotonic()
    while fifo.pop(timeout=0) is not None:
        pass
    return time.monotonic() - t0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pods", type=int, nargs="+", default=[5000, 10000])
    args = ap.parse_args()
    for n in args.pods:
        s = drain_seconds(n)
        print(json.dumps({"pods": n, "drain_s": s, "us_per_pop": s / n * 1e6,
                          "host": platform.processor() or platform.machine(),
                          "python": platform.python_version()}), flush=True)


if __name__ == "__main__":
    main()
