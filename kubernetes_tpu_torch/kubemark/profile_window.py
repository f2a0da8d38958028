"""What the native store's write lock (`NativeStore._window`) costs the
live pipeline.

    python -m kubernetes_tpu_torch.kubemark.profile_window [--nodes 5000]
        [--pods 30000] [--rounds 2] [--cpu]

Runs the durable e2e over the native store (deployment.run_durable_e2e,
backend "native": the kubemark benchmark's pipeline over
NativeStore(wal_dir), then its recovery) in two arms, lock, open, open,
lock each round: `lock` is the store as it is; `open` replaces each
store's `_window` with a lock that never blocks, the store as it was
before the lock, where a write may land between another's staging and
its commit and claim its revision window (the commit then restages, up
to ten times, and raises Conflict). A run is ok when it binds every
pod. Prints one JSON line a run (the arm, ok, elapsed s, pods/s, the
pods bound, recovery s, or the error), then one line with each arm's
runs and, on the card, the card's name and power limit.
`--cpu` runs the engine on the CPU (its plain versions).
"""

from __future__ import annotations

import argparse
import json
import statistics


class _OpenLock:
    """A context manager that never blocks: the store without its lock."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _run(arm: str, n_nodes: int, n_pods: int, device) -> dict:
    from ..core import native_store
    from .deployment import run_durable_e2e

    init = native_store.NativeStore.__init__

    def open_init(self, *a, **kw):
        init(self, *a, **kw)
        self._window = _OpenLock()

    if arm == "open":
        native_store.NativeStore.__init__ = open_init
    try:
        r = run_durable_e2e(n_nodes, n_pods, "native", device=device,
                            timeout_s=300.0)
        return {"arm": arm, "ok": r["scheduled"] == n_pods,
                "elapsed_s": r["elapsed_s"],
                "pods_per_sec": r["pods_per_sec"],
                "scheduled": r["scheduled"],
                "recovery_s": r["recovery_s"]}
    except Exception as e:                 # the open arm may race
        return {"arm": arm, "ok": False, "error": repr(e)[:300]}
    finally:
        native_store.NativeStore.__init__ = init


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--pods", type=int, default=30000)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from ..utils.platform import pick_device
    device = pick_device(args.cpu)
    runs = []
    for _ in range(args.rounds):
        for arm in ("lock", "open", "open", "lock"):
            rec = _run(arm, args.nodes, args.pods, device)
            print(json.dumps(rec), flush=True)
            runs.append(rec)
    summary = {"nodes": args.nodes, "pods": args.pods,
               "device": str(device)}
    for arm in ("lock", "open"):
        done = [r for r in runs if r["arm"] == arm and r["ok"]]
        summary[arm] = {
            "runs": sum(1 for r in runs if r["arm"] == arm),
            "failed": sum(1 for r in runs if r["arm"] == arm
                          and not r["ok"]),
            "elapsed_s": [r["elapsed_s"] for r in done],
            "median_elapsed_s": (statistics.median(
                r["elapsed_s"] for r in done) if done else None)}
    if device.type == "cuda":
        from .gpu_evidence import card_line
        summary["card"] = card_line()
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
