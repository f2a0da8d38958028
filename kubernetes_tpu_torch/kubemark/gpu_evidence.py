"""GPU evidence capture: what the port does on the card, section by section.

The counterpart of the JAX package's `kubemark/tpu_evidence.py`. Results
land in `--out` (GPU_EVIDENCE.json by default), written section by
section with an atomic rename at each flush, and each flush folds the
completed sections into the per-section best artifact (`--best-out`).

    python -m kubernetes_tpu_torch.kubemark.gpu_evidence --out PATH

Sections:

- ``platform``: the CUDA device's name and count, and nvidia-smi's name
  and power limit (the line every number here stands beside).
- ``dispatch``: the roundtrip of a tiny launch-and-fetch, and
  host->device MB/s for 256 MiB.
- ``kernels``: the predicate-filter kernel against the engine's probe
  mask, then the rejection check that the JAX section made with a kernel
  Mosaic could not lower: the argsort kernel bit-equal to its plain
  version, the same kernel launched with a block CUDA refuses
  (the wrapper raises RuntimeError naming the CUDA error), that refusing
  launch swapped in for the filter kernel's launch (BatchEngine.
  filter_masks raises and returns no mask: the port has no degrade
  latch), and the filter kernel bit-equal again once restored (the
  context survived).
- ``engine``: engine-only throughput (`BatchEngine.run_chunked(enc,
  8192)`) on the smoke's engine fixture at 1000x3000 and 5000x30000.
- ``e2e``: the live pipeline under the kubemark benchmark
  (`run_scheduling_benchmark(5000, 30000, "batch")`: registry, informer
  fan-out, FIFO drain, incremental encode, chained device scan, batched
  CAS bind), run once, with its per-node counts digest (held to
  fixtures.E2E_COUNTS by chip_smoke.py).

Every section needs the card: none falls back to the CPU. Still to port
from the JAX tool (ROADMAP.md Queue 1, 'Harness and entry points'): the
chip lock, the crossover against a CPU engine rate, and the speculative
engine A/B (engine_spec).
"""

from __future__ import annotations

import json
import os
import subprocess
import time
import traceback

import numpy as np
import torch

# seed of the random [8, 128] argsort input with ties
REJECT_SEED = 11
REJECT_SHAPE = (8, 128)


def _utc() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def _atomic_write_json(path: str, doc: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)


class _Evidence:
    """Accumulates sections, flushing the artifact after each one so a
    failure mid-capture loses only the in-flight section. Each flush also
    folds completed sections into the per-section BEST artifact — a
    capture killed mid-e2e still contributes its engine number."""

    def __init__(self, path: str, best_path: str | None = None):
        self.path = path
        self.best_path = best_path
        self.doc = {"ts_start": _utc(), "complete": False, "sections": {}}

    def flush(self):
        _atomic_write_json(self.path, self.doc)
        if self.best_path:
            try:
                merge_best(self.doc, self.best_path)
            except Exception:
                # best-file trouble (disk full, unwritable path) must
                # never fail the primary artifact or the capture rc
                traceback.print_exc()

    def run_section(self, name: str, fn):
        t0 = time.time()
        try:
            out = fn()
            # a section that reports its own elapsed_s (e2e: the run's
            # bind time — the quantity pods_per_sec derives from) keeps
            # it; the section's wall share of the capture is recorded
            # separately either way
            out.setdefault("elapsed_s", round(time.time() - t0, 2))
            out["section_elapsed_s"] = round(time.time() - t0, 2)
            out.setdefault("status", "ok")
        except Exception:
            out = {"status": "error",
                   "elapsed_s": round(time.time() - t0, 2),
                   "tail": traceback.format_exc()[-600:]}
        self.doc["sections"][name] = out
        self.flush()
        return out


def _cuda(device) -> torch.device:
    from ..sched.device.engine import resolve_device
    d = resolve_device(device)
    if d.type != "cuda":
        raise ValueError(f"this section measures the card; {d} is not one")
    return d


def card_line() -> str:
    """nvidia-smi's `name, power.limit` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def section_platform() -> dict:
    _cuda(None)
    n = torch.cuda.device_count()
    return {"backend": "cuda",
            "devices": [torch.cuda.get_device_name(i) for i in range(n)],
            "n_devices": n, "card": card_line(),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def section_dispatch(device=None) -> dict:
    """Roundtrip latency of a tiny launch + fetch, and host->device
    bandwidth — the two numbers the tile pipeline is designed around."""
    d = _cuda(device)
    x = torch.ones(8, device=d)
    float(x.sum())  # warm
    lat = []
    for _ in range(30):
        t0 = time.perf_counter()
        float(x.sum())
        lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    host = torch.ones((64, 1024, 1024), dtype=torch.float32)  # 256 MiB
    torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    host.to(d)
    torch.cuda.synchronize(d)
    put_s = time.perf_counter() - t0
    nbytes = host.numel() * host.element_size()
    return {"roundtrip_ms": {"p50": lat[len(lat) // 2],
                             "p90": lat[int(len(lat) * 0.9)],
                             "min": lat[0]},
            "device_put_mb_per_s": nbytes / 2 ** 20 / put_s}


def reject_inputs(device) -> dict:
    """The argsort kernel's inputs: the JAX section's all-ones [8, 128],
    and a seeded [8, 128] of small integers (many ties) with -0.0,
    denormals, infinities and NaNs of both signs mixed in."""
    rng = np.random.default_rng(REJECT_SEED)
    ties = rng.integers(-4, 5, size=REJECT_SHAPE).astype(np.float32)
    specials = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf,
                         1e-45, -1e-45], np.float32)
    ties[:, ::7] = rng.choice(specials, size=ties[:, ::7].shape)
    return {"ones": torch.ones(REJECT_SHAPE, device=device),
            "ties": torch.from_numpy(ties).to(device)}


def _kernel_snapshot():
    from .fixtures import mixed_snapshot
    # a small mixed snapshot (host ports, selectors, disks, pinned
    # hosts, existing pods): the JAX section's tiny 8-pod x 16-node shape
    return mixed_snapshot(7, 16, 8, 10)


def section_kernels(device=None) -> dict:
    """The filter kernel's parity, then the rejection check (module
    docstring). Every field must come out True for the section to hold."""
    from ..sched.device import BatchEngine, encode_snapshot
    from ..sched.device import filter_kernel, reject_kernel

    d = _cuda(device)
    out: dict = {}
    enc = encode_snapshot(_kernel_snapshot())
    if not filter_kernel.supports(enc):
        raise AssertionError("the kernel snapshot is not filter-eligible")
    eng = BatchEngine(device=d)
    ref, _ = eng.probe(enc)
    ref = ref[:enc.n_pods]

    # 1) the filter kernel against the probe's mask
    out["filter_parity"] = bool(np.array_equal(eng.filter_masks(enc), ref))

    # 2a) the argsort kernel, bit-equal to its plain version
    inputs = reject_inputs(d)
    errs = []
    for x in inputs.values():
        got = reject_kernel.argsort_rows(x)
        want = reject_kernel.argsort_rows_plain(x)
        errs.append(int((got - want).abs().max()))
    torch.cuda.synchronize(d)
    out["reject_max_abs_err"] = max(errs)
    out["reject_parity"] = max(errs) == 0

    # 2b) the same kernel with a block of more than 1024 threads: the
    # launch is refused (cudaErrorInvalidConfiguration, which
    # leaves the context usable) and the wrapper must raise
    refused = 2 * reject_kernel.MAX_BLOCK_THREADS
    ones = inputs["ones"]
    try:
        reject_kernel.argsort_rows(ones, block_threads=refused)
        out["rejection_raised"] = False
    except RuntimeError as e:
        out["rejection_raised"] = True
        out["rejection_type"] = type(e).__name__
        out["rejection_msg"] = str(e)[:200]

    # 2c) the refusing launch in place of the filter kernel's launch, as
    # the JAX section swapped pallas_filter._filter_call: the engine's
    # filter_masks must raise and hand back no mask
    scratch = torch.empty(REJECT_SHAPE, dtype=torch.int32, device=d)

    def refusing_launch(args, mask_out):
        return reject_kernel._launch(ones, scratch, refused)

    orig = filter_kernel._launch
    launches = filter_kernel.filter_masks.launches
    mask = None
    try:
        filter_kernel._launch = refusing_launch
        try:
            mask = eng.filter_masks(enc)
        except RuntimeError as e:
            out["filter_error"] = str(e)[:200]
        out["no_fallback"] = (mask is None and "filter_error" in out
                              and filter_kernel.filter_masks.launches
                              == launches)
    finally:
        filter_kernel._launch = orig

    # 2d) the filter kernel again: bit-equal, so the context survived
    out["parity_after"] = bool(np.array_equal(eng.filter_masks(enc), ref))
    torch.cuda.synchronize(d)
    out["ok"] = all(out[k] for k in ("filter_parity", "reject_parity",
                                     "rejection_raised", "no_fallback",
                                     "parity_after"))
    return out


def section_engine(device=None,
                   shapes=((1000, 3000), (5000, 30000))) -> dict:
    """Engine-only throughput on the smoke's engine fixture (plain tier),
    `run_chunked(enc, 8192)` from host numpy, encode excluded."""
    from ..sched.device import BatchEngine, encode_snapshot
    from .fixtures import (SMOKE_CHUNK, assigned_digest, engine_snapshot,
                           smoke_pod_pad)
    d = _cuda(device)
    eng = BatchEngine(device=d)
    out = {}
    for n_nodes, n_pods in shapes:
        enc = encode_snapshot(engine_snapshot(n_nodes, n_pods, plain=True),
                              pod_pad_to=smoke_pod_pad(n_pods))
        torch.cuda.synchronize(d)
        t0 = time.monotonic()
        assigned, _ = eng.run_chunked(enc, SMOKE_CHUNK)
        run_s = time.monotonic() - t0
        sha, bound = assigned_digest(assigned, enc.n_pods)
        out[f"{n_nodes}x{n_pods}"] = {"pods_per_sec": n_pods / run_s,
                                      "run_s": run_s, "bound": bound,
                                      "sha256": sha}
    return out


# latency summaries of the host layers around the scan: per tile, the
# batch loop's (sched/batch.py) FIFO drain, its top-up while a tile is
# in flight, the tile encode and the bind commit; per status burst, the
# fleet's Running echo (kubemark/fleet.py). The scan itself is the
# engine's scan_stats.
E2E_LAYERS = {"drain": "batch_drain_latency_microseconds",
              "topup": "batch_topup_latency_microseconds",
              "encode": "batch_snapshot_latency_microseconds",
              "commit": "binding_latency_microseconds",
              "confirm": "fleet_status_batch_latency_microseconds"}


def section_e2e(n_nodes: int = 5000, n_pods: int = 30000,
                device=None, timeout_s: float = 900.0) -> dict:
    """One run of the live pipeline under the kubemark benchmark (not
    best-of-two: card time is the budget). device=None is the card; the
    tests pass device="cpu" at a small size. Reports the tiles (chained
    or not), the engine's upload and scan accounting, the seconds each
    host layer of E2E_LAYERS spent, summed over the run, and the
    per-node counts digest."""
    from ..api.registry import Registry
    from ..utils.metrics import global_metrics
    from .benchmark import run_scheduling_benchmark
    from .fixtures import node_counts_digest

    def reading():
        out = {ch: global_metrics.counter("batch_tiles_total",
                                          {"chained": ch})
               for ch in ("true", "false")}
        for layer, name in E2E_LAYERS.items():
            stats = global_metrics.summary_stats(name).get((), {})
            out[layer] = (stats.get("count", 0), stats.get("sum", 0.0))
        return out

    registry = Registry()
    before = reading()
    r = run_scheduling_benchmark(n_nodes, n_pods, "batch",
                                 registry=registry, device=device,
                                 timeout_s=timeout_s)
    after = reading()
    nodes, _ = registry.list("nodes")
    pods, _ = registry.list("pods", "default")
    sha, counted = node_counts_digest(
        [n.metadata.name for n in nodes],
        [p.spec.node_name for p in pods
         if p.metadata.name.startswith("bench-pod-")])
    layers = {layer: {"count": after[layer][0] - before[layer][0],
                      "seconds": (after[layer][1] - before[layer][1]) / 1e6}
              for layer in E2E_LAYERS}
    return {"pods_per_sec": r.pods_per_sec, "elapsed_s": r.elapsed_s,
            "scheduled": r.scheduled, "nodes": r.n_nodes, "pods": r.n_pods,
            "tiles_chained": int(after["true"] - before["true"]),
            "tiles_unchained": int(after["false"] - before["false"]),
            "layers": layers, "scan_stats": r.scan_stats,
            "upload_stats": r.upload_stats,
            "counts_sha256": sha, "counts_bound": counted}


def merge_best(doc: dict, best_path: str) -> None:
    """Fold one capture into the running per-section BEST artifact.

    The freshest capture is the honest "this is what the card did last
    time" record; the best file records the demonstrated ceiling, every
    entry stamped with the capture timestamp it came from so the two
    are auditable together."""
    ts = doc.get("ts_start", _utc())
    try:
        with open(best_path) as f:
            best = json.load(f)
    except (OSError, ValueError):
        best = {"sections": {}}
    bs = best.setdefault("sections", {})
    secs = doc.get("sections", {})

    changed = False

    def _ok(name):
        s = secs.get(name)
        return s if s and s.get("status") == "ok" else None

    eng = _ok("engine")
    if eng:
        tgt = bs.setdefault("engine", {})
        for shape, rec in eng.items():
            if not isinstance(rec, dict) or "pods_per_sec" not in rec:
                continue
            old = tgt.get(shape)
            if old is None or rec["pods_per_sec"] > old["pods_per_sec"]:
                tgt[shape] = dict(rec, ts=ts)
                changed = True
    e2e = _ok("e2e")
    if e2e:
        old = bs.get("e2e")
        if old is None or e2e["pods_per_sec"] > old["pods_per_sec"]:
            bs["e2e"] = dict(e2e, ts=ts)
            changed = True
    disp = _ok("dispatch")
    if disp:
        old = bs.get("dispatch")
        if (old is None or disp["roundtrip_ms"]["p50"]
                < old["roundtrip_ms"]["p50"]):
            bs["dispatch"] = dict(disp, ts=ts)
            changed = True

    def _content(rec):
        # per-capture jitter fields must not count as a content change
        # (they would bump ts_updated on every capture)
        return {k: v for k, v in (rec or {}).items()
                if k not in ("ts", "elapsed_s", "section_elapsed_s",
                             "status")}

    if _ok("platform") and _content(bs.get("platform")) != _content(
            secs["platform"]):
        bs["platform"] = dict(secs["platform"], ts=ts)
        changed = True
    ker = _ok("kernels")
    if ker:
        # a run can return status ok with a validation bit False; never
        # let it replace a record that actually validated
        def _quality(rec):
            return tuple(bool(rec.get(k)) for k in (
                "filter_parity", "reject_parity", "rejection_raised",
                "no_fallback", "parity_after"))
        old = bs.get("kernels")
        # per-field non-regression, not lexicographic: a capture that
        # improves an earlier bit but regresses a later one must not
        # replace a fully-validated record
        if (old is None or all(n >= o for n, o in zip(_quality(ker),
                                                      _quality(old)))) \
                and _content(old) != _content(ker):
            bs["kernels"] = dict(ker, ts=ts)
            changed = True
    if changed:
        best["ts_updated"] = _utc()
        _atomic_write_json(best_path, best)


def main() -> int:
    """Runs every section; exits non-zero if any of them failed."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="GPU_EVIDENCE.json")
    ap.add_argument("--best-out", default="GPU_EVIDENCE_BEST.json")
    ap.add_argument("--skip-e2e", action="store_true")
    args = ap.parse_args()

    ev = _Evidence(args.out, best_path=args.best_out)
    ev.run_section("platform", section_platform)
    ev.run_section("dispatch", section_dispatch)
    ev.run_section("kernels", section_kernels)
    ev.run_section("engine", section_engine)
    if not args.skip_e2e:
        ev.run_section("e2e", section_e2e)
    ev.doc["complete"] = True
    ev.doc["ts_end"] = _utc()
    ev.flush()
    status = {k: v.get("status") for k, v in ev.doc["sections"].items()}
    print(json.dumps(status))
    return 0 if all(v == "ok" for v in status.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
