#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`kubernetes_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port's main device path once on the card, at the north-star
size, through the entry points a user calls, and holds every kernel and
every answer to a reference:

  build     nvcc-builds every CUDA source of the path (all at once).
  filter    the predicate-filter kernel on a mixed 8192-pod x 5000-node
            snapshot: bit-equal to its plain PyTorch version on the card
            and to the engine's probe mask; a mask that is neither all
            True nor all False; kernel / plain times beside the bound.
  engine    BatchEngine.run_chunked(enc, 8192) on the 5000 x 30000 plain
            and 5000 x 8192 spread fixtures; the assignment's sha256 and
            bound count must equal SMOKE_DIGESTS, the JAX engine's answer.
  extender  the extender sidecar (ExtenderServer + DeviceBackend on the
            card) answers 3 Filter and 3 Prioritize requests over 5000
            nodes through the port's HTTP client; the answers must equal
            those of a DeviceBackend on the CPU, and the filter kernel's
            launch count must have risen.

Kernel launch counts are set to 0 just before the engine phase and read
just after the extender phase. Each phase prints one JSON line; a failed
check raises, so the script exits non-zero and prints no result. Every
line carries the card's name and power limit (nvidia-smi). The last
lines are the card's line, the kernel table, and
{"ok": true, "device": {...}}. Needs one CUDA device; exits non-zero
without one, or without the rest of the repository beside it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
# H100 SXM float32 CUDA-core peak; it stands in for the 32-bit integer
# ALU rate, for which no separate peak figure is used here.
ALU32_OPS_PER_S = 67e12

FILTER_SEED = 7
FILTER_SHAPE = (5000, 8192, 20000)        # nodes, pods, existing pods
EXTENDER_PODS = (1, 5, 7)                 # plain, node selector, host port
EXTENDER_EXISTING = 2000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def call_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median wall time of one call as the card sees it (CUDA events
    around each call, after warm-up): includes the host's time to check
    inputs and launch whenever that exceeds the device's work."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, trials: int = 5) -> float:
    """Device time of one call: `reps` calls captured into one CUDA graph,
    the graph replayed between CUDA events, so no host time is counted.
    Median over `trials` replays, divided by `reps`."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def filter_ops(p: int, n: int, lw: int, pw: int, kw: int) -> int:
    """32-bit ALU operations per (pod, node) element that no
    implementation can avoid (per-node and per-pod terms hoisted):
    two resource compares + ORs, the 4-term resource combine, the
    per-word AND/OR of the ports, selector and disk loops with their
    zero tests, the host compare + OR, and the 8-way final AND."""
    return p * n * (20 + 2 * pw + 2 * lw + 4 * kw)


def phase_build():
    import torch

    from kubernetes_tpu_torch.sched.device import _build, filter_kernel
    t0 = time.monotonic()
    records = _build.build_all([filter_kernel.SOURCE])
    for r in records:
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {os.path.basename(r['source'])}: "
                      f"{line.strip()}", file=sys.stderr)
    return {"phase": "build", "seconds": time.monotonic() - t0,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "libraries": [os.path.relpath(r["library"], ROOT)
                          for r in records]}


def phase_filter():
    import torch

    from kubernetes_tpu_torch.kubemark.fixtures import mixed_snapshot
    from kubernetes_tpu_torch.sched.device import BatchEngine, encode_snapshot
    from kubernetes_tpu_torch.sched.device import filter_kernel as fk

    n_nodes, n_pods, n_existing = FILTER_SHAPE
    t0 = time.monotonic()
    enc = encode_snapshot(mixed_snapshot(FILTER_SEED, n_nodes, n_pods,
                                         n_existing))
    encode_s = time.monotonic() - t0
    if not fk.supports(enc):
        raise AssertionError("filter fixture is not kernel-eligible")
    engine = BatchEngine()
    args = fk.FilterArgs.from_engine(*engine.device_args(enc))
    got = fk.filter_masks(args)
    plain = fk.filter_masks_plain(args)
    probe_mask, _ = engine.probe(enc)
    torch.cuda.synchronize()
    max_abs_err = int((got.int() - plain.int()).abs().max())
    if not torch.equal(got, plain) or max_abs_err != 0:
        raise AssertionError("filter kernel != plain version on the card")
    if not torch.equal(got.cpu(), torch.from_numpy(probe_mask)):
        raise AssertionError("filter kernel != the engine's probe mask")
    share = float(got.float().mean())
    if not 0.0 < share < 1.0:
        raise AssertionError(f"degenerate filter mask: share True {share}")

    # the extender's shape: one pod against every node
    one = args.pod_slice(1, 2)
    if not torch.equal(fk.filter_masks(one), fk.filter_masks_plain(one)):
        raise AssertionError("filter kernel != plain version at P=1")

    ms = device_ms(lambda: fk.filter_masks(args))
    plain_ms = device_ms(lambda: fk.filter_masks_plain(args))
    ms_p1 = device_ms(lambda: fk.filter_masks(one))
    call_ms_p1 = call_ms(lambda: fk.filter_masks(one))
    p, n = args.shape
    lw, pw, kw = (args.labels.shape[1], args.port_bits.shape[1],
                  args.disk_any.shape[1])
    bytes_ms = args.nbytes() / HBM_BYTES_PER_S * 1e3
    ops_ms = filter_ops(p, n, lw, pw, kw) / ALU32_OPS_PER_S * 1e3
    rec = {"phase": "filter", "shape": [p, n], "words": [lw, pw, kw],
           "encode_s": encode_s, "share_true": share,
           "max_abs_err": max_abs_err, "equal_plain": True,
           "equal_probe": True, "ms": ms, "plain_ms": plain_ms,
           "ms_p1": ms_p1, "call_ms_p1": call_ms_p1,
           "bytes": args.nbytes(),
           "bound_ms": max(bytes_ms, ops_ms), "bytes_bound_ms": bytes_ms,
           "ops_bound_ms": ops_ms,
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    return rec


def phase_engine():
    import torch

    from kubernetes_tpu_torch.kubemark.fixtures import (SMOKE_CHUNK,
                                                        SMOKE_DIGESTS,
                                                        assigned_digest,
                                                        engine_snapshot,
                                                        smoke_pod_pad)
    from kubernetes_tpu_torch.sched.device import BatchEngine, encode_snapshot

    engine = BatchEngine()
    records = []
    for name, want in SMOKE_DIGESTS.items():
        t0 = time.monotonic()
        enc = encode_snapshot(
            engine_snapshot(want["n_nodes"], want["n_pods"], want["plain"]),
            pod_pad_to=smoke_pod_pad(want["n_pods"]))
        encode_s = time.monotonic() - t0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        assigned, _ = engine.run_chunked(enc, SMOKE_CHUNK)
        run_s = time.monotonic() - t0
        sha, bound = assigned_digest(assigned, enc.n_pods)
        if (sha, bound) != (want["sha256"], want["bound"]):
            raise AssertionError(
                f"{name}: assignment {sha} / {bound} bound differs from "
                f"the JAX engine's {want['sha256']} / {want['bound']}")
        records.append({
            "phase": "engine", "fixture": name, "nodes": enc.n_nodes,
            "pods": enc.n_pods, "steps": int(enc.pod_batch.valid.shape[0]),
            "encode_s": encode_s, "run_s": run_s,
            "pods_per_s": enc.n_pods / run_s, "bound": bound,
            "sha256": sha, "digest_ok": True})
    return records


def phase_extender():
    from kubernetes_tpu_torch.kubemark.fixtures import mixed_snapshot
    from kubernetes_tpu_torch.sched.api import ExtenderConfig
    from kubernetes_tpu_torch.sched.device import filter_kernel as fk
    from kubernetes_tpu_torch.sched.extender import HTTPExtender
    from kubernetes_tpu_torch.sched.extender_server import (DeviceBackend,
                                                            ExtenderServer)

    n_nodes = FILTER_SHAPE[0]
    snap = mixed_snapshot(FILTER_SEED, n_nodes, max(EXTENDER_PODS) + 1,
                          EXTENDER_EXISTING)
    pods = [snap.pending_pods[j] for j in EXTENDER_PODS]

    def provider():
        return snap.existing_pods, [], []

    servers = [ExtenderServer(DeviceBackend(state_provider=provider)),
               ExtenderServer(DeviceBackend(state_provider=provider,
                                            device="cpu"))]
    answers = []
    seconds = []
    launches_before = fk.filter_masks.launches
    try:
        for i, server in enumerate(servers):
            server.start()
            client = HTTPExtender(ExtenderConfig(
                url_prefix=server.url, filter_verb="filter",
                prioritize_verb="prioritize", http_timeout=300.0))
            got = []
            for pod in pods:
                t0 = time.monotonic()
                fit = [n.metadata.name for n in client.filter(pod, snap.nodes)]
                t1 = time.monotonic()
                prio, _ = client.prioritize(pod, snap.nodes)
                t2 = time.monotonic()
                got.append((fit, [(h.host, h.score) for h in prio]))
                if i == 0:
                    seconds.append((t1 - t0, t2 - t1))
            answers.append(got)
            if i == 0:
                launches_card = fk.filter_masks.launches - launches_before
    finally:
        for server in servers:
            server.stop()
    if answers[0] != answers[1]:
        raise AssertionError("extender answers on the card differ from "
                             "the CPU backend's")
    fits = [len(fit) for fit, _ in answers[0]]
    if not any(0 < f < n_nodes for f in fits):
        raise AssertionError(f"degenerate Filter answers: {fits}")
    if any(len(prio) != n_nodes for _, prio in answers[0]):
        raise AssertionError("Prioritize did not score every node")
    if launches_card < len(pods):
        raise AssertionError(f"filter kernel launched {launches_card} "
                             f"times for {len(pods)} Filter requests")
    return {"phase": "extender", "nodes": n_nodes,
            "requests": 2 * len(pods), "filter_fit": fits, "equal_cpu": True,
            "filter_s": [f for f, _ in seconds],
            "prioritize_s": [p for _, p in seconds],
            "filter_kernel_launches": launches_card}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from kubernetes_tpu_torch.sched.device import filter_kernel as fk

    card = card_line()

    def stamp(rec):
        emit({**rec, "card": card})

    stamp(phase_build())
    filt = phase_filter()
    stamp(filt)
    fk.filter_masks.launches = 0          # the main path starts here
    for rec in phase_engine():
        stamp(rec)
    stamp(phase_extender())
    launches = fk.filter_masks.launches   # ... and ends here
    if launches == 0:
        raise AssertionError("the main path never launched the filter "
                             "kernel")
    print(card, flush=True)
    emit({"kernels": [{
        "name": "filter_masks", "route": "cuda",
        "source": "kubernetes_tpu_torch/sched/device/csrc/filter_kernel.cu",
        "replaces": "kubernetes_tpu/sched/device/pallas_filter.py:169",
        "launches": launches, "equal_plain": filt["equal_plain"],
        "max_abs_err": filt["max_abs_err"],
        "ms": filt["ms"], "plain_ms": filt["plain_ms"],
        "bound_ms": filt["bound_ms"], "bound_by": filt["bound_by"],
        "library_ms": None, "shape": filt["shape"]}]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
