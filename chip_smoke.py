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
            True nor all False; kernel / plain times beside the bound
            and the launch floor, at that batch shape and at 1 x 5000
            (the extender's launch).
  engine    BatchEngine.run_chunked(enc, 8192) on the 5000 x 30000 plain
            and 5000 x 8192 spread fixtures; the assignment's sha256 and
            bound count must equal SMOKE_DIGESTS, the JAX engine's answer.
  extender  the extender sidecar (ExtenderServer + DeviceBackend on the
            card) answers 3 Filter and 3 Prioritize requests over 5000
            nodes through the port's HTTP client; the answers must equal
            those of a DeviceBackend on the CPU, and the filter kernel's
            launch count must have risen.
  reject    the GPU evidence tool's `kernels` section
            (kubemark/gpu_evidence.py): the argsort kernel bit-equal to
            its plain version, a launch CUDA refuses raising, that
            refusing launch in place of the filter kernel's making
            BatchEngine.filter_masks raise with no mask, and the filter
            kernel bit-equal again; then the argsort kernel's time beside
            its plain version's, torch.argsort's, the launch floor and
            its bound.
  e2e       the evidence tool's `e2e` section: the live batch pipeline
            under run_scheduling_benchmark(5000, 30000, "batch") on the
            card, with the JAX benchmark's traffic (fleet heartbeats
            every 600 s); every pod bound and the per-node counts equal
            to E2E_COUNTS (the JAX engine's answer). Chained and
            unchained tiles are reported, not held.

Bounds (`kubernetes_tpu_torch/sched/device/bounds.py`): the larger of the
bytes over 3.35 TB/s and the 32-bit integer operations over the card's
integer rate (SMs x 64 INT32 lanes x maximum SM clock); every record
with a bound names the rate (`int_ops_per_s`, `sm_clock_mhz`, `sms`).
The launch floor is the device time of a kernel that does nothing,
timed like every kernel (20 launches in one CUDA graph).

Three paths are driven, each with the kernel launch counts set to 0 just
before it and read just after: the engine and extender phases (the
filter kernel), the reject phase (the argsort kernel), and the e2e phase
(which runs neither kernel: its scan is eager PyTorch until ROADMAP K1).
Each phase prints one JSON line; a failed check raises, so the script
exits non-zero and prints no result. Every line carries the card's name
and power limit (nvidia-smi). The last lines are the card's line, the
kernel table, and {"ok": true, "device": {...}}. The kernel table gives
for each kernel: route, source, the TPU kernel it replaces, its launches
on its path and their shape (`main_path_shape`), `equal_plain`,
`max_abs_err`, `ms` / `plain_ms` / `library_ms` / `bound_ms` at the timed
shape (`shape`), `main_path_ms` / `main_path_bound_ms`, the launch floor
and the integer rate. Needs one CUDA device;
exits non-zero without one, or without the rest of the repository beside
it.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

FILTER_SEED = 7
FILTER_SHAPE = (5000, 8192, 20000)        # nodes, pods, existing pods
EXTENDER_PODS = (1, 5, 7)                 # plain, node selector, host port
EXTENDER_EXISTING = 2000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def phase_build():
    import torch

    from kubernetes_tpu_torch.sched.device import (_build, filter_kernel,
                                                   reject_kernel)
    t0 = time.monotonic()
    records = _build.build_all([filter_kernel.SOURCE, reject_kernel.SOURCE])
    for r in records:
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {os.path.basename(r['source'])}: "
                      f"{line.strip()}", file=sys.stderr)
    return {"phase": "build", "seconds": time.monotonic() - t0,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "libraries": [os.path.relpath(r["library"], ROOT)
                          for r in records]}


def phase_filter(rate, floor_ms):
    import torch

    from kubernetes_tpu_torch.kubemark.fixtures import mixed_snapshot
    from kubernetes_tpu_torch.kubemark.gpu_evidence import (filter_bound,
                                                            kernel_timing)
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

    p, n = args.shape
    lw, pw, kw = (args.labels.shape[1], args.port_bits.shape[1],
                  args.disk_any.shape[1])
    batch = {**kernel_timing(lambda: fk.filter_masks(args),
                             lambda: fk.filter_masks_plain(args), None,
                             floor_ms), **filter_bound(args, rate)}
    p1 = {**kernel_timing(lambda: fk.filter_masks(one),
                          lambda: fk.filter_masks_plain(one), None,
                          floor_ms), **filter_bound(one, rate)}
    return {"phase": "filter", "shape": [p, n], "words": [lw, pw, kw],
            "plan": list(fk.launch_plan(p, n, lw, pw, kw)),
            "encode_s": encode_s, "share_true": share,
            "max_abs_err": max_abs_err, "equal_plain": True,
            "equal_probe": True, **batch,
            **{f"{k}_p1": p1[k] for k in ("ms", "plain_ms", "call_ms",
                                          "bound_ms", "bound_by", "bytes",
                                          "ops")}}


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


def phase_reject(rate, floor_ms):
    """The evidence tool's kernels section, every field held, then the
    argsort kernel timed at the section's shape. Returns (record, the
    argsort kernel's launches in the section)."""
    import torch

    from kubernetes_tpu_torch.kubemark import gpu_evidence
    from kubernetes_tpu_torch.kubemark.gpu_evidence import (argsort_bound,
                                                            kernel_timing)
    from kubernetes_tpu_torch.sched.device import reject_kernel as rk

    rk.argsort_rows.launches = 0          # this path starts here
    sec = gpu_evidence.section_kernels()
    launches = rk.argsort_rows.launches   # ... and ends here
    failed = [k for k in ("filter_parity", "reject_parity",
                          "rejection_raised", "no_fallback", "parity_after")
              if not sec[k]]
    if failed:
        raise AssertionError(f"reject phase: {failed} false: {sec}")
    if launches == 0:
        raise AssertionError("the kernels section never launched the "
                             "argsort kernel")
    x = gpu_evidence.reject_inputs(torch.device("cuda"))["ties"]
    r, c = x.shape
    rec = {"phase": "reject", **sec, "shape": [r, c],
           "plan": list(rk.launch_plan(r, c)),
           **kernel_timing(lambda: rk.argsort_rows(x),
                           lambda: rk.argsort_rows_plain(x),
                           lambda: torch.argsort(x, dim=-1, stable=True),
                           floor_ms),
           **argsort_bound(x, rate)}
    return rec, launches


def phase_e2e():
    """The live pipeline at 5000 x 30000 on the card, held to the JAX
    engine's per-node counts."""
    from kubernetes_tpu_torch.kubemark import gpu_evidence
    from kubernetes_tpu_torch.kubemark.fixtures import E2E_COUNTS

    want = E2E_COUNTS
    sec = gpu_evidence.section_e2e(want["n_nodes"], want["n_pods"])
    if sec["scheduled"] != want["n_pods"]:
        raise AssertionError(f"e2e bound {sec['scheduled']} of "
                             f"{want['n_pods']} pods")
    if (sec["counts_sha256"], sec["counts_bound"]) != (want["sha256"],
                                                      want["bound"]):
        raise AssertionError(
            f"e2e per-node counts {sec['counts_sha256']} / "
            f"{sec['counts_bound']} differ from the JAX engine's "
            f"{want['sha256']} / {want['bound']}")
    return {"phase": "e2e", **sec, "counts_ok": True}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from kubernetes_tpu_torch.kubemark.gpu_evidence import (card_line,
                                                            launch_floor_ms)
    from kubernetes_tpu_torch.sched.device import bounds
    from kubernetes_tpu_torch.sched.device import filter_kernel as fk
    from kubernetes_tpu_torch.sched.device import reject_kernel as rk

    card = card_line()

    def stamp(rec):
        emit({**rec, "card": card})

    stamp(phase_build())
    rate = bounds.card_rate()
    floor_ms = launch_floor_ms()
    stamp({"phase": "floor", "launch_floor_ms": floor_ms, **rate})
    filt = phase_filter(rate, floor_ms)
    stamp(filt)
    fk.filter_masks.launches = 0          # the main path starts here
    for rec in phase_engine():
        stamp(rec)
    ext = phase_extender()
    stamp(ext)
    launches = fk.filter_masks.launches   # ... and ends here
    if launches == 0:
        raise AssertionError("the main path never launched the filter "
                             "kernel")
    reject, reject_launches = phase_reject(rate, floor_ms)
    stamp(reject)
    fk.filter_masks.launches = 0          # the e2e path starts here
    rk.argsort_rows.launches = 0
    stamp({**phase_e2e(),                 # ... and ends here
           "filter_launches": fk.filter_masks.launches,
           "argsort_launches": rk.argsort_rows.launches})
    print(card, flush=True)
    emit({"kernels": [{
        "name": "filter_masks", "route": "cuda",
        "source": "kubernetes_tpu_torch/sched/device/csrc/filter_kernel.cu",
        "replaces": "kubernetes_tpu/sched/device/pallas_filter.py:169",
        "launches": launches,
        "main_path_shape": [1, ext["nodes"]],
        "equal_plain": filt["equal_plain"],
        "max_abs_err": filt["max_abs_err"], "shape": filt["shape"],
        "ms": filt["ms"], "plain_ms": filt["plain_ms"],
        "bound_ms": filt["bound_ms"], "bound_by": filt["bound_by"],
        "library_ms": None, "main_path_ms": filt["ms_p1"],
        "main_path_bound_ms": filt["bound_ms_p1"],
        "launch_floor_ms": floor_ms, **rate}, {
        "name": "argsort_rows", "route": "cuda",
        "source": "kubernetes_tpu_torch/sched/device/csrc/reject_kernel.cu",
        "replaces": "kubernetes_tpu/kubemark/tpu_evidence.py:369",
        "launches": reject_launches, "main_path_shape": reject["shape"],
        "equal_plain": reject["reject_parity"],
        "max_abs_err": reject["reject_max_abs_err"],
        "shape": reject["shape"],
        "ms": reject["ms"], "plain_ms": reject["plain_ms"],
        "bound_ms": reject["bound_ms"], "bound_by": reject["bound_by"],
        "library_ms": reject["library_ms"], "main_path_ms": reject["ms"],
        "main_path_bound_ms": reject["bound_ms"],
        "launch_floor_ms": floor_ms, **rate}]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
