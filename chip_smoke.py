#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`kubernetes_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port's main device path once on the card, at the north-star
size, through the entry points a user calls, and holds every kernel and
every answer to a reference:

  build     nvcc-builds every CUDA source (all five at once); no
            kernel, in any instantiation, may spill (`-Xptxas -v`,
            printed to stderr and summarised).
  filter    the predicate-filter kernel on a mixed 8192-pod x 5000-node
            snapshot: bit-equal to its plain PyTorch version on the card
            and to the engine's probe mask; a mask that is neither all
            True nor all False; kernel / plain times beside the bound
            and the launch floor, at that batch shape and at 1 x 5000
            (the extender's launch).
  scan      the scan kernel (K1) and the probe kernel (K5) against their
            plain versions on seeded random tables (fixtures.scan_cases,
            and K1 alone at fixtures.CLUSTER_EDGES: one slot, fewer
            slots than CTAs, every slot fitting, pods pinned across CTAs)
            at 64 pods x 5120 slots, for each tier (node-local,
            SelectorSpread, inter-pod affinity, ServiceAntiAffinity,
            all four with other weights) in both layouts (int32, int64),
            and at the edges, all tiers on: P = 1, N = 1500 and 37 (not
            multiples of the block), every pod invalid, nothing fitting,
            three-word bitsets; every table holds cap == 0, zero requests,
            pinned hosts, exceeded nodes and the FMA trap. The
            assignment and the final State must be bit-equal, and K5's
            mask and total on both of its routes (a cluster a pod: the
            case's 64 pods and its first pod alone; a block a pod), each
            route in all eight instantiations, and at the cluster
            edges. Then K1 on the e2e's chunk (8192 bench pods
            x the 5000-node fleet's 5120 slots): its launch plan (one
            cluster of C >= 8 CTAs, the slots a CTA), device ms with the
            SM clock, power and temperature sampled while it ran, the
            plain version's ms for the same chunk (bit-equal), the bound
            and the launch floor; K5 at 8192 x 5000 and 1 x 5000 (the
            filter phase's snapshot), bit-equal, and timed likewise.
  engine    BatchEngine.run_chunked(enc, 8192) on the 5000 x 30000 plain
            and 5000 x 8192 spread fixtures; the assignment's sha256 and
            bound count must equal SMOKE_DIGESTS, the JAX engine's answer;
            the scan kernel launched once a chunk and no eager step.
  extender  the extender sidecar (ExtenderServer + DeviceBackend on the
            card) answers 3 Filter and 3 Prioritize requests over 5000
            nodes through the port's HTTP client; the answers must equal
            those of a DeviceBackend on the CPU, and the filter kernel
            (Filter) and the probe kernel (Prioritize) must have
            launched.
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
            every 600 s) and the device table mirror on; every pod bound
            and the per-node counts equal to E2E_COUNTS (the JAX
            engine's answer); at least one tile off the mirror (delta
            or reuse), and the scan kernel launched for every tile at
            least, its time on the card in situ (`k1_device_ms`, CUDA
            events around the launches, read when each tile's
            assignment is pulled). Chained and unchained tiles, the
            upload bytes and the scatter kernel's launches are reported
            (a run whose tiles all chain or reuse the mirror scatters
            nothing: that depends on the host's speed against the
            heartbeats, so the scatter kernel's count is read in the
            mirror phase).
  mirror    the table mirror's own path on the e2e fleet: two unchained
            tiles of 8192 bench pods through run_chunked, a heartbeat of
            one 500-node shard between them; the second tile's prologue
            (both tables' dirty rows, the run's State, the pods) must be
            one launch of the scatter kernel and, by torch.profiler, one
            host-to-device copy, and its host ms is timed; both tiles
            bind as an engine that uploads in full.
  scatter   the scatter kernel on a delta tile's prologue over the
            5000-node fleet's tables (5120 slots), at the mirror phase's
            rows and at 5000 rows of each table: bit-equal to its plain
            version and to `index_copy_` a column plus `copy_` a State
            column; kernel / plain / PyTorch times beside the bound and
            the launch floor.
  spec      the speculative engine (K6): BatchEngine(speculative=True)
            on K1's e2e chunk and the engine fixtures, equal to the scan
            engine (assignment, State) and to the JAX digests (the spec
            path); then its pass (K6a) and repair (K6b) held to their
            plain versions and K1 on fixtures.scan_cases' tables (K6's
            tiers, both layouts, blocks of 256 and 7) and on the spread
            fixture's first 512 pods; K6 timed against K1 on the e2e
            chunk and the spread fixture, a block's K6a and K6b beside
            their bounds.
  preempt   an IncrementalEncoder over 5000 nodes, each full by CPU with
            16 bound pods of seeded priorities (80,000 pods), and 64
            seeded preemptors: victim_table -> BatchEngine.find_victims
            on the card for each, equal to oracle_find_victims field for
            field and to the plain version; the sha256 over the 64
            results equal to PREEMPT_DIGEST (the JAX engine's answer);
            the victim kernel timed at 5120 x 16 and at the one-victim
            table (5120 x 1); the 64 searches' time split into the
            host's packing, launch and pull and the device's upload and
            kernel (BatchEngine.victim_stats).
  no_fallback  a victim-kernel launch the card refuses (more threads a
            block than it takes), swapped in: find_victims raises and
            returns nothing; restored, the search equals the oracle.
            The same for the scatter kernel: a refused launch in its
            place makes run_chunked raise on a tile off the mirror; and
            for the scan kernel (a cluster of 32 CTAs), the probe
            kernel on both routes and K6a and K6b (2048 threads a
            block): run_chunked and probe raise, and restored, equal the
            CPU engine.
  shard     the node-axis mesh on one card (fixtures.SHARD_COUNTS: 2, 4
            and 8 virtual shards, a cluster each): the sharded K1 (K7,
            the exchange between the shards, inside it) on the scan
            cases' tables padded to the shards (fixtures.SHARD_CASES,
            both layouts) and at the cluster edges, bit-equal to K1 (the
            assignment, every State field, every shard's replicas of the
            replicated counts), four cases also to the sharded plain
            twin; on the e2e's chunk bit-equal to K1 at every count and
            to the twin on its first 256 pods; BatchEngine(mesh=...) on
            the engine fixtures, equal to SMOKE_DIGESTS at every count;
            the sharded victim search over the preempt phase's 64 tables
            equal to PREEMPT_DIGEST at every count, and to the unsharded
            kernel and its twin on the widest table; then the sharded
            K1's device ms a chunk against K1's at 1, 2, 4 and 8 shards
            with the SM clock, beside K7's bound and its latency floor
            (one relaxed hop through L2 a pod), and the sharded K4's.
  shard_path  the batch loop over NodeMesh([card] * 4) on the e2e fleet
            (the e2e phase's traffic): every pod bound, the per-node
            counts equal to E2E_COUNTS, the sharded K1 launched and K1
            not; the survivor drill (fixtures.shard_survivor_drill: four
            shard leases on a FakeClock, shard 2's owner dies after the
            first half of the pods binds, its lease expires while a
            tile of the second half is in flight, the loop fences,
            re-shards onto 3 and requeues that tile's pods under
            shard-2, every pod binds, nothing reaches the commit path
            under the dead epoch); and, in a process of its own, a
            shard that withholds its first candidate record: the other
            shards' spin traps past its budget and the synchronize
            raises (gpu_evidence.shard_wedge_child).
  soak      the churn soak (kubemark/soak.py) at 5000 hollow nodes and
            5000 pods a cycle for 45 s: its leak gates hold from the
            warm baseline to the end (RSS, watchers, threads, store
            keys, the encoder's ledger, the modeler's tombstones), at
            least two cycles, K1 launched at least once a cycle; RSS,
            threads and the caching allocator's allocated bytes at the
            baseline and the end are printed.
  shard_soak  the shard-kill soak (kubemark/shard_soak.py) over
            NodeMesh([card] * 4) on the e2e's fleet (5120 slots) and
            chunk, 30000 pods: the seeded kill of shard 1 at 8066 bound
            pods, a tile held in flight while its lease expires, fence,
            re-shard onto 3, the tile dropped whole and requeued,
            converged and bit-exact against a clean run on 3 shards;
            the sharded K1 launched before and after the re-shard, K1
            never; the seconds and launches of each part.
  chaos     the benchmark's chaos arm: run_scheduling_benchmark(5000,
            30000) with 1 % faults on every verb (seed 7); every pod
            bound exactly once (a watch on the registry); pods/s beside
            the e2e phase's.
  node_chaos  the node-kill soak (kubemark/node_chaos.py) at 1000 nodes
            and 600 replicas under 5 % API faults, 100 nodes killed:
            converged, no pod left on a dead node, at least one
            eviction, the kill set the seed's replay; the recovery
            times.
  durable   the e2e's pipeline (5000 x 30000) over Store(wal_dir,
            fsync_policy="batch"): every pod bound, the per-node counts
            equal to E2E_COUNTS; then Store.recover(wal_dir), every
            pod's node and resourceVersion and the revision equal to
            the live store's; the WAL's frames and bytes, the recovery's
            seconds and records a second, pods/s beside the e2e's.
  native    the same over NativeStore(wal_dir) (the C++ store, built
            from native/kvstore.cc with g++ in the build phase) and
            NativeStore.recover.
  split     `python -m kubernetes_tpu_torch` as three processes:
            apiserver (native store, NamespaceAutoProvision),
            hollow-fleet (5000 nodes, heartbeats every 60 s) and
            scheduler (batch, on the card); 15000 pods over HttpClient
            in batch POSTs of 128 (SLO_5K.json's density tier): all
            bound once and Running, no node over its capacity, the
            counts equal to fixtures.SPLIT_COUNTS (the JAX engine's),
            the scheduler on the card (its READY line names
            device=cuda, nvidia-smi lists it, and the launch counts it
            prints as it exits hold K1 and K3 at least once), every
            child exiting 0 on SIGTERM; the seconds to the last POST,
            the last binding and the last pod Running, each component's
            start-up seconds, the scheduler's launches.
  crash     the process-crash soak (kubemark/crash_soak.py) at 1000
            hollow nodes (heartbeats every 10 s) and 3000 replicas, then
            1500 more after the last kill: a WAL-backed store behind an
            ApiServer, two batch schedulers on the card and two
            controller managers, each pair under lease election, 5 % API
            faults on every verb, and a seeded CrashPlan killing the
            apiserver (the store recovered from its WAL), the active
            scheduler (reaped: its threads ended, its engine's device
            tables released) and the active controller manager.
            tests/test_chaos.py's gates: converged, the recovered store
            equal to the pre-crash ledger, no duplicate binding, no
            term violation, all three kills applied and the schedule
            the seed's replay, both terms at 2 or more, every
            durability counter moved; both engines on the card, K1
            launched, and K3 on every tile off the table mirror (the
            RC's pods carry spread groups, so their tiles upload in full
            and K3 is not on this path). Prints the elapsed, converge
            and recovery seconds, the replayed records, the kill points,
            the launches and the allocated device bytes before and
            after.
  mixed     mixed mode (factory.create_mixed): the device probe on the
            card and one HTTP extender (the port's ExtenderServer over a
            CPU backend) place 8 pods on 5000 nodes, one at a time; the
            bindings equal those of the same policy on device="cpu",
            and the probe kernel launched.

Bounds (`kubernetes_tpu_torch/sched/device/bounds.py`): the larger of the
bytes over 3.35 TB/s and the 32-bit integer operations over the card's
integer rate (SMs x 64 INT32 lanes x maximum SM clock), and for K1 and
K5 their f64 operations over the FP64 rate (SMs x 64 FP64 lanes x the
same clock); every record with a bound names the rates
(`int_ops_per_s`, `fp64_ops_per_s`, `sm_clock_mhz`, `sms`).
The launch floor is the device time of a kernel that does nothing,
timed like every kernel (20 launches in one CUDA graph).

Eighteen paths are driven in this process, each with the kernel launch
counts set to 0 just before it and read just after: the engine and extender phases (the
scan kernel a chunk, the filter kernel a Filter, the probe kernel a
Prioritize), the reject phase (the argsort kernel), the e2e phase (the
scan kernel a chunk, the scatter kernel a tile), the mirror phase (the
scatter kernel, and the scan kernel), the spec path (K6a and K6b a
block), the preempt phase's 64 searches (the victim kernel), the shard
phase's 3 x 64 searches over a mesh (the sharded victim kernel), the
shard path's batch loop over a mesh (the sharded scan kernel a chunk,
K7 inside it), the soak (the scan kernel, the scatter kernel), the
shard-kill soak (the sharded scan kernel on 4 shards and then 3), the
chaos arm and the node-kill soak (the scan kernel, the scatter kernel),
the density SLO over a real apiserver at 5000 nodes x 15000 pods and the
chaos soak over HTTP (the scan kernel, the scatter kernel), the e2e over
a journaled Store and over the native store (the scan kernel, the
scatter kernel), the process-crash soak (the scan kernel) and the mixed
phase (the probe kernel a pod). The split
deployment's scheduler launches in a process of its own, which starts
with its counts at 0 and prints them as it exits on SIGTERM (the scan
kernel, the scatter kernel).
Each phase prints one JSON line; a failed check raises, so the script
exits non-zero and prints no result. Every line carries the card's name
and power limit (nvidia-smi). The last lines are the card's line, the
kernel table, and {"ok": true, "device": {...}}. The kernel table gives
for each kernel: route, source, the TPU kernel it replaces, its launches
on its path, the phase(s) they were counted in (`launches_path`), their
shape (`main_path_shape`), `equal_plain`,
`max_abs_err`, `ms` / `plain_ms` / `library_ms` / `bound_ms` at the timed
shape (`shape`), `main_path_ms` / `main_path_bound_ms`, the launch floor
and the integer rate; K1's also its cluster (`cluster`, `ctas`,
`slots_per_cta`, `threads_per_cta`), the SM clock while it was timed and
its device ms in the e2e (`e2e_device_ms`); the scatter kernel's its
launches a tile and the delta tile's profiler counts and host ms; K6b's
the chunk's ms against K1's at both fixtures; the sharded K1's its
ms at 1, 2, 4 and 8 shards against K1's (`by_shards`); K7's the
sharded K1's ms less K1's on the same chunk, its plain cost the sharded
twin's less the plain scan's, its bound (the records' bytes) and its
latency floor (`hop_floor_ms`: the chunk's pods x one relaxed hop
through L2, read with profile_kernels.hop_cycles, the L2 hop probe
built beside the kernels); every kernel's launches on the soak, shard
soak, chaos, node-chaos, SLO, HTTP chaos and crash paths
(`launches_soak_paths`) and on the durable, native and split paths
(`launches_store_paths`). Needs
one CUDA device;
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
SCATTER_SEED = 13
MIXED_PODS = 8
# the soak and chaos paths: the churn soak at SOAK_5K.json's shape (a
# 45 s window, tests/test_soak.py's depth, which keeps the smoke's time;
# the 10,000-event watch window fills by design before the baseline, as
# in tests/test_soak.py),
# the shard-kill soak at the e2e's
# fleet and chunk, the benchmark's chaos arm at the e2e's size, and the
# node-kill soak at tests/test_chaos.py's fleet-scale gate
SOAK_SHAPE = {"duration_s": 45.0, "n_nodes": 5000, "pods_per_cycle": 5000,
              "sample_every_s": 2.0, "history_window": 10_000}
SHARD_SOAK_SHAPE = {"n_shards": 4, "n_nodes": 5000, "node_capacity": 5120,
                    "n_pods": 30000, "tile": 8192, "seed": 0}
CHAOS_ARM = {"chaos_seed": 7, "chaos_error_rate": 0.01}
NODE_CHAOS_SHAPE = {"n_nodes": 1000, "replicas": 600, "kill_fraction": 0.10,
                    "seed": 77, "fault_rate": 0.05, "timeout": 420.0,
                    "heartbeat_interval": 2.0, "monitor_period": 0.3,
                    "monitor_grace_period": 6.0,
                    "pod_eviction_timeout": 0.5}
# the HTTP plane: the reference's density SLO (3 pods a node,
# density.go:203-208) at the 5000-node fleet over a real apiserver, not
# cut; and tests/test_chaos.py's chaos soak at its own size with the
# scheduler fed through the HTTP watch path
SLO_SHAPE = {"n_nodes": 5000, "n_pods": 15000}
HTTP_CHAOS_SHAPE = {"seed": 0, "replicas": 16, "n_nodes": 6,
                    "fault_rate": 0.05, "timeout": 150.0,
                    "transport": "http"}


# the durable store and the split deployment: the e2e's pipeline over a
# store that writes a WAL (batch fsync) and over the native store with
# its WAL, each recovered and read back; the north star's deployment,
# apiserver | hollow-fleet | scheduler in processes of their own, at
# SLO_5K.json's density tier (fixtures.SPLIT_COUNTS)
SPLIT_SHAPE = "5000x15000"
# the controller manager under the process-crash soak: the reference
# density test's 3 pods a node (density.go:203-208) on NODE_CHAOS_SHAPE's
# 1000-node fleet (the north star's 5000 cut for the smoke's time), the
# reference kubelet's 10 s node-status period against the node
# controller's 40 s grace; the soak's compressed lease timings
CRASH_SHAPE = {"n_nodes": 1000, "replicas": 3000, "seed": 0,
               "fault_rate": 0.05, "heartbeat_interval": 10.0,
               "timeout": 300.0}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def phase_build():
    import torch

    from kubernetes_tpu_torch.kubemark.profile_kernels import L2_HOP_SOURCE
    from kubernetes_tpu_torch.sched.device import (_build, filter_kernel,
                                                   reject_kernel,
                                                   scan_kernel,
                                                   scatter_kernel,
                                                   victim_kernel)
    t0 = time.monotonic()
    # the kernels, and the L2 hop probe K7's floor is read with
    records = _build.build_all([filter_kernel.SOURCE, reject_kernel.SOURCE,
                                scatter_kernel.SOURCE, victim_kernel.SOURCE,
                                scan_kernel.SOURCE, L2_HOP_SOURCE])
    # the native store's library (g++), which the split deployment's
    # apiserver loads: built here, before any child process starts
    from kubernetes_tpu_torch.core import native_store
    t_native = time.monotonic()
    native_lib = native_store._load_library()._name
    native_s = time.monotonic() - t_native
    entries = {}
    for r in records:
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                print(f"ptxas {os.path.basename(r['source'])}: "
                      f"{line.strip()}", file=sys.stderr)
        entries.update(ptxas_entries(r["log"]))
    # no kernel (each instantiation) may spill
    spilled = {k: v for k, v in entries.items()
               if v["spill_stores"] or v["spill_loads"]}
    if spilled:
        raise AssertionError(f"kernels that spill: {spilled}")
    return {"phase": "build", "seconds": time.monotonic() - t0,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "libraries": [os.path.relpath(r["library"], ROOT)
                          for r in records + [{"library": native_lib}]],
            "native_store_s": native_s,
            "ptxas": {k: [v["registers"], v["spill_stores"]]
                      for k, v in entries.items()}}


def ptxas_entries(log: str) -> dict:
    """`-Xptxas -v` output -> {kernel (mangled name): registers, spill
    stores and spill loads in bytes}."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m[1]
            out[name] = {"registers": 0, "spill_stores": 0, "spill_loads": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_stores"] = int(m[1])
            out[name]["spill_loads"] = int(m[2])
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m[1])
    return out


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
    tables = engine.device_args(enc)
    args = fk.FilterArgs.from_engine(*tables)
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
                                          "ops")}}, tables


def phase_scan(rate, floor_ms, mixed_tables):
    """K1 and K5 held bit-equal to their plain versions on seeded random
    tables (each tier, both layouts, the edge shapes), then timed: K1 on
    the e2e's chunk, K5 on the filter phase's snapshot at 8192 x 5000
    and 1 x 5000. -> (record, {"k1", "k5", "k5_p1"} timings)."""
    import torch

    from kubernetes_tpu_torch.kubemark.benchmark import _bench_pod
    from kubernetes_tpu_torch.kubemark.fixtures import (CLUSTER_EDGES,
                                                        SCAN_DEGENERATE,
                                                        SMOKE_CHUNK,
                                                        cluster_edge_tables,
                                                        fleet_encoder,
                                                        scan_cases,
                                                        scan_tables)
    from kubernetes_tpu_torch.kubemark.gpu_evidence import (probe_timing,
                                                            scan_args,
                                                            scan_parity,
                                                            scan_timing)
    from kubernetes_tpu_torch.sched.device import BatchEngine
    from kubernetes_tpu_torch.sched.device import engine as eng_mod
    from kubernetes_tpu_torch.sched.device import scan_kernel as sk

    engine = BatchEngine()
    dev = engine.device
    rec = {"phase": "scan", "cases": {}, "max_abs_err": 0}
    k5_codes = {}                  # K5's route -> instantiations held
    t0 = time.monotonic()
    for name, case in scan_cases().items():
        tables = scan_tables(**case["tables"])
        a = scan_args(*(eng_mod._upload(t, dev) for t in tables))
        got = scan_parity(a, case["weights"], case["anti_weight"],
                          case["has_aff"], case["has_spread"])
        if not got["equal"]:
            bad = [f for f, ok in got["fields"].items() if not ok]
            raise AssertionError(f"scan {name}: the kernels differ from "
                                 f"their plain versions in {bad}")
        degenerate = name.split("/")[0] in SCAN_DEGENERATE
        if (got["placed"] == 0) != degenerate:
            raise AssertionError(f"scan {name}: {got['placed']} pods "
                                 f"placed")
        d = a.dims()
        code = sk.variant(case["tables"]["wide"], True, case["has_aff"],
                          bool(case["anti_weight"]))
        for route, c in got["probe_clusters"].items():
            k5_codes.setdefault(
                "cluster" if c > 1 else "block", set()).add(code)
        rec["cases"][name] = [d["p"], d["n"], got["placed"],
                              got["probe_clusters"]]
        rec["max_abs_err"] = max(rec["max_abs_err"], got["max_abs_err"])
    # K1's cluster edges, with no tier and with every tier on
    rec["edges"] = {}
    for name in CLUSTER_EDGES:
        for tiers in (False, True):
            a = scan_args(*(eng_mod._upload(t, dev)
                            for t in cluster_edge_tables(name)))
            b = a._replace(state=eng_mod._clone_state(a.state))
            flags = ((1, 1, 1), 2 if tiers else 0, tiers, tiers)
            got = sk.scan_chunk(a, *flags)
            want = sk.scan_chunk_plain(b, *flags)
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and all(
                    torch.equal(x, y) for x, y in zip(a.state, b.state))):
                raise AssertionError(f"scan edge {name} (tiers {tiers}): "
                                     f"K1 differs from its plain version")
            # K5 there too, on its cluster route (the edge's pods and its
            # first pod alone) and a block a pod
            pflags = flags[:3]
            p_mask, p_total = sk.probe_plain(a, *pflags)
            for b, sms, rows in ((a, None, slice(None)), (a, 1, slice(None)),
                                 (a.pod_slice(0, 1), None, slice(0, 1))):
                mask, total = sk.probe(b, *pflags, sms=sms)
                torch.cuda.synchronize()
                if not (torch.equal(mask, p_mask[rows])
                        and torch.equal(total, p_total[rows])):
                    raise AssertionError(f"probe edge {name} (tiers "
                                         f"{tiers}, sms {sms}): K5 differs "
                                         f"from its plain version")
            rec["edges"][f"{name}/{'all' if tiers else 'none'}"] = [
                a.dims()["p"], a.dims()["n"], int((got >= 0).sum())]
    rec["parity_s"] = time.monotonic() - t0
    every = {sk.variant(wide, True, aff, anti) for wide in (False, True)
             for aff in (False, True) for anti in (False, True)}
    for route in ("cluster", "block"):
        if k5_codes.get(route) != every:
            raise AssertionError(f"K5's {route} route was held to its plain "
                                 f"version in {k5_codes.get(route)}, not "
                                 f"in all of {sorted(every)}")
    rec["k5_instantiations"] = {r: sorted(c) for r, c in k5_codes.items()}

    # K1 on the e2e's chunk: 8192 bench pods against the fleet's slots
    inc = fleet_encoder()
    enc = inc.encode_tile([_bench_pod(i) for i in range(SMOKE_CHUNK)], [],
                          [])
    a = scan_args(*engine.device_args(enc))
    flags = engine._enc_flags(enc)
    plan = sk.launch_plan(sk.SCAN, a.dims(), a.dtype == torch.int64,
                          flags[1], flags[0], False)
    if plan.cluster < min(sk.CLUSTERS) or plan.grid != plan.cluster:
        raise AssertionError(f"K1's plan is not one cluster of 8 CTAs or "
                             f"more: {plan}")
    k1 = scan_timing(a, engine.weights, 0, *flags, rate, floor_ms)
    if not k1["equal_plain"]:
        raise AssertionError("K1 differs from its plain version on the "
                             "e2e's chunk")
    # K5 on the filter phase's snapshot, the batch and the extender's pod
    big = scan_args(*mixed_tables)
    one = big.pod_slice(1, 2)
    timed = {"k1": {**k1, "plan": plan}}
    for key, b in (("k5", big), ("k5_p1", one)):
        mask, total = sk.probe(b, engine.weights, 0, False)
        p_mask, p_total = sk.probe_plain(b, engine.weights, 0, False)
        torch.cuda.synchronize()
        if not (torch.equal(mask, p_mask) and torch.equal(total, p_total)):
            raise AssertionError(f"K5 differs from its plain version at "
                                 f"{tuple(mask.shape)}")
        plan = sk.launch_plan(sk.PROBE, b.dims(), b.dtype == torch.int64,
                              True, False, False, sms=sk.card_sms())
        timed[key] = {**probe_timing(b, engine.weights, 0, False, rate,
                                     floor_ms),
                      "shape": list(mask.shape), "cluster": plan.cluster,
                      "threads": plan.threads}
    rec.update(equal_plain=True, k1_shape=[a.dims()["p"], a.dims()["n"]],
               k1_flags=list(flags),
               **{f"{key}_{f}": t[f] for key, t in timed.items()
                  for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                            "bytes", "ops", "f64_ops")},
               k1_restore_ms=k1["restore_ms"],
               k1_cluster=plan.cluster, k1_ctas=plan.grid,
               k1_slots_per_cta=plan.slots, k1_threads=plan.threads,
               k1_smem=plan.smem,
               **{f"k1_{f}": k1[f] for f in ("sm_clock_mhz", "power_draw_w",
                                              "temperature_c",
                                              "smi_samples")},
               k1_fitting_elements=k1["fitting_elements"],
               k1_placed=k1["placed"], k5_call_ms=timed["k5"]["call_ms"],
               k5_p1_call_ms=timed["k5_p1"]["call_ms"],
               k5_cluster=timed["k5"]["cluster"],
               k5_p1_cluster=timed["k5_p1"]["cluster"],
               k5_p1_threads=timed["k5_p1"]["threads"])
    return rec, timed


def phase_engine():
    import torch

    from kubernetes_tpu_torch.kubemark.fixtures import (SMOKE_CHUNK,
                                                        SMOKE_DIGESTS,
                                                        assigned_digest,
                                                        engine_snapshot,
                                                        smoke_pod_pad)
    from kubernetes_tpu_torch.sched.device import BatchEngine, encode_snapshot
    from kubernetes_tpu_torch.sched.device import scan_kernel as sk

    engine = BatchEngine()
    records, encs = [], {}
    for name, want in SMOKE_DIGESTS.items():
        t0 = time.monotonic()
        enc = encode_snapshot(
            engine_snapshot(want["n_nodes"], want["n_pods"], want["plain"]),
            pod_pad_to=smoke_pod_pad(want["n_pods"]))
        encode_s = time.monotonic() - t0
        torch.cuda.synchronize()
        before = sk.scan_chunk.launches
        t0 = time.monotonic()
        assigned, _ = engine.run_chunked(enc, SMOKE_CHUNK)
        run_s = time.monotonic() - t0
        launched = sk.scan_chunk.launches - before
        chunks = enc.pod_batch.valid.shape[0] // SMOKE_CHUNK
        if launched != chunks or engine.scan_stats["eager_steps"]:
            raise AssertionError(
                f"{name}: {launched} scan launches for {chunks} chunks, "
                f"{engine.scan_stats['eager_steps']} eager steps")
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
            "sha256": sha, "digest_ok": True, "chunks": chunks,
            "scan_launches": launched,
            "eager_steps": engine.scan_stats["eager_steps"]})
        encs[name] = enc
    return records, encs


def phase_extender():
    from kubernetes_tpu_torch.kubemark.fixtures import mixed_snapshot
    from kubernetes_tpu_torch.sched.api import ExtenderConfig
    from kubernetes_tpu_torch.sched.device import filter_kernel as fk
    from kubernetes_tpu_torch.sched.device import scan_kernel as sk
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
    probes_before = sk.probe.launches
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
                probes_card = sk.probe.launches - probes_before
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
    if probes_card < len(pods):
        raise AssertionError(f"probe kernel launched {probes_card} times "
                             f"for {len(pods)} Prioritize requests")
    return {"phase": "extender", "nodes": n_nodes,
            "requests": 2 * len(pods), "filter_fit": fits, "equal_cpu": True,
            "filter_s": [f for f, _ in seconds],
            "prioritize_s": [p for _, p in seconds],
            "filter_kernel_launches": launches_card,
            "probe_kernel_launches": probes_card}


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
    up = sec["upload_stats"]
    if up["delta_tiles"] + up["reuse_tiles"] < 1:
        raise AssertionError(f"e2e: no tile ran off the table mirror: {up}")
    if sec["scheduled"] != want["n_pods"]:
        raise AssertionError(f"e2e bound {sec['scheduled']} of "
                             f"{want['n_pods']} pods")
    if (sec["counts_sha256"], sec["counts_bound"]) != (want["sha256"],
                                                      want["bound"]):
        raise AssertionError(
            f"e2e per-node counts {sec['counts_sha256']} / "
            f"{sec['counts_bound']} differ from the JAX engine's "
            f"{want['sha256']} / {want['bound']}")
    if not sec["k1_device_ms"] or sec["k1_device_ms"] <= 0:
        raise AssertionError(f"e2e: no K1 device time in situ: "
                             f"{sec['scan_stats']}")
    return {"phase": "e2e", **sec, "counts_ok": True,
            **{k: up[k] for k in ("full_tiles", "delta_tiles", "reuse_tiles",
                                  "full_bytes", "delta_bytes")}}


def phase_mirror():
    """The table mirror's path (BatchEngine.run_chunked over the
    encoder's tiles) on the e2e fleet: a tile of 8192 bench pods seeds
    the mirror; a heartbeat of one 500-node shard and the tile's own
    placements dirty node and State rows, so the next unchained tile
    scatters them. That delta tile's prologue must be one launch of the
    scatter kernel (both tables' rows and the run's State) and one
    host-to-device copy; torch.profiler counts the kernels and copies
    the card ran for the tile's prologue, and _wrapper_ms times the
    prologue on the host (the mirror's generations set back before each
    call, so each repeats the delta tile). Each tile is held equal to an
    engine that uploads in full. -> (record, (node rows, State rows) of
    the delta tile)."""
    import numpy as np

    from kubernetes_tpu_torch.kubemark.benchmark import _bench_pod
    from kubernetes_tpu_torch.kubemark.fixtures import (E2E_COUNTS,
                                                        SMOKE_CHUNK,
                                                        fleet_encoder)
    from kubernetes_tpu_torch.kubemark.fleet import HollowFleet
    from kubernetes_tpu_torch.sched.device import BatchEngine
    from kubernetes_tpu_torch.sched.device import scatter_kernel as sk

    n = E2E_COUNTS["n_nodes"]
    fleet = HollowFleet(None, n, cpu="4", memory="32Gi",
                        max_pods=E2E_COUNTS["max_pods"])
    inc = fleet_encoder()
    delta, full = BatchEngine(), BatchEngine()
    full.delta_uploads = False
    rows_before = sk.launch_staged.rows
    launches_before = sk.launch_staged.launches
    bound, per_tile, rows = 0, [], None
    for t in range(2):
        if t:
            # one shard of the fleet's heartbeat (PERF.md section 4)
            for i in range(min(500, n)):
                inc.on_node_update(fleet._node_object(i),
                                   fleet._node_object(i))
        pods = [_bench_pod(t * SMOKE_CHUNK + j) for j in range(SMOKE_CHUNK)]
        enc = inc.encode_tile(pods, [], [])
        before = sk.launch_staged.launches
        if t:
            cache = delta._table_cache
            gens = (cache.node_gen, cache.state_gen)
            d = enc.delta
            rows = (int((d.node_dirty_gen > gens[0]).sum()),
                    int((d.state_dirty_gen > gens[1]).sum()))
        got, _ = delta.run_chunked(enc, SMOKE_CHUNK)
        per_tile.append(sk.launch_staged.launches - before)
        want, _ = full.run_chunked(enc, SMOKE_CHUNK)
        if not np.array_equal(got, want):
            raise AssertionError(f"mirror tile {t}: the delta upload binds "
                                 f"differently from the full upload")
        if t:
            prologue = _measure_prologue(delta, enc, gens)
        inc.assume_assigned(enc, pods, got)
        bound += int((got[:enc.n_pods] >= 0).sum())
    up = delta.upload_stats
    launches = sk.launch_staged.launches - launches_before
    if up["delta_tiles"] < 1 or min(rows) < 1:
        raise AssertionError(f"mirror: no tile scattered both tables' "
                             f"rows: {up}, rows {rows}")
    if per_tile[1] != 1:
        raise AssertionError(f"mirror: the delta tile took {per_tile[1]} "
                             f"scatter launches, not one")
    prof = prologue["profile"]
    if max(prof["h2d_copies"], prof["copy_calls"], prof["kernels"],
           prof["launch_calls"]) > 1:
        raise AssertionError(f"mirror: the delta tile's prologue took "
                             f"more than one copy and one launch: {prof}")
    return ({"phase": "mirror", "tiles": 2, "bound": bound,
             "equal_full": True, "scatter_launches": launches,
             "launches_per_tile": per_tile,
             "delta_rows": {"node": rows[0], "state": rows[1]},
             "scatter_rows": sk.launch_staged.rows - rows_before,
             "prologue_profile": prof,
             "prologue_host_ms": prologue["host_ms"],
             **{k: up[k] for k in ("full_tiles", "delta_tiles",
                                   "reuse_tiles", "delta_bytes",
                                   "table_bytes")}},
            rows)


def _measure_prologue(engine, enc, gens):
    """The delta tile's prologue again, measured and not counted:
    torch.profiler's counts of one call and its host ms (_wrapper_ms),
    the mirror's generations set back to `gens` before each call so that
    each scatters the same rows (into the mirror, the same values); then
    the launch counts, the upload stats and the generations restored."""
    from kubernetes_tpu_torch.kubemark.fixtures import SMOKE_CHUNK
    from kubernetes_tpu_torch.kubemark.gpu_evidence import profile_counts
    from kubernetes_tpu_torch.sched.device import scatter_kernel as sk
    counts = (sk.launch_staged.launches, sk.launch_staged.rows)
    stats = dict(engine.upload_stats)
    cache = engine._table_cache
    done = (cache.node_gen, cache.state_gen)
    flags = engine._enc_flags(enc)

    def again():
        cache.node_gen, cache.state_gen = gens
        return engine._prologue(enc, flags, SMOKE_CHUNK)

    out = {"profile": profile_counts(again), "host_ms": _wrapper_ms(again)}
    cache.node_gen, cache.state_gen = done
    sk.launch_staged.launches, sk.launch_staged.rows = counts
    engine.upload_stats.update(stats)
    return out


def phase_scatter(rate, floor_ms, path_rows):
    """The scatter kernel on a delta tile's prologue over the e2e fleet's
    tables (gpu_evidence.prologue_staged: both tables' rows into the
    mirror, the State rows also into the run's State, the 13 copies), at
    the mirror phase's rows and at 5000 rows of each table, the rows
    spread over the whole table: bit-equal to its plain version and to
    the PyTorch calls (index_copy_ a column, copy_ a State column);
    kernel / plain / PyTorch times beside the bound and the launch
    floor, and the host's whole prologue (_wrapper_ms). -> (record,
    timings by rows)."""
    import torch

    from kubernetes_tpu_torch.kubemark.fixtures import E2E_COUNTS
    from kubernetes_tpu_torch.kubemark.gpu_evidence import (kernel_timing,
                                                            prologue_staged,
                                                            prologue_tables)
    from kubernetes_tpu_torch.sched.device import BatchEngine, bounds
    from kubernetes_tpu_torch.sched.device import scatter_kernel as sk

    dev = BatchEngine().device
    n = E2E_COUNTS["n_nodes"]
    rec = {"phase": "scatter", "path_rows": list(path_rows),
           "equal_plain": True, "equal_library": True, "max_abs_err": 0,
           "prologues": {}}
    timed = {}
    for r_node, r_state in sorted({tuple(path_rows), (n, n)}):
        sides = {}
        for who in ("kernel", "plain", "library"):
            node, state, nr, sr = prologue_tables(dev, r_node, r_state)
            staged, run = prologue_staged(sk, dev, node, state, nr, sr)
            sides[who] = (node, state, run, staged, nr, sr)
        sk.launch_staged(sides["kernel"][3])
        sk.prologue_plain(sides["plain"][3])
        node, state, run, _, nr, sr = sides["library"]
        lib_args = (node, state, run, [
            (torch.from_numpy(idx).to(dev),
             [torch.from_numpy(sk._host_view(a)).to(dev) for a in rows])
            for idx, rows in (nr, sr)])
        index_copy(*lib_args)
        torch.cuda.synchronize()
        k, p, lib = (tuple(sides[w][0]) + tuple(sides[w][1])
                     + tuple(sides[w][2]) for w in ("kernel", "plain",
                                                    "library"))
        for got, want, other in zip(k, p, lib):
            err = int((got.long() - want.long()).abs().max())
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if not torch.equal(got, want):
                raise AssertionError(f"scatter kernel != plain version "
                                     f"({r_node} + {r_state} rows)")
            if not torch.equal(got, other):
                raise AssertionError(f"scatter kernel != index_copy_ and "
                                     f"copy_ ({r_node} + {r_state} rows)")
        staged = sides["kernel"][3]
        pstaged = sides["plain"][3]

        def wrapper(node=sides["kernel"][0], state=sides["kernel"][1],
                    nr=nr, sr=sr):
            sk.apply_staged(prologue_staged(sk, dev, node, state, nr,
                                            sr)[0])

        t = {**kernel_timing(lambda: sk.launch_staged(staged),
                             lambda: sk.prologue_plain(pstaged),
                             lambda: index_copy(*lib_args), floor_ms),
             "wrapper_ms": _wrapper_ms(wrapper),
             **bounds.prologue_bound(staged.nbytes, rate),
             "descriptors": staged.n_desc, "grid_x": staged.grid_x,
             "rows": [r_node, r_state]}
        rec["prologues"][f"{r_node}+{r_state}"] = t
        timed[(r_node, r_state)] = t
    return rec, timed


def index_copy(node, state, run, rows) -> None:
    """A delta tile's prologue as PyTorch calls, from rows already on
    the card: one typed `index_copy_` a mirror column, one `copy_` a
    State column into the run's State (the PyTorch yardstick of the
    scatter kernel, `library_ms`, which the port never calls)."""
    from kubernetes_tpu_torch.sched.device import engine as eng
    for tab, fields, (idx, blocks) in ((node, eng._NODE_ROW_FIELDS, rows[0]),
                                       (state, eng._STATE_ROW_FIELDS,
                                        rows[1])):
        for f, r in zip(fields, blocks):
            getattr(tab, f).index_copy_(0, idx, r)
    for d, s in zip(run, state):
        d.copy_(s)


def _wrapper_ms(fn) -> float:
    """Host-clock ms of one whole call (pack on the host, one copy, one
    launch) up to its completion, the median of 20."""
    import statistics

    import torch
    times = []
    for _ in range(23):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[3:])


def phase_spec_path(encs):
    """The speculative engine's path through the entry point a user
    calls, BatchEngine(speculative=True).run_chunked(enc, 8192): on K1's
    e2e chunk (8192 bench pods on the e2e fleet's 5120 slots) and on the
    engine fixtures (SMOKE_DIGESTS, encoded by the engine phase). Each
    must bind as the scan engine does, with the same final State, and the
    fixtures' digests must equal the JAX engine's; every chunk takes K6
    and none an eager step. -> (record, the e2e chunk's encoding)."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.kubemark.benchmark import _bench_pod
    from kubernetes_tpu_torch.kubemark.fixtures import (SMOKE_CHUNK,
                                                        SMOKE_DIGESTS,
                                                        assigned_digest,
                                                        fleet_encoder)
    from kubernetes_tpu_torch.sched.device import BatchEngine

    chunk_enc = fleet_encoder().encode_tile(
        [_bench_pod(i) for i in range(SMOKE_CHUNK)], [], [])
    rec = {"phase": "spec_path", "runs": {}}
    for name, enc in (("k1_chunk", chunk_enc), *encs.items()):
        spec = BatchEngine(speculative=True)
        scan = BatchEngine()
        t0 = time.monotonic()
        got, g_state = spec.run_chunked(enc, SMOKE_CHUNK)
        spec_s = time.monotonic() - t0
        t0 = time.monotonic()
        want, w_state = scan.run_chunked(enc, SMOKE_CHUNK)
        scan_s = time.monotonic() - t0
        torch.cuda.synchronize()
        if not np.array_equal(got, want) or not all(
                torch.equal(x, y) for x, y in zip(g_state, w_state)):
            raise AssertionError(f"spec {name}: K6 binds otherwise than K1")
        chunks = enc.pod_batch.valid.shape[0] // SMOKE_CHUNK
        st = spec.scan_stats
        if st["spec_chunks"] != chunks or st["eager_steps"] \
                or scan.scan_stats["spec_chunks"]:
            raise AssertionError(f"spec {name}: {st} for {chunks} chunks")
        sha, bound = assigned_digest(got, enc.n_pods)
        if name in SMOKE_DIGESTS and (sha, bound) != (
                SMOKE_DIGESTS[name]["sha256"], SMOKE_DIGESTS[name]["bound"]):
            raise AssertionError(f"spec {name}: assignment {sha} / {bound} "
                                 f"differs from the JAX engine's")
        rec["runs"][name] = {
            "pods": enc.n_pods, "chunks": chunks, "bound": bound,
            "sha256": sha, "equal_k1": True, "spec_run_s": spec_s,
            "scan_run_s": scan_s, "spec_device_ms": st["device_ms"],
            "scan_device_ms": scan.scan_stats["device_ms"]}
    return rec, chunk_enc


def _chunk_ms(a, fn) -> float:
    """Device ms of fn(a) on one chunk from a.state each time: a graph of
    restores and calls, less the restores' own graph."""
    from kubernetes_tpu_torch.kubemark.gpu_evidence import device_ms
    init = [t.clone() for t in a.state]

    def restore():
        for t, s in zip(a.state, init):
            t.copy_(s)

    def call():
        restore()
        fn(a)

    ms = device_ms(call, reps=5, trials=3) - device_ms(restore, reps=5,
                                                       trials=3)
    restore()
    return ms


def phase_spec(rate, floor_ms, encs, chunk_enc):
    """K6a and K6b held to their plain versions and K1 on seeded random
    tables (fixtures.scan_cases, each case's tables on K6's tiers: the
    spread tier as the case has it, no affinity, no ServiceAntiAffinity;
    both layouts; blocks of 256 and 7), then timed: on K1's e2e chunk
    (K6 == K1, the chunk, K6a and K6b on its first block, bounds from
    this run's rescores, K1's own ms in the same turn) and on the spread
    fixture's chunk (the same; K6 == its plain version on the first 512
    pods). -> (record, timings)."""
    import torch

    from kubernetes_tpu_torch.kubemark.fixtures import (SCAN_DEGENERATE,
                                                        scan_cases,
                                                        scan_tables)
    from kubernetes_tpu_torch.kubemark.gpu_evidence import (scan_args,
                                                            spec_parity,
                                                            spec_timing)
    from kubernetes_tpu_torch.sched.device import BatchEngine
    from kubernetes_tpu_torch.sched.device import engine as eng_mod
    from kubernetes_tpu_torch.sched.device import scan_kernel as sk

    engine = BatchEngine()
    dev, w = engine.device, engine.weights
    rec = {"phase": "spec", "cases": {}, "max_abs_err": 0}
    codes = set()
    t0 = time.monotonic()
    for name, case in scan_cases().items():
        tables = scan_tables(**case["tables"])
        a = scan_args(*(eng_mod._upload(t, dev) for t in tables))
        got = spec_parity(a, case["weights"], case["has_spread"])
        if not got["equal"]:
            bad = [f for f, ok in got["fields"].items() if not ok]
            raise AssertionError(f"spec {name}: K6 differs from its plain "
                                 f"version or K1 in {bad}")
        if (got["placed"] == 0) != (name.split("/")[0] in SCAN_DEGENERATE):
            raise AssertionError(f"spec {name}: {got['placed']} placed")
        codes.add(sk.variant(case["tables"]["wide"], case["has_spread"],
                             False, False))
        rec["cases"][name] = [a.dims()["p"], a.dims()["n"], got["placed"],
                              got["slow"]]
        rec["max_abs_err"] = max(rec["max_abs_err"], got["max_abs_err"])
    if codes != {0, 4, 8, 12}:
        raise AssertionError(f"K6 was held in instantiations {codes}")
    rec["parity_s"] = time.monotonic() - t0

    timed = {}
    spread = encs["spread_5000x8192"]
    for key, enc in (("chunk", chunk_enc), ("spread", spread)):
        flags = engine._enc_flags(enc)
        a = scan_args(*engine.device_args(enc))
        k1 = scan_args(*engine.device_args(enc))
        k1_ms = _chunk_ms(k1, lambda x: sk.scan_chunk(x, w, 0, *flags))
        t = spec_timing(a, w, flags[1], rate, floor_ms)
        want = sk.scan_chunk(k1, w, 0, *flags)
        torch.cuda.synchronize()
        if not torch.equal(t.pop("assigned"), want) or not all(
                torch.equal(x, y) for x, y in zip(a.state, k1.state)):
            raise AssertionError(f"spec {key}: K6 differs from K1 at "
                                 f"{a.dims()['p']} x {a.dims()['n']}")
        t.update(k1_ms=k1_ms, shape=[a.dims()["p"], a.dims()["n"]],
                 winner="spec" if t["ms"] < k1_ms else "scan")
        timed[key] = t
    # the spread fixture's first 512 pods against the plain versions
    a = scan_args(*engine.device_args(spread)).pod_slice(0, 512)
    got = spec_parity(a, w, True, blocks=(256,))
    if not got["equal"]:
        raise AssertionError("spec: K6 differs from its plain version on "
                             "the spread fixture's first 512 pods")
    rec["spread_512"] = [got["placed"], got["slow"]]
    rec.update(equal_plain=True, equal_k1=True,
               **{f"{key}_{f}": t[f] for key, t in timed.items()
                  for f in ("ms", "k1_ms", "winner", "bound_ms",
                            "bound_by", "launches", "blocks", "entries",
                            "rescored", "slow_pods", "sm_clock_mhz",
                            "shape")},
               **{f"{key}_{part}": t[part] for key, t in timed.items()
                  for part in ("pass", "repair")})
    return rec, timed


def _spec_refusals():
    """Launches of K6a, then of K6b, that the card refuses (2048 threads
    a block) in place of the real ones: run_chunked on a speculative
    engine must raise and return nothing, with no launch of the refused
    kernel counted; restored, it equals the CPU engine. -> the errors."""
    import numpy as np

    from kubernetes_tpu_torch.kubemark.fixtures import mixed_snapshot
    from kubernetes_tpu_torch.sched.device import BatchEngine, encode_snapshot
    from kubernetes_tpu_torch.sched.device import spec_kernel as spk

    enc = encode_snapshot(mixed_snapshot(FILTER_SEED, 64, 8, 10))
    engine = BatchEngine(speculative=True)
    real = spk._launch
    errors = {}
    for kind, name, fn in ((spk.PASS, "pass", spk.spec_pass),
                           (spk.REPAIR, "repair", spk.spec_repair)):
        before = fn.launches
        spk._launch = lambda p, *rest, kind=kind: real(
            p._replace(threads=2048) if p.kind == kind else p, *rest)
        got = None
        try:
            got = engine.run_chunked(enc, 8)
        except RuntimeError as e:
            errors[name] = str(e)
        finally:
            spk._launch = real
        if got is not None or name not in errors or fn.launches != before:
            raise AssertionError(f"a refused speculative {name} launch did "
                                 f"not raise through run_chunked")
    cpu = BatchEngine(device="cpu", speculative=True)
    if not np.array_equal(engine.run_chunked(enc, 8)[0],
                          cpu.run_chunked(enc, 8)[0]):
        raise AssertionError("the speculative run after a refused launch "
                             "differs from the CPU engine's")
    return errors


def phase_preempt(rate, floor_ms):
    """The full-width preemption fixture through victim_table and the
    victim kernel, each search held to the oracle and the plain version,
    the 64 results to PREEMPT_DIGEST. -> (record, the kernel's launches
    in the 64 searches, a table at the widest victim axis, the 64
    tables)."""
    import numpy as np

    from kubernetes_tpu_torch.kubemark import fixtures as fx
    from kubernetes_tpu_torch.kubemark.gpu_evidence import (device_ms,
                                                            kernel_timing)
    from kubernetes_tpu_torch.sched.device import BatchEngine, bounds
    from kubernetes_tpu_torch.sched.device import victim_kernel as vk
    from kubernetes_tpu_torch.sched.preemption import oracle_find_victims

    t0 = time.monotonic()
    spec = fx.preempt_spec()
    inc = fx.preempt_encoder(spec)
    pods = fx.preempt_pods(spec)
    build_s = time.monotonic() - t0
    engine = BatchEngine()
    dev = engine.device
    results, tables = [], []
    seconds = {"table": 0.0, "search": 0.0, "oracle": 0.0}
    vk.victim_search.launches = 0         # this path starts here
    launches = 0
    for pod in pods:
        t0 = time.monotonic()
        table = inc.victim_table(pod)
        t1 = time.monotonic()
        got = engine.find_victims(table)
        t2 = time.monotonic()
        launches += vk.victim_search.launches
        vk.victim_search.launches = 0
        want = oracle_find_victims(table)
        seconds["table"] += t1 - t0
        seconds["search"] += t2 - t1
        seconds["oracle"] += time.monotonic() - t2
        if ((got.pick, got.kstar, got.feasible)
                != (want.pick, want.kstar, want.feasible)
                or not np.array_equal(got.node_kstar, want.node_kstar)
                or not np.array_equal(got.node_score, want.node_score)
                or got.victim_keys(table) != want.victim_keys(table)):
            raise AssertionError(f"{pod.metadata.name}: the victim search "
                                 f"on the card differs from the oracle")
        p_pick, p_kstar, p_score = vk.victim_search_plain(
            vk.VictimArgs.from_table(table, dev))
        if (int(p_pick) != got.pick
                or not np.array_equal(p_kstar.cpu().numpy(), got.node_kstar)
                or not np.array_equal(p_score.cpu().numpy(),
                                      got.node_score)):
            raise AssertionError(f"{pod.metadata.name}: the victim kernel "
                                 f"differs from its plain version")
        results.append((got, table))
        tables.append(table)
    digest = fx.preempt_digest(results)     # ... and ends at the last one
    if digest != fx.PREEMPT_DIGEST:
        raise AssertionError(f"preempt digest {digest} differs from the "
                             f"JAX engine's {fx.PREEMPT_DIGEST}")
    if launches != len(pods):
        raise AssertionError(f"victim kernel launched {launches} times "
                             f"for {len(pods)} searches")
    feasible = sum(r.feasible for r, _ in results)
    if not 0 < feasible < len(results):
        raise AssertionError(f"degenerate preempt fixture: {feasible} of "
                             f"{len(results)} feasible")
    # the main path's widest table, timed (the search with the most
    # victims walked among the widest ones); a one-victim table likewise
    wide = fx.widest_table(tables)
    args = vk.VictimArgs.from_table(wide, dev)
    read, steps = vk.walk(args)
    n, v = args.shape
    timing = {**kernel_timing(lambda: vk.victim_search(args),
                              lambda: vk.victim_search_plain(args), None,
                              floor_ms),
              **bounds.victim_bound(n, read, steps, rate),
              "walk_read": read, "walk_steps": steps,
              "plan": list(vk.launch_plan(n, v, vk.card_sms()))}
    one = min(tables, key=lambda t: (t.v, -int(t.v_valid.sum())))
    one_args = vk.VictimArgs.from_table(one, dev)
    timing["one"] = {
        "shape": list(one_args.shape),
        "plan": list(vk.launch_plan(*one_args.shape, vk.card_sms())),
        "ms": device_ms(lambda: vk.victim_search(one_args))}
    split = {k: engine.victim_stats[k] for k in
             ("pack_s", "launch_s", "pull_s", "upload_ms", "kernel_ms")}
    rec = {"phase": "preempt", "nodes": wide.n, "bound_pods": len(spec[1]),
           "preemptors": len(pods), "shape": [n, v],
           "victim_axes": sorted({t.v for t in tables}),
           "feasible": feasible,
           "evicting": sum(r.kstar > 0 for r, _ in results),
           "zero_request": sum(t.zero_req for t in tables),
           "build_s": build_s, **{f"{k}_s": x for k, x in seconds.items()},
           "search_split": split,
           "plans": sorted({tuple(vk.launch_plan(t.n, t.v, vk.card_sms()))
                            for t in tables}),
           "digest": digest, "digest_ok": True, "equal_oracle": True,
           "equal_plain": True, "max_abs_err": 0, **timing}
    return rec, launches, wide, tables



# the scan cases the shard phase also holds to the sharded plain twin
# (its per-pod loop of tensor ops costs ~1 s a case on the card): every
# tier at once in both layouts, and ServiceAntiAffinity and affinity
SHARD_TWIN_CASES = ("all/i32", "all/i64", "service_anti/i64",
                    "affinity/i32")
# pods of the e2e chunk the sharded K1 and its twin are timed on
SHARD_PLAIN_PODS = 256
SHARD_TIMED = 4                           # shards of the timed chunk


def phase_shard_kernels(rate, floor_ms, ptables):
    """The sharded K1 (K7 inside) and the sharded K4 on one card, at
    fixtures.SHARD_COUNTS virtual shards. -> (record, timings)."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.kubemark import fixtures as fx
    from kubernetes_tpu_torch.kubemark.benchmark import _bench_pod
    from kubernetes_tpu_torch.kubemark.gpu_evidence import (call_ms,
                                                            device_ms,
                                                            scan_args,
                                                            shard_parity,
                                                            shard_timing,
                                                            victim_shard_parity)
    from kubernetes_tpu_torch.sched.device import (BatchEngine, NodeMesh,
                                                   bounds, encode_snapshot)
    from kubernetes_tpu_torch.sched.device import engine as eng_mod
    from kubernetes_tpu_torch.sched.device import scan_kernel as sk
    from kubernetes_tpu_torch.sched.device import victim_kernel as vk

    import math

    t0 = time.monotonic()
    engine = BatchEngine()
    dev = engine.device
    rec = {"phase": "shard", "shards": list(fx.SHARD_COUNTS), "cases": {},
           "max_abs_err": 0}
    # (a) the scan cases: each sharded launch against K1, some against
    # the twin as well; the cluster edges against K1
    for name, case in fx.scan_cases().items():
        if name.split("/")[0] not in fx.SHARD_CASES:
            continue
        for shards in fx.SHARD_COUNTS:
            tables = fx.shard_pad(fx.scan_tables(**case["tables"]), shards)
            a = scan_args(*(eng_mod._upload(t, dev) for t in tables))
            got = shard_parity(a, case["weights"], case["anti_weight"],
                               case["has_aff"], case["has_spread"], shards,
                               twin=name in SHARD_TWIN_CASES)
            if not got["equal"]:
                bad = [f for f, ok in got["fields"].items() if not ok]
                raise AssertionError(f"shard {name} at {shards}: the sharded "
                                     f"K1 differs in {bad[:8]}")
            rec["cases"][f"{name}@{shards}"] = [
                got["placed"], got["plan"]["cluster"],
                name in SHARD_TWIN_CASES]
            rec["max_abs_err"] = max(rec["max_abs_err"], got["max_abs_err"])
    for name in fx.CLUSTER_EDGES:
        for shards in fx.SHARD_COUNTS:
            tables = fx.shard_pad(fx.cluster_edge_tables(name), shards)
            a = scan_args(*(eng_mod._upload(t, dev) for t in tables))
            got = shard_parity(a, (1, 1, 1), 2, True, True, shards,
                               twin=False)
            if not got["equal"]:
                raise AssertionError(f"shard edge {name} at {shards}: the "
                                     f"sharded K1 differs from K1")
    rec["parity_s"] = time.monotonic() - t0
    # the e2e's chunk (8192 bench pods x the fleet's 5120 slots) against
    # K1, then the twin on its first pods; its device ms against K1's
    inc = fx.fleet_encoder()
    enc = inc.encode_tile([_bench_pod(i) for i in range(fx.SMOKE_CHUNK)],
                          [], [])
    a = scan_args(*engine.device_args(enc))
    flags = engine._enc_flags(enc)
    for shards in fx.SHARD_COUNTS:
        got = shard_parity(a, engine.weights, 0, *flags, shards, twin=False)
        if not got["equal"] or got["placed"] != fx.SMOKE_CHUNK:
            raise AssertionError(f"shard: the sharded K1 at {shards} differs "
                                 f"from K1 on the e2e chunk")
        rec[f"e2e_chunk_plan_{shards}"] = got["plan"]
    head = a.pod_slice(0, SHARD_PLAIN_PODS)
    got = shard_parity(head, engine.weights, 0, *flags, SHARD_TIMED)
    if not got["equal"]:
        raise AssertionError("shard: the sharded K1 differs from its twin "
                             "on the e2e chunk's first pods")
    init = [t.clone() for t in a.state]
    space = sk.ShardSpace(SHARD_TIMED, a.dims(), dev)

    def twin():
        return sk.scan_chunk_sharded_plain(head, engine.weights, 0, *flags,
                                           space)

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    twin()
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    for t, s in zip(a.state, init):
        t.copy_(s)

    def head_kernel():
        for t, s in zip(a.state, init):
            t.copy_(s)
        sk.scan_chunk_sharded(head, engine.weights, 0, *flags, space)

    head_ms = device_ms(head_kernel, reps=5, trials=3)
    start.record()
    sk.scan_chunk_plain(head, engine.weights, 0, *flags)
    end.record()
    end.synchronize()
    unsharded_plain_ms = start.elapsed_time(end)
    for t, s in zip(a.state, init):
        t.copy_(s)
    timings = {s: shard_timing(a, engine.weights, 0, *flags, s, rate)
               for s in (1,) + tuple(fx.SHARD_COUNTS)}
    for t, s in zip(a.state, init):
        t.copy_(s)
    # K7's latency floor on the timed chunk: a pod's exchanges in
    # series, each at least one relaxed hop through L2 between distant
    # SMs (profile_kernels.hop_cycles)
    from kubernetes_tpu_torch.kubemark import profile_kernels as pk
    pair = pk.far_pair(dev)
    hop = pk.hop_cycles(dev, *pair, 0)
    valid = int(a.pods.valid.sum())
    k7_hop = {"relaxed_hop_cycles": hop, "sm_ids": list(pair),
              "pods": valid,
              "floor_ms": pk.hop_floor_ms(valid, hop, rate["sm_clock_mhz"])}
    d = a.dims()
    # the engine's digests over a mesh
    digests = {}
    for name, want in fx.SMOKE_DIGESTS.items():
        enc = encode_snapshot(
            fx.engine_snapshot(want["n_nodes"], want["n_pods"],
                               want["plain"]),
            node_pad_to=math.lcm(*fx.SHARD_COUNTS),
            pod_pad_to=fx.smoke_pod_pad(want["n_pods"]))
        for shards in fx.SHARD_COUNTS:
            mesh_engine = BatchEngine(mesh=NodeMesh([dev] * shards))
            assigned, _ = mesh_engine.run_chunked(enc, fx.SMOKE_CHUNK)
            sha, bound = fx.assigned_digest(assigned, enc.n_pods)
            if (sha, bound) != (want["sha256"], want["bound"]):
                raise AssertionError(
                    f"shard {name} at {shards}: assignment {sha} / {bound} "
                    f"differs from the JAX engine's {want['sha256']}")
            if mesh_engine.scan_stats["eager_steps"]:
                raise AssertionError(f"shard {name}: eager steps on a mesh")
            digests[f"{name}@{shards}"] = sha
    # (b) the sharded K4 over the preempt phase's 64 tables
    _zero_counts()                        # the sharded search path
    results = []
    for shards in fx.SHARD_COUNTS:
        mesh_engine = BatchEngine(mesh=NodeMesh([dev] * shards))
        got = [(mesh_engine.find_victims(t), t) for t in ptables]
        digest = fx.preempt_digest(got)
        if digest != fx.PREEMPT_DIGEST:
            raise AssertionError(f"shard: the sharded victim search at "
                                 f"{shards} gives {digest}, not the JAX "
                                 f"engine's {fx.PREEMPT_DIGEST}")
        results.append(digest)
    k4_launches = _read_counts()["victim_search_sharded"]
    if k4_launches != len(ptables) * len(fx.SHARD_COUNTS):
        raise AssertionError(f"the sharded victim kernel launched "
                             f"{k4_launches} times")
    wide = fx.widest_table(ptables)
    args = vk.VictimArgs.from_table(wide, dev)
    k4_err = 0
    for shards in fx.SHARD_COUNTS:
        got = victim_shard_parity(args, shards)
        if not got["equal"]:
            raise AssertionError(f"shard: the sharded victim kernel at "
                                 f"{shards} differs from its twin")
        k4_err = max(k4_err, got["max_abs_err"])
    read, steps = vk.walk(args)
    n, v = args.shape
    k4 = {"ms": device_ms(lambda: vk.victim_search_sharded(args,
                                                           SHARD_TIMED)),
          "k4_ms": device_ms(lambda: vk.victim_search(args)),
          # the twin pulls each shard's winner to the host: no graph
          "plain_ms": call_ms(
              lambda: vk.victim_search_sharded_plain(args, SHARD_TIMED),
              warmup=1, reps=5),
          "shape": [n, v], "max_abs_err": k4_err,
          **bounds.victim_bound(n, read, steps, rate)}
    rec.update(
        e2e_chunk_equal=True, digests=digests, digests_ok=True,
        preempt_digests=results, preempt_ok=True,
        k1_plain_shape=[SHARD_PLAIN_PODS, d["n"]], k1_plain_ms=plain_ms,
        unsharded_plain_ms=unsharded_plain_ms,
        k1_ms_at_plain_shape=head_ms,
        timing={s: {k: t[k] for k in (
            "ms", "k1_ms", "cluster", "ctas", "slots_per_cta",
            "threads_per_cta", "sm_clock_mhz", "k7_bound_ms", "k7_bytes")}
            for s, t in timings.items()},
        k4=k4, k7_hop=k7_hop, seconds=time.monotonic() - t0)
    return rec, {"timings": timings, "k4": k4, "plain_ms": plain_ms,
                 "k7_hop": k7_hop,
                 "unsharded_plain_ms": unsharded_plain_ms,
                 "head_ms": head_ms, "k4_launches": k4_launches}


def phase_shard_path():
    """(c) the batch loop over NodeMesh(["cuda:0"] * 4) on the e2e fleet:
    every pod bound and the per-node counts equal to E2E_COUNTS (the JAX
    engine's answer); (d) the survivor drill: a shard's lease expires
    while a tile is in flight, the loop re-shards onto 3 before the next
    dispatch, requeues the tile's pods and nothing reaches the commit
    path under the dead epoch; (f) the wedged exchange raising,
    in a process of its own. -> the record, with the kernels' launches
    counted over (c), the path."""
    from kubernetes_tpu_torch.kubemark import gpu_evidence
    from kubernetes_tpu_torch.kubemark.fixtures import (E2E_COUNTS,
                                                        shard_survivor_drill)
    from kubernetes_tpu_torch.sched.device import NodeMesh
    from kubernetes_tpu_torch.sched.device.engine import resolve_device

    want = E2E_COUNTS
    dev = resolve_device(None)
    t0 = time.monotonic()
    _zero_counts()                        # the shard path starts here
    sec = gpu_evidence.section_e2e(want["n_nodes"], want["n_pods"],
                                   mesh=NodeMesh([dev] * SHARD_TIMED))
    launches = _read_counts()             # ... and ends here
    if launches["scan_chunk_sharded"] < 1 or launches["scan_chunk"]:
        raise AssertionError(f"the shard path launched {launches}")
    if sec["scheduled"] != want["n_pods"] or \
            (sec["counts_sha256"], sec["counts_bound"]) != (
                want["sha256"], want["bound"]):
        raise AssertionError(f"shard e2e: {sec['scheduled']} bound, counts "
                             f"{sec['counts_sha256']} differ from the JAX "
                             f"engine's {want['sha256']}")
    e2e_s = time.monotonic() - t0
    drill = shard_survivor_drill()
    if not (drill["first_half_bound"] and drill["second_half_bound"]
            and drill["mesh_after"] == drill["shards"] - 1
            and drill["reshards"] == 1
            and drill["in_flight_at_expiry"] >= 1
            and drill["requeued_in_flight"] == drill["in_flight_at_expiry"]
            and drill["handed_under_dead_epoch"] == 0):
        raise AssertionError(f"shard survivor drill: {drill}")
    wedge = gpu_evidence.shard_wedge_child()
    if not wedge.get("raised") or wedge.get("rc") != 0:
        raise AssertionError(f"shard: the withheld record did not raise: "
                             f"{wedge}")
    return {"phase": "shard_path", "mesh": SHARD_TIMED,
            "launches": launches,
            "e2e": {k: sec[k] for k in (
                "pods_per_sec", "elapsed_s", "scheduled", "tiles_chained",
                "tiles_unchained", "k1_device_ms", "counts_sha256")},
            "e2e_s": e2e_s, "counts_ok": True, "drill": drill,
            "wedge": wedge, "seconds": time.monotonic() - t0}



def phase_soak():
    """The churn soak (kubemark/soak.py) on the card at SOAK_SHAPE: each
    cycle creates a wave of pods, waits until all are Running, deletes
    them and waits until the store forgets them; the leak gates
    (SoakResult.check: RSS, watchers, threads, store keys, the encoder's
    ledger, the modeler's tombstones) hold from the warm baseline to the
    end, at least two cycles ran and K1 launched at least once a cycle.
    -> the record, with the launches counted over the soak."""
    from kubernetes_tpu_torch.kubemark.soak import run_soak

    t0 = time.monotonic()
    _zero_counts()                        # the soak path starts here
    r = run_soak(**SOAK_SHAPE)
    launches = _read_counts()             # ... and ends here
    r.check()
    if r.cycles < 2:
        raise AssertionError(f"soak: {r.cycles} cycles in "
                             f"{r.duration_s} s")
    if launches["scan_chunk"] < r.cycles:
        raise AssertionError(f"soak: K1 launched {launches['scan_chunk']} "
                             f"times in {r.cycles} cycles")
    b, f = r.baseline, r.final
    return {"phase": "soak", **{k: v for k, v in SOAK_SHAPE.items()},
            "cycles": r.cycles, "pods_churned": r.pods_churned,
            "n_samples": len(r.samples), "duration_s": r.duration_s,
            "rss_kb": [b["rss_kb"], f["rss_kb"]],
            "rss_drift": f["rss_kb"] / b["rss_kb"] - 1.0,
            "threads": [b["threads"], f["threads"]],
            "device_allocated_bytes": [b["device_bytes"], f["device_bytes"]],
            "baseline": b, "final": f, "gates_ok": True,
            "launches": launches, "seconds": time.monotonic() - t0}


def phase_shard_soak():
    """The shard-kill soak (kubemark/shard_soak.py) on NodeMesh([card] *
    4) at SHARD_SOAK_SHAPE: shard 1's owner dies at the seeded kill
    point, a tile is dispatched and held in flight while its lease ages
    out on the FakeClock, the monitor fences it, the encoder and the
    engine re-shard onto 3, the in-flight tile drops whole at the
    shard-epoch fence and requeues, and the rest binds on the survivors;
    converged (every gate of the soak) and the bindings bit-exact against
    a clean run on 3 shards. The sharded K1 launched before the re-shard
    and after it, the unsharded K1 never. -> the record: the seconds up
    to the kill, from the kill through the re-shard, from there to the
    end of the drain, and of the clean run; the launches in each."""
    from kubernetes_tpu_torch.kubemark import shard_soak

    marks = {}

    def mark(name):
        marks[name] = (time.monotonic(), _read_counts())

    class Leases(shard_soak.ShardLeaseSet):
        def kill(self, shard):
            mark("kill")
            super().kill(shard)

    def reshard(*args, **kw):
        out = real_reshard(*args, **kw)
        mark("reshard")
        return out

    def clean(*args, **kw):
        mark("clean")
        return real_clean(*args, **kw)

    real_leases = shard_soak.ShardLeaseSet
    real_reshard = shard_soak.reshard_survivors
    real_clean = shard_soak._run_clean
    shard_soak.ShardLeaseSet = Leases
    shard_soak.reshard_survivors = reshard
    shard_soak._run_clean = clean
    try:
        _zero_counts()                    # the shard-kill path starts here
        mark("start")
        res = shard_soak.run_shard_kill_soak(**SHARD_SOAK_SHAPE)
        mark("end")                       # ... and ends here
    finally:
        shard_soak.ShardLeaseSet = real_leases
        shard_soak.reshard_survivors = real_reshard
        shard_soak._run_clean = real_clean
    out = res.as_dict()
    if not (res.converged and res.parity_ok):
        raise AssertionError(f"shard_soak: {out}")
    if set(marks) != {"start", "kill", "reshard", "clean", "end"}:
        raise AssertionError(f"shard_soak: the run passed {sorted(marks)}")
    order = ("start", "kill", "reshard", "clean", "end")
    spans = dict(zip(("to_kill", "kill_to_reshard", "drain", "clean"),
                     zip(order, order[1:])))
    seconds = {k: marks[b][0] - marks[a][0] for k, (a, b) in spans.items()}
    launches = {k: {n: marks[b][1][n] - marks[a][1][n]
                    for n in marks[b][1]} for k, (a, b) in spans.items()}
    before = marks["reshard"][1]["scan_chunk_sharded"]
    after = (marks["clean"][1]["scan_chunk_sharded"]
             - marks["reshard"][1]["scan_chunk_sharded"])
    if before < 1 or after < 1 or marks["end"][1]["scan_chunk"]:
        raise AssertionError(f"shard_soak: the sharded K1 launched {before} "
                             f"times before the re-shard and {after} after, "
                             f"K1 {marks['end'][1]['scan_chunk']} times")
    return {"phase": "shard_soak", **SHARD_SOAK_SHAPE, **out,
            "replay_rows": res.replay_rows, "seconds_by_phase": seconds,
            "launches_by_phase": launches,
            "sharded_k1_before_reshard": before,
            "sharded_k1_after_reshard": after,
            "launches": marks["end"][1],
            "seconds": marks["end"][0] - marks["start"][0]}


def phase_chaos(e2e_pods_per_sec):
    """The benchmark's chaos arm on the card: run_scheduling_benchmark at
    the e2e's size with every component's client behind the seeded fault
    injector (CHAOS_ARM: 1 % of the calls of every verb fail); every pod
    bound, each binding seen once and never re-pointed (a watch on the
    registry, under no injector). -> the record, pods/s beside the e2e
    phase's (the same pipeline without faults, this run)."""
    import threading
    from kubernetes_tpu_torch.api.client import InProcClient
    from kubernetes_tpu_torch.api.registry import Registry
    from kubernetes_tpu_torch.kubemark.benchmark import \
        run_scheduling_benchmark
    from kubernetes_tpu_torch.kubemark.fixtures import E2E_COUNTS

    n_nodes, n_pods = E2E_COUNTS["n_nodes"], E2E_COUNTS["n_pods"]
    registry = Registry()
    bound_to, rebinds = {}, []
    watcher = InProcClient(registry).watch("pods", "default")

    def track():
        for ev in watcher:
            pod = ev.object
            if ev.type == "DELETED" or not pod.spec.node_name:
                continue
            prev = bound_to.get(pod.metadata.uid)
            if prev is not None and prev != pod.spec.node_name:
                rebinds.append(pod.metadata.name)
            bound_to[pod.metadata.uid] = pod.spec.node_name

    threading.Thread(target=track, daemon=True).start()
    t0 = time.monotonic()
    try:
        _zero_counts()                    # the chaos path starts here
        r = run_scheduling_benchmark(n_nodes, n_pods, "batch",
                                     registry=registry, **CHAOS_ARM)
        launches = _read_counts()         # ... and ends here
        end = time.monotonic() + 60
        while len(bound_to) < n_pods and time.monotonic() < end:
            time.sleep(0.05)
    finally:
        watcher.stop()
    pods, _ = registry.list("pods", "default")
    unbound = sum(1 for p in pods if not p.spec.node_name)
    if (r.scheduled, len(pods), unbound, len(bound_to), len(rebinds)) != (
            n_pods, n_pods, 0, n_pods, 0):
        raise AssertionError(
            f"chaos: {r.scheduled} scheduled, {len(pods)} pods, {unbound} "
            f"unbound, {len(bound_to)} bindings seen, {len(rebinds)} "
            f"re-pointed")
    if launches["scan_chunk"] < 1:
        raise AssertionError(f"chaos: K1 never launched: {launches}")
    return {"phase": "chaos", "nodes": n_nodes, "pods": n_pods,
            **CHAOS_ARM, "scheduled": r.scheduled,
            "bindings_seen": len(bound_to), "rebinds": len(rebinds),
            "elapsed_s": r.elapsed_s, "pods_per_sec": r.pods_per_sec,
            "e2e_pods_per_sec": e2e_pods_per_sec,
            "vs_fault_free": r.pods_per_sec / e2e_pods_per_sec,
            "upload_stats": r.upload_stats, "launches": launches,
            "seconds": time.monotonic() - t0}


def phase_node_chaos():
    """The node-kill soak (kubemark/node_chaos.py) on the card at
    NODE_CHAOS_SHAPE: 5 % API faults on every verb, 10 % of the hollow
    fleet hard-killed once half the replicas are bound; the node
    controller marks them Unknown and evicts their pods, the replication
    manager recreates them, the batch loop binds them on live nodes.
    Converged, no pod bound to a dead node, 100 killed, the kill set the
    seed's pure replay, at least one eviction. -> the record, with the
    recovery times."""
    from kubernetes_tpu_torch.kubemark.node_chaos import run_node_kill_soak

    t0 = time.monotonic()
    _zero_counts()                        # the node-chaos path starts here
    r = run_node_kill_soak(**NODE_CHAOS_SHAPE)
    launches = _read_counts()             # ... and ends here
    out = r.as_dict()
    if not (r.converged and r.dead_bound == 0 and len(r.killed) == 100
            and r.schedule_replayed and r.evictions >= 1):
        raise AssertionError(f"node_chaos: {out}")
    if launches["scan_chunk"] < 1:
        raise AssertionError(f"node_chaos: K1 never launched: {launches}")
    out["killed"] = len(r.killed)
    return {"phase": "node_chaos", **NODE_CHAOS_SHAPE, **out,
            "launches": launches, "seconds": time.monotonic() - t0}

def phase_slo():
    """The density SLO (kubemark/slo.py) on the card at SLO_SHAPE: pod
    writers and probers over HttpClient to the port's ApiServer, the
    hollow fleet and the batch scheduler in-process, the GIL switch
    interval at 1 ms for the run; SLOResult.check() at the full sample
    floor (API p99 < 1 s on every gated endpoint, startup p50 < 5 s),
    every pod Running and K1 launched. -> the record, with the per-verb
    server-side latencies and the launches."""
    from kubernetes_tpu_torch.kubemark.slo import MIN_API_SAMPLES, \
        run_density_slo

    t0 = time.monotonic()
    _zero_counts()                        # the SLO path starts here
    r = run_density_slo(**SLO_SHAPE)
    launches = _read_counts()             # ... and ends here
    out = r.as_dict()
    if r.running != SLO_SHAPE["n_pods"]:
        raise AssertionError(f"slo: {r.running} of {SLO_SHAPE['n_pods']} "
                             f"pods Running: {out}")
    r.check(min_samples=MIN_API_SAMPLES)
    if launches["scan_chunk"] < 1:
        raise AssertionError(f"slo: K1 never launched: {launches}")
    return {"phase": "slo", **SLO_SHAPE, **out,
            "api_verb_counts": {k: v["count"]
                                for k, v in r.api_verbs.items()},
            "min_api_samples": MIN_API_SAMPLES, "launches": launches,
            "seconds": time.monotonic() - t0}


def phase_http_chaos():
    """tests/test_chaos.py's chaos soak on the card at HTTP_CHAOS_SHAPE
    (fixtures.run_chaos_soak): the replication controller, the batch
    scheduler and the hollow fleet over one seeded fault injector on an
    HttpClient to the port's ApiServer, 5 % faults on every verb, one
    forced watch cut. Converged, every binding seen once and never
    re-pointed, the faults the seed's pure replay, K1 launched. -> the
    record."""
    from kubernetes_tpu_torch.chaos import VERBS
    from kubernetes_tpu_torch.kubemark.fixtures import run_chaos_soak

    t0 = time.monotonic()
    _zero_counts()                        # the HTTP chaos path starts here
    ok, rebinds, pods, trace, plan = run_chaos_soak(**HTTP_CHAOS_SHAPE)
    launches = _read_counts()             # ... and ends here
    replayed = all(trace[v] == plan.schedule(v, len(trace[v]))
                   for v in VERBS)
    faults = sum(1 for v in VERBS for f in trace[v] if f)
    if not (ok and not rebinds and replayed):
        raise AssertionError(
            f"http_chaos: converged {ok}, re-pointed {rebinds}, replayed "
            f"{replayed}: {[(p.metadata.name, p.spec.node_name) for p in pods]}")
    if launches["scan_chunk"] < 1:
        raise AssertionError(f"http_chaos: K1 never launched: {launches}")
    return {"phase": "http_chaos", **HTTP_CHAOS_SHAPE, "converged": ok,
            "rebinds": len(rebinds), "pods": len(pods),
            "calls": sum(len(t) for t in trace.values()),
            "faults_injected": faults, "launches": launches,
            "seconds": time.monotonic() - t0}


def phase_store(backend, e2e):
    """The e2e's pipeline (5000 x 30000) over a journaled store on the
    card (kubemark/deployment.run_durable_e2e): backend "python" is
    Store(wal_dir, fsync_policy="batch") ("durable"), "native" the
    native store with its WAL ("native"). Every pod bound, the per-node
    counts equal to E2E_COUNTS; then the store recovered from its
    directory, every pod's node and resourceVersion and the revision
    equal to the live store's. -> the record, pods/s beside the same
    call's e2e, with the WAL's frames and bytes, the recovery's seconds
    and records a second, and the launches."""
    from kubernetes_tpu_torch.kubemark.deployment import run_durable_e2e
    from kubernetes_tpu_torch.kubemark.fixtures import E2E_COUNTS

    name = "durable" if backend == "python" else "native"
    want = E2E_COUNTS
    t0 = time.monotonic()
    _zero_counts()                        # the store's path starts here
    r = run_durable_e2e(want["n_nodes"], want["n_pods"], backend,
                        timeout_s=300.0)
    launches = _read_counts()             # ... and ends here
    if r["scheduled"] != want["n_pods"] or r["pods_unbound"]:
        raise AssertionError(f"{name}: bound {r['scheduled']} of "
                             f"{want['n_pods']} pods, {r['pods_unbound']} "
                             f"unbound in the store")
    if (r["counts_sha256"], r["counts_bound"]) != (want["sha256"],
                                                  want["bound"]):
        raise AssertionError(
            f"{name}: per-node counts {r['counts_sha256']} / "
            f"{r['counts_bound']} differ from the JAX engine's "
            f"{want['sha256']} / {want['bound']}")
    if launches["scan_chunk"] < 1:
        raise AssertionError(f"{name}: K1 never launched: {launches}")
    keep = ("backend", "elapsed_s", "pods_per_sec", "scheduled",
            "tiles_chained", "tiles_unchained", "k1_device_ms", "layers",
            "revision", "pods_live", "wal_frames", "wal_bytes",
            "wal_disk_bytes", "snapshot_rev", "replayed_records",
            "recovery_s", "replayed_per_s", "recovered_equal",
            "counts_sha256")
    return {"phase": name, **{k: r[k] for k in keep}, "counts_ok": True,
            "e2e_elapsed_s": e2e["elapsed_s"],
            "e2e_pods_per_sec": e2e["pods_per_sec"],
            "vs_e2e": r["pods_per_sec"] / e2e["pods_per_sec"],
            "launches": launches, "seconds": time.monotonic() - t0}


def phase_split():
    """The split deployment on the card (kubemark/deployment.run_split):
    `python -m kubernetes_tpu_torch apiserver` over the native store with
    NamespaceAutoProvision, `hollow-fleet` of 5000 nodes (heartbeats
    every 60 s), `scheduler --mode batch --no-rate-limit` on the card, a
    process each; 15000 identical pods over HttpClient in batch POSTs of
    128. Every pod bound once and Running on a node that exists, no node
    over its capacity, the per-node counts equal to
    fixtures.SPLIT_COUNTS (the JAX engine's), the scheduler on the card
    (its READY line names device=cuda; its pid among nvidia-smi's compute
    processes, or one more of them than before it started: in a
    container nvidia-smi lists the host's pids; and the launch counts
    it prints as it exits hold K1 and K3 at least once), every child
    exiting 0 on SIGTERM. -> the record: seconds from the first POST to
    the last pod Running, pods/s, each component's start-up seconds,
    the scheduler's launches (`launches`, counted in its process)."""
    from kubernetes_tpu_torch.kubemark.deployment import run_split
    from kubernetes_tpu_torch.kubemark.fixtures import SPLIT_COUNTS

    want = SPLIT_COUNTS[SPLIT_SHAPE]
    t0 = time.monotonic()
    r = run_split(want["n_nodes"], want["n_pods"], timeout_s=500.0)
    if not r["scheduler_ready"].endswith("device=cuda"):
        raise AssertionError(f"split: the scheduler was not on the card: "
                             f"{r['scheduler_ready']!r}")
    launches = r.pop("scheduler_launches")
    for name in ("scan_chunk", "scatter_prologue"):
        if launches[name] == 0:
            raise AssertionError(f"the split's scheduler never launched "
                                 f"{name}: {launches}")
    if (r["counts_sha256"], r["counts_bound"]) != (want["sha256"],
                                                  want["bound"]):
        raise AssertionError(
            f"split: per-node counts {r['counts_sha256']} / "
            f"{r['counts_bound']} differ from the JAX engine's "
            f"{want['sha256']} / {want['bound']}")
    return {"phase": "split", **r, "counts_ok": True,
            "launches": launches, "seconds": time.monotonic() - t0}


def phase_crash():
    """The process-crash soak on the card at CRASH_SHAPE (see the module
    docstring): tests/test_chaos.py's gates on the result, both engines
    on the card, K1 and K3 launched. -> the record, with the launches and
    the caching allocator's bytes before and after."""
    import torch
    from kubernetes_tpu_torch.kubemark.crash_soak import run_crash_soak

    t0 = time.monotonic()
    before = torch.cuda.memory_allocated()
    _zero_counts()                        # the crash path starts here
    r = run_crash_soak(**CRASH_SHAPE)
    launches = _read_counts()             # ... and ends here
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    out = r.as_dict()
    rec = r.recovery or {}
    gates = {
        "converged": r.converged,
        "recovered": bool(rec) and rec.get("revision_match") is True
        and rec.get("live_set_match") is True
        and rec.get("replayed_records", 0) >= 1,
        "no_duplicate_bindings": r.duplicate_bindings == [],
        "no_term_violations": r.term_violations == [],
        "all_kills": set(r.killed) == {"apiserver", "scheduler",
                                       "controller-manager"},
        "schedule_replayed": r.schedule_replayed,
        "terms": r.terms.get("batch-scheduler", 0) >= 2
        and r.terms.get("controller-manager", 0) >= 2,
        "counters": r.counters.get("wal_records_total", 0) >= 1
        and r.counters.get("wal_recoveries_total", 0) >= 1
        and r.counters.get("leader_transitions_total", 0) >= 4
        and r.counters.get("lease_renew_failures_total", 0) >= 1,
        "engines_on_card": bool(r.engine_devices) and all(
            d.startswith("cuda") for d in r.engine_devices.values()),
        "reaped": r.reaped,
        "k1": launches["scan_chunk"] >= 1,
        # K3 is the prologue of a tile off the table mirror: one launch
        # a delta tile at least (the RC's pods carry SelectorSpread
        # groups, which the mirror's delta path does not take, so their
        # tiles upload in full: BatchEngine._delta_eligible)
        "k3_every_delta_tile": launches["scatter_prologue"]
        >= r.upload_tiles.get("delta", 0)}
    failed = sorted(k for k, ok in gates.items() if not ok)
    if failed:
        raise AssertionError(f"crash: gates {failed} failed: {out}, "
                             f"launches {launches}")
    print(f"crash: elapsed_s {r.elapsed_s} converge_s {r.converge_s} "
          f"recovery_s {rec['seconds']}", flush=True)
    print(f"crash: replayed_records {rec['replayed_records']}", flush=True)
    print(f"crash: kill points {json.dumps(r.killed, sort_keys=True)}",
          flush=True)
    print(f"crash: launches K1 {launches['scan_chunk']} K3 "
          f"{launches['scatter_prologue']}; tiles "
          f"{json.dumps(r.upload_tiles, sort_keys=True)}", flush=True)
    for k in ("duplicate_bindings", "term_violations", "flight_bundles"):
        out[k] = len(out[k])
    return {"phase": "crash", **CRASH_SHAPE, **out, "gates": gates,
            "device_allocated_bytes": [before, after],
            "launches": launches, "seconds": time.monotonic() - t0}


def _scatter_refusal():
    """A scatter-kernel launch the card refuses (the argsort kernel with
    more threads a block than the card takes) in place of the real one,
    on a tile off the table mirror: run_chunked must raise and return
    nothing; restored, the same tile scatters again and equals the CPU
    engine's."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.kubemark import fixtures as fx
    from kubernetes_tpu_torch.sched.device import BatchEngine
    from kubernetes_tpu_torch.sched.device import reject_kernel as rk
    from kubernetes_tpu_torch.sched.device import scatter_kernel as sk

    inc = fx.preempt_encoder(fx.preempt_spec(n_nodes=64, n_preemptors=0))
    tile = [fx._preempt_pod(f"z{i}", "", 0, 0, 0) for i in range(8)]
    engine = BatchEngine()
    enc = inc.encode_tile(tile, [], [])
    assigned, _ = engine.run_chunked(enc, 8)      # seeds the mirror
    inc.assume_assigned(enc, tile, assigned)
    enc = inc.encode_tile(tile[:1], [], [])       # a tile of dirty rows
    ones = torch.ones(8, 128, device=engine.device)
    scratch = torch.empty(8, 128, dtype=torch.int32, device=engine.device)
    real = sk._launch
    before = sk.launch_staged.launches
    got, error = None, None
    sk._launch = lambda staged: rk._launch(
        ones, scratch, rk.launch_plan(8, 128, 2 * rk.MAX_BLOCK_THREADS))
    try:
        got, _ = engine.run_chunked(enc, 8)
    except RuntimeError as e:
        error = str(e)
    finally:
        sk._launch = real
    if got is not None or error is None \
            or sk.launch_staged.launches != before:
        raise AssertionError("a refused scatter launch did not raise "
                             "through run_chunked")
    # the mirror's generations moved only past scatters that landed, so
    # the same tile scatters again
    again, _ = engine.run_chunked(enc, 8)
    want, _ = BatchEngine(device="cpu").run_chunked(enc, 8)
    if not np.array_equal(again, want):
        raise AssertionError("the tile after a refused scatter differs "
                             "from the CPU engine's")
    return error


def _refused_plan(plan):
    """A launch the card refuses: K1 on a cluster of 32 CTAs (past the
    16 a cluster can hold), K5 (either route) and the sharded K1 with
    2048 threads a block (past their launch bounds)."""
    from kubernetes_tpu_torch.sched.device import scan_kernel as sk
    if plan.kind == sk.SCAN:
        return plan._replace(cluster=2 * sk.MAX_CLUSTER,
                             grid=2 * sk.MAX_CLUSTER)
    return plan._replace(threads=2048)


def _scan_refusals():
    """Launches of the scan and probe kernels that the card refuses
    (_refused_plan) in place of the real ones: run_chunked and probe
    must raise and return nothing, with no launch counted; restored,
    both equal the CPU engine's. -> the errors, by call."""
    import numpy as np

    from kubernetes_tpu_torch.kubemark.fixtures import mixed_snapshot
    from kubernetes_tpu_torch.sched.device import (BatchEngine, NodeMesh,
                                                   encode_snapshot)
    from kubernetes_tpu_torch.sched.device import scan_kernel as sk

    enc = encode_snapshot(mixed_snapshot(FILTER_SEED, 64, 8, 10))
    # 160 pods: K5 a block a pod (8 pods take a cluster of 16 CTAs each)
    batch = encode_snapshot(mixed_snapshot(FILTER_SEED, 64, 160, 10))
    engine = BatchEngine()
    meshed = BatchEngine(mesh=NodeMesh([engine.device] * 4))
    calls = {"scan": lambda: engine.run_chunked(enc, 8),
             "probe": lambda: engine.probe(enc),
             "probe_block": lambda: engine.probe(batch),
             "scan_sharded": lambda: meshed.run_chunked(enc, 8)}
    real = sk._launch
    before = (sk.scan_chunk.launches, sk.probe.launches,
              sk.scan_chunk_sharded.launches)
    errors = {}
    sk._launch = lambda plan, dims, ptrs, device, shard=None: real(
        _refused_plan(plan), dims, ptrs, device, shard)
    try:
        for name, call in calls.items():
            got = None
            try:
                got = call()
            except RuntimeError as e:
                errors[name] = str(e)
            if got is not None or name not in errors:
                raise AssertionError(f"a refused {name} launch did not "
                                     f"raise through the engine")
    finally:
        sk._launch = real
    # shards the card cannot hold at once: the plan refuses, the engine
    # raises (no shard waits for an SM while the others spin)
    held = sk.max_active_clusters
    sk.max_active_clusters = lambda code, cluster, threads, smem: 1
    try:
        meshed.run_chunked(enc, 8)
    except ValueError as e:
        errors["scan_sharded_resident"] = str(e)
    finally:
        sk.max_active_clusters = held
    if "scan_sharded_resident" not in errors:
        raise AssertionError("four shards the card cannot hold at once "
                             "did not raise through the engine")
    if (sk.scan_chunk.launches, sk.probe.launches,
            sk.scan_chunk_sharded.launches) != before:
        raise AssertionError("a refused scan or probe launch was counted")
    cpu = BatchEngine(device="cpu")
    if not np.array_equal(engine.run_chunked(enc, 8)[0],
                          cpu.run_chunked(enc, 8)[0]) \
            or not np.array_equal(meshed.run_chunked(enc, 8)[0],
                                  cpu.run_chunked(enc, 8)[0]):
        raise AssertionError("the scan after a refused launch differs "
                             "from the CPU engine's")
    for e in (enc, batch):
        if not all(np.array_equal(x, y) for x, y in zip(engine.probe(e),
                                                        cpu.probe(e))):
            raise AssertionError("the probe after a refused launch differs "
                                 "from the CPU engine's")
    return errors


def phase_no_fallback(table):
    """A victim-kernel launch the card refuses, in place of the real one:
    find_victims must raise and return nothing; restored, the search
    equals the oracle again (the context survived). Then the same for
    the scatter kernel through run_chunked, and the scan and probe
    kernels (both probe routes), and the sharded scan and victim search
    (a refused launch, and four shards the card cannot hold at once)."""
    import numpy as np

    from kubernetes_tpu_torch.sched.device import BatchEngine, NodeMesh
    from kubernetes_tpu_torch.sched.device import victim_kernel as vk
    from kubernetes_tpu_torch.sched.preemption import oracle_find_victims

    engine = BatchEngine()
    real = vk._launch
    before = vk.victim_search.launches
    got, error = None, None
    vk._launch = lambda a, out, plan: real(a, out,
                                           plan._replace(threads=2048))
    try:
        got = engine.find_victims(table)
    except RuntimeError as e:
        error = str(e)
    finally:
        vk._launch = real
    if got is not None or error is None \
            or vk.victim_search.launches != before:
        raise AssertionError("a refused victim-kernel launch did not "
                             "raise through find_victims")
    again, want = engine.find_victims(table), oracle_find_victims(table)
    if (again.pick, again.kstar) != (want.pick, want.kstar) \
            or not np.array_equal(again.node_score, want.node_score):
        raise AssertionError("the victim search after a refused launch "
                             "differs from the oracle")
    # the sharded search likewise
    meshed = BatchEngine(mesh=NodeMesh([engine.device] * 4))
    real_sharded = vk._sharded_launch
    before = vk.victim_search_sharded.launches
    got, sharded_error = None, None
    vk._sharded_launch = lambda a, out, plan, shards, b: real_sharded(
        a, out, plan._replace(threads=2048), shards, b)
    try:
        got = meshed.find_victims(table)
    except RuntimeError as e:
        sharded_error = str(e)
    finally:
        vk._sharded_launch = real_sharded
    if got is not None or sharded_error is None \
            or vk.victim_search_sharded.launches != before:
        raise AssertionError("a refused sharded victim launch did not "
                             "raise through find_victims")
    again = meshed.find_victims(table)
    if (again.pick, again.kstar) != (want.pick, want.kstar) \
            or not np.array_equal(again.node_score, want.node_score):
        raise AssertionError("the sharded victim search after a refused "
                             "launch differs from the oracle")
    scan_errors = _scan_refusals()
    spec_errors = _spec_refusals()
    return {"phase": "no_fallback", "raised": True, "error": error[:200],
            "spec_pass_error": spec_errors["pass"][:200],
            "spec_repair_error": spec_errors["repair"][:200],
            "spec_raised": True,
            "equal_after": True,
            "scatter_error": _scatter_refusal()[:200],
            "scatter_raised": True,
            "scan_error": scan_errors["scan"][:200],
            "probe_error": scan_errors["probe"][:200],
            "probe_block_error": scan_errors["probe_block"][:200],
            "scan_sharded_error": scan_errors["scan_sharded"][:200],
            "scan_sharded_resident_error":
                scan_errors["scan_sharded_resident"][:200],
            "victim_sharded_error": sharded_error[:200],
            "scan_raised": True, "probe_raised": True,
            "sharded_raised": True}


def _mixed_bindings(device, snap, server_url):
    """Mixed mode over snap's nodes with one HTTP extender, its pods
    created one at a time, each bound before the next -> names."""
    from kubernetes_tpu_torch.api.client import InProcClient
    from kubernetes_tpu_torch.api.registry import Registry
    from kubernetes_tpu_torch.sched.api import ExtenderConfig, Policy
    from kubernetes_tpu_torch.sched.factory import ConfigFactory
    from kubernetes_tpu_torch.sched.scheduler import Scheduler

    client = InProcClient(Registry())
    factory = ConfigFactory(client, rate_limit=False).start()
    sched = None
    try:
        config = factory.create_mixed(Policy(extenders=[ExtenderConfig(
            url_prefix=server_url, filter_verb="filter",
            prioritize_verb="prioritize", weight=2, http_timeout=300.0)]),
            device=device)
        if config is None:
            raise AssertionError("the policy does not qualify for mixed "
                                 "mode")
        client.create_batch("nodes", snap.nodes)
        deadline = time.monotonic() + 300
        while len(factory.node_lister.list()) < len(snap.nodes):
            if time.monotonic() > deadline:
                raise AssertionError("mixed: the node cache never synced")
            time.sleep(0.05)
        sched = Scheduler(config).run()
        out, seconds = [], []
        for pod in snap.pending_pods:
            t0 = time.monotonic()
            client.create("pods", pod)
            name = pod.metadata.name
            while not client.get("pods", name, "default").spec.node_name:
                if time.monotonic() > t0 + 300:
                    raise AssertionError(f"mixed: {name} never bound")
                time.sleep(0.01)
            seconds.append(time.monotonic() - t0)
            out.append(client.get("pods", name, "default").spec.node_name)
        return out, seconds
    finally:
        if sched is not None:
            sched.stop()
        factory.stop()


def phase_mixed():
    """Mixed mode on the card against the same policy on the CPU."""
    from kubernetes_tpu_torch.kubemark.fixtures import mixed_snapshot
    from kubernetes_tpu_torch.sched.api import HostPriority
    from kubernetes_tpu_torch.sched.extender_server import (CallableBackend,
                                                            ExtenderServer)

    n_nodes = FILTER_SHAPE[0]
    snap = mixed_snapshot(FILTER_SEED, n_nodes, MIXED_PODS + 1, 0)
    # pod 0 names its node in its spec (already bound): the rest
    snap.pending_pods = snap.pending_pods[1:]

    def tenth(pod, node):              # the extender's own predicate
        return int(node.metadata.name[1:]) % 10 == 1

    def zone_bonus(pod, nodes):
        return [HostPriority(n.metadata.name,
                             10 if n.metadata.labels.get("zone") == "z1"
                             else 0) for n in nodes]

    server = ExtenderServer(CallableBackend(
        predicates=[tenth], prioritizers=[(zone_bonus, 1)])).start()
    try:
        card, card_s = _mixed_bindings(None, snap, server.url)
        cpu, _ = _mixed_bindings("cpu", snap, server.url)
    finally:
        server.stop()
    if card != cpu:
        raise AssertionError(f"mixed mode on the card bound {card}, on "
                             f"the CPU {cpu}")
    if not all(card) or any(int(h[1:]) % 10 != 1 for h in card):
        raise AssertionError(f"mixed mode ignored the extender: {card}")
    return {"phase": "mixed", "nodes": n_nodes, "pods": len(card),
            "bindings": card, "equal_cpu": True, "pod_s": card_s}


def _counts():
    from kubernetes_tpu_torch.sched.device import (filter_kernel,
                                                   reject_kernel,
                                                   scan_kernel,
                                                   scatter_kernel,
                                                   spec_kernel,
                                                   victim_kernel)
    return {"filter_masks": filter_kernel.filter_masks,
            "argsort_rows": reject_kernel.argsort_rows,
            "scatter_prologue": scatter_kernel.launch_staged,
            "victim_search": victim_kernel.victim_search,
            "victim_search_sharded": victim_kernel.victim_search_sharded,
            "scan_chunk": scan_kernel.scan_chunk,
            "scan_chunk_sharded": scan_kernel.scan_chunk_sharded,
            "probe": scan_kernel.probe,
            "spec_pass": spec_kernel.spec_pass,
            "spec_repair": spec_kernel.spec_repair}


def _zero_counts():
    for fn in _counts().values():
        fn.launches = 0
    _counts()["scatter_prologue"].rows = 0


def _read_counts():
    return {name: fn.launches for name, fn in _counts().items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from kubernetes_tpu_torch.kubemark.gpu_evidence import (card_line,
                                                            launch_floor_ms)
    from kubernetes_tpu_torch.sched.device import bounds
    from kubernetes_tpu_torch.kubemark.fixtures import E2E_COUNTS
    from kubernetes_tpu_torch.sched.device import scatter_kernel as sk

    card = card_line()

    def stamp(rec):
        emit({**rec, "card": card})

    stamp(phase_build())
    rate = bounds.card_rate()
    floor_ms = launch_floor_ms()
    stamp({"phase": "floor", "launch_floor_ms": floor_ms, **rate})
    filt, mixed_tables = phase_filter(rate, floor_ms)
    stamp(filt)
    scan, scan_t = phase_scan(rate, floor_ms, mixed_tables)
    del mixed_tables
    stamp(scan)
    _zero_counts()                        # the main path starts here
    engine_recs, encs = phase_engine()
    for rec in engine_recs:
        stamp(rec)
    ext = phase_extender()
    stamp(ext)
    main_launches = _read_counts()        # ... and ends here
    stamp({"phase": "main_path", "launches": main_launches})
    for name in ("filter_masks", "scan_chunk", "probe"):
        if main_launches[name] == 0:
            raise AssertionError(f"the main path never launched {name}")
    reject, reject_launches = phase_reject(rate, floor_ms)
    stamp(reject)
    _zero_counts()                        # the e2e path starts here
    e2e = phase_e2e()
    e2e_launches = _read_counts()         # ... and ends here
    e2e_rows = sk.launch_staged.rows
    stamp({**e2e, "launches": e2e_launches, "scatter_rows": e2e_rows})
    tiles = e2e["tiles_chained"] + e2e["tiles_unchained"]
    if e2e_launches["scan_chunk"] < max(tiles, 1):
        raise AssertionError(f"the e2e launched the scan kernel "
                             f"{e2e_launches['scan_chunk']} times for "
                             f"{tiles} tiles")
    if e2e["scan_stats"]["eager_steps"]:
        raise AssertionError(f"the e2e ran {e2e['scan_stats']} eager steps")
    _zero_counts()                        # the mirror path starts here
    mirror, rows_a_launch = phase_mirror()
    mirror_launches = _read_counts()      # ... and ends here
    stamp({**mirror, "launches": mirror_launches})
    if mirror_launches["scatter_prologue"] == 0:
        raise AssertionError("the mirror path never launched the scatter "
                             "kernel")
    scatter, scatter_t = phase_scatter(rate, floor_ms, rows_a_launch)
    stamp(scatter)
    _zero_counts()                        # the spec path starts here
    spec_path, chunk_enc = phase_spec_path(encs)
    spec_launches = _read_counts()        # ... and ends here
    stamp({**spec_path, "launches": spec_launches})
    for name in ("spec_pass", "spec_repair"):
        if spec_launches[name] == 0:
            raise AssertionError(f"the spec path never launched {name}")
    spec, spec_t = phase_spec(rate, floor_ms, encs, chunk_enc)
    del encs, chunk_enc
    stamp(spec)
    preempt, preempt_launches, wide, ptables = phase_preempt(rate,
                                                             floor_ms)
    stamp(preempt)
    stamp(phase_no_fallback(wide))
    shard, shard_t = phase_shard_kernels(rate, floor_ms, ptables)
    del ptables
    stamp(shard)
    shard_path = phase_shard_path()
    stamp(shard_path)
    soak = phase_soak()
    stamp(soak)
    shard_soak = phase_shard_soak()
    stamp(shard_soak)
    chaos = phase_chaos(e2e["pods_per_sec"])
    stamp(chaos)
    node_chaos = phase_node_chaos()
    stamp(node_chaos)
    slo = phase_slo()
    stamp(slo)
    http_chaos = phase_http_chaos()
    stamp(http_chaos)
    durable = phase_store("python", e2e)
    stamp(durable)
    native = phase_store("native", e2e)
    stamp(native)
    split = phase_split()
    stamp(split)
    crash = phase_crash()
    stamp(crash)
    _zero_counts()                        # the mixed path starts here
    mixed = phase_mixed()
    mixed_launches = _read_counts()       # ... and ends here
    stamp({**mixed, "launches": mixed_launches})
    if mixed_launches["probe"] == 0:
        raise AssertionError("mixed mode never launched the probe kernel")
    print(card, flush=True)
    n_rows = E2E_COUNTS["n_nodes"]
    big = scatter_t[(n_rows, n_rows)]
    small = scatter_t[tuple(scatter["path_rows"])]
    k6 = spec_t["chunk"]
    k1, k5, k5_p1 = scan_t["k1"], scan_t["k5"], scan_t["k5_p1"]
    sharded = shard_t["timings"][SHARD_TIMED]
    kernels = [{
        "name": "filter_masks", "route": "cuda",
        "source": "kubernetes_tpu_torch/sched/device/csrc/filter_kernel.cu",
        "replaces": "kubernetes_tpu/sched/device/pallas_filter.py:169",
        "launches": main_launches["filter_masks"],
        "launches_path": "engine+extender",
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
        "launches": reject_launches, "launches_path": "reject",
        "main_path_shape": reject["shape"],
        "equal_plain": reject["reject_parity"],
        "max_abs_err": reject["reject_max_abs_err"],
        "shape": reject["shape"],
        "ms": reject["ms"], "plain_ms": reject["plain_ms"],
        "bound_ms": reject["bound_ms"], "bound_by": reject["bound_by"],
        "library_ms": reject["library_ms"], "main_path_ms": reject["ms"],
        "main_path_bound_ms": reject["bound_ms"],
        "launch_floor_ms": floor_ms, **rate}, {
        "name": "scatter_prologue", "route": "cuda",
        "source": "kubernetes_tpu_torch/sched/device/csrc/scatter_kernel.cu",
        "replaces": "kubernetes_tpu/sched/device/engine.py:669",
        "launches": mirror_launches["scatter_prologue"],
        "launches_path": "mirror",
        "launches_per_tile": mirror["launches_per_tile"],
        "e2e_launches": e2e_launches["scatter_prologue"],
        "main_path_shape": scatter["path_rows"],
        "equal_plain": scatter["equal_plain"],
        "max_abs_err": scatter["max_abs_err"],
        "shape": [n_rows, n_rows],
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": big["library_ms"], "main_path_ms": small["ms"],
        "main_path_bound_ms": small["bound_ms"],
        "prologue_host_ms": mirror["prologue_host_ms"],
        "prologue_profile": {k: mirror["prologue_profile"][k] for k in (
            "kernels", "h2d_copies", "launch_calls", "copy_calls")},
        "launch_floor_ms": floor_ms, **rate}, {
        "name": "victim_search", "route": "cuda",
        "source": "kubernetes_tpu_torch/sched/device/csrc/victim_kernel.cu",
        "replaces": "kubernetes_tpu/sched/device/engine.py:700",
        "launches": preempt_launches, "launches_path": "preempt",
        "main_path_shape": preempt["shape"],
        "equal_plain": preempt["equal_plain"],
        "max_abs_err": preempt["max_abs_err"], "shape": preempt["shape"],
        "ms": preempt["ms"], "plain_ms": preempt["plain_ms"],
        "bound_ms": preempt["bound_ms"], "bound_by": preempt["bound_by"],
        "library_ms": None, "main_path_ms": preempt["ms"],
        "main_path_bound_ms": preempt["bound_ms"],
        "plan": preempt["plan"], "one_victim": preempt["one"],
        "search_split": preempt["search_split"],
        "launch_floor_ms": floor_ms, **rate}, {
        "name": "scan_chunk", "route": "cuda",
        "source": "kubernetes_tpu_torch/sched/device/csrc/scan_kernel.cu",
        "replaces": "kubernetes_tpu/sched/device/engine.py:313",
        "launches": e2e_launches["scan_chunk"], "launches_path": "e2e",
        "engine_launches": main_launches["scan_chunk"],
        "main_path_shape": scan["k1_shape"],
        "equal_plain": scan["equal_plain"],
        "max_abs_err": scan["max_abs_err"], "shape": scan["k1_shape"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None, "main_path_ms": k1["ms"],
        "main_path_bound_ms": k1["bound_ms"],
        "e2e_device_ms": e2e["k1_device_ms"],
        "cluster": k1["plan"].cluster, "ctas": k1["plan"].grid,
        "slots_per_cta": k1["plan"].slots,
        "threads_per_cta": k1["plan"].threads,
        "sm_clock_mhz_timed": k1["sm_clock_mhz"],
        "launch_floor_ms": floor_ms, **rate}, {
        "name": "probe", "route": "cuda",
        "source": "kubernetes_tpu_torch/sched/device/csrc/scan_kernel.cu",
        "replaces": "kubernetes_tpu/sched/device/engine.py:384",
        "launches": main_launches["probe"],
        "launches_path": "engine+extender",
        "mixed_launches": mixed_launches["probe"],
        "main_path_shape": k5_p1["shape"],
        "equal_plain": scan["equal_plain"],
        "max_abs_err": scan["max_abs_err"], "shape": k5["shape"],
        "ms": k5["ms"], "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
        "library_ms": None, "main_path_ms": k5_p1["ms"],
        "main_path_bound_ms": k5_p1["bound_ms"],
        "cluster": k5["cluster"], "main_path_cluster": k5_p1["cluster"],
        "launch_floor_ms": floor_ms, **rate}, {
        "name": "spec_pass", "route": "cuda",
        "source": "kubernetes_tpu_torch/sched/device/csrc/scan_kernel.cu",
        "replaces": "kubernetes_tpu/sched/device/engine.py:428",
        "launches": spec_launches["spec_pass"], "launches_path": "spec",
        "main_path_shape": k6["pass"]["shape"],
        "equal_plain": spec["equal_plain"],
        "max_abs_err": spec["max_abs_err"], "shape": k6["pass"]["shape"],
        "ms": k6["pass"]["ms"], "plain_ms": k6["pass"]["plain_ms"],
        "bound_ms": k6["pass"]["bound_ms"],
        "bound_by": k6["pass"]["bound_by"], "library_ms": None,
        "main_path_ms": k6["pass"]["ms"],
        "main_path_bound_ms": k6["pass"]["bound_ms"],
        "launch_floor_ms": floor_ms, **rate}, {
        "name": "spec_repair", "route": "cuda",
        "source": "kubernetes_tpu_torch/sched/device/csrc/scan_kernel.cu",
        "replaces": "kubernetes_tpu/sched/device/engine.py:474",
        "launches": spec_launches["spec_repair"], "launches_path": "spec",
        "main_path_shape": k6["repair"]["shape"],
        "equal_plain": spec["equal_plain"],
        "max_abs_err": spec["max_abs_err"], "shape": k6["repair"]["shape"],
        "ms": k6["repair"]["ms"], "plain_ms": k6["repair"]["plain_ms"],
        "bound_ms": k6["repair"]["bound_ms"],
        "bound_by": k6["repair"]["bound_by"], "library_ms": None,
        "main_path_ms": k6["repair"]["ms"],
        "main_path_bound_ms": k6["repair"]["bound_ms"],
        "chunk_shape": k6["shape"], "chunk_ms": k6["ms"],
        "chunk_bound_ms": k6["bound_ms"], "chunk_k1_ms": k6["k1_ms"],
        "spread_chunk_ms": spec_t["spread"]["ms"],
        "spread_k1_ms": spec_t["spread"]["k1_ms"],
        "launch_floor_ms": floor_ms, **rate}, {
        "name": "scan_chunk_sharded", "route": "cuda",
        "source": "kubernetes_tpu_torch/sched/device/csrc/scan_kernel.cu",
        "replaces": "kubernetes_tpu/sched/device/engine.py:829",
        "launches": shard_path["launches"]["scan_chunk_sharded"],
        "launches_path": "shard_path", "shards": SHARD_TIMED,
        "main_path_shape": scan["k1_shape"],
        "equal_plain": True, "max_abs_err": shard["max_abs_err"],
        "shape": scan["k1_shape"], "ms": sharded["ms"],
        "plain_ms": shard_t["plain_ms"],
        "plain_shape": shard["k1_plain_shape"],
        "ms_at_plain_shape": shard_t["head_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None, "k1_ms": sharded["k1_ms"],
        "by_shards": {s: [t["ms"], t["k1_ms"], t["cluster"]]
                      for s, t in shard_t["timings"].items()},
        "sm_clock_mhz_timed": sharded["sm_clock_mhz"],
        "launch_floor_ms": floor_ms, **rate}, {
        "name": "victim_search_sharded", "route": "cuda",
        "source": "kubernetes_tpu_torch/sched/device/csrc/victim_kernel.cu",
        "replaces": "kubernetes_tpu/sched/device/engine.py:879",
        "launches": shard_t["k4_launches"], "launches_path": "shard",
        "main_path_shape": shard["k4"]["shape"],
        "equal_plain": True, "max_abs_err": shard["k4"]["max_abs_err"],
        "shape": shard["k4"]["shape"], "shards": SHARD_TIMED,
        "ms": shard["k4"]["ms"], "plain_ms": shard["k4"]["plain_ms"],
        "k4_ms": shard["k4"]["k4_ms"],
        "bound_ms": shard["k4"]["bound_ms"],
        "bound_by": shard["k4"]["bound_by"], "library_ms": None,
        "launch_floor_ms": floor_ms, **rate}, {
        "name": "k7_exchange", "route": "cuda",
        "source": "kubernetes_tpu_torch/sched/device/csrc/scan_kernel.cu",
        "replaces": "kubernetes_tpu/sched/device/engine.py:677",
        "inside": ["scan_chunk_sharded", "victim_search_sharded"],
        "launches": shard_path["launches"]["scan_chunk_sharded"],
        "launches_path": "shard_path", "shards": SHARD_TIMED,
        "equal_plain": True, "max_abs_err": shard["max_abs_err"],
        "shape": scan["k1_shape"],
        "ms": sharded["ms"] - sharded["k1_ms"],
        "ms_is": "the sharded K1's device ms less K1's, same chunk",
        "plain_ms": shard_t["plain_ms"] - shard_t["unsharded_plain_ms"],
        "plain_ms_is": "the sharded twin's ms less the plain scan's, "
                       "same pods (plain_shape)",
        "plain_shape": shard["k1_plain_shape"],
        "bound_ms": sharded["k7_bound_ms"],
        "bound_by": sharded["k7_bound_by"],
        "hop_floor_ms": shard_t["k7_hop"]["floor_ms"],
        "hop_floor_is": "the chunk's pods x one relaxed one-way hop "
                        "through L2 between the lowest and the highest "
                        "SM id (profile_kernels.hop_cycles)",
        "hop_cycles": shard_t["k7_hop"]["relaxed_hop_cycles"],
        "library_ms": None, "bytes": sharded["k7_bytes"],
        "launch_floor_ms": floor_ms, **rate}]
    # each kernel's launches on the soak, chaos and HTTP paths (K7's:
    # the sharded K1's, which it runs inside)
    paths = {"soak": soak, "shard_soak": shard_soak, "chaos": chaos,
             "node_chaos": node_chaos, "slo": slo, "http_chaos": http_chaos,
             "crash": crash}
    for k in kernels:
        counter = ("scan_chunk_sharded" if k["name"] == "k7_exchange"
                   else k["name"])
        k["launches_soak_paths"] = {p: rec["launches"][counter]
                                    for p, rec in paths.items()}
        k["launches_store_paths"] = {
            "durable": durable["launches"][counter],
            "native": native["launches"][counter],
            "split": split["launches"][counter]}
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
