"""Where the victim search's, the probe's and the speculative engine's
time goes, on the card.

    python -m kubernetes_tpu_torch.kubemark.profile_kernels [--out PATH]

Prints one JSON object (and writes it to PATH when given):

- ``victim_phases``: the victim kernel (K4) on the preempt fixture's
  widest table (5120 x 16) and a one-victim table, and the sharded K4
  on the widest table at 2, 4 and 8 shards, built from a copy of
  `csrc/victim_kernel.cu` that records, for thread 0 of every CTA,
  clock64 at the kernel's start, once the node's fields are in (its
  k = 0 test), once its victims are scanned, after
  the CTA's first maximum and after the counter, and the globaltimer at
  its start and after the counter; the last CTA also records its final
  reduction. Percentiles (0, 50, 100) of each phase in cycles, and the
  CTAs' start spread and counter times in ns. The copy's device time is
  given beside the committed kernel's, which it must equal in its
  answers.
- ``victim_host``: find_victims' host steps on the widest table, warm
  and one at a time: packing into pinned memory, queueing the copy,
  queueing the launch, the launch with its pull, the whole search
  (median host ms).
- ``probe_bounds``: the probe kernel's block-a-pod route (K5 at 8192
  pods x 5000 nodes) in each of its eight instantiations, built from
  the committed source and from copies that differ only in the slot
  order (mask first / total first) and the launch bounds (no minimum,
  2 or 3 blocks an SM), each copy's registers and spills from ptxas and
  its device time per instantiation: the evidence behind the committed
  choice.

- ``spec_phases`` (also ``--spec-only``, and ``--against DIR`` for
  another checkout's kernels beside this one's): K6 on K1's e2e chunk
  and on the spread fixture's chunk (32 blocks of 256 each), built from
  a copy of `csrc/scan_kernel.cu` with clock64 sums kept in registers:
  the repair's cycles a pod by part (for the block-reduce design and
  for the pipeline, `SPEC_DESIGNS`, picked by which edit anchors the
  source holds), its prologue and epilogue a block; the pass's scoring
  and top-list cycles a CTA, with the first and last CTA on the
  globaltimer; both builds' chunk ms, their answers equal.
- ``score_latency``: one slot's `node_total` + `fits` in series, cycles
  an iteration, from the tables, from a shared copy and on K6b's path
  (a RegSlot), one warp alone and 16 at once (the latency K6b's step is
  made of).

- ``k7_phases`` (also ``--k7-only``, and ``--against DIR`` for another
  checkout's kernels beside this one's): K7, the exchange between the
  shards inside the sharded K1, at 1, 2, 4 and 8 shards on one card, on
  K1's e2e chunk and on the spread fixture's first chunk, built from a
  copy of `csrc/scan_kernel.cu` with K7's probe points defined: cycles
  a pod for CTA 0's thread 0 of each shard, split five ways (the post,
  the first poll, the spin after it, the payload's load, the broadcast
  barrier) for the candidate exchange, the group max and the zone
  histogram; both builds' device ms (their answers held equal).
- ``l2_hop``: one one-way hop through L2 between two SMs
  (`csrc/l2_hop.cu`, a probe built on its own), with a relaxed
  flag-in-data word and with st.release / ld.acquire and a payload
  load, for a near, a middle and the distant pair of SMs: pods x the
  relaxed hop is K7's latency floor.

Every copy is held equal to the plain version before it is timed.
Copies are written under `kubernetes_tpu_torch/_build/variants/` and
built there; the committed libraries are untouched.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import sys

import numpy as np
import torch

from ..sched.device import _build
from ..sched.device import engine as eng
from ..sched.device import scan_kernel as sk
from ..sched.device import victim_kernel as vk
from . import fixtures as fx
from .gpu_evidence import _cuda, _same, card_line, device_ms, scan_args

VARIANT_DIR = os.path.join(_build.BUILD_DIR, "variants")


def _variant(name: str, source: str, edits) -> str:
    """A copy of `source` with each (old, new) edit applied once."""
    with open(source) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{name}: edit anchor found "
                             f"{text.count(old)} times: {old[:60]!r}")
        text = text.replace(old, new)
    path = os.path.join(VARIANT_DIR, name, os.path.basename(source))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path


def _with_source(module, path: str):
    """Point a wrapper module at another build of its source."""
    module.SOURCE = path
    module._library.cache_clear()


# --------------------------------------------------------------- K4 phases

_ATOM = """    unsigned prev;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
                 : "=r"(prev) : "l"(a.done) : "memory");
    last = prev == gridDim.x - 1;"""
_HEAD = ("__global__ void __launch_bounds__(VICTIM_BLOCK_THREADS)\n"
         "victim_kernel(const VictimParams a) {\n")
# per CTA: 0 start, 1 node fields in, 2 victims scanned, 3 first maximum,
# 4 counter, 5 last CTA's end (clock64); 6 start, 7 counter (globaltimer)
_SLOTS = 8


def _phase_edits():
    rec = "victim_dbg[blockIdx.x * 8 + %d]"
    return [
        ("#define SCORE_STRIDE (2 * PMAX + 2)\n",
         "#define SCORE_STRIDE (2 * PMAX + 2)\n"
         "__device__ long long victim_dbg[8 * 4096];\n"
         "__device__ __forceinline__ long long gtime() {\n"
         "  long long t;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
         "  return t;\n}\n"),
        (_HEAD, _HEAD + "  if (threadIdx.x == 0) {\n"
         f"    {rec % 0} = clock64();\n    {rec % 6} = gtime();\n"
         f"    {rec % 5} = 0;\n  }}\n"),
        ("  int k0 = cand && fits_after(a, pc, pcap, cc, mc, cu, mu, 0, 0, 0)"
         " ? 0 : -1;\n",
         "  int k0 = cand && fits_after(a, pc, pcap, cc, mc, cu, mu, 0, 0, 0)"
         " ? 0 : -1;\n"
         f"  if (threadIdx.x == 0) {rec % 1} = clock64() + (k0 > 99);\n"),
        ("  ks = 0;\n  sc = -1;\n",
         f"  if (threadIdx.x == 0) {rec % 2} = clock64() + (nv > 999);\n"
         "  ks = 0;\n  sc = -1;\n"),
        ("  block_best(best, best_j);\n  __shared__ bool last;",
         "  block_best(best, best_j);\n"
         f"  if (threadIdx.x == 0) {rec % 3} = clock64();\n"
         "  __shared__ bool last;"),
        (_ATOM, _ATOM + f"\n    {rec % 4} = clock64();"
         f"\n    {rec % 7} = gtime();"),
        ("    a.pick[0] = best_j;\n    *a.done = 0;",
         "    a.pick[0] = best_j;\n    *a.done = 0;"
         f"\n    {rec % 5} = clock64();"),
        ("extern \"C\" const char* victim_error_name(int err) {",
         "extern \"C\" int victim_dbg_read(void* out, int n) {\n"
         "  return (int)cudaMemcpyFromSymbol(out, victim_dbg, 8 * (size_t)n);"
         "\n}\n\nextern \"C\" const char* victim_error_name(int err) {"),
    ]


_SHARDED_HEAD = ("__global__ void __launch_bounds__(VICTIM_BLOCK_THREADS)\n"
                 "victim_sharded_kernel(const VictimParams a) {\n")
_SHARDED_MAX = """  block_best(best, best_j);
  if (threadIdx.x == 0) {
    a.block_score[blk] = best;"""
_SHARDED_COUNT = "    last = count_done(a.done, gridDim.x * gridDim.y);\n"
_SHARDED_END = "      a.pick[0] = best_j;\n      *a.done = 0;"


def _sharded_phase_edits():
    """The same slots in the sharded K4 (applied after _phase_edits):
    its start, first maximum, counter and the last CTA's end, a block's
    slots at its place in the 2D grid (shard-major), search_node's slots
    1 and 2, which both kernels run, moved there too (K4's blockIdx.y is
    0)."""
    rec = "victim_dbg[(blockIdx.y * gridDim.x + blockIdx.x) * 8 + %d]"
    old = "  if (threadIdx.x == 0) victim_dbg[blockIdx.x * 8 + %d] = clock64()"
    new = "  if (threadIdx.x == 0) %s = clock64()" % rec
    return [
        (old % 1, new % 1),
        (old % 2, new % 2),
        (_SHARDED_HEAD, _SHARDED_HEAD + "  if (threadIdx.x == 0) {\n"
         f"    {rec % 0} = clock64();\n    {rec % 6} = gtime();\n"
         f"    {rec % 5} = 0;\n  }}\n"),
        (_SHARDED_MAX, "  block_best(best, best_j);\n"
         f"  if (threadIdx.x == 0) {rec % 3} = clock64();\n"
         + _SHARDED_MAX.split("\n", 1)[1]),
        (_SHARDED_COUNT, _SHARDED_COUNT + f"    {rec % 4} = clock64();\n"
         f"    {rec % 7} = gtime();\n"),
        (_SHARDED_END, _SHARDED_END + f"\n      {rec % 5} = clock64();"),
    ]


def _pct(x) -> list:
    return [float(v) for v in np.percentile(x, [0, 50, 100])]


def victim_phases(device) -> dict:
    """The phases above for K4 on the widest and a one-victim table, and
    for the sharded K4 on the widest table at 2, 4 and 8 shards
    (`wide@S`), from one instrumented copy, so the sharded kernel's
    phases read beside K4's on one card."""
    tables = fx.preempt_tables()
    wide = fx.widest_table(tables)
    one = min(tables, key=lambda t: (t.v, -int(t.v_valid.sum())))
    real = vk.SOURCE
    copy = _variant("victim_phases", real,
                    _phase_edits() + _sharded_phase_edits())
    _build.build_all([real, copy])
    # (label, table, shards: 0 for K4)
    runs = [("wide", wide, 0), ("one_victim", one, 0)] + [
        (f"wide@{s}", wide, s) for s in (2, 4, 8)]
    out = {}
    try:
        for label, t, s in runs:
            args = vk.VictimArgs.from_table(t, device)
            want = vk.victim_search_plain(args)
            if s:
                plan, _ = vk.sharded_plan(t.n, t.v, s, vk.card_sms())

                def search():
                    return vk.victim_search_sharded(args, s)
            else:
                plan = vk.launch_plan(t.n, t.v, vk.card_sms())

                def search():
                    return vk.victim_search(args)
            rec = {"shape": [t.n, t.v], "plan": list(plan)}
            for name, path in (("committed", real), ("instrumented", copy)):
                _with_source(vk, path)
                if not _same(search(), want):
                    raise AssertionError(f"{name} {label} victim kernel "
                                         f"differs from its plain version")
                rec[f"{name}_ms"] = device_ms(search)
            torch.cuda.synchronize()
            search()
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * (_SLOTS * plan.grid))()
            err = vk._library().victim_dbg_read(buf, _SLOTS * plan.grid)
            if err:
                raise RuntimeError(f"reading the phases: CUDA error {err}")
            d = np.array(list(buf), dtype=np.int64).reshape(plan.grid,
                                                              _SLOTS)
            last = d[d[:, 5] != 0]           # only the last CTA sets it
            rec.update(
                node_fields_cycles=_pct(d[:, 1] - d[:, 0]),
                victims_scan_cycles=_pct(d[:, 2] - d[:, 1]),
                first_max_cycles=_pct(d[:, 3] - d[:, 2]),
                counter_cycles=_pct(d[:, 4] - d[:, 3]),
                last_cta_reduce_cycles=int(last[0, 5] - last[0, 4]),
                start_spread_ns=int(d[:, 6].max() - d[:, 6].min()),
                counter_done_ns=_pct(d[:, 7] - d[:, 6].min()))
            out[label] = rec
    finally:
        _with_source(vk, real)
    return out


def _host_ms(fn, reps: int = 30) -> float:
    """Median host ms of fn() after warm-up, the card idle between."""
    import time
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def victim_host(device) -> dict:
    """find_victims' host steps on the widest table, warm, one at a time
    (the preempt phase runs each search cold, after a victim_table
    cut): packing into pinned memory, the copy queued, the launch
    queued, the pull, and the whole search."""
    from ..sched.device import BatchEngine
    t = fx.widest_table(fx.preempt_tables(fx.preempt_spec(n_preemptors=12)))
    staged = vk.VictimArgs.stage(t, pin=True)
    args = staged.to_device(device)
    engine = BatchEngine(device=device)
    return {"shape": [t.n, t.v],
            "stage_ms": _host_ms(lambda: vk.VictimArgs.stage(t, pin=True)),
            "to_device_ms": _host_ms(lambda: staged.to_device(device)),
            "launch_ms": _host_ms(lambda: vk.victim_search(args)),
            "search_and_pull_ms": _host_ms(
                lambda: vk.victim_search(args).flat().cpu()),
            "find_victims_ms": _host_ms(lambda: engine.find_victims(t))}


# --------------------------------------------------------------- K6 phases

# The repair's clock64 slots, summed over a run's pods, by design (the
# names of the slots in order; "pods" and "slow_pods" count, a name
# ending in "a_slow_pod" is read per slow pod, one ending in "logue" per
# block, the others per pod). Each
# thread that records keeps its sums in registers and adds them to the
# device's at the kernel's end, so the timed stretches hold no global
# access of the probe's own.
# Block reduce (the repair as first ported), as thread 0 (the thread
# that commits) sees a pod: its own offers, its wait at the reduction's
# barrier, the two reduction levels, the commit and of it load_slot and
# the spread loop, the barrier after the commit, the pod whole; the slow
# pods' own offers; the block's last thread's offers (the rescore of
# the block's first taken slot); the block's prologue and epilogue
# (thread 0).
_REDUCE_NAMES = ("own_offers", "reduce_wait", "reduce_levels", "commit",
                 "commit_load_slot", "commit_spread", "commit_barrier",
                 "pod", "pods", "slow_pods", "slow_own_offers_a_slow_pod",
                 "last_thread_offers", "prologue", "epilogue")
# Pipeline, a step: the chain's pick (the producer warps' pairs and pod
# k's score on j(k-1)), its outputs and the spread latch, its commit into
# the other set of records, its wait for the step's end, the step's
# barrier, the step whole; a slow pod's full-width phase (every warp);
# the first producer thread's candidates (its list entry and the rescore
# of the block's first record), its best two, its wait at the step's
# barrier; the as-if thread's scores (the last producer warp's lane 0);
# the block's prologue and epilogue and of the prologue the records and
# pod rows (thread 0).
_PIPE_NAMES = ("chain_pick", "chain_outputs", "chain_commit", "chain_wait",
               "step_barrier", "pod", "pods", "slow_pods",
               "slow_full_width_a_slow_pod", "producer_candidates",
               "producer_best_two", "producer_barrier_wait", "asif",
               "prologue", "epilogue", "rows_prologue")
_SPEC_SLOTS = 16
# K6a's per CTA (blockIdx), summed over a run's launches: 0 the scoring
# (the pod's row, the group max, the composites, to the barrier after
# them), 1 the top list, 2 launches; of the last launch: 3 its start and
# 4 its end (globaltimer, ns), 5 the entries it drew
_PASS_SLOTS = 8
_PASS_CTAS = 256
_GTIME = ("__device__ __forceinline__ long long gtime() {\n"
          "  long long t;\n"
          "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
          "  return t;\n}\n")
_DBG_READ = (
    "extern \"C\" int spec_dbg_read(void* out, int which, int zero) {\n"
    "  static long long zeros[%d * %d] = {0};\n"
    "  if (which)\n"
    "    return zero ? (int)cudaMemcpyToSymbol(k6a_dbg, zeros, "
    "sizeof k6a_dbg)\n"
    "                : (int)cudaMemcpyFromSymbol(out, k6a_dbg, "
    "sizeof k6a_dbg);\n"
    "  return zero ? (int)cudaMemcpyToSymbol(spec_dbg, zeros, "
    "sizeof spec_dbg)\n"
    "              : (int)cudaMemcpyFromSymbol(out, spec_dbg, "
    "sizeof spec_dbg);\n"
    "}\n\n" % (_PASS_SLOTS, _PASS_CTAS))
_ERRNAME = "extern \"C\" const char* scan_error_name(int err) {"
_PASS_HEAD = "spec_pass_kernel(const Params<T> a, int k0, int count) {\n"


def _pass_edits_draw():
    """K6a as first ported: scoring, then k + 1 reductions in turn."""
    return [
        (_PASS_HEAD, _PASS_HEAD
         + "  const long long q0 = clock64(), g0 = gtime();\n"),
        ("  __syncthreads();\n  T mine = (T)-1;\n",
         "  __syncthreads();\n  const long long q1 = clock64();\n"
         "  T mine = (T)-1;\n"),
        ("    out_c[q] = (T)-1;\n    out_n[q] = -1;\n  }\n}\n",
         "    out_c[q] = (T)-1;\n    out_n[q] = -1;\n  }\n"
         "  if (threadIdx.x == 0) {\n"
         "    long long* d = k6a_dbg + blockIdx.x * 8;\n"
         "    d[0] += q1 - q0;\n    d[1] += clock64() - q1;\n    d[2] += 1;\n"
         "    d[3] = g0;\n    d[4] = gtime();\n    d[5] = r;\n  }\n}\n"),
    ]


def _flush(tids: str) -> str:
    """The recording threads' register sums into spec_dbg, once."""
    return ("  if (" + tids + ") {\n#pragma unroll\n"
            "    for (int q = 0; q < 16; ++q)\n"
            "      if (dbg[q]) atomicAdd((unsigned long long*)&spec_dbg[q],"
            " (unsigned long long)dbg[q]);\n  }\n")


def _repair_edits_reduce():
    """K6b as first ported: offers, a CTA-wide reduction, thread 0's
    commit, a barrier."""
    head = "spec_repair_kernel(const Params<T> a, int k0, int count) {\n"
    back = "  // the taken slots' State back, once\n"
    return [
        (head, head + "  long long dbg[16] = {0};\n"
         "  const long long e0 = clock64();\n"),
        ("  for (int k = 0; k < count; ++k) {\n"
         "    Pod<T> p = read_pod<T, HAS_SPREAD, false, false>(a, rows + "
         "(size_t)k * E);\n",
         "  dbg[12] += clock64() - e0;\n"
         "  for (int k = 0; k < count; ++k) {\n"
         "    const long long c0 = clock64();\n"
         "    Pod<T> p = read_pod<T, HAS_SPREAD, false, false>(a, rows + "
         "(size_t)k * E);\n"),
        ("    // the CTA's best, read by every thread\n",
         "    const long long c1 = clock64();\n"
         "    // the CTA's best, read by every thread\n"),
        ("    __syncthreads();\n    T cb = lane < nwarps",
         "    const long long c1b = clock64();\n    __syncthreads();\n"
         "    const long long c2 = clock64();\n    T cb = lane < nwarps"),
        ("    warp_best(cb, j);\n    if (tid == 0) {\n",
         "    warp_best(cb, j);\n    const long long c3 = clock64();\n"
         "    long long cl = 0, cs = 0;\n    if (tid == 0) {\n"),
        ("        int i = (int)slot_of[j] - 1;\n",
         "        const long long l0 = clock64();\n"
         "        int i = (int)slot_of[j] - 1;\n"),
        ("          node_of[k] = j;\n        }\n",
         "          node_of[k] = j;\n        }\n"
         "        cl = clock64() - l0;\n        const long long s0 = "
         "clock64();\n"),
        ("            a.spread[(size_t)g * a.N + j] = before + add;\n"
         "          }\n",
         "            a.spread[(size_t)g * a.N + j] = before + add;\n"
         "          }\n        cs = clock64() - s0;\n"),
        ("    __syncthreads();                  // the commit, published\n",
         "    const long long c4 = clock64();\n"
         "    __syncthreads();                  // the commit, published\n"
         "    if (tid == 0) {\n"
         "      const long long c5 = clock64();\n"
         "      dbg[0] += c1 - c0;\n      dbg[1] += c2 - c1b;\n"
         "      dbg[2] += (c1b - c1) + (c3 - c2);\n"
         "      dbg[3] += c4 - c3;\n      dbg[4] += cl;\n"
         "      dbg[5] += cs;\n      dbg[6] += c5 - c4;\n"
         "      dbg[7] += c5 - c0;\n      dbg[8] += 1;\n"
         "      dbg[9] += slow;\n      dbg[10] += slow ? c1 - c0 : 0;\n"
         "    }\n"
         "    if (tid == nthreads - 1) dbg[11] += c1 - c0;\n"),
        (back, "  const long long e1 = clock64();\n" + back),
        ("    if (node_of[i] >= 0) store_slot(a, c, i, node_of[i]);\n}\n",
         "    if (node_of[i] >= 0) store_slot(a, c, i, node_of[i]);\n"
         "  __syncthreads();\n  if (tid == 0) dbg[13] += clock64() - e1;\n"
         + _flush("tid == 0 || tid == nthreads - 1") + "}\n"),
    ]


def _pass_edits_select():
    """K6a as a radix select: scoring, then the select and the ranks."""
    head = ("__device__ __forceinline__ void spec_pass_block(const Params<T>& "
            "a, int k0,\n                                                int "
            "count) {\n")
    return [
        (head, head + "  const long long q0 = clock64(), g0 = gtime();\n"),
        ("  __syncthreads();\n  int M = 0;\n",
         "  __syncthreads();\n  const long long q1 = clock64();\n"
         "  int M = 0;\n"),
        ("    out_c[r] = (T)-1;\n    out_n[r] = -1;\n  }\n}\n",
         "    out_c[r] = (T)-1;\n    out_n[r] = -1;\n  }\n"
         "  if (threadIdx.x == 0) {\n"
         "    long long* d = k6a_dbg + blockIdx.x * 8;\n"
         "    d[0] += q1 - q0;\n    d[1] += clock64() - q1;\n    d[2] += 1;\n"
         "    d[3] = g0;\n    d[4] = gtime();\n    d[5] = S;\n  }\n}\n"),
    ]


def _repair_edits_pipeline():
    """K6b as a pipeline: the chain warp and the producer warps a step."""
    head = "spec_repair_kernel(const Params<T> a, int k0, int count) {\n"
    loop = ("  for (int k = -1; k < count; ++k) {\n"
            "    const int m = k + 1;            // the pod the producers "
            "prepare\n")
    step = ("    __syncthreads();                  // commit k and pod k + "
            "1's pairs\n")
    back = "  // the taken slots' State back, once: the tables' plus the " \
        "records\n"
    stage = ("                                     : *(const uint32_t*)src;\n"
             "    }\n  for (int n = tid; n < a.N; n += nthreads) "
             "slot_of[n] = 0;\n")
    tail = ("    if (HAS_SPREAD)\n      for (int g = 0; g < a.G; ++g)\n"
            "        a.spread[(size_t)g * a.N + n] += fin.spread[i * a.G + g];"
            "\n  }\n}\n")
    return [
        (head, head + "  long long dbg[16] = {0};\n"
         "  const long long e0 = clock64();\n"),
        (stage, stage + "  dbg[15] += clock64() - e0;\n"),
        (loop, "  dbg[13] += clock64() - e0;\n" + loop
         + "    const long long c0 = clock64();\n"
         "    long long c1 = 0, c2 = 0, c3 = 0, w0 = 0, w1 = 0;\n"),
        ("        warp_best(fb, fj);\n      }\n    }\n    if (warp == 0) {\n",
         "        warp_best(fb, fj);\n      }\n    }\n"
         "    const long long cw = clock64();\n    if (warp == 0) {\n"),
        ("        j = best >= 0 ? bj : -1;\n",
         "        c1 = clock64();\n        j = best >= 0 ? bj : -1;\n"),
        ("      // the commit into the other set of records, which the "
         "producers\n",
         "      c2 = clock64();\n"
         "      // the commit into the other set of records, which the "
         "producers\n"),
        ("      iprev = i;\n", "      iprev = i;\n      c3 = clock64();\n"),
        ("      if (pw == nprod - 1) {\n",
         "      w0 = clock64();\n      if (pw == nprod - 1) {\n"),
        ("      // list entry pt of pod m + 1, for the next step\n",
         "      w1 = clock64();\n"
         "      // list entry pt of pod m + 1, for the next step\n"),
        (step, "    const long long c4 = clock64();\n" + step
         + "    const long long c5 = clock64();\n"
           "    if (tid == 0 && k >= 0) {\n"
           "      dbg[0] += c1 - cw;\n      dbg[1] += c2 - c1;\n"
           "      dbg[2] += c3 - c2;\n      dbg[3] += c5 - c3;\n"
           "      dbg[4] += c5 - c4;\n      dbg[5] += c5 - c0;\n"
           "      dbg[6] += 1;\n      dbg[7] += slow;\n"
           "      dbg[8] += slow ? cw - c0 : 0;\n    }\n"
           "    if (tid == 32 && k >= 0 && m < count) {\n"
           "      dbg[9] += w0 - cw;\n      dbg[10] += c4 - w1;\n"
           "      dbg[11] += c5 - c4;\n    }\n"
           "    if (lane == 0 && pw == nprod - 1 && k >= 0 && m < count)\n"
           "      dbg[12] += w1 - w0;\n"),
        (back, "  const long long e1 = clock64();\n" + back),
        (tail, tail[:-2] + "  __syncthreads();\n"
         "  if (tid == 0) dbg[14] += clock64() - e1;\n"
         + _flush("tid == 0 || tid == 32 || (lane == 0 && pw == nprod - 1)")
         + "}\n"),
    ]


# the edit sets by the design their anchors belong to, and the names of
# the repair's slots in each
SPEC_DESIGNS = {
    "block_reduce": (_pass_edits_draw, _repair_edits_reduce, _REDUCE_NAMES),
    "pipeline": (_pass_edits_select, _repair_edits_pipeline, _PIPE_NAMES),
}


def spec_design(text: str) -> str:
    """Which K6 design a scan_kernel.cu holds: the one whose every edit
    anchor it holds once."""
    for name, (pe, re_, _) in SPEC_DESIGNS.items():
        if all(text.count(old) == 1 for old, _ in pe() + re_()):
            return name
    raise ValueError("no K6 probe's anchors match this scan_kernel.cu")


def _spec_edits(design: str):
    pass_edits, repair_edits, _ = SPEC_DESIGNS[design]
    return [
        ("#define SCAN_MAX_CLUSTER 16\n",
         "#define SCAN_MAX_CLUSTER 16\n"
         f"__device__ long long spec_dbg[{_SPEC_SLOTS}];\n"
         f"__device__ long long k6a_dbg[{_PASS_SLOTS} * {_PASS_CTAS}];\n"
         + _GTIME),
        (_ERRNAME, _DBG_READ + _ERRNAME),
    ] + pass_edits() + repair_edits()


def _spec_encodings():
    from ..sched.device import encode_snapshot
    from .benchmark import _bench_pod
    spread = fx.SMOKE_DIGESTS["spread_5000x8192"]
    return {"e2e_chunk": fx.fleet_encoder().encode_tile(
        [_bench_pod(i) for i in range(fx.SMOKE_CHUNK)], [], []),
        "spread_5000x8192": encode_snapshot(
            fx.engine_snapshot(spread["n_nodes"], spread["n_pods"],
                               spread["plain"]),
            pod_pad_to=fx.smoke_pod_pad(spread["n_pods"]))}


def _read_dbg(lib, which: int, n: int) -> np.ndarray:
    buf = (ctypes.c_longlong * n)()
    err = lib.spec_dbg_read(buf, which, 0)
    if err:
        raise RuntimeError(f"reading K6's cycles: CUDA error {err}")
    return np.array(list(buf), dtype=np.int64)


def _pass_summary(d: np.ndarray, ctas: int) -> dict:
    d = d.reshape(_PASS_CTAS, _PASS_SLOTS)[:ctas]
    runs = np.maximum(d[:, 2], 1)
    score, draw = d[:, 0] / runs, d[:, 1] / runs
    t0 = d[:, 3].min()
    return {"ctas": ctas, "launches": int(d[0, 2]),
            "score_cycles": _pct(score), "draw_cycles": _pct(draw),
            "first_cta": {"score_cycles": float(score[0]),
                          "draw_cycles": float(draw[0]),
                          "ns": [int(d[0, 3] - t0), int(d[0, 4] - t0)]},
            "last_cta": {"score_cycles": float(score[-1]),
                         "draw_cycles": float(draw[-1]),
                         "ns": [int(d[-1, 3] - t0), int(d[-1, 4] - t0)]},
            "grid_ns": int(d[:, 4].max() - t0),
            "last_start_ns": int(d[:, 3].max() - t0)}


def spec_phases(device, against: str = "") -> dict:
    """K6's clock64 split on K1's e2e chunk and on the spread fixture's
    chunk (the whole chunk through spec_chunk, 32 blocks of 256): the
    repair's cycles a pod by part as its committing thread sees them,
    and the pass's scoring and top-list cycles a CTA with the first and
    last CTA of the last launch on the globaltimer; each build's chunk
    device ms, the instrumented answers held equal to the committed
    ones. With `against`, the same for that checkout's kernels (its
    `sched/device` loaded beside this one's), so one call reads both
    designs on one card."""
    from ..sched.device import spec_kernel as spk
    sets = {"this": (sk, spk, _build)}
    if against:
        from .gpu_evidence import load_wrappers
        other = load_wrappers(against)
        sets["against"] = (other["scan_kernel"], other["spec_kernel"],
                           other["_build"])
    engine = eng.BatchEngine(device=device)
    w = engine.weights
    encs = _spec_encodings()
    out = {}
    for who, (skm, spm, bld) in sets.items():
        real = skm.SOURCE
        with open(real) as f:
            design = spec_design(f.read())
        copy = _variant(f"spec_phases_{who}", real, _spec_edits(design))
        bld.build_all([real, copy])
        names = SPEC_DESIGNS[design][2]
        rec = {"design": design}
        try:
            for key, enc in encs.items():
                a = scan_args(*engine.device_args(enc))
                has_spread = engine._enc_flags(enc)[1]
                init = [t.clone() for t in a.state]
                p = a.dims()["p"]
                b = min(spm.SPEC_BLOCK, p)
                r, want = {}, None
                for name, path in (("committed", real),
                                   ("instrumented", copy)):
                    _with_source(skm, path)

                    def run():
                        for t, s in zip(a.state, init):
                            t.copy_(s)
                        return spm.spec_chunk(a, w, has_spread)

                    got = run().clone()
                    want = got if want is None else want
                    if not torch.equal(got, want):
                        raise AssertionError(f"{who} {name} K6 differs")
                    r[f"{name}_chunk_ms"] = device_ms(run, reps=3,
                                                      trials=3)
                lib = skm._library()
                lib.spec_dbg_read.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_int]
                err = lib.spec_dbg_read(None, 0, 1) or \
                    lib.spec_dbg_read(None, 1, 1)
                if err:
                    raise RuntimeError(f"zeroing K6's cycles: CUDA error "
                                       f"{err}")
                run()
                torch.cuda.synchronize()
                d = dict(zip(names, _read_dbg(lib, 0, _SPEC_SLOTS)))
                pods = max(int(d["pods"]), 1)
                slow = max(int(d["slow_pods"]), 1)
                blocks = -(-pods // b)
                r["repair"] = {"pods": int(d["pods"]),
                               "slow_pods": int(d["slow_pods"])}
                for k, v in d.items():
                    if k in ("pods", "slow_pods"):
                        continue
                    if k.endswith("logue"):
                        r["repair"][f"{k}_cycles_a_block"] = float(v) / blocks
                    elif k.endswith("slow_pod"):
                        r["repair"][f"{k}_cycles"] = float(v) / slow
                    else:
                        r["repair"][f"{k}_cycles_a_pod"] = float(v) / pods
                r["pass"] = _pass_summary(
                    _read_dbg(lib, 1, _PASS_SLOTS * _PASS_CTAS), b)
                rec[key] = r
                _with_source(skm, real)
        finally:
            _with_source(skm, real)
        out[who] = rec
    return out


# ------------------------------------------------ one slot's score latency

# A kernel appended to a copy of `csrc/scan_kernel.cu`: one warp or more
# score one slot for pod 0 in series (the next slot depends on the last
# score), `iters` times, and record clock64 cycles an iteration; MODE
# 0: node_total + fits from the tables (GlobalSlots), 1: the same from a
# shared copy (K1's SharedSlots), 2: K6b's path (the tables plus a
# record of commits, read at once into a RegSlot, fits_reg), 3:
# node_total alone from the shared copy, 4: fits alone from it.
_LATENCY = """
template <typename T, int MODE>
__global__ void score_latency_kernel(const Params<T> a, int active,
                                     int iters, long long* out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int E = pod_words<T, false, false, false>(a);
  uint32_t* row = (uint32_t*)smem;
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    row[e] = pod_word<T, false, false, false>(a, 0, e);
  SharedSlots<T> c;
  c.flags_ = carve(c, smem + ((4 * E + 15) & ~15), 64, a.L, a.PW, a.K);
  uint8_t* rec = (uint8_t*)(((uintptr_t)(c.flags_ + 64) + 15)
                            & ~(uintptr_t)15);
  Deltas<T> d;
  uint8_t* end = carve(d, rec, 1, a.PW, a.K, 0);
  for (uint32_t* w = (uint32_t*)rec + threadIdx.x; w < (uint32_t*)end;
       w += blockDim.x)
    *w = 0;
  for (int i = threadIdx.x; i < 64; i += blockDim.x) load_slot(a, c, i, i);
  __syncthreads();
  const Pod<T> p = read_pod<T, false, false, false>(a, row);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= active) return;
  int n = lane & 63;
  T acc = 0;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    T tot = 0;
    bool f = true;
    if (MODE == 0) {
      const GlobalSlots<T> s{a};
      tot = node_total<T, false>(a, p, s, n, n);
      f = fits<T, false>(a, p, s, n, n);
    } else if (MODE == 1 || MODE == 3 || MODE == 4) {
      if (MODE != 4) tot = node_total<T, false>(a, p, c, n, n);
      if (MODE != 3) f = fits<T, false>(a, p, c, n, n);
    } else {
      const RegSlot<T> r = reg_slot<T, false>(
          a, p, LiveSlot<T>{a, d, 0, nullptr}, n);
      tot = node_total<T, false>(a, p, r, n, n);
      f = fits_reg(p, r, n);
    }
    acc += tot + f;
    n = (n + 1 + (int)((tot >> 30) & 1) + (int)(!f & (tot < -5))) & 63;
  }
  const long long t1 = clock64();
  if (lane == 0) {
    out[2 * warp] = (t1 - t0) / iters;
    out[2 * warp + 1] = (long long)acc;
  }
}

template <typename T, int MODE>
static int score_latency_go(const long long* dims,
                            const unsigned long long* ptrs, int active,
                            int iters, long long* out, cudaStream_t st) {
  const Params<T> a = unpack<T>(dims, ptrs);
  auto k = score_latency_kernel<T, MODE>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       64 * 1024);
  k<<<1, 512, 64 * 1024, st>>>(a, active, iters, out);
  return (int)cudaGetLastError();
}

extern "C" int score_latency_launch(int wide, int mode, int active,
                                    int iters, const long long* dims,
                                    const unsigned long long* ptrs,
                                    long long* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define SCORE_LATENCY(T) \\
  switch (mode) { \\
    case 0: return score_latency_go<T, 0>(dims, ptrs, active, iters, out, st); \\
    case 1: return score_latency_go<T, 1>(dims, ptrs, active, iters, out, st); \\
    case 2: return score_latency_go<T, 2>(dims, ptrs, active, iters, out, st); \\
    case 3: return score_latency_go<T, 3>(dims, ptrs, active, iters, out, st); \\
    case 4: return score_latency_go<T, 4>(dims, ptrs, active, iters, out, st); \\
    default: return -1; \\
  }
  if (wide) SCORE_LATENCY(int64_t) else SCORE_LATENCY(int32_t)
  return -1;
}

"""
_LATENCY_MODES = ("tables", "shared_copy", "k6b_regslot",
                  "shared_total_only", "shared_fits_only")


def score_latency(device, iters: int = 64) -> dict:
    """One slot's node_total + fits in series, cycles an iteration (the
    latency K6b's pipeline step is made of), on K1's e2e tables (pod 0,
    the first 64 slots), one warp alone and 16 warps at once, in each
    MODE of _LATENCY."""
    from .benchmark import _bench_pod
    real = sk.SOURCE
    copy = _variant("score_latency", real, [(_ERRNAME, _LATENCY + _ERRNAME)])
    rec = _build.build_all([copy])[0]
    lib = ctypes.CDLL(rec["library"])
    lib.score_latency_launch.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_void_p] * 4
    engine = eng.BatchEngine(device=device)
    enc = fx.fleet_encoder().encode_tile(
        [_bench_pod(i) for i in range(256)], [], [])
    a = scan_args(*engine.device_args(enc))
    wide = int(a.dtype == torch.int64)
    dims, ptrs = sk.pack(a, engine.weights, 0, {})
    out = torch.zeros(64, dtype=torch.int64, device=device)
    res = {"wide": bool(wide)}
    for mode, name in enumerate(_LATENCY_MODES):
        for active in (1, 16):
            out.zero_()
            err = lib.score_latency_launch(
                wide, mode, active, iters, dims.ctypes.data,
                ptrs.ctypes.data, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"score_latency {name}: CUDA error {err}")
            cyc = out.view(32, 2)[:active, 0].tolist()
            res[f"{name}@{active}_warps"] = [min(cyc), max(cyc)]
    return res


# --------------------------------------------------------------- K7

# The probe points' definitions, put at the head of a copy of
# `csrc/scan_kernel.cu`: CTA 0's thread 0 of each shard (by its cluster
# rank) takes clock64 at each point of an exchange, 0 before the post,
# 1 after it, 2 once its first poll is back, 3 once warp 0 (every lane
# a shard) has every record's flag, 4 once the payload is in and
# reduced, 5 after the barrier that hands the result to the CTA, and
# sums the five differences a kind (0 candidate, 1 group max, 2 zone
# histogram) in shared memory, flushed once a launch into k7_dbg
# [shard][kind][the five, the exchanges].
_K7_PROBE = r"""
__device__ long long k7_dbg[32 * 3 * 6];
__shared__ long long k7_t[6];
__shared__ long long k7_acc[3 * 6];
__shared__ int k7_kind, k7_polled;
__device__ __forceinline__ bool k7_me() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return threadIdx.x == 0 && r == 0;
}
__device__ __forceinline__ void k7_mark(int kind, int phase) {
  if (phase == 3 || phase == 4) __syncwarp();
  if (!k7_me()) return;
  const long long t = clock64();
  if (phase == 2) {
    if (k7_polled) return;
    k7_polled = 1;
  }
  if (phase == 0) { k7_kind = kind; k7_polled = 0; }
  k7_t[phase] = t;
  if (phase == 5) {
    if (!k7_polled) k7_t[2] = k7_t[1];
    for (int i = 0; i < 5; ++i)
      k7_acc[k7_kind * 6 + i] += k7_t[i + 1] - k7_t[i];
    k7_acc[k7_kind * 6 + 5] += 1;
  }
}
#define K7_MARK(kind, phase) k7_mark(kind, phase)
#define K7_PROBE_BEGIN() \
  do { if (k7_me()) for (int i = 0; i < 18; ++i) k7_acc[i] = 0; } while (0)
#define K7_PROBE_END(shard) \
  do { if (k7_me()) for (int i = 0; i < 18; ++i) \
         k7_dbg[(shard) * 18 + i] += k7_acc[i]; } while (0)
"""
_K7_READ = r"""
extern "C" int k7_dbg_read(void* out, int zero) {
  static const long long zeros[32 * 3 * 6] = {0};
  if (zero) return (int)cudaMemcpyToSymbol(k7_dbg, zeros, sizeof zeros);
  return (int)cudaMemcpyFromSymbol(out, k7_dbg, sizeof zeros);
}
"""
_K7_PHASES = ("post", "first_poll", "spin", "payload", "broadcast")
_K7_KINDS = ("candidate", "group_max", "zones")


def _k7_edits(text: str):
    """The probe's definitions and reader, for a scan_kernel.cu whose K7
    carries the probe points (the flag-in-data records do)."""
    if "#ifndef K7_MARK" not in text:
        raise ValueError("this scan_kernel.cu's K7 has no probe points")
    return [("#include <climits>\n", _K7_PROBE + "#include <climits>\n"),
            (_ERRNAME, _K7_READ + "\n" + _ERRNAME)]


def _k7_chunks():
    from .benchmark import _bench_pod
    return {"e2e_chunk": fx.fleet_encoder().encode_tile(
        [_bench_pod(i) for i in range(fx.SMOKE_CHUNK)], [], []),
        "spread_chunk": eng.encode_snapshot(
            fx.engine_snapshot(5000, fx.SMOKE_CHUNK, plain=False),
            node_pad_to=8)}


def k7_phases(device, shards=(1, 2, 4, 8), against: str = "") -> dict:
    """K7's cycles a pod in the sharded K1, split five ways for CTA 0's
    thread 0 of each shard (`_K7_PHASES`: its post, its first poll, the
    spin after it (the wait for the slowest shard), the payload's load,
    the barrier that hands the result to the CTA), for each exchange kind
    (`_K7_KINDS`), at each count of `shards`, on K1's e2e chunk (the
    candidate exchange alone) and on the spread fixture's first chunk
    (the group max too), from a copy of `csrc/scan_kernel.cu` with the
    probe points defined; the uninstrumented and the instrumented builds'
    device ms, their answers held equal. With `against`, the same for
    that checkout's kernels (its `sched/device` loaded beside this
    one's), so one call splits both on one card."""
    # (label, module, source, instrumented copy)
    mods = [("this", sk)]
    if against:
        from .gpu_evidence import load_wrappers
        mods.append(("against", load_wrappers(against)["scan_kernel"]))
    builds = []
    for label, skm in mods:
        with open(skm.SOURCE) as f:
            edits = _k7_edits(f.read())
        builds.append((label, skm, skm.SOURCE,
                       _variant(f"k7_phases_{label}", skm.SOURCE, edits)))
    _build.build_all([p for b in builds for p in b[2:]])
    engine = eng.BatchEngine(device=device)
    chunks = _k7_chunks()
    out = {}
    for label, skm, plain, copy in builds:
        real = skm.SOURCE
        rec = {}
        try:
            for key, enc in chunks.items():
                a = scan_args(*engine.device_args(enc))
                flags = engine._enc_flags(enc)
                init = [t.clone() for t in a.state]
                ar = skm.ScanArgs(*a)
                d = a.dims()
                for s in shards:
                    space = skm.ShardSpace(s, d, device)
                    r, want = {}, None
                    for name, path in (("committed", plain),
                                       ("instrumented", copy)):
                        _with_source(skm, path)

                        def run():
                            for t, v in zip(ar.state, init):
                                t.copy_(v)
                            return skm.scan_chunk_sharded(
                                ar, engine.weights, 0, *flags, space)

                        got = run().clone()
                        want = got if want is None else want
                        if not torch.equal(got, want):
                            raise AssertionError(f"{label} {name} sharded "
                                                 f"K1 differs")
                        r[f"{name}_ms"] = device_ms(run, reps=5, trials=3)
                    lib = skm._library()
                    lib.k7_dbg_read.argtypes = [ctypes.c_void_p,
                                                ctypes.c_int]
                    buf = (ctypes.c_longlong * (32 * 3 * 6))()
                    err = lib.k7_dbg_read(buf, 1)
                    run()
                    torch.cuda.synchronize()
                    err = err or lib.k7_dbg_read(buf, 0)
                    if err:
                        raise RuntimeError(f"reading K7's cycles: CUDA "
                                           f"error {err}")
                    dbg = np.array(list(buf), dtype=np.int64).reshape(
                        32, 3, 6)[:s]
                    for k, kind in enumerate(_K7_KINDS):
                        n = dbg[:, k, 5]
                        if not n.any():
                            continue
                        per = dbg[:, k, :5] / np.maximum(n, 1)[:, None]
                        r[kind] = {"exchanges": [int(v) for v in n],
                                   **{ph: [float(v) for v in per[:, i]]
                                      for i, ph in enumerate(_K7_PHASES)},
                                   "whole": [float(v) for v in
                                             per.sum(axis=1)]}
                    rec[f"{key}@{s}"] = r
                for t, v in zip(ar.state, init):
                    t.copy_(v)
        finally:
            _with_source(skm, real)
        out[label] = rec
    return out


# ---------------------------------------------- one hop through L2

L2_HOP_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "csrc", "l2_hop.cu")
# each CTA's dynamic shared memory: more than half of an SM's, so the
# grid runs one CTA an SM
_HOP_SMEM = 120 * 1024


@functools.cache
def _hop_library():
    lib = ctypes.CDLL(_build.build_all([L2_HOP_SOURCE])[0]["library"])
    # buf, sms, smem, ping, pong, mode, rounds, budget, out, stream
    lib.l2_hop_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 6 \
        + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    lib.l2_hop_launch.restype = ctypes.c_int
    return lib


def _hop_launch(device, out, ping: int, pong: int, mode: int,
                rounds: int) -> None:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    buf = torch.zeros(64, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = _hop_library().l2_hop_launch(
            buf.data_ptr(), sms, _HOP_SMEM, ping, pong, mode, rounds,
            1 << 30, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"l2_hop launch failed: CUDA error {err}")


def sm_ids(device) -> list:
    """The SM ids a grid of one CTA an SM ran on, sorted (the census:
    ids need not be contiguous)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = torch.full((sms,), -1, dtype=torch.int64, device=device)
    _hop_launch(device, out, 0, 1, 2, 1)
    return sorted(set(out.tolist()) - {-1})


def hop_cycles(device, ping: int, pong: int, mode: int,
               rounds: int = 2000) -> float:
    """One one-way hop through L2 between the SMs with ids `ping` and
    `pong`, in the pinger's cycles (csrc/l2_hop.cu: mode 0 a relaxed
    flag-in-data word, 1 a payload then a st.release sequence, read with
    ld.acquire then a payload load), the median of three launches of
    `rounds` round trips each; raises if a side did not run or the
    payloads differ."""
    want = 7 * rounds * (rounds + 1) // 2 + rounds
    got = []
    for _ in range(3):
        out = torch.full((4,), -1, dtype=torch.int64, device=device)
        _hop_launch(device, out, ping, pong, mode, rounds)
        cycles, total, a, b = out.tolist()
        if (a, b) != (ping, pong) or cycles <= 0 or total != want:
            raise AssertionError(f"l2_hop {ping}-{pong} mode {mode}: "
                                 f"{out.tolist()}")
        got.append(cycles / (2 * rounds))
    return float(np.median(got))


def far_pair(device) -> tuple:
    """The lowest and the highest SM id a grid ran on."""
    ids = sm_ids(device)
    return ids[0], ids[-1]


def l2_hop(device, rounds: int = 2000) -> dict:
    """The one-way hop through L2 (hop_cycles) both ways, between the
    lowest SM id and the next, the middle one and the highest (the
    distant pair, whose relaxed hop sets K7's latency floor: a pod's
    exchange needs at least one hop), with the card's SM clock."""
    from ..sched.device import bounds
    ids = sm_ids(device)
    pairs = ((ids[0], ids[1]), (ids[0], ids[len(ids) // 2]),
             (ids[0], ids[-1]))
    out = {"rounds": rounds, "sm_ids": len(ids),
           "sm_clock_mhz": bounds.card_rate()["sm_clock_mhz"]}
    for mode, name in ((0, "relaxed"), (1, "release_acquire")):
        out[name] = {f"{a}-{b}": hop_cycles(device, a, b, mode, rounds)
                     for a, b in pairs}
    far = f"{ids[0]}-{ids[-1]}"
    out["relaxed_hop_cycles"] = out["relaxed"][far]
    out["release_acquire_hop_cycles"] = out["release_acquire"][far]
    return out


def hop_floor_ms(pods: int, hop: float, sm_clock_mhz: float) -> float:
    """K7's latency floor over a chunk: `pods` exchanges in series, each
    at least one relaxed hop of `hop` cycles."""
    return pods * hop / (sm_clock_mhz * 1e3)


# ------------------------------------------------ K5's block-a-pod route

_LB = "__global__ void __launch_bounds__(PROBE_BLOCK_THREADS)\nprobe_kernel("
_TOTAL_FIRST = """    const T t = node_total<T, true>(a, p, s, n, n);
    const bool m = fits<T, HAS_AFF>(a, p, s, n, n);
"""
_MASK_FIRST = """    const bool m = fits<T, HAS_AFF>(a, p, s, n, n);
    const T t = node_total<T, true>(a, p, s, n, n);
"""
_PICK = "      if constexpr (sizeof(T) == 8 && HAS_AFF && ANTI)\n"


def _bounds_variants(real: str) -> dict:
    """Copies with one order and one bound for every instantiation."""
    out = {}
    for order, body in (("total_first", _TOTAL_FIRST),
                        ("mask_first", _MASK_FIRST)):
        for minimum in (0, 2, 3):
            lb = _LB if not minimum else _LB.replace(
                "(PROBE_BLOCK_THREADS)", f"(PROBE_BLOCK_THREADS, {minimum})")
            name = f"{order}_min{minimum}"
            out[name] = _variant(name, real, [
                (_TOTAL_FIRST, body), (_LB, lb),
                (_PICK, "      if constexpr (false)\n")])
    return out


def _ptxas(log: str) -> dict:
    """{probe_kernel instantiation: [registers, spill stores]}."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m[1] if "probe_kernel" in m[1] else None
            if name:
                out[name] = [0, 0]
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out[name][1] = int(m[1])
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name][0] = int(m[1])
    return out


def probe_bounds(device, p: int = 8192, n: int = 5000) -> dict:
    real = sk.SOURCE
    copies = _bounds_variants(real)
    logs = {r["source"]: r["log"]
            for r in _build.build_all([real, *copies.values()])}
    inst = {}
    for wide in (False, True):
        for aff in (False, True):
            for anti in (False, True):
                tables = fx.scan_tables(3 + 4 * wide + 2 * aff + anti, p, n,
                                        wide, 2, 3 if aff else 0,
                                        2 if anti else 0)
                a = scan_args(*(eng._upload(t, device) for t in tables))
                inst[sk.variant(wide, True, aff, anti)] = (
                    a, ((1, 1, 1), 2 if anti else 0, aff))
    out = {}
    try:
        for name, path in [("committed", real)] + list(copies.items()):
            _with_source(sk, path)
            rec = {"ptxas": _ptxas(logs[path]) if logs[path] else None,
                   "ms": {}}
            for code, (a, flags) in inst.items():
                head = a.pod_slice(0, 64)
                if not _same(sk.probe(head, *flags, sms=1),
                             sk.probe_plain(head, *flags)):
                    raise AssertionError(f"{name}: probe {code} differs "
                                         f"from its plain version")
                rec["ms"][code] = device_ms(lambda: sk.probe(a, *flags,
                                                             sms=1))
            out[name] = rec
    finally:
        _with_source(sk, real)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write the JSON here")
    ap.add_argument("--spec-only", action="store_true",
                    help="only spec_phases")
    ap.add_argument("--k7-only", action="store_true",
                    help="only k7_phases and l2_hop")
    ap.add_argument("--against", default="",
                    help="another checkout whose K6 (spec_phases) and K7 "
                         "(k7_phases) are also read")
    args = ap.parse_args(argv)
    device = _cuda(None)
    if args.spec_only or args.k7_only:
        doc = {"card": card_line()}
        if args.spec_only:
            doc.update(spec_phases=spec_phases(device, args.against),
                       score_latency=score_latency(device))
        if args.k7_only:
            doc.update(k7_phases=k7_phases(device, against=args.against),
                       l2_hop=l2_hop(device))
        text = json.dumps(doc, default=str)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
        print(text)
        return 0
    doc = {"card": card_line(),
           "k7_phases": k7_phases(device, against=args.against),
           "l2_hop": l2_hop(device),
           "spec_phases": spec_phases(device, args.against),
           "score_latency": score_latency(device),
           "victim_phases": victim_phases(device),
           "victim_host": victim_host(device),
           "probe_bounds": probe_bounds(device)}
    text = json.dumps(doc, default=str)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
