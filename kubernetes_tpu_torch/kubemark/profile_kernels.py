"""Where the victim search's, the probe's and the speculative repair's
time goes, on the card.

    python -m kubernetes_tpu_torch.kubemark.profile_kernels [--out PATH]

Prints one JSON object (and writes it to PATH when given):

- ``victim_phases``: the victim kernel (K4) on the preempt fixture's
  widest table (5120 x 16) and a one-victim table, built from a copy of `csrc/victim_kernel.cu` that records, for
  thread 0 of every CTA, clock64 at the kernel's start, once the node's
  fields are in (its k = 0 test), once its victims are scanned, after
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

- ``spec_phases``: the speculative repair (K6b) on the first block of
  K1's e2e chunk (256 bench pods on the e2e fleet's 5120 slots, after
  K6a's top lists), built from a copy of `csrc/scan_kernel.cu` that sums
  clock64 over the block's pods, for thread 0 (list entry 0, the
  reduction, the commit): its own offers, the wait at the reduction's
  barrier (the slowest thread's offers and the warp reductions), the
  CTA's reduction and the commit, and the barrier after the commit;
  and for the last thread (the rescore of the block's first taken
  slot) its offers. Cycles a pod of each, and both builds' device ms.

- ``k7_phases``: K7, the exchange between the shards inside the sharded
  K1, at 2, 4 and 8 shards on one card, on K1's e2e chunk and on the
  spread fixture's first chunk, built from a copy of
  `csrc/scan_kernel.cu` that sums clock64 around each exchange for CTA
  0's thread 0 of each shard (its post, its wait for every shard's
  record, the reduction): cycles a pod of the candidate exchange, the
  group max and the zone histogram, each shard's; both builds' device
  ms (their answers held equal).

Every copy is held equal to the plain version before it is timed.
Copies are written under `kubernetes_tpu_torch/_build/variants/` and
built there; the committed libraries are untouched.
"""

from __future__ import annotations

import argparse
import ctypes
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


def _pct(x) -> list:
    return [float(v) for v in np.percentile(x, [0, 50, 100])]


def victim_phases(device) -> dict:
    tables = fx.preempt_tables()
    wide = fx.widest_table(tables)
    one = min(tables, key=lambda t: (t.v, -int(t.v_valid.sum())))
    real = vk.SOURCE
    copy = _variant("victim_phases", real, _phase_edits())
    _build.build_all([real, copy])
    out = {}
    try:
        for label, t in (("wide", wide), ("one_victim", one)):
            args = vk.VictimArgs.from_table(t, device)
            plan = vk.launch_plan(t.n, t.v, vk.card_sms())
            want = vk.victim_search_plain(args)
            rec = {"shape": [t.n, t.v], "plan": list(plan)}
            for name, path in (("committed", real), ("instrumented", copy)):
                _with_source(vk, path)
                if not _same(vk.victim_search(args), want):
                    raise AssertionError(f"{name} victim kernel differs "
                                         f"from its plain version")
                rec[f"{name}_ms"] = device_ms(lambda: vk.victim_search(args))
            torch.cuda.synchronize()
            vk.victim_search(args)
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


# --------------------------------------------------------------- K6b phases

_SPEC_LOOP = """  for (int k = 0; k < count; ++k) {
    Pod<T> p = read_pod<T, HAS_SPREAD, false, false>(a, rows + (size_t)k * E);
    const T fc = nc;"""
_SPEC_REDUCE = "    // the CTA's best, read by every thread\n"
_SPEC_READ = "    T cb = lane < nwarps ? (T)red_c[b][lane] : (T)-1;\n"
_SPEC_PUBLISH = "    __syncthreads();                  // the commit, published\n"
# 0 thread 0's offers, 1 its wait at the reduction's barrier, 2 the
# reduction and the commit, 3 the barrier after the commit, 4 the last
# thread's offers, 5 pods (all cycles summed over the block's pods)
_SPEC_SLOTS = 6


def _spec_edits():
    return [
        ("#define SPEC_REPAIR_THREADS 512\n",
         "#define SPEC_REPAIR_THREADS 512\n"
         "__device__ long long spec_dbg[8];\n"),
        (_SPEC_LOOP, _SPEC_LOOP.replace(
            "  for (int k = 0; k < count; ++k) {\n",
            "  for (int k = 0; k < count; ++k) {\n"
            "    const long long c0 = clock64();\n")),
        (_SPEC_REDUCE, "    const long long c1 = clock64();\n" + _SPEC_REDUCE),
        (_SPEC_READ, "    const long long c2 = clock64();\n" + _SPEC_READ),
        (_SPEC_PUBLISH,
         "    const long long c3 = clock64();\n" + _SPEC_PUBLISH
         + "    if (tid == 0) {\n"
           "      spec_dbg[0] += c1 - c0;\n      spec_dbg[1] += c2 - c1;\n"
           "      spec_dbg[2] += c3 - c2;\n"
           "      spec_dbg[3] += clock64() - c3;\n      spec_dbg[5] += 1;\n"
           "    }\n"
           "    if (tid == nthreads - 1) spec_dbg[4] += c1 - c0;\n"),
        ("extern \"C\" const char* scan_error_name(int err) {",
         "extern \"C\" int spec_dbg_read(void* out, int zero) {\n"
         "  static const long long zeros[8] = {0};\n"
         "  if (zero) return (int)cudaMemcpyToSymbol(spec_dbg, zeros,"
         " sizeof zeros);\n"
         "  return (int)cudaMemcpyFromSymbol(out, spec_dbg, sizeof zeros);"
         "\n}\n\nextern \"C\" const char* scan_error_name(int err) {"),
    ]


def spec_phases(device) -> dict:
    from ..sched.device import spec_kernel as spk
    from .benchmark import _bench_pod
    enc = fx.fleet_encoder().encode_tile(
        [_bench_pod(i) for i in range(fx.SMOKE_CHUNK)], [], [])
    tables = eng.BatchEngine(device=device).device_args(enc)
    real = sk.SOURCE
    copy = _variant("spec_phases", real, _spec_edits())
    _build.build_all([real, copy])
    w = eng.DEFAULT_WEIGHTS
    b = spk.SPEC_BLOCK
    out = {"shape": [b, int(enc.node_tab.valid.shape[0])]}
    want = None
    a = scan_args(*tables)
    init = [t.clone() for t in a.state]
    try:
        for name, path in (("committed", real), ("instrumented", copy)):
            _with_source(sk, path)
            # both builds from the chunk's initial State
            for t, s in zip(a.state, init):
                t.copy_(s)
            top = spk.spec_pass(a, w, False, 0, b)
            assigned = torch.empty(a.dims()["p"], dtype=torch.int32,
                                   device=device)

            def repair():
                for t, s in zip(a.state, init):
                    t.copy_(s)
                spk.spec_repair(a, top, 0, b, w, False, assigned)

            repair()
            got = assigned[:b].clone()
            want = got if want is None else want
            if not torch.equal(got, want):
                raise AssertionError(f"{name} repair differs from the "
                                     f"committed one")
            out[f"{name}_ms"] = device_ms(repair, reps=5, trials=3)
        lib = sk._library()
        lib.spec_dbg_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        buf = (ctypes.c_longlong * 8)()
        err = lib.spec_dbg_read(buf, 1)
        repair()
        torch.cuda.synchronize()
        err = err or lib.spec_dbg_read(buf, 0)
        if err:
            raise RuntimeError(f"reading the phases: CUDA error {err}")
        d = list(buf)
        pods = max(d[5], 1)
        out.update(pods=d[5], **{f"{k}_cycles_a_pod": d[i] / pods
                                 for i, k in enumerate(
                                     ("own_offers", "reduce_wait",
                                      "reduce_commit", "commit_barrier",
                                      "rescore_offers"))})
    finally:
        _with_source(sk, real)
    return out


# --------------------------------------------------------------- K7

_K7_MAX = "      if constexpr (SHARDED) m = k7_max(x, m, n_max, poster, xs_m);\n"
_K7_ZONES = ("      if constexpr (SHARDED) k7_zones(x, ztot, a.Z, n_zone, "
             "rank == 0);\n")
_K7_BEST = """    if constexpr (SHARDED)
      k7_best(x, best, best_j, n_cand, poster,
              a.withhold == shard && n_cand == 0, xs_c, xs_j);
"""
# per shard: 0 the candidate exchange, 1 the group max, 2 the zone
# histogram (cycles summed over the chunk), 3 the pods that exchanged


def _k7_edits():
    def timed(call, slot, count=False):
        body = call.replace("if constexpr (SHARDED) ", "").replace(
            "    if constexpr (SHARDED)\n", "")
        return ("    if constexpr (SHARDED) {\n"
                "      const long long c0 = clock64();\n" + body
                + f"      if (poster) {{\n"
                f"        k7_dbg[4 * shard + {slot}] += clock64() - c0;\n"
                + ("        k7_dbg[4 * shard + 3] += 1;\n" if count else "")
                + "      }\n    }\n")
    return [
        ("#define K7_MAX_SHARDS 32\n",
         "#define K7_MAX_SHARDS 32\n"
         "__device__ long long k7_dbg[4 * K7_MAX_SHARDS];\n"),
        (_K7_BEST, timed(_K7_BEST, 0, count=True)),
        (_K7_MAX, timed(_K7_MAX, 1)),
        (_K7_ZONES, timed(_K7_ZONES, 2)),
        ("extern \"C\" const char* scan_error_name(int err) {",
         "extern \"C\" int k7_dbg_read(void* out, int zero) {\n"
         "  static const long long zeros[4 * K7_MAX_SHARDS] = {0};\n"
         "  if (zero) return (int)cudaMemcpyToSymbol(k7_dbg, zeros,"
         " sizeof zeros);\n"
         "  return (int)cudaMemcpyFromSymbol(out, k7_dbg, sizeof zeros);"
         "\n}\n\nextern \"C\" const char* scan_error_name(int err) {"),
    ]


def k7_phases(device, shards=(2, 4, 8)) -> dict:
    """K7's cycles a pod in the sharded K1, as CTA 0's thread 0 of each
    shard sees them (its post, the wait for every shard's record and the
    reduction), on K1's e2e chunk (the candidate exchange alone) and on
    the spread fixture's first chunk (the group max too), from a copy of
    `csrc/scan_kernel.cu` that sums clock64 around each exchange; both
    builds' device ms and answers."""
    from .benchmark import _bench_pod
    real = sk.SOURCE
    copy = _variant("k7_phases", real, _k7_edits())
    _build.build_all([real, copy])
    engine = eng.BatchEngine(device=device)
    chunks = {"e2e_chunk": fx.fleet_encoder().encode_tile(
        [_bench_pod(i) for i in range(fx.SMOKE_CHUNK)], [], []),
        "spread_chunk": eng.encode_snapshot(
            fx.engine_snapshot(5000, fx.SMOKE_CHUNK, plain=False),
            node_pad_to=8)}
    out = {}
    try:
        for key, enc in chunks.items():
            a = scan_args(*engine.device_args(enc))
            flags = engine._enc_flags(enc)
            init = [t.clone() for t in a.state]
            for s in shards:
                space = sk.ShardSpace(s, a.dims(), device)
                rec, want = {}, None
                for name, path in (("committed", real),
                                   ("instrumented", copy)):
                    _with_source(sk, path)

                    def run():
                        for t, v in zip(a.state, init):
                            t.copy_(v)
                        return sk.scan_chunk_sharded(a, engine.weights, 0,
                                                     *flags, space)

                    got = run().clone()
                    want = got if want is None else want
                    if not torch.equal(got, want):
                        raise AssertionError(f"{name} sharded K1 differs")
                    rec[f"{name}_ms"] = device_ms(run, reps=5, trials=3)
                lib = sk._library()
                lib.k7_dbg_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
                buf = (ctypes.c_longlong * (4 * sk.MAX_SHARDS))()
                err = lib.k7_dbg_read(buf, 1)
                run()
                torch.cuda.synchronize()
                err = err or lib.k7_dbg_read(buf, 0)
                if err:
                    raise RuntimeError(f"reading K7's cycles: CUDA error "
                                       f"{err}")
                d = np.array(list(buf), dtype=np.int64).reshape(-1, 4)[:s]
                pods = max(int(d[0, 3]), 1)
                rec.update(pods=int(d[0, 3]), **{
                    f"{k}_cycles_a_pod": [float(x) for x in d[:, i] / pods]
                    for i, k in enumerate(("candidate", "group_max",
                                           "zones"))})
                out[f"{key}@{s}"] = rec
                _with_source(sk, real)
    finally:
        _with_source(sk, real)
    return out


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
    args = ap.parse_args(argv)
    device = _cuda(None)
    doc = {"card": card_line(), "k7_phases": k7_phases(device),
           "spec_phases": spec_phases(device),
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
