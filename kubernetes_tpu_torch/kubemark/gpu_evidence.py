"""GPU evidence capture: what the port does on the card, section by section.

The counterpart of the JAX package's `kubemark/tpu_evidence.py`. Results
land in `--out` (GPU_EVIDENCE.json by default), written section by
section with an atomic rename at each flush, and each flush folds the
completed sections into the per-section best artifact (`--best-out`).

    python -m kubernetes_tpu_torch.kubemark.gpu_evidence --out PATH
    python -m kubernetes_tpu_torch.kubemark.gpu_evidence --turns-against DIR

The second form only times this checkout's hand kernels against those of
another checkout at DIR (for example `git archive <parent>
kubernetes_tpu_torch | tar -x -C DIR`) in the order other, this, this,
other on one card, with the SM clock, power and temperature sampled
while each kernel's turns run (SmiSampler), and prints one JSON object
(`section_turns`).

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
- ``engine_spec``: the speculative engine (K6) against the scan (K1) on
  the same fixture and shapes, plain and spread tiers, with the winner.
- ``mesh``: the sharded K1 (K7, the exchange between the shards, inside
  it) at 1, 2, 4 and 8 shards on one card, on K1's e2e chunk: bit-equal
  to K1, its device ms a chunk against K1's with the SM clock, and K7's
  bound (`section_mesh`; the shard phase of chip_smoke.py reuses its
  helpers `shard_parity`, `shard_timing`, `victim_shard_parity` and
  `shard_wedge_child`).
- ``e2e``: the live pipeline under the kubemark benchmark
  (`run_scheduling_benchmark(5000, 30000, "batch")`: registry, informer
  fan-out, FIFO drain, incremental encode, chained device scan, batched
  CAS bind), run once, with its per-node counts digest (held to
  fixtures.E2E_COUNTS by chip_smoke.py).

Every section needs the card: none falls back to the CPU. Still to port
from the JAX tool (ROADMAP.md Queue 1, 'Harness and entry points'): the
chip lock and the crossover against a CPU engine rate.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import time
import traceback
import types

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


SMI_FIELDS = ("clocks.sm", "power.draw", "temperature.gpu")


class SmiSampler:
    """nvidia-smi's SM clock (MHz), power draw (W) and temperature (C) of
    the first card, sampled every `period` seconds on a thread while the
    block runs (and once before and after): what the card ran at beside
    a timing. `summary()` -> min / median / max of each."""

    def __init__(self, period: float = 0.2):
        import threading
        self.period = period
        self.samples = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def read() -> list:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=" + ",".join(SMI_FIELDS),
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return [float(x) for x in out.strip().splitlines()[0].split(",")]

    def _run(self):
        while True:
            self.samples.append(self.read())
            if self._stop.wait(self.period):
                return

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.samples.append(self.read())

    def summary(self) -> dict:
        out = {"smi_samples": len(self.samples)}
        for i, name in enumerate(("sm_clock_mhz", "power_draw_w",
                                  "temperature_c")):
            col = sorted(x[i] for x in self.samples)
            out[name] = [col[0], statistics.median(col), col[-1]]
        return out


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


def call_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median wall time of one call as the card sees it (CUDA events
    around each call, after warm-up): includes the host's time to check
    inputs and launch whenever that exceeds the device's work."""
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


def launch_floor_ms(device=None) -> float:
    """device_ms of a kernel that does nothing: what any one launch
    costs in a graph, the floor under every kernel's `ms`."""
    from ..sched.device import reject_kernel
    d = _cuda(device)
    return device_ms(lambda: reject_kernel.empty_launch(d))


def kernel_timing(kernel, plain, library, floor_ms: float) -> dict:
    """A kernel's device time beside its plain version's, the one
    PyTorch call that computes the same function (None where there is
    none) and the launch floor; call_ms adds the host's launch."""
    return {"launch_floor_ms": floor_ms, "ms": device_ms(kernel),
            "plain_ms": device_ms(plain),
            "library_ms": None if library is None else device_ms(library),
            "call_ms": call_ms(kernel)}


def filter_bound(args, rate: dict) -> dict:
    """The filter kernel's bound on FilterArgs at the card's integer
    rate (bounds.card_rate), with the rate's keys."""
    from ..sched.device import bounds
    p, n = args.shape
    ops = bounds.filter_ops(p, n, args.labels.shape[1],
                            args.port_bits.shape[1], args.disk_any.shape[1])
    return {**bounds.bound(args.nbytes(), ops, rate["int_ops_per_s"]),
            "bytes": args.nbytes(), "ops": ops, **rate}


def argsort_bound(x, rate: dict) -> dict:
    """The argsort kernel's bound on f32[R, C]: each input read once,
    each int32 index written once, ceil(log2 C!) compares a row."""
    from ..sched.device import bounds
    r, c = x.shape
    nbytes = 2 * r * c * 4
    ops = bounds.argsort_ops(r, c)
    return {**bounds.bound(nbytes, ops, rate["int_ops_per_s"]),
            "bytes": nbytes, "ops": ops, **rate}


def scan_args(node, state, pods):
    """The scan kernels' arguments from the engine's device tables."""
    from ..sched.device import scan_kernel
    return scan_kernel.ScanArgs.from_engine(
        node, scan_kernel.reciprocals(node), state, pods)


def scan_parity(a, weights, anti_weight: int, has_aff: bool,
                has_spread: bool) -> dict:
    """K1 and K5 on ScanArgs `a` (on the card) against their plain
    versions on the same inputs: K1 from two copies of a.state (the
    assignment and every State field must be bit-equal after the
    chunk), K5 against the unchanged a.state on each of its routes: the
    plan's for the P pods, a block a pod (`sms=1`), and the first pod
    alone (a cluster of 16 CTAs, or 8). -> the fields compared, whether
    all were equal, the largest absolute difference, the pods the kernel
    placed, and the CTAs a pod of each K5 launch. a.state is left as it
    was."""
    from ..sched.device import scan_kernel as sk
    out = {}
    k_state = type(a.state)(*(t.clone() for t in a.state))
    p_state = type(a.state)(*(t.clone() for t in a.state))
    got = sk.scan_chunk(a._replace(state=k_state), weights, anti_weight,
                        has_aff, has_spread)
    want = sk.scan_chunk_plain(a._replace(state=p_state), weights,
                               anti_weight, has_aff, has_spread)
    pairs = [("assigned", got, want)]
    one = a.pod_slice(0, 1)
    routes = {}
    for key, b, sms in (("probe", a, None), ("probe_block", a, 1),
                        ("probe_p1", one, None)):
        mask, total = sk.probe(b, weights, anti_weight, has_aff, sms)
        p_mask, p_total = sk.probe_plain(b, weights, anti_weight, has_aff)
        pairs += [(f"{key}_mask", mask, p_mask),
                  (f"{key}_total", total, p_total)]
        routes[key] = sk.launch_plan(
            sk.PROBE, b.dims(), a.dtype == torch.int64, True, has_aff,
            bool(anti_weight),
            sms=sk.card_sms() if sms is None else sms).cluster
    torch.cuda.synchronize(a.device)
    pairs += [(f"state.{f}", x, y) for f, x, y in zip(
        a.state._fields, k_state, p_state)]
    err = 0
    for name, x, y in pairs:
        out[name] = bool(torch.equal(x, y))
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return {"equal": all(out.values()), "max_abs_err": err,
            "placed": int((got >= 0).sum()), "fields": out,
            "probe_clusters": routes}


def scan_timing(a, weights, anti_weight: int, has_aff: bool,
                has_spread: bool, rate: dict, floor_ms: float) -> dict:
    """K1 on one chunk (ScanArgs `a` on the card), from a.state each
    time: its device time (5 launches in one CUDA graph, each after the
    copies that restore the State, whose own graph time is taken off),
    with the SM clock, power and temperature sampled while it runs
    (SmiSampler);
    the plain version's one call from the same State between CUDA
    events (a graph of its ~150 launches a pod is too large), which
    also counts the fitting elements the bound needs; the two held
    bit-equal; and the bound (bounds.scan_bound). a.state ends as the
    chunk leaves it."""
    from ..sched.device import bounds
    from ..sched.device import scan_kernel as sk
    init = [t.clone() for t in a.state]

    def restore():
        for t, s in zip(a.state, init):
            t.copy_(s)

    def kernel():
        restore()
        sk.scan_chunk(a, weights, anti_weight, has_aff, has_spread)

    restore_ms = device_ms(restore, reps=5, trials=3)
    with SmiSampler() as smi:
        ms = device_ms(kernel, reps=5, trials=3) - restore_ms
    restore()
    got = sk.scan_chunk(a, weights, anti_weight, has_aff, has_spread)
    plain_state = type(a.state)(*(t.clone() for t in init))
    fits = torch.zeros(3, dtype=torch.int64, device=a.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = sk.scan_chunk_plain(a._replace(state=plain_state), weights,
                               anti_weight, has_aff, has_spread, fits)
    end.record()
    end.synchronize()
    equal = bool(torch.equal(got, want)) and all(
        torch.equal(x, y) for x, y in zip(a.state, plain_state))
    d = a.dims()
    valid = int(a.pods.valid.sum())
    scored, spread, anti = (int(x) for x in fits.cpu())
    state_bytes = sum(t.numel() * t.element_size() for t in init)
    nbytes = a.nbytes() + state_bytes + 4 * d["p"]
    ops = bounds.scan_ops(valid * d["n"], scored, a.dtype == torch.int64,
                          d["l"], d["pw"], d["k"],
                          d["t"] if has_aff else 0,
                          spread if has_spread else 0, anti)
    return {"launch_floor_ms": floor_ms, "ms": ms,
            "restore_ms": restore_ms, "plain_ms": start.elapsed_time(end),
            "library_ms": None, "equal_plain": equal, **smi.summary(),
            "valid_pods": valid, "fitting_elements": scored,
            "placed": int((got >= 0).sum()),
            **bounds.scan_bound(nbytes, ops, rate)}


def shard_parity(a, weights, anti_weight: int, has_aff: bool,
                 has_spread: bool, shards: int, twin: bool = True) -> dict:
    """The sharded K1 (scan_kernel.scan_chunk_sharded, `shards` shards on
    a's device) on ScanArgs `a` against the unsharded K1 and, with
    `twin`, the sharded plain twin, each from its own copy of a.state:
    the assignment and every State field must be bit-equal, and every
    shard's copy of the replicated counts equal to the State's after
    the chunk. -> the fields compared, whether all were equal, the
    largest absolute difference, the pods placed, the launch plan. a.state
    is left as it was."""
    from ..sched.device import scan_kernel as sk
    d = a.dims()
    flags = (weights, anti_weight, has_aff, has_spread)
    runs = {}
    for key in ("sharded", "unsharded") + (("twin",) if twin else ()):
        state = type(a.state)(*(t.clone() for t in a.state))
        b = a._replace(state=state)
        space = sk.ShardSpace(shards, d, a.device)
        if key == "sharded":
            out = sk.scan_chunk_sharded(b, *flags, space)
        elif key == "twin":
            out = sk.scan_chunk_sharded_plain(b, *flags, space)
        else:
            out = sk.scan_chunk(b, *flags)
        runs[key] = (out, state, space)
    torch.cuda.synchronize(a.device)
    got, g_state, g_space = runs["sharded"]
    pairs = []
    for key in [k for k in runs if k != "sharded"]:
        out, state, _ = runs[key]
        pairs.append((f"{key}.assigned", got, out))
        pairs += [(f"{key}.state.{f}", x, y) for f, x, y in zip(
            a.state._fields, g_state, state)]
    for k in range(1, shards):
        rep = g_space.replica(k, d)
        pairs += [(f"replica{k}.{f}", rep[f], getattr(g_state, f))
                  for f in sk.REPLICATED]
    fields, err = {}, 0
    for name, x, y in pairs:
        fields[name] = bool(torch.equal(x, y))
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    plan = sk.launch_plan(sk.SCAN, d, a.dtype == torch.int64, has_spread,
                          has_aff, bool(anti_weight), shards=shards)
    return {"equal": all(fields.values()), "max_abs_err": err,
            "placed": int((got >= 0).sum()), "fields": fields,
            "plan": plan._asdict()}


def shard_timing(a, weights, anti_weight: int, has_aff: bool,
                 has_spread: bool, shards: int, rate: dict) -> dict:
    """The sharded K1 at `shards` shards against the unsharded K1 on one
    chunk (ScanArgs `a` on the card), each from a.state every time
    (device_ms of 5 launches in one CUDA graph, each after the copies
    that restore the State, whose own time is taken off), the SM clock
    sampled while each ran; K7's bound (bounds.k7_bound: the records'
    bytes a pod) beside them. a.state ends as the chunk leaves it."""
    from ..sched.device import bounds
    from ..sched.device import scan_kernel as sk
    init = [t.clone() for t in a.state]
    d = a.dims()
    space = sk.ShardSpace(shards, d, a.device)
    flags = (weights, anti_weight, has_aff, has_spread)

    def restore():
        for t, s in zip(a.state, init):
            t.copy_(s)

    def sharded():
        restore()
        sk.scan_chunk_sharded(a, *flags, space)

    def unsharded():
        restore()
        sk.scan_chunk(a, *flags)

    restore_ms = device_ms(restore, reps=5, trials=3)
    with SmiSampler() as smi:
        ms = device_ms(sharded, reps=5, trials=3) - restore_ms
        k1_ms = device_ms(unsharded, reps=5, trials=3) - restore_ms
    restore()
    valid = int(a.pods.valid.sum())
    spread = int((a.pods.valid & (a.pods.group_id >= 0)).sum()) \
        if has_spread else 0
    anti = int((a.pods.valid & (a.pods.svc_group >= 0)).sum()) \
        if anti_weight else 0
    plan = sk.launch_plan(sk.SCAN, d, a.dtype == torch.int64, has_spread,
                          has_aff, bool(anti_weight), shards=shards)
    return {"shards": shards, "ms": ms, "k1_ms": k1_ms,
            "restore_ms": restore_ms, "cluster": plan.cluster,
            "ctas": plan.grid, "slots_per_cta": plan.slots,
            "threads_per_cta": plan.threads, **smi.summary(),
            **bounds.k7_bound(shards, valid, spread, anti, d["z"], rate)}


def victim_shard_parity(args, shards: int) -> dict:
    """The sharded K4 (victim_kernel.victim_search_sharded) on
    VictimArgs `args` (on the card) against the unsharded kernel and the
    sharded plain twin: pick, kstar and score bit-equal. -> whether
    they were, the largest absolute difference, the pick."""
    from ..sched.device import victim_kernel as vk
    got = vk.victim_search_sharded(args, shards).flat()
    one = vk.victim_search(args).flat()
    n = args.shape[0]
    pick, kstar, score = vk.victim_search_sharded_plain(args, shards)
    twin = torch.cat([pick.reshape(1).to(args.cand.device), kstar, score])
    torch.cuda.synchronize(args.cand.device)
    err = max(int((got - one).abs().max()), int((got - twin).abs().max()))
    return {"equal": bool(torch.equal(got, one) and torch.equal(got, twin)),
            "max_abs_err": err, "pick": int(got[0]), "n": n}


def shard_wedge(shards: int = 4, budget: int = 1 << 24) -> dict:
    """The wedged exchange, in a process of its own (a trapped kernel
    leaves the CUDA context unusable): the sharded K1 on small seeded
    tables with shard 1 withholding its first candidate record and a
    spin budget of `budget` cycles. The launch succeeds; the other
    shards' wait traps, and the synchronize after it must raise. -> what
    happened, within the seconds it took."""
    from ..sched.device import engine as eng_mod
    from ..sched.device import scan_kernel as sk
    from .fixtures import scan_tables, shard_pad
    t0 = time.monotonic()
    tables = shard_pad(scan_tables(SHARD_WEDGE_SEED, 16, 512), shards)
    a = scan_args(*(eng_mod._upload(t, torch.device("cuda"))
                    for t in tables))
    space = sk.ShardSpace(shards, a.dims(), a.device)
    try:
        sk.scan_chunk_sharded(a, (1, 1, 1), 0, False, False, space,
                              budget=budget, withhold=1)
        torch.cuda.synchronize()
    except RuntimeError as e:
        return {"raised": True, "error": str(e).splitlines()[0][:200],
                "seconds": time.monotonic() - t0}
    return {"raised": False, "seconds": time.monotonic() - t0}


SHARD_WEDGE_SEED = 29


def shard_wedge_child(timeout_s: float = 120.0) -> dict:
    """shard_wedge in a child process of the current interpreter (its
    own CUDA context), from the checkout this module lies in. -> the
    child's record, its exit code and the seconds it took."""
    import sys
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    code = ("import json; from kubernetes_tpu_torch.kubemark.gpu_evidence "
            "import shard_wedge; print(json.dumps(shard_wedge()))")
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=timeout_s,
                          env={**os.environ, "PYTHONPATH": root})
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    rec = json.loads(lines[-1]) if lines else {
        "raised": False, "stderr": proc.stderr[-2000:]}
    return {**rec, "rc": proc.returncode,
            "child_s": time.monotonic() - t0}


def probe_timing(a, weights, anti_weight: int, has_aff: bool, rate: dict,
                 floor_ms: float) -> dict:
    """K5 on ScanArgs `a` (on the card): kernel_timing of it and its plain
    version, and its bound (bounds.probe_bound)."""
    from ..sched.device import bounds
    from ..sched.device import scan_kernel as sk
    d = a.dims()
    pd = a.pods
    return {**kernel_timing(
        lambda: sk.probe(a, weights, anti_weight, has_aff),
        lambda: sk.probe_plain(a, weights, anti_weight, has_aff), None,
        floor_ms),
        **bounds.probe_bound(
            d["p"], d["n"], a.nbytes(), a.dtype == torch.int64, d["l"],
            d["pw"], d["k"], d["t"] if has_aff else 0,
            int((pd.group_id >= 0).sum()),
            int((pd.svc_group >= 0).sum()) if anti_weight else 0, rate)}


def spec_parity(a, weights, has_spread: bool, blocks=(256, 7)) -> dict:
    """K6 on ScanArgs `a` (on the card) against its plain versions and
    K1, each from its own copy of a.state: K6a on the first block against
    spec_top_plain of spec_pass_plain (the top lists); K6b alone, on the
    plain top lists, against JAX's repair from the whole rows
    (spec_block_plain: picks, slow marks and State); the whole chunk at
    each block size of `blocks` against spec_run_plain (the same); and
    the chunk against K1 (assignment and State). -> the fields compared,
    whether all were equal, the largest absolute difference, the pods
    placed and those that took the full-width rescore. a.state is left
    as it was."""
    from ..sched.device import scan_kernel as sk
    from ..sched.device import spec_kernel as spk
    p = a.dims()["p"]
    b = min(spk.SPEC_BLOCK, p)
    init = [t.clone() for t in a.state]

    def fresh():
        return a._replace(state=type(a.state)(*(t.clone() for t in init)))

    pairs = []
    top = spk.spec_pass(a, weights, has_spread, 0, b)
    rows = spk.spec_pass_plain(a.pod_slice(0, b), weights, has_spread)
    want_top = spk.Top(*spk.spec_top_plain(rows, b))
    pairs += [("pass", top.comp, want_top.comp),
              ("pass_slots", top.slot, want_top.slot)]
    kb, pb = fresh(), fresh()
    out = torch.full((p,), -7, dtype=torch.int32, device=a.device)
    slow_k = torch.zeros(p, dtype=torch.uint8, device=a.device)
    spk.spec_repair(kb, want_top, 0, b, weights, has_spread, out, slow_k)
    slow_p = torch.zeros(b, dtype=torch.bool, device=a.device)
    want = spk.spec_block_plain(pb.pod_slice(0, b), rows, weights,
                                has_spread, slow=slow_p)
    pairs += [("repair", out[:b], want),
              ("repair_slow", slow_k[:b].bool(), slow_p)]
    pairs += [(f"repair.state.{f}", x, y)
              for f, x, y in zip(a.state._fields, kb.state, pb.state)]
    got = None
    for blk in blocks:
        ka, pa = fresh(), fresh()
        slow_k = torch.zeros(p, dtype=torch.uint8, device=a.device)
        slow_p = torch.zeros(p, dtype=torch.bool, device=a.device)
        got = spk.spec_chunk(ka, weights, has_spread, blk, slow_k)
        want = spk.spec_run_plain(pa, weights, has_spread, blk, slow_p)
        pairs += [(f"chunk{blk}", got, want),
                  (f"chunk{blk}_slow", slow_k.bool(), slow_p)]
        pairs += [(f"chunk{blk}.state.{f}", x, y)
                  for f, x, y in zip(a.state._fields, ka.state, pa.state)]
        slow = int(slow_k.sum())
    k1 = fresh()
    pairs.append(("k1", got, sk.scan_chunk(k1, weights, 0, False,
                                           has_spread)))
    pairs += [(f"k1.state.{f}", x, y)
              for f, x, y in zip(a.state._fields, ka.state, k1.state)]
    torch.cuda.synchronize(a.device)
    fields, err = {}, 0
    for name, x, y in pairs:
        fields[name] = bool(torch.equal(x, y))
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return {"equal": all(fields.values()), "max_abs_err": err,
            "placed": int((got >= 0).sum()), "slow": slow,
            "fields": fields}


def spec_timing(a, weights, has_spread: bool, rate: dict,
                floor_ms: float) -> dict:
    """K6 on one chunk (ScanArgs `a` on the card), from a.state each
    time: the chunk's device time (a graph of its launches after the
    copies that restore the State, whose own time is taken off), with
    the SM clock, power and temperature sampled while it runs; K6a on the
    first block and its plain version (device_ms); K6b on the first
    block (restored the same way) and its plain version once between
    CUDA events; each part's bound and the chunk's (bounds.spec_bound,
    from spec_work's counts of this run). a.state ends as the chunk
    leaves it; `assigned` is the chunk's assignment."""
    from ..sched.device import bounds
    from ..sched.device import spec_kernel as spk
    d = a.dims()
    p, n = d["p"], d["n"]
    b = min(spk.SPEC_BLOCK, p)
    wide = a.dtype == torch.int64
    init = [t.clone() for t in a.state]

    def restore():
        for t, s in zip(a.state, init):
            t.copy_(s)

    def chunk():
        restore()
        spk.spec_chunk(a, weights, has_spread)

    restore_ms = device_ms(restore, reps=5, trials=3)
    with SmiSampler() as smi:
        ms = device_ms(chunk, reps=5, trials=3) - restore_ms
    # the parts alone, on the first block against the initial State
    restore()
    top = spk.spec_pass(a, weights, has_spread, 0, b)
    pass_ms = device_ms(lambda: spk.spec_pass(a, weights, has_spread, 0, b,
                                              top))
    first = a.pod_slice(0, b)
    pass_plain_ms = device_ms(lambda: spk.spec_top_plain(
        spk.spec_pass_plain(first, weights, has_spread), b))
    out = torch.empty(p, dtype=torch.int32, device=a.device)

    def repair():
        restore()
        spk.spec_repair(a, top, 0, b, weights, has_spread, out)

    repair_ms = device_ms(repair, reps=5, trials=3) - restore_ms
    restore()
    plain_state = type(a.state)(*(t.clone() for t in init))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    spk.spec_block_plain(first._replace(state=plain_state),
                         (top.comp, top.slot), weights, has_spread)
    end.record()
    end.synchronize()
    repair_plain_ms = start.elapsed_time(end)
    # one run for its outputs: the assignment and the slow marks
    restore()
    slow = torch.zeros(p, dtype=torch.uint8, device=a.device)
    assigned = spk.spec_chunk(a, weights, has_spread, spk.SPEC_BLOCK, slow)
    pd = a.pods
    valid = pd.valid.cpu().numpy()
    group = pd.group_id.cpu().numpy() if has_spread \
        else np.full(p, -1, np.int32)
    got = assigned.cpu().numpy()
    slow_np = slow.cpu().numpy().astype(bool)
    work = spk.spec_work(got, valid, group, slow_np)
    work_b = spk.spec_work(got[:b], valid[:b], group[:b], slow_np[:b])
    pod_bytes = sum(t.numel() * t.element_size() for t in pd)
    table_bytes = a.nbytes() - pod_bytes
    blocks = -(-p // b)
    spread_pods = int((pd.group_id >= 0).sum()) if has_spread else 0
    spread_b = int((pd.group_id[:b] >= 0).sum()) if has_spread else 0
    words = (d["l"], d["pw"], d["k"])
    pass_t = bounds.spec_pass_terms(p, n, blocks, b, table_bytes,
                                    pod_bytes, wide, *words, spread_pods)
    rep_t = bounds.spec_repair_terms(p, n, pod_bytes, wide, *words, *work)
    pod_b = pod_bytes * b // max(p, 1)
    pass_b = bounds.spec_pass_terms(b, n, 1, b, table_bytes, pod_b, wide,
                                    *words, spread_b)
    rep_b = bounds.spec_repair_terms(b, n, pod_b, wide, *words, *work_b)
    return {"launch_floor_ms": floor_ms, "ms": ms, "restore_ms": restore_ms,
            "blocks": blocks, "block": b, "launches": 2 * blocks,
            "entries": work[0], "rescored": work[1],
            "rescored_spread": work[2], "slow_pods": work[3],
            "placed": int((got >= 0).sum()),
            "assigned": assigned, **smi.summary(),
            **bounds.spec_bound([pass_t, rep_t], rate),
            "pass": {"ms": pass_ms, "plain_ms": pass_plain_ms,
                     "shape": [b, n],
                     **bounds.spec_bound([pass_b], rate)},
            "repair": {"ms": repair_ms, "plain_ms": repair_plain_ms,
                       "shape": [b, n], "entries": work_b[0],
                       "rescored": work_b[1], "slow_pods": work_b[3],
                       **bounds.spec_bound([rep_b], rate)}}


def profile_counts(fn) -> dict:
    """torch.profiler over one call of `fn` (then a synchronise): the
    kernels and host->device copies the card ran (device events), and
    the launches and copies the host queued (runtime calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"kernels": 0, "h2d_copies": 0, "other_copies": 0,
           "launch_calls": 0, "copy_calls": 0, "kernel_names": {}}
    for e in prof.events():
        name = e.name
        if e.device_type == DeviceType.CUDA:
            if name.startswith("Memcpy HtoD"):
                out["h2d_copies"] += 1
            elif name.startswith(("Memcpy", "Memset")):
                out["other_copies"] += 1
            else:
                out["kernels"] += 1
                short = name.split("(")[0][-60:]
                out["kernel_names"][short] = \
                    out["kernel_names"].get(short, 0) + 1
        elif name.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            out["launch_calls"] += 1
        elif name.startswith(("cudaMemcpy", "cuMemcpy")):
            out["copy_calls"] += 1
    return out


TURNS = ("other", "this", "this", "other")


def turns(fns: dict, library=None, device=None) -> dict:
    """Device time of two versions of one kernel, in turns on one card:
    `fns` maps "this" and "other" to a callable that launches each. Per
    turn of TURNS: the launch floor, the side's device_ms and, where
    given, that of the PyTorch call computing the same function."""
    d = _cuda(device)
    rec = {"order": list(TURNS), "ms": [], "launch_floor_ms": []}
    if library is not None:
        rec["library_ms"] = []
    for who in TURNS:
        rec["launch_floor_ms"].append(launch_floor_ms(d))
        rec["ms"].append(device_ms(fns[who]))
        if library is not None:
            rec["library_ms"].append(device_ms(library))
    return rec


def load_wrappers(root: str) -> dict:
    """Another checkout's `sched/device/{_build,bounds,filter_kernel,
    reject_kernel,scan_kernel,victim_kernel,scatter_kernel}.py` (those it
    has), loaded
    as a package of their own beside this checkout's (its kernels build
    from its own sources into its own `_build/`). Their parent package
    holds this checkout's `preemption` (the victim kernel's constants)."""
    import importlib.util
    import sys

    from ..sched import preemption
    pkg_dir = os.path.join(os.path.abspath(root), "kubernetes_tpu_torch",
                           "sched", "device")
    parent, name = "_other_sched", "_other_sched.device"
    for mod, path in ((parent, []), (name, [pkg_dir])):
        sys.modules[mod] = types.ModuleType(mod)
        sys.modules[mod].__path__ = path
    sys.modules[f"{parent}.preemption"] = preemption
    mods = {}
    for mod_name in ("_build", "bounds", "filter_kernel", "reject_kernel",
                     "scan_kernel", "spec_kernel", "victim_kernel",
                     "scatter_kernel"):
        path = os.path.join(pkg_dir, f"{mod_name}.py")
        if not os.path.exists(path):
            continue
        spec = importlib.util.spec_from_file_location(
            f"{name}.{mod_name}", path)
        mods[mod_name] = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mods[mod_name]
        spec.loader.exec_module(mods[mod_name])
    return mods


def section_turns(other_root: str, device=None) -> dict:
    """This checkout's hand kernels against another checkout's, in
    turns (`--turns-against DIR`), on the inputs chip_smoke times: the
    filter on the mixed snapshot (seed 7, 20000 existing pods) at 8192 x
    5000 and its pod 1 alone (the extender's launch), the argsort on the
    seeded [8, 128]. Each output is first held equal to the other's and
    to the plain version. Where the other checkout has the scan kernels,
    also K5 at both shapes, K1 on the snapshot's first 256 pods and K1
    at the e2e's chunk (8192 bench pods on the e2e fleet's 5120 slots),
    each call restoring the State first. Where it has the victim kernel,
    also K4 on the preempt fixture's widest table (5120 x 16). Each
    kernel's turns carry the SM clock, power and temperature sampled
    while they ran. The other checkout's wrappers must take the same
    arguments (`filter_masks(FilterArgs)`, `argsort_rows(x)`,
    `probe(ScanArgs, ...)`, `scan_chunk(ScanArgs, ...)`,
    `victim_search(VictimArgs.from_table(t, device))`)."""
    from ..sched.device import (BatchEngine, encode_snapshot, filter_kernel,
                                reject_kernel, scan_kernel)
    from .benchmark import _bench_pod
    from .fixtures import SMOKE_CHUNK, fleet_encoder, mixed_snapshot
    d = _cuda(device)
    other = load_wrappers(other_root)
    ofk, ork = other["filter_kernel"], other["reject_kernel"]
    enc = encode_snapshot(mixed_snapshot(7, 5000, 8192, 20000))
    eng = BatchEngine(device=d)
    tables = eng.device_args(enc)
    args = filter_kernel.FilterArgs.from_engine(*tables)
    x = reject_inputs(d)["ties"]
    cases = {f"argsort_rows {x.shape[0]}x{x.shape[1]}": (
        reject_kernel.argsort_rows, ork.argsort_rows,
        reject_kernel.argsort_rows_plain, x,
        lambda: torch.argsort(x, dim=-1, stable=True))}
    for shape, a in (("8192x5000", args), ("1x5000", args.pod_slice(1, 2))):
        cases[f"filter_masks {shape}"] = (
            filter_kernel.filter_masks,
            lambda a, _f=ofk: _f.filter_masks(_f.FilterArgs(*a)),
            filter_kernel.filter_masks_plain, a, None)
    if "scan_kernel" in other:
        osk, w = other["scan_kernel"], eng.weights
        sa = scan_args(*tables)
        init = [t.clone() for t in sa.state]

        def chunk(mod, a):
            for t, s in zip(a.state, init):
                t.copy_(s)
            return mod.scan_chunk(mod.ScanArgs(*a), w, 0, False, False)

        for shape, a in (("8192x5000", sa), ("1x5000", sa.pod_slice(1, 2))):
            cases[f"probe {shape}"] = (
                lambda a: scan_kernel.probe(a, w, 0, False),
                lambda a: osk.probe(osk.ScanArgs(*a), w, 0, False),
                lambda a: scan_kernel.probe_plain(a, w, 0, False), a, None)
        plain = types.SimpleNamespace(scan_chunk=scan_kernel.scan_chunk_plain,
                                      ScanArgs=scan_kernel.ScanArgs)
        cases["scan_chunk 256x5000"] = (
            lambda a: chunk(scan_kernel, a), lambda a: chunk(osk, a),
            lambda a: chunk(plain, a), sa.pod_slice(0, 256), None)
        # K1 at the e2e's chunk: 8192 bench pods on the fleet's slots
        fleet = scan_args(*eng.device_args(fleet_encoder().encode_tile(
            [_bench_pod(i) for i in range(SMOKE_CHUNK)], [], [])))
        fleet_init = [t.clone() for t in fleet.state]

        def e2e_chunk(mod, a):
            for t, s in zip(a.state, fleet_init):
                t.copy_(s)
            return mod.scan_chunk(mod.ScanArgs(*a), w, 0, False, False)

        p, n = fleet.dims()["p"], fleet.dims()["n"]
        cases[f"scan_chunk {p}x{n}"] = (
            lambda a: e2e_chunk(scan_kernel, a),
            lambda a: e2e_chunk(osk, a), lambda a: e2e_chunk(plain, a),
            fleet, None)
    if "victim_kernel" in other:
        # K4 on the preempt fixture's widest table
        from ..sched.device import victim_kernel as vk
        from .fixtures import preempt_tables, widest_table
        ovk = other["victim_kernel"]
        wide = widest_table(preempt_tables())
        ta = vk.VictimArgs.from_table(wide, d)
        oa = ovk.VictimArgs.from_table(wide, d)
        cases[f"victim_search {wide.n}x{wide.v}"] = (
            lambda t: vk.victim_search(ta), lambda t: ovk.victim_search(oa),
            lambda t: vk.victim_search_plain(ta), wide, None)
    if "scatter_kernel" in other:
        # K3: a delta tile's device prologue on the e2e fleet's tables,
        # both tables dirty, the run's State from the mirror's
        for r_node, r_state in PROLOGUE_ROWS:
            cases[f"prologue {r_node}+{r_state}"] = prologue_turn_case(
                other["scatter_kernel"], d, r_node, r_state)
    out = {"card": card_line(), "kernels": {}}
    for name, (this_fn, other_fn, plain_fn, a, library) in cases.items():
        got = this_fn(a)
        if not (_same(got, other_fn(a)) and _same(got, plain_fn(a))):
            raise AssertionError(f"{name}: this checkout's kernel differs "
                                 f"from the other's or the plain version")
        with SmiSampler() as smi:
            out["kernels"][name] = turns(
                {"this": lambda: this_fn(a), "other": lambda: other_fn(a)},
                library, d)
        out["kernels"][name].update(smi.summary())
    return out


# the delta tiles K3's turns time: a 500-node heartbeat shard with 1274
# State rows (the e2e's tiles), and every row of both tables
PROLOGUE_ROWS = ((500, 1274), (5000, 5000))
PROLOGUE_SEED = 13


def prologue_tables(device, r_node: int, r_state: int,
                    seed: int = PROLOGUE_SEED):
    """The e2e fleet's node and State tables on `device` (the mirror)
    and a delta tile's host rows for them: r_node and r_state random rows
    of each, spread over the whole table -> (node, state, (node_idx,
    node_rows), (state_idx, state_rows))."""
    from ..sched.device import BatchEngine
    from ..sched.device import engine as eng
    from .benchmark import _bench_pod
    from .fixtures import fleet_encoder
    node_h, state_h, _ = BatchEngine(device=device).host_args(
        fleet_encoder().encode_tile([_bench_pod(0)], [], []))
    rng = np.random.default_rng(seed)
    n = int(node_h.valid.shape[0])

    def rows(tab, fields, r):
        idx = np.sort(rng.permutation(n)[:r]).astype(np.int64)
        out = []
        for f in fields:
            a = getattr(tab, f)
            shape = (r,) + a.shape[1:]
            if a.dtype == np.bool_:
                out.append(rng.random(shape) < 0.5)
            else:
                out.append(rng.integers(0, 2 ** 31, shape).astype(a.dtype))
        return idx, out

    return (eng._upload(node_h, device), eng._upload(state_h, device),
            rows(node_h, eng._NODE_ROW_FIELDS, r_node),
            rows(state_h, eng._STATE_ROW_FIELDS, r_state))


def prologue_staged(mod, device, node, state, node_rows, state_rows):
    """A delta tile's prologue as BatchEngine._fetch_tables builds it,
    with scatter_kernel module `mod`: both tables' rows into the mirror
    (the State rows also into the run's State) and the 13 copies ->
    (staged, the run's State)."""
    from ..sched.device import engine as eng
    pro = mod.Prologue()
    run = eng._alloc_like(state)
    pro.scatter([getattr(node, f) for f in eng._NODE_ROW_FIELDS],
                *node_rows)
    g = pro.scatter([getattr(state, f) for f in eng._STATE_ROW_FIELDS],
                    *state_rows,
                    also=[getattr(run, f) for f in eng._STATE_ROW_FIELDS])
    for f in eng.State._fields:
        pro.copy(getattr(run, f), getattr(state, f),
                 skip=g if f in eng._STATE_ROW_FIELDS else None)
    return pro.stage(device), run


def prologue_turn_case(osc, device, r_node: int, r_state: int):
    """K3's case for section_turns: this checkout's one launch against
    another checkout's prologue on its own copy of the same tables (two
    scatter launches and 13 `copy_`s into the run's State where its
    scatter_kernel has no Prologue), and the plain version on a third.
    Each callable returns every table it wrote."""
    from ..sched.device import scatter_kernel as sck
    from ..sched.device import engine as eng
    sides = {}
    for who in ("this", "other", "plain"):
        node, state, nr, sr = prologue_tables(device, r_node, r_state)
        if who == "other" and not hasattr(osc, "Prologue"):
            run = type(state)(*(torch.empty_like(t) for t in state))
            staged = [osc.to_device(osc.stage(
                [getattr(tab, f) for f in fields], idx, rows, pin=True),
                device) for tab, fields, (idx, rows) in (
                    (node, eng._NODE_ROW_FIELDS, nr),
                    (state, eng._STATE_ROW_FIELDS, sr))]

            def fn(_, st=staged, node=node, state=state, run=run):
                for x in st:
                    osc.launch_staged(x)
                for d_, s_ in zip(run, state):
                    d_.copy_(s_)
                return tuple(node) + tuple(state) + tuple(run)
        else:
            mod = osc if who == "other" else sck
            staged, run = prologue_staged(mod, device, node, state, nr, sr)
            launch = sck.prologue_plain if who == "plain" \
                else mod.launch_staged

            def fn(_, st=staged, node=node, state=state, run=run,
                   launch=launch):
                launch(st)
                return tuple(node) + tuple(state) + tuple(run)
        sides[who] = fn
    return sides["this"], sides["other"], sides["plain"], None, None


def _same(x, y) -> bool:
    """Bit-equal tensors, or tuples of them."""
    if isinstance(x, tuple):
        return all(torch.equal(a, b) for a, b in zip(x, y))
    return torch.equal(x, y)


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
        return reject_kernel._launch(
            ones, scratch, reject_kernel.launch_plan(*ones.shape, refused))

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


def section_mesh(device=None, shards=(1, 2, 4, 8)) -> dict:
    """The sharded K1 (K7 inside) on one card at each shard count of
    `shards`, on K1's e2e chunk (8192 bench pods against the e2e fleet's
    5120 slots): held bit-equal to K1, then its device ms a chunk
    against K1's (shard_timing: the same graph-timed launches, the SM
    clock sampled) beside K7's bound. K7's cycles a pod come from
    kubemark/profile_kernels.py (`k7_phases`)."""
    from ..sched.device import BatchEngine, bounds
    from .benchmark import _bench_pod
    from .fixtures import SMOKE_CHUNK, fleet_encoder
    d = _cuda(device)
    engine = BatchEngine(device=d)
    enc = fleet_encoder().encode_tile(
        [_bench_pod(i) for i in range(SMOKE_CHUNK)], [], [])
    a = scan_args(*engine.device_args(enc))
    flags = engine._enc_flags(enc)
    rate = bounds.card_rate()
    out = {"shape": [a.dims()["p"], a.dims()["n"]], "by_shards": {}}
    for s in shards:
        got = shard_parity(a, engine.weights, 0, *flags, s, twin=False)
        if not got["equal"]:
            raise AssertionError(f"mesh: the sharded K1 at {s} shards "
                                 f"differs from K1")
        out["by_shards"][s] = shard_timing(a, engine.weights, 0, *flags, s,
                                           rate)
    return out


def section_engine_spec(device=None,
                        shapes=((1000, 3000), (5000, 30000))) -> dict:
    """The speculative engine against the scan (JAX tpu_evidence's
    engine_spec): engine-only throughput on the smoke's engine fixture,
    plain (the node-local tier, the e2e's) and spread (one service),
    `run_chunked(enc, 8192)` once to warm up and once timed, encode
    excluded, with both engines' device ms (scan_stats' CUDA events) and
    the winner. The two assignments must be equal."""
    from ..sched.device import BatchEngine, encode_snapshot
    from .fixtures import (SMOKE_CHUNK, assigned_digest, engine_snapshot,
                           smoke_pod_pad)
    d = _cuda(device)
    out = {}
    for n_nodes, n_pods in shapes:
        for tier, plain in (("plain", True), ("spread", False)):
            enc = encode_snapshot(engine_snapshot(n_nodes, n_pods,
                                                  plain=plain),
                                  pod_pad_to=smoke_pod_pad(n_pods))
            rec = {}
            for name, spec in (("scan", False), ("spec", True)):
                eng = BatchEngine(device=d, speculative=spec)
                eng.run_chunked(enc, SMOKE_CHUNK)
                before = eng.scan_stats["device_ms"]
                torch.cuda.synchronize(d)
                t0 = time.monotonic()
                assigned, _ = eng.run_chunked(enc, SMOKE_CHUNK)
                run_s = time.monotonic() - t0
                sha, bound = assigned_digest(assigned, enc.n_pods)
                rec[name] = {"pods_per_sec": bound / run_s, "run_s": run_s,
                             "device_ms": eng.scan_stats["device_ms"]
                             - before, "bound": bound, "sha256": sha,
                             "spec_chunks": eng.scan_stats["spec_chunks"]}
            if rec["spec"]["sha256"] != rec["scan"]["sha256"]:
                raise AssertionError(f"{n_nodes}x{n_pods}-{tier}: the "
                                     f"speculative engine binds otherwise "
                                     f"than the scan")
            rec["winner"] = ("spec" if rec["spec"]["pods_per_sec"]
                             >= rec["scan"]["pods_per_sec"] else "scan")
            out[f"{n_nodes}x{n_pods}-{tier}"] = rec
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
                device=None, timeout_s: float = 900.0, mesh=None) -> dict:
    """One run of the live pipeline under the kubemark benchmark (not
    best-of-two: card time is the budget). device=None is the card; the
    tests pass device="cpu" at a small size. Reports the tiles (chained
    or not), the engine's upload and scan accounting, the seconds each
    host layer of E2E_LAYERS spent, summed over the run, and the
    per-node counts digest. `k1_device_ms` is the scan kernel's time on
    the card in the run (scan_stats' CUDA events around the launches).
    `mesh`: a NodeMesh for the batch loop's engine (the shard phase)."""
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
                                 timeout_s=timeout_s, mesh=mesh)
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
            "k1_device_ms": (r.scan_stats or {}).get("device_ms"),
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
    ap.add_argument("--turns-against", metavar="DIR", default="",
                    help="only time this checkout's kernels against those "
                         "of the checkout at DIR (section_turns) and print "
                         "the JSON")
    args = ap.parse_args()
    if args.turns_against:
        print(json.dumps(section_turns(args.turns_against)))
        return 0

    ev = _Evidence(args.out, best_path=args.best_out)
    ev.run_section("platform", section_platform)
    ev.run_section("dispatch", section_dispatch)
    ev.run_section("kernels", section_kernels)
    ev.run_section("engine", section_engine)
    ev.run_section("engine_spec", section_engine_spec)
    ev.run_section("mesh", section_mesh)
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
