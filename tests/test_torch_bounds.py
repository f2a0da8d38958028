"""The port's kernel bounds (kubernetes_tpu_torch.sched.device.bounds),
the launch plans the kernel wrappers hand their CUDA entry points, and
the traffic of the port's kubemark benchmark against the JAX one's.
Everything here is arithmetic on shapes or Python around the kernels:
the kernels themselves run on the card (tests/test_torch_gpu.py)."""

import inspect
import math
import re

import pytest
import torch

import kubernetes_tpu.kubemark.benchmark as jax_benchmark
import kubernetes_tpu_torch.kubemark.benchmark as port_benchmark
from kubernetes_tpu_torch.kubemark import gpu_evidence
from kubernetes_tpu_torch.kubemark.fixtures import mixed_snapshot
from kubernetes_tpu_torch.sched.device import (BatchEngine, bounds,
                                               encode_snapshot, filter_kernel,
                                               reject_kernel)

H100_SMS, H100_CLOCK_HZ = 132, 1.98e9


def _defines(source: str) -> dict:
    with open(source) as f:
        return {m[1]: int(m[2]) for m in
                re.finditer(r"^#define (\w+) (\d+)$", f.read(), re.M)}


def test_int_rate_is_64_lanes_per_sm_per_clock():
    assert bounds.int_ops_per_s(H100_SMS, H100_CLOCK_HZ) == \
        H100_SMS * 64 * H100_CLOCK_HZ
    assert bounds.int_ops_per_s(H100_SMS, H100_CLOCK_HZ) == \
        pytest.approx(16.727e12, rel=1e-4)
    # a quarter of the float32 figure (FMA = 2 ops on 128 lanes) that
    # the bound used before
    assert bounds.int_ops_per_s(H100_SMS, H100_CLOCK_HZ) == \
        pytest.approx(67e12 / 4, rel=0.01)


def test_filter_bound_at_the_batch_shape_with_the_mixed_widths():
    # the mixed fixture's bitsets are one word each (widths do not grow
    # with the pod count: its labels, ports and disks are few)
    enc = encode_snapshot(mixed_snapshot(7, 5000, 16, 20000))
    small = filter_kernel.FilterArgs.from_engine(
        *BatchEngine(device="cpu").device_args(enc))
    widths = (small.labels.shape[1], small.port_bits.shape[1],
              small.disk_any.shape[1])
    assert widths == (1, 1, 1)
    p, n = 8192, 5000
    args = small._replace(**{
        f: torch.zeros((p,) + getattr(small, f).shape[1:],
                       dtype=getattr(small, f).dtype)
        for f in filter_kernel._POD_FIELDS})
    assert args.shape == (p, n)
    # 44 bytes a node, 30 a pod, one bool an element
    assert args.nbytes() == 44 * n + 30 * p + p * n == 41_425_760
    ops = bounds.filter_ops(p, n, *widths)
    # 4 compares, a LOP3 a bitset word, 2 PLOP3s, 1 placement
    assert ops == 11 * p * n == 450_560_000
    assert bounds.filter_ops(p, n, 2, 3, 4) == (7 + 2 + 3 + 8) * p * n
    rate = {"int_ops_per_s": bounds.int_ops_per_s(H100_SMS, H100_CLOCK_HZ),
            "sms": H100_SMS, "sm_clock_mhz": 1980.0}
    b = gpu_evidence.filter_bound(args, rate)
    assert b["bound_by"] == "operations"
    assert b["ops_bound_ms"] == pytest.approx(0.02694, abs=1e-5)
    assert b["bytes_bound_ms"] == pytest.approx(0.01237, abs=1e-5)
    assert b["bound_ms"] == b["ops_bound_ms"]
    assert (b["sms"], b["sm_clock_mhz"]) == (H100_SMS, 1980.0)


@pytest.mark.parametrize("cols", [1, 2, 3, 128, 1000, 6144])
def test_argsort_ops_is_log2_factorial_per_row(cols):
    want = math.ceil(sum(math.log2(k) for k in range(2, cols + 1)))
    assert bounds.argsort_ops(8, cols) == 8 * want
    if cols == 128:
        assert bounds.argsort_ops(8, 128) == 8 * 717


def test_argsort_bound_is_bytes_at_the_evidence_shape():
    x = gpu_evidence.reject_inputs("cpu")["ties"]
    rate = {"int_ops_per_s": bounds.int_ops_per_s(H100_SMS, H100_CLOCK_HZ)}
    b = gpu_evidence.argsort_bound(x, rate)
    assert b["bytes"] == 8 * 128 * 8
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(8192 / 3.35e12 * 1e3)


def test_filter_blocking_matches_the_source():
    d = _defines(filter_kernel.SOURCE)
    assert d["FILTER_BLOCK_THREADS"] == filter_kernel.BLOCK_THREADS
    assert d["FILTER_NODES_PER_THREAD"] == filter_kernel.NODES_PER_THREAD
    assert d["FILTER_POD_TILE"] == filter_kernel.POD_TILE
    with open(filter_kernel.SOURCE) as f:
        cases = set(map(int, re.findall(r"case (\d+): filter_kernel<",
                                        f.read())))
    assert cases == set(filter_kernel.WORD_CAPS) | {0}


@pytest.mark.parametrize("p", [1, 7, 8192])
@pytest.mark.parametrize("n", [4096, 5012, 5000, 5001])   # N % 16: 0 4 8 1
def test_filter_grid_covers_ragged_shapes(p, n):
    plan = filter_kernel.launch_plan(p, n, 1, 1, 1)
    per_block = filter_kernel.BLOCK_THREADS * filter_kernel.NODES_PER_THREAD
    assert (plan.grid_x - 1) * per_block < n <= plan.grid_x * per_block
    tile = filter_kernel.POD_TILE
    assert (plan.grid_y - 1) * tile < p <= plan.grid_y * tile
    assert plan.grid_y <= filter_kernel._MAX_GRID_Y
    if (p, n) == (8192, 5000):
        # 10 node groups x 128 pod tiles: one wave on 132 SMs
        assert (plan.grid_x, plan.grid_y) == (10, 128)


@pytest.mark.parametrize("widths,words", [
    ((1, 1, 1), 1), ((2, 1, 1), 2), ((1, 2, 2), 2), ((2, 2, 2), 2),
    ((3, 1, 1), 0), ((1, 1, 5), 0), ((1, 40, 1), 0)])
def test_filter_instantiation_follows_the_widest_set(widths, words):
    assert filter_kernel.launch_plan(8192, 5000, *widths).words == words


@pytest.mark.parametrize("rows,cols,plan", [
    (8, 128, (4, 8, 32)), (1, 1, (1, 1, 32)), (3, 37, (2, 3, 32)),
    (1, 32, (1, 1, 32)), (1, 33, (2, 1, 32)), (9, 1024, (32, 9, 32)),
    (1000, 1000, (32, 1000, 32)), (2, 1025, (0, 2, 1024)),
    (2, 6144, (0, 2, 1024))])
def test_argsort_plan(rows, cols, plan):
    assert tuple(reject_kernel.launch_plan(rows, cols)) == plan


def test_argsort_plan_launches_a_refused_block_as_given():
    # the evidence tool's refusal: 2048 threads, one block for 8 rows
    assert tuple(reject_kernel.launch_plan(8, 128, 2048)) == (4, 1, 2048)
    assert tuple(reject_kernel.launch_plan(8, 128, 256)) == (4, 1, 256)
    with pytest.raises(ValueError, match="multiple of 32"):
        reject_kernel.launch_plan(8, 128, 100)
    with open(reject_kernel.SOURCE) as f:
        cases = set(map(int, re.findall(r"case (\d+):", f.read())))
    assert cases == {0, 1, 2, 4, 8, 16, 32}


def test_turns_load_another_checkouts_wrappers():
    # this checkout loaded as the other one: its modules sit beside this
    # checkout's, and their plain paths agree on the CPU
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = gpu_evidence.load_wrappers(root)
    ofk, ork = other["filter_kernel"], other["reject_kernel"]
    assert ofk is not filter_kernel and ork is not reject_kernel
    assert ofk.SOURCE == filter_kernel.SOURCE
    x = gpu_evidence.reject_inputs("cpu")["ties"]
    assert torch.equal(ork.argsort_rows(x), reject_kernel.argsort_rows(x))
    enc = encode_snapshot(mixed_snapshot(7, 50, 9, 30))
    args = filter_kernel.FilterArgs.from_engine(
        *BatchEngine(device="cpu").device_args(enc))
    assert torch.equal(ofk.filter_masks(ofk.FilterArgs(*args)),
                       filter_kernel.filter_masks(args))


def test_benchmark_heartbeat_is_the_jax_benchmarks(monkeypatch):
    jax_src = inspect.getsource(jax_benchmark.run_scheduling_benchmark)
    jax_interval = float(re.search(r"heartbeat_interval=([0-9.]+)",
                                   jax_src)[1])
    assert jax_interval == 600.0

    class Captured(Exception):
        pass

    seen = {}

    def fleet(*args, **kwargs):
        seen.update(kwargs)
        raise Captured

    monkeypatch.setattr(port_benchmark, "HollowFleet", fleet)
    with pytest.raises(Captured):
        port_benchmark.run_scheduling_benchmark(10, 10, device="cpu")
    assert seen["heartbeat_interval"] == jax_interval


RATE = {"int_ops_per_s": bounds.int_ops_per_s(H100_SMS, H100_CLOCK_HZ),
        "sms": H100_SMS, "sm_clock_mhz": 1980.0}


@pytest.mark.parametrize("rows", [1, 137, 5000])
def test_scatter_bound_is_bytes(rows):
    # the State table's columns: 4 int64, 1 int32, 3 one-word bitsets
    row_bytes = [8, 8, 8, 8, 4, 4, 4, 4]
    b = bounds.scatter_bound(rows, row_bytes, RATE)
    assert b["bytes"] == 8 * rows + 2 * rows * 48
    assert b["ops"] == 0 and b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(rows * 104 / 3.35e12 * 1e3)
    assert (b["sms"], b["sm_clock_mhz"]) == (H100_SMS, 1980.0)


def test_scatter_bound_of_the_engines_mirror_columns():
    """The bytes a row the engine's scatter moves are those of the
    mirror's per-slot columns in the narrowed encoding."""
    from kubernetes_tpu_torch.sched.device import engine as eng
    from kubernetes_tpu_torch.sched.device import scatter_kernel as sk
    from kubernetes_tpu_torch.sched.device.incremental import \
        IncrementalEncoder
    from test_incremental import mk_node, mk_pod
    from test_torch_encode import cross
    inc = IncrementalEncoder()
    for i in range(8):
        inc.on_node_add(cross([mk_node(f"n-{i}")])[0])
    node, state, _ = BatchEngine(device="cpu").device_args(
        inc.encode_tile(cross([mk_pod("p", phase="Pending")]), [], []))
    per = {name: [sk._row_bytes(getattr(tab, f)) for f in fields]
           for name, tab, fields in (("node", node, eng._NODE_ROW_FIELDS),
                                     ("state", state,
                                      eng._STATE_ROW_FIELDS))}
    # i32-narrowed resources: 1-byte flags, 4-byte ints and words
    assert per["node"] == [1, 1, 4, 4, 4, 4, 4, 1, 1, 4, 1, 4]
    assert per["state"] == [4] * 8
    b = bounds.scatter_bound(5000, per["state"], RATE)
    assert b["bytes"] == 5000 * (8 + 2 * 32) == 360_000


def test_victim_bound_counts_the_walk():
    # 5120 slots, 60,000 victim entries read in 65,000 steps
    b = bounds.victim_bound(5120, 60_000, 65_000, RATE)
    assert b["bytes"] == 5120 * 73 + 60_000 * 25 + 8
    assert b["ops"] == 65_000 * 32 + 5120 * 16
    assert b["bound_by"] == "bytes"
    assert b["bytes_bound_ms"] == pytest.approx(b["bytes"] / 3.35e9)
    assert b["ops_bound_ms"] == pytest.approx(b["ops"] / RATE[
        "int_ops_per_s"] * 1e3)
    # the whole 5000 x 16 table read once: ~2.3 MB, ~0.7 us
    whole = bounds.victim_bytes(5000, 5000 * 16)
    assert 2.2e6 < whole < 2.4e6
    assert whole / 3.35e12 * 1e6 == pytest.approx(0.69, abs=0.02)


def test_scatter_and_victim_blocking_match_the_sources():
    from kubernetes_tpu_torch.sched.device import scatter_kernel as sk
    from kubernetes_tpu_torch.sched.device import victim_kernel as vk
    assert _defines(sk.SOURCE)["SCATTER_BLOCK_THREADS"] == sk.BLOCK_THREADS
    d = _defines(vk.SOURCE)
    assert d["VICTIM_BLOCK_THREADS"] == vk.BLOCK_THREADS
    # the descriptor the host packs is the struct the kernel reads
    assert sk.DESCRIPTOR.itemsize == 64
    assert sk.DESCRIPTOR.names == ("dst", "dst2", "src", "aux", "elems",
                                   "words", "word", "kind", "magic",
                                   "shift", "pad")
    src = open(sk.SOURCE).read()
    assert re.search(r"KIND_SCATTER = 0, KIND_COPY = 1", src)
    assert (sk.SCATTER, sk.COPY) == (0, 1)


@pytest.mark.parametrize("rows,row_bytes,grid", [
    (1, [1, 8], 1), (300, [4, 4, 8], 2), (5000, [1, 12], 59),
    (5000, [8] * 8, 20), (200_000, [8], 782), (1_000_000, [8], 1024)])
def test_scatter_grid_covers_the_widest_field(rows, row_bytes, grid):
    from kubernetes_tpu_torch.sched.device import scatter_kernel as sk
    elems = max(rows * rb // sk._word(rb, 0) for rb in row_bytes)
    assert sk.grid_x(elems) == grid


RATE2 = {**RATE, "fp64_ops_per_s": bounds.fp64_ops_per_s(H100_SMS,
                                                          H100_CLOCK_HZ)}


def test_fp64_rate_is_64_lanes_per_sm_per_clock():
    rate = bounds.fp64_ops_per_s(H100_SMS, H100_CLOCK_HZ)
    assert rate == H100_SMS * 64 * H100_CLOCK_HZ
    # the data sheet's 34 TFLOP/s of FP64 counts an FMA as two
    assert 2 * rate == pytest.approx(33.45e12, rel=0.01)


def test_scan_ops_per_element():
    # i32: 7 + 6 + 4 words of mask, 31 + 9 of score
    assert bounds.scan_int_ops(False, 1, 1, 1) == (17, 40)
    # i64: the carried adds, compares and selects twice, multiplies 3x
    assert bounds.scan_int_ops(True, 1, 1, 1) == (7 + 12 + 4, 62 + 27)
    assert bounds.scan_int_ops(False, 2, 3, 4) == (7 + 6 + 2 + 3 + 8, 40)
    # two divisions of 8 in Balanced, one in each of the tenths scores
    assert bounds.F64_DIV_OPS == 8
    assert bounds.SCAN_F64_NODE == 8 + 11 + 16 == 35
    assert bounds.SCAN_F64_TENTHS == 5 + 8 == 13
    ints, f64 = bounds.scan_ops(100, 40, False, 1, 1, 1, terms=2,
                                spread=10, anti=5)
    assert ints == 100 * (17 + 12) + 40 * 40 + 15 * 6
    assert f64 == 40 * 35 + 15 * 13


def test_scan_bound_at_the_e2e_chunk():
    """K1 on the e2e's chunk, every pod fitting: operations bound it,
    and at one word a set the INT32 term leads the FP64 term."""
    p, n = 8192, 5120
    ops = bounds.scan_ops(p * n, p * n, False, 1, 1, 1)
    b = bounds.scan_bound(1_000_000, ops, RATE2)
    assert b["bound_by"] == "operations"
    assert b["int_bound_ms"] == pytest.approx(p * n * 57 / 16.727e9,
                                              rel=1e-3)
    assert b["f64_bound_ms"] == pytest.approx(p * n * 35 / 16.727e9,
                                              rel=1e-3)
    assert b["ops_bound_ms"] == b["int_bound_ms"] == b["bound_ms"]
    assert 0.1 < b["bound_ms"] < 0.15
    assert (b["ops"], b["f64_ops"]) == ops
    assert b["fp64_ops_per_s"] == RATE2["fp64_ops_per_s"]


def test_scan_bound_in_the_wide_layout_counts_more():
    narrow = bounds.scan_ops(1000, 1000, False, 1, 1, 1)
    wide = bounds.scan_ops(1000, 1000, True, 1, 1, 1)
    assert wide[0] > narrow[0] and wide[1] == narrow[1]


@pytest.mark.parametrize("p", [1, 8192])
def test_probe_bound_adds_the_mask_and_total(p):
    n = 5000
    b = bounds.probe_bound(p, n, 50_000, False, 1, 1, 1, 0, 0, 0, RATE2)
    assert b["bytes"] == 50_000 + p * n * 5
    assert (b["ops"], b["f64_ops"]) == bounds.scan_ops(
        p * n, p * n, False, 1, 1, 1)
    wide = bounds.probe_bound(p, n, 50_000, True, 1, 1, 1, 0, p, 0, RATE2)
    assert wide["bytes"] == 50_000 + p * n * 9
    assert wide["f64_ops"] == p * n * (35 + 13)
    if p == 1:
        assert b["bound_ms"] < 0.001


def test_bound_without_f64_keeps_the_integer_keys():
    b = bounds.bound(1000, 2000, 1e9)
    assert "f64_bound_ms" not in b and b["ops_bound_ms"] == 2e-3
    c = bounds.bound(1000, 2000, 1e9, 5000, 1e9)
    assert c["ops_bound_ms"] == c["f64_bound_ms"] == 5e-3
    assert c["int_bound_ms"] == 2e-3 and c["bound_by"] == "operations"


def test_turns_load_another_checkouts_scan_kernel():
    """The turns tool loads the other checkout's scan kernels where it
    has them; their plain paths agree with this checkout's on the CPU."""
    import os

    from kubernetes_tpu_torch.kubemark.fixtures import scan_tables
    from kubernetes_tpu_torch.sched.device import engine as eng
    from kubernetes_tpu_torch.sched.device import scan_kernel
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    osk = gpu_evidence.load_wrappers(root)["scan_kernel"]
    assert osk is not scan_kernel and osk.SOURCE == scan_kernel.SOURCE
    a = gpu_evidence.scan_args(*(eng._upload(t, torch.device("cpu"))
                                 for t in scan_tables(4, 12, 60)))
    assert gpu_evidence._same(osk.probe(osk.ScanArgs(*a), (1, 1, 1), 0,
                                        False),
                              scan_kernel.probe(a, (1, 1, 1), 0, False))


def test_smi_sampler_summarises_each_field(monkeypatch):
    """The SM clock, power and temperature beside K1's timings: min,
    median and max of what nvidia-smi read, before, during and after."""
    from kubernetes_tpu_torch.kubemark import gpu_evidence
    reads = iter([[1980.0, 120.5, 35.0], [1755.0, 690.0, 61.0],
                  [1980.0, 300.0, 40.0]] + [[1980.0, 130.0, 36.0]] * 100)
    monkeypatch.setattr(gpu_evidence.SmiSampler, "read",
                        staticmethod(lambda: next(reads)))
    with gpu_evidence.SmiSampler(period=0.01) as smi:
        pass
    out = smi.summary()
    assert out["smi_samples"] == len(smi.samples) >= 2
    assert out["sm_clock_mhz"][0] <= out["sm_clock_mhz"][1] \
        <= out["sm_clock_mhz"][2] == 1980.0
    assert set(out) == {"smi_samples", "sm_clock_mhz", "power_draw_w",
                        "temperature_c"}


def test_turns_load_another_checkouts_victim_kernel():
    """The turns tool loads the other checkout's victim kernel (its
    `from ..preemption` resolves to this checkout's constants); the
    plain paths agree on the CPU through each wrapper's own packing."""
    import os

    from kubernetes_tpu_torch.kubemark import fixtures as fx
    from kubernetes_tpu_torch.sched.device import victim_kernel
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ovk = gpu_evidence.load_wrappers(root)["victim_kernel"]
    assert ovk is not victim_kernel and ovk.SOURCE == victim_kernel.SOURCE
    spec = fx.preempt_spec(n_nodes=40, n_preemptors=3)
    for t in fx.preempt_tables(spec):
        assert gpu_evidence._same(
            ovk.victim_search(ovk.VictimArgs.from_table(t, "cpu")),
            victim_kernel.victim_search(
                victim_kernel.VictimArgs.from_table(t, "cpu")))
    assert fx.widest_table(fx.preempt_tables(spec)).v == \
        max(t.v for t in fx.preempt_tables(spec))


def test_profile_kernels_edits_apply_to_the_sources(tmp_path, monkeypatch):
    """The profiling tool's instrumented and re-bounded copies are built
    by text edits of the committed sources: every anchor is found once,
    and each copy differs from its source only where it says."""
    from kubernetes_tpu_torch.kubemark import profile_kernels as pk
    from kubernetes_tpu_torch.sched.device import scan_kernel, victim_kernel
    monkeypatch.setattr(pk, "VARIANT_DIR", str(tmp_path))
    phases = open(pk._variant("phases", victim_kernel.SOURCE,
                              pk._phase_edits())).read()
    assert phases.count("victim_dbg[blockIdx.x * 8 +") == 9
    assert "victim_dbg_read" in phases
    # the K6 probe's anchors match the committed design's kernels
    assert pk.spec_design(open(scan_kernel.SOURCE).read()) == "pipeline"
    spec = open(pk._variant("spec", scan_kernel.SOURCE,
                            pk._spec_edits("pipeline"))).read()
    assert "spec_dbg_read" in spec and "long long dbg[16] = {0};" in spec
    assert spec.count("atomicAdd((unsigned long long*)&spec_dbg[q]") == 1
    assert spec.count("k6a_dbg + blockIdx.x * 8") == 1
    assert all(f"c{i} = clock64();" in spec for i in range(6))
    latency = open(pk._variant("latency", scan_kernel.SOURCE, [
        (pk._ERRNAME, pk._LATENCY + pk._ERRNAME)])).read()
    assert latency.count("score_latency_launch(") == 1
    copies = pk._bounds_variants(scan_kernel.SOURCE)
    assert sorted(copies) == sorted(
        f"{o}_min{m}" for o in ("total_first", "mask_first")
        for m in (0, 2, 3))
    for name, path in copies.items():
        text = open(path).read()
        first = text.index("probe_block(const Params<T>& a)")
        mask_first = text.index("const bool m = fits<T, HAS_AFF>", first) \
            < text.index("const T t = node_total<T, true>", first)
        assert mask_first == name.startswith("mask")
        assert ("(PROBE_BLOCK_THREADS, 3)\nprobe_kernel(" in text) == \
            name.endswith("min3")
        assert "if constexpr (false)" in text
