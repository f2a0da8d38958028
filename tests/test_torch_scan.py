"""The port's scan step (K1) and stateless probe (K5),
`kubernetes_tpu_torch.sched.device.scan_kernel`, on the CPU: the plain
versions the wrappers compute for CPU tensors equal the JAX engine's
`_make_run` (assignment and final State, field for field, chunk by
chunk) and `_make_probe` on the same seeded encodings, for the four
tiers of test_torch_engine.TIERS in the i32-narrowed and the i64-wide
layout. Every quantity is an integer or an f64 floor: tolerance 0.

Then the wrapper around the CUDA kernels, which needs no card: the
arguments' layout check (ScanArgs.from_engine), the launch plan, the
order in which the addresses and sizes are packed (read from the
kernel's source), the random tables the card tests use, and the plain
probe's Balanced floor at the FMA trap. The kernels themselves run on
the card (tests/test_torch_gpu.py)."""

import dataclasses
import functools
import re

import jax
import numpy as np
import pytest
import torch

from kubernetes_tpu.sched.device import BatchEngine as JaxEngine
from kubernetes_tpu.sched.device.engine import (_make_probe, _make_run,
                                               ensure_x64)
from kubernetes_tpu_torch.kubemark.fixtures import (CLUSTER_EDGES,
                                                    SCAN_DEGENERATE,
                                                    SCAN_TRAP,
                                                    cluster_edge_tables,
                                                    scan_cases, scan_tables)
from kubernetes_tpu_torch.sched.device import BatchEngine
from kubernetes_tpu_torch.sched.device import engine as port_engine
from kubernetes_tpu_torch.sched.device import scan_kernel as sk

from test_torch_encode import encodings, port_policy, wide_snapshot
from test_torch_engine import TIERS

SCAN_SEED, PROBE_SEED = 11, 3
LAYOUTS = ("i32", "i64")


def _widen(enc):
    """The int64 layout of a narrowed EncodeResult of either package: the
    engine's own re-widening (BatchEngine._ensure_safe_dtypes)."""
    nt, st, pb, g = enc.node_tab, enc.init_state, enc.pod_batch, \
        enc.mem_scale
    if nt.cpu_cap.dtype == np.int64:
        return enc
    i64 = np.int64
    rep = dataclasses.replace
    return rep(
        enc, mem_scale=1,
        node_tab=rep(nt, cpu_cap=nt.cpu_cap.astype(i64),
                     mem_cap=nt.mem_cap.astype(i64) * g,
                     static_score=nt.static_score.astype(i64)),
        init_state=rep(st, cpu_used=st.cpu_used.astype(i64),
                       mem_used=st.mem_used.astype(i64) * g,
                       nz_cpu=st.nz_cpu.astype(i64),
                       nz_mem=st.nz_mem.astype(i64) * g),
        pod_batch=rep(pb, req_cpu=pb.req_cpu.astype(i64),
                      req_mem=pb.req_mem.astype(i64) * g,
                      nz_cpu=pb.nz_cpu.astype(i64),
                      nz_mem=pb.nz_mem.astype(i64) * g))


@functools.cache
def _case(tier: str, layout: str, seed: int):
    """-> (JAX engine, its encode, port engine, its encode) of one tier
    in one layout."""
    snap, policy = TIERS[tier](seed)
    jax_enc, enc = encodings(snap, policy=policy)
    if layout == "i64":
        jax_enc, enc = _widen(jax_enc), _widen(enc)
    want = np.int64 if layout == "i64" else np.int32
    assert enc.node_tab.cpu_cap.dtype == jax_enc.node_tab.cpu_cap.dtype \
        == want
    return (JaxEngine(policy=policy), jax_enc,
            BatchEngine(policy=port_policy(policy), device="cpu"), enc)


@functools.cache
def _jax_run(tier: str, layout: str):
    """The JAX engine's scan over the whole batch -> (assigned, final
    State as numpy, int32 views of the bitsets)."""
    je, jax_enc, _, _ = _case(tier, layout, SCAN_SEED)
    run = jax.jit(_make_run(je.weights, je._anti_weight,
                            *je._enc_flags(jax_enc)))
    state, assigned = run(*je.device_args(jax_enc))
    return np.asarray(assigned), {
        f: port_engine._host(np.asarray(getattr(state, f)))
        for f in state._fields}


def _port_args(te, enc):
    node, state, pods = te.device_args(enc)
    return sk.ScanArgs.from_engine(node, sk.reciprocals(node), state, pods)


@pytest.mark.parametrize("chunk", [1, 7, 40])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_scan_chunk_matches_jax_make_run(tier, layout, chunk):
    """scan_chunk over successive chunks of the batch, the State carried
    between them, equals one JAX scan: the assignment and every State
    field. 7 leaves a short tail chunk; 40 is the batch in one."""
    _, _, te, enc = _case(tier, layout, SCAN_SEED)
    want, want_state = _jax_run(tier, layout)
    a = _port_args(te, enc)
    flags = te._enc_flags(enc)
    p = a.pods.valid.shape[0]
    got = torch.cat([sk.scan_chunk(a.pod_slice(lo, lo + chunk), te.weights,
                                   te._anti_weight, *flags)
                     for lo in range(0, p, chunk)])
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert (want >= 0).any()
    for f, t in zip(a.state._fields, a.state):
        assert np.array_equal(t.numpy(), want_state[f]), f


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_probe_matches_jax_make_probe(tier, layout, monkeypatch):
    je, jax_enc, te, enc = _case(tier, layout, PROBE_SEED)
    has_aff, _ = je._enc_flags(jax_enc)
    probe = jax.jit(_make_probe(je.weights, je._anti_weight, has_aff,
                                has_spread=True))
    want_mask, want_total = probe(*je.device_args(jax_enc))
    # a block smaller than the batch exercises the blocked pod dimension
    monkeypatch.setattr(sk, "PROBE_BLOCK", 16)
    a = _port_args(te, enc)
    mask, total = sk.probe(a, te.weights, te._anti_weight,
                           te._enc_flags(enc)[0])
    assert mask.dtype == torch.bool and total.dtype == a.dtype
    assert np.array_equal(mask.numpy(), np.asarray(want_mask))
    assert np.array_equal(total.numpy(), np.asarray(want_total))


def test_wide_snapshot_scan_and_probe_match_jax():
    """A snapshot the encoder cannot narrow (a prime-byte request)."""
    jax_enc, enc = encodings(wide_snapshot())
    je, te = JaxEngine(), BatchEngine(device="cpu")
    a = _port_args(te, enc)
    assert a.dtype == torch.int64
    state, assigned = jax.jit(_make_run(je.weights, 0, False, False))(
        *je.device_args(jax_enc))
    got = sk.scan_chunk(a, te.weights, 0, False, False)
    assert np.array_equal(got.numpy(), np.asarray(assigned))
    assert np.array_equal(a.state.mem_used.numpy(),
                          np.asarray(state.mem_used))
    _, want_total = jax.jit(_make_probe(je.weights, 0, False, True))(
        *je.device_args(jax_enc))
    a = _port_args(te, enc)
    assert np.array_equal(sk.probe(a, te.weights, 0, False)[1].numpy(),
                          np.asarray(want_total))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_from_engine_dtypes_and_shapes(layout):
    _, _, te, enc = _case("service_anti", layout, SCAN_SEED)
    a = _port_args(te, enc)
    wide = layout == "i64"
    assert a.dtype == (torch.int64 if wide else torch.int32)
    assert a.device == torch.device("cpu")
    d = a.dims()
    nt, pb = enc.node_tab, enc.pod_batch
    assert d == {"p": pb.valid.shape[0], "n": nt.valid.shape[0],
                 "l": nt.label_words.shape[1],
                 "pw": enc.init_state.port_bits.shape[1],
                 "k": enc.init_state.disk_any.shape[1],
                 "g": enc.init_state.spread.shape[0],
                 "t": nt.aff_dom.shape[0],
                 "d": enc.init_state.aff_count.shape[1],
                 "s": enc.init_state.svc_count.shape[0],
                 "z": nt.zone_scratch.shape[0]}
    carried = {"cpu_cap", "mem_cap", "static_score", "cpu_used",
               "mem_used", "nz_cpu", "nz_mem", "req_cpu", "req_mem"}
    for tree in (a.node, a.state, a.pods):
        for f, t in zip(tree._fields, tree):
            assert t.is_contiguous()
            if f in carried:
                assert t.dtype == a.dtype, f
            else:
                assert t.dtype in (torch.bool, torch.int32), f
    assert a.aux.inv_cpu.dtype == a.aux.inv_mem.dtype == torch.float64
    # inputs read once: every table, the two reciprocals and the pods
    assert a.nbytes() == sum(t.numel() * t.element_size() for t in (
        *a.node, a.aux.inv_cpu, a.aux.inv_mem, *a.state, *a.pods))


def test_from_engine_rejects_another_layout():
    _, _, te, enc = _case("node_local", "i32", SCAN_SEED)
    node, state, pods = te.device_args(enc)
    aux = sk.reciprocals(node)
    wide = state._replace(cpu_used=state.cpu_used.long())
    with pytest.raises(ValueError, match="state.cpu_used"):
        sk.ScanArgs.from_engine(node, aux, wide, pods)
    strided = torch.zeros((state.port_bits.shape[0], 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="port_bits"):
        sk.ScanArgs.from_engine(node, aux, state._replace(
            port_bits=strided[:, :1]), pods)
    with pytest.raises(ValueError, match="pods.req_cpu"):
        sk.ScanArgs.from_engine(node, aux, state, pods._replace(
            req_cpu=pods.req_cpu[:-1]))


def test_wrappers_run_on_cpu_or_cuda_only():
    _, _, te, enc = _case("node_local", "i32", SCAN_SEED)
    a = _port_args(te, enc)
    meta = sk.ScanArgs(*(type(t)(*(x.to("meta") for x in t)) for t in a))
    with pytest.raises(ValueError, match="runs on cuda"):
        sk.scan_chunk(meta, (1, 1, 1), 0, False, False)
    with pytest.raises(ValueError, match="runs on cuda"):
        sk.probe(meta, (1, 1, 1), 0, False)


def _schedules(*largest):
    """A card that can run one cluster of each size in `largest` (the
    answer of max_active_clusters), whatever its shared memory."""
    return lambda code, cluster, threads, smem: int(cluster in largest)


E2E_DIMS = {"p": 8192, "n": 5120, "l": 1, "pw": 1, "k": 1, "g": 1, "t": 1,
            "d": 1, "s": 1, "z": 1}


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("tiers", [(False, False, False), (True, False, False),
                                   (False, True, False), (True, True, True)])
def test_launch_plan(wide, tiers):
    has_spread, has_aff, anti = tiers
    d = {"p": 8192, "n": 5120, "l": 2, "pw": 1, "k": 3, "g": 4, "t": 5,
         "d": 3, "s": 2, "z": 7}
    code = 8 * wide + 4 * has_spread + 2 * has_aff + anti
    scan = sk.launch_plan(sk.SCAN, d, wide, has_spread, has_aff, anti,
                          _schedules(16, 8))
    # one cluster of 16 CTAs, 320 slots and as many threads each, and the
    # loader warp
    slot = 16 + 7 * (8 if wide else 4) + 16 + 4 * (2 + 1 + 6) + 1
    words = (5 + 4 * (2 if wide else 1) + 2 + 1 + 12 + 15 * has_aff
             + 4 * has_spread + 2 * anti)
    assert scan == (sk.SCAN, code, 16, 352, 320 * slot + 4 * (3 * words + 21),
                    16, 320)
    probe = sk.launch_plan(sk.PROBE, d, wide, has_spread, has_aff, anti)
    # the probe always scores the spread tier, one block a pod
    probe_words = words - 4 * has_spread + 4
    assert probe == (sk.PROBE, code | 4, 8192, sk.PROBE_THREADS,
                     4 * (probe_words + 7), 1, 0)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("n,slots,threads", [(5120, 320, 352), (1, 1, 64),
                                             (37, 3, 64), (1500, 94, 128),
                                             (20480, 1280, 384)])
def test_launch_plan_splits_the_slots_over_16_ctas(wide, n, slots, threads):
    """The e2e chunk, the edges and the JAX package's largest fleet
    (DENSITY_20K.json, 20480 slots) at the e2e's widths."""
    plan = sk.launch_plan(sk.SCAN, {**E2E_DIMS, "n": n}, wide, False, False,
                          False, _schedules(16, 8))
    assert (plan.cluster, plan.grid, plan.slots, plan.threads) == \
        (16, 16, slots, threads)
    assert plan.smem == sk.shared_bytes(sk.SCAN, {**E2E_DIMS, "n": n}, wide,
                                        False, False, False, 16)
    assert plan.smem <= sk.MAX_SHARED_BYTES


@pytest.mark.parametrize("wide", [False, True])
def test_launch_plan_takes_8_ctas_where_16_cannot_run(wide):
    plan = sk.launch_plan(sk.SCAN, E2E_DIMS, wide, False, False, False,
                          _schedules(8))
    assert (plan.cluster, plan.slots, plan.threads) == (8, 640, 384)
    # 20480 slots at 8 CTAs hold 2560 a CTA: the int64 layout's 105
    # bytes a slot do not fit in a CTA's shared memory, the int32's 77 do
    big = {**E2E_DIMS, "n": 20480}
    if wide:
        with pytest.raises(ValueError, match="shared memory"):
            sk.launch_plan(sk.SCAN, big, wide, False, False, False,
                           _schedules(8))
    else:
        assert sk.launch_plan(sk.SCAN, big, wide, False, False, False,
                              _schedules(8)).cluster == 8


def test_launch_plan_asks_the_card_for_each_size_largest_first():
    asked = []

    def card(code, cluster, threads, smem):
        asked.append((code, cluster, threads, smem))
        return 0
    with pytest.raises(ValueError, match="cannot schedule"):
        sk.launch_plan(sk.SCAN, E2E_DIMS, True, True, False, False, card)
    assert [(c, k) for c, k, _, _ in asked] == [(12, 16), (12, 8)]
    assert [t for _, _, t, _ in asked] == [352, 384]


def partition(n: int, cluster: int, threads: int) -> list:
    """The slots each thread of K1 owns, [rank][thread] -> list, as the
    kernel walks them (csrc/scan_kernel.cu, `first` / `nscore`): CTA r
    the range [r * S, min(n, r * S + S)), S = ceil(n / C), thread t <
    threads - 32 of it every (threads - 32)-th slot from its start + t;
    the last warp (the loader) none."""
    slots, owners = -(-n // cluster), threads - 32
    return [[list(range(r * slots + t, min(n, r * slots + slots), owners))
             if t < owners else [] for t in range(threads)]
            for r in range(cluster)]


@pytest.mark.parametrize("name", sorted(scan_cases()))
def test_launch_plan_at_the_scan_cases(name):
    """Every case the card holds the kernels to gets a 16-CTA plan whose
    slots cover the case's slots once."""
    case = scan_cases()[name]
    t = case["tables"]
    wide = t["wide"]
    d = {"p": t.get("p", 64), "n": t.get("n", 5120), "l": t.get("words", 1),
         "pw": t.get("words", 1), "k": t.get("words", 1),
         "g": max(t["groups"], 1), "t": max(t["terms"], 1), "d": 3,
         "s": max(t["services"], 1), "z": 3}
    plan = sk.launch_plan(sk.SCAN, d, wide, case["has_spread"],
                          case["has_aff"], bool(case["anti_weight"]),
                          _schedules(16, 8))
    assert plan.cluster == 16 and plan.slots == -(-d["n"] // 16)
    assert plan.threads % 32 == 0 and plan.smem <= sk.MAX_SHARED_BYTES
    owned = sorted(n for cta in partition(d["n"], plan.cluster,
                                             plan.threads)
                   for slots in cta for n in slots)
    assert owned == list(range(d["n"]))


@pytest.mark.parametrize("n,cluster,threads", [(1, 16, 64), (37, 16, 64),
                                               (5120, 16, 352),
                                               (5120, 8, 384),
                                               (20480, 16, 384),
                                               (1000, 16, 64), (17, 8, 64)])
def test_partition_covers_every_slot_once(n, cluster, threads):
    """The kernel's ownership, modelled: CTA r the contiguous range of
    ceil(n / C) slots from r * ceil(n / C), thread t < threads - 32 every
    (threads - 32)-th slot of it from t, the loader warp none; some CTAs
    may own nothing."""
    parts = partition(n, cluster, threads)
    assert len(parts) == cluster and all(len(c) == threads for c in parts)
    flat = [s for cta in parts for slots in cta for s in slots]
    assert sorted(flat) == list(range(n))
    per, owners = -(-n // cluster), threads - 32
    for r, cta in enumerate(parts):
        for t, slots in enumerate(cta):
            assert all(r * per <= s < r * per + per and (s - r * per) %
                       owners == t for s in slots)
            assert t < owners or not slots


def test_launch_plan_refuses_what_the_kernel_cannot_take():
    d = {"p": 1, "n": 5000, "l": 1, "pw": 1, "k": 1, "g": 1, "t": 1,
         "d": 1, "s": 1, "z": 1}
    with pytest.raises(ValueError, match="shared memory"):
        sk.launch_plan(sk.PROBE, {**d, "z": 60000}, False, True, False, True)
    # more slots than 16 CTAs hold in shared memory
    with pytest.raises(ValueError, match="no cluster fits"):
        sk.launch_plan(sk.SCAN, {**d, "n": 40000}, True, False, False,
                       False, _schedules(16, 8))


def _source_enum(name: str):
    """The member names of one enum in the kernel's source, prefix
    dropped and lower-cased (PTR_CPU_CAP -> cpu_cap): the order
    scan_launch reads its arguments in."""
    with open(sk.SOURCE) as f:
        body = re.search(r"enum %s \{(.*?)\};" % name, f.read(), re.S)[1]
    return tuple(n.lower() for n in re.findall(r"\b[A-Z]+_(\w+)", body)
                 if n != "COUNT")


def test_pack_orders_addresses_and_sizes_as_the_source():
    assert _source_enum("ScanPtr") == sk.PTR_FIELDS
    assert _source_enum("ScanDim") == sk.DIM_FIELDS
    _, _, te, enc = _case("service_anti", "i32", SCAN_SEED)
    a = _port_args(te, enc)
    out = torch.empty(a.dims()["p"], dtype=torch.int32)
    dims, ptrs = sk.pack(a, (3, 4, 5), 6, {"assigned": out})
    assert dims.dtype == np.int64 and ptrs.dtype == np.uint64
    assert list(dims) == [a.dims()[k] for k in sk.DIM_FIELDS[:10]] + \
        [3, 4, 5, 6]
    by_name = dict(zip(sk.PTR_FIELDS, ptrs))
    assert by_name["cpu_cap"] == a.node.cpu_cap.data_ptr()
    assert by_name["inv_mem"] == a.aux.inv_mem.data_ptr()
    assert by_name["svc_total"] == a.state.svc_total.data_ptr()
    assert by_name["pod_valid"] == a.pods.valid.data_ptr()
    assert by_name["pod_nz_mem"] == a.pods.nz_mem.data_ptr()
    assert by_name["nz_mem"] == a.state.nz_mem.data_ptr()
    assert by_name["svc_member"] == a.pods.svc_member.data_ptr()
    assert by_name["assigned"] == out.data_ptr()
    assert by_name["mask"] == by_name["total"] == by_name["work_total"] == 0
    assert by_name["spec_nodes"] == 0
    # every input has an address, and no two share one
    inputs = [v for f, v in by_name.items()
              if f not in ("assigned", "mask", "total", "work_total",
                           "work_mask", "spec_nodes")]
    assert all(inputs) and len(set(inputs)) == len(inputs)


def test_blocking_matches_the_source():
    with open(sk.SOURCE) as f:
        src = f.read()
    defines = {m[1]: int(m[2]) for m in
               re.finditer(r"^#define (\w+) (\d+)$", src, re.M)}
    assert defines["SCAN_BLOCK_THREADS"] == sk.SCAN_THREADS
    assert defines["PROBE_BLOCK_THREADS"] == sk.PROBE_THREADS
    assert defines["SCAN_MAX_SHARED_BYTES"] == sk.MAX_SHARED_BYTES
    assert defines["SCAN_MAX_CLUSTER"] == sk.MAX_CLUSTER == \
        max(sk.CLUSTERS)
    # the shared memory a slot takes, as the source counts it
    counted = re.search(r"return 16 \+ 7 \* \(long long\)sizeof\(T\) \+ 16 "
                        r"\+ 4 \* \(L \+ PW \+ 2 \* K\) \+ 1;", src)
    assert counted is not None
    d = {"l": 2, "pw": 3, "k": 4}
    assert sk.slot_bytes(d, True) == 16 + 56 + 16 + 4 * 13 + 1
    assert sk.slot_bytes(d, False) == 16 + 28 + 16 + 4 * 13 + 1
    cases = re.findall(r"case (\d+): return \(int\)dispatch<(\w+), (\w+), "
                       r"(\w+), (\w+)>", src)
    assert len(cases) == 16
    for code, dtype, spread, aff, anti in cases:
        assert int(code) == sk.variant(dtype == "int64_t", spread == "true",
                                       aff == "true", anti == "true")


@pytest.mark.parametrize("wide", [False, True])
def test_scan_tables_are_in_the_engines_layout(wide):
    node, state, pods = scan_tables(3, 50, 400, wide, 2, 3, 2)
    dt = np.int64 if wide else np.int32
    assert node.cpu_cap.dtype == state.mem_used.dtype == \
        pods.req_mem.dtype == dt
    assert np.array_equal(np.sort(node.tie_rank), np.arange(400))
    assert not node.valid[-10:].any() and node.valid[:SCAN_TRAP].all()
    assert (node.cpu_cap == 0).any() and pods.zero_req.any()
    assert ((pods.host_idx >= 0) & (pods.host_idx < 400)).any()
    assert (pods.host_idx == -2).any() or (pods.host_idx == 405).any()
    if wide:
        assert node.mem_cap.max() > 2 ** 31
    tensors = [port_engine._upload(t, torch.device("cpu"))
               for t in (node, state, pods)]
    a = sk.ScanArgs.from_engine(tensors[0], sk.reciprocals(tensors[0]),
                                *tensors[1:])
    assert a.dims()["g"] == 2 and a.dims()["t"] == 3 and a.dims()["s"] == 2


@pytest.mark.parametrize("name", sorted(scan_cases(p=12, n=90)))
def test_scan_cases_place_pods_unless_degenerate(name):
    """The cases the card holds the kernels to (chip_smoke's scan phase,
    the card tests), at a small size through the plain versions: each
    builds tables the layout check takes, in the case's layout, and only
    the degenerate edges place no pod."""
    case = scan_cases(p=12, n=90)[name]
    tensors = [port_engine._upload(t, torch.device("cpu"))
               for t in scan_tables(**case["tables"])]
    a = sk.ScanArgs.from_engine(tensors[0], sk.reciprocals(tensors[0]),
                                *tensors[1:])
    assert (a.dtype == torch.int64) == name.endswith("/i64")
    flags = (case["has_aff"], case["has_spread"])
    got = sk.scan_chunk(a, case["weights"], case["anti_weight"], *flags)
    assert ((got >= 0).sum() == 0) == (name.split("/")[0] in SCAN_DEGENERATE)
    mask, _ = sk.probe(a, case["weights"], case["anti_weight"], flags[0])
    assert mask.shape == (a.dims()["p"], a.dims()["n"])


@pytest.mark.parametrize("wide", [False, True])
def test_plain_probe_scores_balanced_as_the_oracle_at_the_fma_trap(wide):
    """cpu_frac 0.9 against mem_frac 0: 10 - 0.9 * 10 rounds the product
    to 9 and floors to 1, as the serial oracle's Python floats do; one
    fused multiply-add would give 0.99999... and floor to 0."""
    assert np.floor(10.0 - abs(900 / 1000 - 0.0) * 10.0) == 1
    tensors = [port_engine._upload(t, torch.device("cpu"))
               for t in scan_tables(2, 16, 64, wide)]
    a = sk.ScanArgs.from_engine(tensors[0], sk.reciprocals(tensors[0]),
                                *tensors[1:])
    mask, total = sk.probe(a, (0, 1, 0), 0, False)
    trap = slice(0, SCAN_TRAP)
    assert mask[trap, trap].all()
    assert (total[trap, trap] == 1).all()


def test_engine_counts_the_plain_steps_on_the_cpu():
    """On the CPU every chunk runs the plain per-pod loop, and
    scan_stats counts its steps under eager_steps (0 on the card)."""
    _, _, te, enc = _case("spread", "i32", SCAN_SEED)
    te = BatchEngine(device="cpu")
    te.run_chunked(enc, 16)
    p = enc.pod_batch.valid.shape[0]
    assert te.scan_stats["steps"] == p + (-p) % 16
    assert te.scan_stats["eager_steps"] == te.scan_stats["steps"]


@pytest.mark.parametrize("name", sorted(CLUSTER_EDGES))
def test_cluster_edge_tables(name):
    """The tables K1's cluster edges run on (chip_smoke's scan phase, the
    card tests), through the plain version on the CPU: every slot takes
    every pod where every_fits says so, and each pinned pod lands on its
    slot, whichever CTA owns it."""
    kw = CLUSTER_EDGES[name]
    tensors = [port_engine._upload(t, torch.device("cpu"))
               for t in cluster_edge_tables(name)]
    a = sk.ScanArgs.from_engine(tensors[0], sk.reciprocals(tensors[0]),
                                *tensors[1:])
    assert (a.dims()["p"], a.dims()["n"]) == (kw["p"], kw["n"])
    got = sk.scan_chunk(a, (1, 1, 1), 2, True, True)
    assert (got >= 0).any()
    if kw.get("every_fits"):
        assert (got >= 0).all()
    pins = list(kw.get("pins", ()))
    if pins:
        assert got[SCAN_TRAP:SCAN_TRAP + len(pins)].tolist() == pins
        per = -(-kw["n"] // 16)
        assert len({s // per for s in pins}) > 3   # several CTAs' slots


# ------------------------------------------- K5 over a cluster: plan, model

def _accepts(code, cluster, threads, smem):
    return 1


@pytest.mark.parametrize("p,cluster,threads", [
    (1, 16, 320), (9, 16, 320), (17, 8, 512), (64, 4, 512),
    (66, 2, 512), (131, 2, 512), (132, 1, 512), (8192, 1, 512)])
def test_probe_plan_picks_the_cluster_from_p(p, cluster, threads):
    """P clusters of C CTAs cover the card's 132 SMs: 16 CTAs at the
    extender's one pod (one slot a thread at 5000 nodes), one block a
    pod at 132 pods and more (the batch shape, as before)."""
    d = {**E2E_DIMS, "p": p, "n": 5000}
    plan = sk.launch_plan(sk.PROBE, d, False, True, False, False, _accepts)
    slots = -(-5000 // cluster) if cluster > 1 else 0
    assert (plan.cluster, plan.grid, plan.threads, plan.slots) == \
        (cluster, p * cluster, threads, slots)
    assert plan.smem == sk.shared_bytes(sk.PROBE, d, False, True, False,
                                        False, cluster)
    assert plan.threads * max(cluster, 1) >= 5000 or cluster < 16


def test_probe_plan_asks_the_card_only_for_clusters():
    asked = []

    def card(code, cluster, threads, smem):
        asked.append((code, cluster))
        return int(cluster != 16)
    d = {**E2E_DIMS, "p": 1, "n": 5000}
    plan = sk.launch_plan(sk.PROBE, d, True, True, True, False, card)
    # 16 is refused: 8, the portable size, with K5's code
    assert (plan.cluster, plan.grid, plan.threads) == (8, 8, 512)
    code = sk.variant(True, True, True, False)
    assert asked == [(code | sk.PROBE_CODE, 16), (code | sk.PROBE_CODE, 8)]
    asked.clear()
    sk.launch_plan(sk.PROBE, {**d, "p": 8192}, True, True, True, False, card)
    assert asked == []                    # a block a pod asks nothing
    with pytest.raises(ValueError, match="cannot schedule"):
        sk.launch_plan(sk.PROBE, d, True, True, True, False,
                       lambda *args: 0)


def test_probe_plan_covers_the_sms_it_is_given():
    d = {**E2E_DIMS, "n": 5000}
    assert sk.launch_plan(sk.PROBE, {**d, "p": 57}, False, True, False,
                          False, _accepts, sms=114).cluster == 2
    assert sk.launch_plan(sk.PROBE, {**d, "p": 114}, False, True, False,
                          False, _accepts, sms=114).cluster == 1
    assert [sk.probe_cluster(p, 132) for p in (1, 8, 9, 16, 17, 33, 34, 66,
                                                67, 131, 132)] == \
        [16, 16, 16, 16, 8, 4, 4, 2, 2, 2, 1]


def probe_model(a, weights, anti_weight, has_aff, cluster):
    """K5's cluster route, modelled (csrc/scan_kernel.cu,
    probe_cluster_kernel): per pod, CTA r of C owns slots [r * S, r * S +
    S), S = ceil(N / C); phase 1 takes each CTA's max of the pod's
    spread row and its zone histogram of the fitting labelled slots;
    the partials are maxed and summed over the CTAs; phase 2 adds the
    spread and ServiceAntiAffinity scores to the node-local total."""
    node, state, pods = a.node, a.state, a.pods
    n = node.valid.shape[0]
    aux = sk.node_aux(node)
    mask, total = sk.mask_and_score(node, aux, weights, 0, state, pods,
                                    has_aff, has_spread=False)
    s = -(-n // cluster)
    ranges = [(r * s, min(n, r * s + s)) for r in range(cluster)]
    covered = sorted(i for lo, hi in ranges for i in range(lo, hi))
    assert covered == list(range(n))
    sdt = total.dtype
    out = total.clone()
    z = node.zone_scratch.shape[0]
    for b in range(pods.valid.shape[0]):
        gid = int(pods.group_id[b])
        g = max(gid, 0)
        parts = [int(state.spread[g, lo:hi].max()) if hi > lo
                 else -2 ** 31 for lo, hi in ranges]
        maxc = max(max(parts), int(node.offgrid_max[g])) if gid >= 0 else 0
        if gid < 0 or maxc == 0:
            spread = torch.full((n,), 10, dtype=sdt)
        else:
            spread = torch.floor(
                10.0 * (maxc - state.spread[g]).to(torch.float64)
                / max(maxc, 1)).to(sdt)
        out[b] = out[b] + weights[2] * spread
        if not anti_weight:
            continue
        sg = int(pods.svc_group[b])
        hist = torch.zeros(z, dtype=torch.int64)
        for lo, hi in ranges:          # each CTA's partial, then the sum
            part = torch.zeros(z, dtype=torch.int64)
            for i in range(lo, hi):
                zone = int(node.zone_id[i])
                if mask[b, i] and zone >= 0:
                    part[zone] += int(state.svc_count[max(sg, 0), i])
            hist += part
        tot = int(state.svc_total[sg]) if sg >= 0 else 0
        zc = hist[torch.clamp(node.zone_id, min=0).long()]
        sa = torch.floor(10.0 * (tot - zc).to(torch.float64)
                         / max(tot, 1)).to(sdt) if tot > 0 \
            else torch.full((n,), 10, dtype=sdt)
        sa = torch.where(node.zone_id >= 0, sa, 0)
        out[b] = out[b] + anti_weight * sa
    return mask, out


def _jax_tables(node, state, pods):
    """scan_tables' numpy tables as the JAX engine's NamedTuples
    (bitset words as uint32)."""
    from kubernetes_tpu.sched.device import engine as je
    words = {"labels", "port_bits", "disk_any", "disk_rw", "sel", "ports",
             "qany", "qrw", "sany", "srw"}

    def conv(tree, cls):
        return cls(**{f: (x.view(np.uint32) if f in words else x)
                      for f, x in zip(tree._fields, tree)})
    return (conv(node, je.NodeConst), conv(state, je.State),
            conv(pods, je.PodXs))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("tier", ["node_local", "spread", "affinity",
                                  "service_anti"])
@pytest.mark.parametrize("n", [1, 31, 16 * 320 - 1, 16 * 320 + 1])
def test_probe_cluster_model_equals_plain_and_jax(n, tier, layout):
    """The node partition and the two-phase reductions of K5's cluster
    route, modelled, equal probe_plain and JAX _make_probe at N around a
    multiple of the 16 CTAs' share, on each tier in both layouts.
    Tolerance 0. JAX runs on a copy whose FMA-trap slots are moved off
    the trap (ROADMAP Queue 3 item 2: XLA fuses Balanced there)."""
    from kubernetes_tpu_torch.kubemark.fixtures import SCAN_TIERS
    groups, terms, services = SCAN_TIERS[tier]
    weights, anti = (1, 1, 1), 2 if services else 0
    wide = layout == "i64"
    tables = scan_tables(5 + n, 3, n, wide, groups, terms, services)
    plan = sk.launch_plan(sk.PROBE, {"p": 3, "n": n, "l": 1, "pw": 1,
                                     "k": 1, "g": 1, "t": 1, "d": 1, "s": 1,
                                     "z": 3}, wide, True, terms > 0,
                          bool(anti), _accepts)
    assert plan.cluster == 16
    a = sk.ScanArgs.from_engine(*_torch_args(tables))
    want = sk.probe_plain(a, weights, anti, terms > 0)
    got = probe_model(a, weights, anti, terms > 0, plan.cluster)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    node, state, pods = tables
    state.nz_cpu[:SCAN_TRAP] += 1            # off the FMA trap
    a = sk.ScanArgs.from_engine(*_torch_args(tables))
    got = probe_model(a, weights, anti, terms > 0, plan.cluster)
    ensure_x64()                             # as the JAX engine runs it
    j_mask, j_total = jax.jit(_make_probe(weights, anti, terms > 0, True))(
        *_jax_tables(node, state, pods))
    assert np.array_equal(got[0].numpy(), np.asarray(j_mask))
    assert np.array_equal(got[1].numpy(), np.asarray(j_total))


def _torch_args(tables):
    node, state, pods = (type(t)(*(torch.from_numpy(np.ascontiguousarray(x))
                                   for x in t)) for t in tables)
    return node, sk.reciprocals(node), state, pods
