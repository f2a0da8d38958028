"""The port's CUDA kernels against their plain PyTorch versions on the
card, the evidence tool's kernels section, and the live pipeline on the
card against its CPU run. Every test here needs a CUDA device and skips without one. This
file imports nothing of JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import time

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.core import types as api
from kubernetes_tpu_torch.core.quantity import Quantity
from kubernetes_tpu_torch.kubemark.fixtures import (CLUSTER_EDGES, MI,
                                                    SCAN_DEGENERATE,
                                                    SCAN_EDGES, SCAN_TIERS,
                                                    SHARD_CASES,
                                                    mixed_snapshot,
                                                    scan_cases)
from kubernetes_tpu_torch.sched.device import (BatchEngine, ClusterSnapshot,
                                               encode_snapshot)
from kubernetes_tpu_torch.sched.device import filter_kernel, reject_kernel

# the JAX package's pallas-filter test shapes, plus the extender's
FILTER_SHAPES = [(7, 3, 5, 1), (137, 53, 200, 7), (512, 16, 64, 3),
                 (60, 129, 0, 5), (5000, 1, 2000, 7)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n_nodes,n_pods,n_existing,seed", FILTER_SHAPES)
def test_filter_kernel_matches_plain(cuda, n_nodes, n_pods, n_existing,
                                     seed):
    enc = encode_snapshot(mixed_snapshot(seed, n_nodes, n_pods, n_existing))
    engine = BatchEngine(device=cuda)
    args = filter_kernel.FilterArgs.from_engine(*engine.device_args(enc))
    before = filter_kernel.filter_masks.launches
    got = filter_kernel.filter_masks(args)
    torch.cuda.synchronize()
    assert filter_kernel.filter_masks.launches == before + 1
    assert got.dtype == torch.bool and got.shape == (n_pods, n_nodes)
    assert torch.equal(got, filter_kernel.filter_masks_plain(args))
    probe_mask, _ = engine.probe(enc)
    assert torch.equal(got.cpu(), torch.from_numpy(probe_mask))


INT32_MAX, INT32_MIN = 2 ** 31 - 1, -2 ** 31


def _words(rng, shape, density):
    """Random uint32 bitset words, carried as int32 views."""
    bits = (rng.random(shape + (32,)) < density).astype(np.uint64)
    words = (bits << np.arange(32, dtype=np.uint64)).sum(-1)
    return torch.from_numpy(words.astype(np.uint32).view(np.int32))


def _random_args(p, n, widths=(1, 1, 1), seed=0):
    """FilterArgs on the CPU with every edge of the predicates: cap == 0
    (unlimited), cap - used wrapping in int32, requests at INT32_MAX,
    exceeded nodes, zero-request pods, pods pinned to a node, to no node
    (-1), off the table (-2) and past N."""
    rng = np.random.default_rng(seed)
    lw, pw, kw = widths

    def i32(values, size):
        return torch.from_numpy(rng.choice(
            np.array(values, np.int64), size=size).astype(np.int32))

    def flag(prob, size):
        return torch.from_numpy(rng.random(size) < prob)

    host = rng.choice(np.array([-1] * 12 + [-2, 0, n - 1, n + 5]), size=p)
    host = np.where(rng.random(p) < 0.05, rng.integers(0, n, p), host)
    return filter_kernel.FilterArgs(
        valid=flag(0.9, n),
        cpu_cap=i32([0, 1000, 4000, INT32_MAX, INT32_MIN + 5], n),
        mem_cap=i32([0, 2000, 8000, INT32_MIN], n),
        pod_cap=i32([0, 2, 40, 40], n), exceed_cpu=flag(0.05, n),
        exceed_mem=flag(0.05, n), static_mask=flag(0.95, n),
        labels=_words(rng, (n, lw), 0.5),
        cpu_used=i32([0, 100, 900, 3500, 4500], n),
        mem_used=i32([0, 10, 1500, 9000], n),
        pod_count=i32([0, 1, 2, 39], n),
        port_bits=_words(rng, (n, pw), 0.05),
        disk_any=_words(rng, (n, kw), 0.05),
        disk_rw=_words(rng, (n, kw), 0.02),
        pvalid=flag(0.95, p),
        preq_cpu=i32([0, 100, 100, 500, 2000, INT32_MAX], p),
        preq_mem=i32([0, 100, 100, 5000, INT32_MAX], p),
        pzero=flag(0.1, p),
        psel=_words(rng, (p, lw), 0.03 / lw),
        pports=_words(rng, (p, pw), 0.03 / pw),
        pqany=_words(rng, (p, kw), 0.03 / kw),
        pqrw=_words(rng, (p, kw), 0.02 / kw),
        phost=torch.from_numpy(host.astype(np.int32)))


def _on(args, device):
    return filter_kernel.FilterArgs(*(t.to(device) for t in args))


def _kernel_equals_plain(args):
    before = filter_kernel.filter_masks.launches
    got = filter_kernel.filter_masks(args)
    torch.cuda.synchronize()
    assert filter_kernel.filter_masks.launches == before + 1
    assert got.dtype == torch.bool and got.shape == args.shape
    assert torch.equal(got, filter_kernel.filter_masks_plain(args))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 7, 8192])
@pytest.mark.parametrize("n", [1, 3, 4, 5000, 5001, 5003])
def test_filter_kernel_ragged_shapes_match_plain(cuda, p, n):
    # N = 5001 and 5003 start most rows off a 4-byte boundary; N < 4
    # leaves every row a ragged tail
    _kernel_equals_plain(_on(_random_args(p, n, seed=p * 7 + n), cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("widths", [(2, 1, 2), (3, 5, 4)])
def test_filter_kernel_wider_bitsets_match_plain(cuda, widths):
    # (2, 1, 2) takes the two-word instantiation, (3, 5, 4) the general one
    args = _on(_random_args(512, 5001, widths, seed=sum(widths)), cuda)
    assert filter_kernel.launch_plan(*args.shape, *widths).words == \
        (2 if max(widths) == 2 else 0)
    got = _kernel_equals_plain(args)
    assert 0.0 < float(got.float().mean()) < 1.0


def _wide_snapshot(n_nodes, n_pods):
    """A snapshot whose labels, host ports and disks each need three
    bitset words: 80 label values, 70 host ports, 70 disks."""
    nodes = [api.Node(
        metadata=api.ObjectMeta(name=f"w{i:04d}",
                                labels={f"k{i % 80}": "v", "zone": "a"}),
        status=api.NodeStatus(capacity={
            "cpu": Quantity(4000), "memory": Quantity(512 * MI * 1000),
            "pods": Quantity(40 * 1000)})) for i in range(n_nodes)]

    def pod(name, node="", port=None, disk=None, selector=None):
        vols = ([api.Volume(name="d", gce_persistent_disk=(
            api.GCEPersistentDiskVolumeSource(pd_name=disk)))]
            if disk else [])
        return api.Pod(
            metadata=api.ObjectMeta(name=name, namespace="default"),
            spec=api.PodSpec(
                node_name=node, volumes=vols, node_selector=selector or {},
                containers=[api.Container(
                    name="c", image="i",
                    ports=([api.ContainerPort(host_port=port)]
                           if port else []),
                    resources=api.ResourceRequirements(requests={
                        "cpu": Quantity(100),
                        "memory": Quantity(64 * MI * 1000)}))]))

    existing = [pod(f"e{j}", node=f"w{j % n_nodes:04d}", port=9000 + j % 70,
                    disk=f"pd-{j % 70}") for j in range(3 * n_nodes)]
    pending = [pod(f"p{j}", port=9000 + j % 70 if j % 3 == 0 else None,
                   disk=f"pd-{j % 70}" if j % 3 == 1 else None,
                   selector={f"k{j % 80}": "v"} if j % 2 else None)
               for j in range(n_pods)]
    return ClusterSnapshot(nodes=nodes, existing_pods=existing, services=[],
                           controllers=[], pending_pods=pending)


@pytest.mark.gpu
def test_filter_kernel_wide_snapshot_matches_plain_and_probe(cuda):
    enc = encode_snapshot(_wide_snapshot(300, 64))
    assert filter_kernel.supports(enc)
    engine = BatchEngine(device=cuda)
    args = filter_kernel.FilterArgs.from_engine(*engine.device_args(enc))
    widths = (args.labels.shape[1], args.port_bits.shape[1],
              args.disk_any.shape[1])
    assert min(widths) >= 3
    assert filter_kernel.launch_plan(*args.shape, *widths).words == 0
    got = _kernel_equals_plain(args)
    probe_mask, _ = engine.probe(enc)
    assert torch.equal(got.cpu(), torch.from_numpy(probe_mask))
    assert 0.0 < float(got.float().mean()) < 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("fits", [True, False])
def test_filter_kernel_uniform_masks(cuda, fits):
    args = _random_args(96, 5001, seed=3)
    if fits:
        n, p = args.valid.shape[0], args.pvalid.shape[0]
        args = args._replace(
            valid=torch.ones(n, dtype=torch.bool),
            static_mask=torch.ones(n, dtype=torch.bool),
            exceed_cpu=torch.zeros(n, dtype=torch.bool),
            exceed_mem=torch.zeros(n, dtype=torch.bool),
            cpu_cap=torch.zeros(n, dtype=torch.int32),
            mem_cap=torch.zeros(n, dtype=torch.int32),
            pod_cap=torch.ones(n, dtype=torch.int32),
            pod_count=torch.zeros(n, dtype=torch.int32),
            pvalid=torch.ones(p, dtype=torch.bool),
            psel=torch.zeros_like(args.psel),
            pports=torch.zeros_like(args.pports),
            pqany=torch.zeros_like(args.pqany),
            pqrw=torch.zeros_like(args.pqrw),
            phost=torch.full((p,), -1, dtype=torch.int32))
    else:
        args = args._replace(pvalid=torch.zeros_like(args.pvalid))
    got = _kernel_equals_plain(_on(args, cuda))
    assert bool(got.all()) if fits else not bool(got.any())


@pytest.mark.gpu
def test_engine_on_card_matches_cpu(cuda):
    enc = encode_snapshot(mixed_snapshot(3, 300, 96, 200))
    want, _ = BatchEngine(device="cpu").run_chunked(enc, 32)
    got, _ = BatchEngine(device=cuda).run_chunked(enc, 32)
    assert (got == want).all() and (got >= 0).any()


# the evidence tool's shape, a ragged one, and a wide one
REJECT_SHAPES = [(8, 128), (3, 37), (64, 1000)]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols", REJECT_SHAPES)
def test_reject_kernel_matches_plain(cuda, rows, cols):
    rng = np.random.default_rng(rows * cols)
    x = rng.integers(-3, 4, (rows, cols)).astype(np.float32)
    x[:, ::5] = rng.choice(np.array([0.0, -0.0, np.nan, -np.inf, 1e-45],
                                    np.float32), size=x[:, ::5].shape)
    x = torch.from_numpy(x).to(cuda)
    before = reject_kernel.argsort_rows.launches
    got = reject_kernel.argsort_rows(x)
    torch.cuda.synchronize()
    assert reject_kernel.argsort_rows.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (rows, cols)
    assert torch.equal(got, reject_kernel.argsort_rows_plain(x))


# bit patterns: +0, -0, denormals of both signs (the largest too), +inf,
# -inf, and NaNs of both signs with different payloads
SPECIAL_BITS = np.array([0x00000000, 0x80000000, 0x00000001, 0x80000001,
                         0x007FFFFF, 0x7F800000, 0xFF800000, 0x7FC00000,
                         0xFFC00000, 0x7F800001, 0xFFBADBAD, 0x7FFFFFFF],
                        np.uint32)


@pytest.mark.gpu
@pytest.mark.parametrize("cols", [1, 2, 31, 32, 33, 127, 128, 129, 1000,
                                  6144])
def test_reject_kernel_columns_match_plain(cuda, cols):
    # the plain version holds [R, C, C] temporaries: fewer rows as C grows
    rows = 1000 if cols <= 129 else 40 if cols <= 1000 else 3
    rng = np.random.default_rng(cols)
    x = rng.integers(-3, 4, (rows, cols)).astype(np.float32)
    special = rng.random((rows, cols)) < 0.3
    x[special] = rng.choice(SPECIAL_BITS, size=int(special.sum())).view(
        np.float32)
    x = torch.from_numpy(x).to(cuda)
    got = reject_kernel.argsort_rows(x)
    torch.cuda.synchronize()
    assert torch.equal(got, reject_kernel.argsort_rows_plain(x))
    # each row is a permutation of its column indices
    assert torch.equal(got.sort(dim=1).values,
                       torch.arange(cols, dtype=torch.int32, device=cuda)
                       .expand(rows, cols))


@pytest.mark.gpu
@pytest.mark.parametrize("cols", [128, 2000])
def test_refused_launch_raises_and_context_survives(cuda, cols):
    # 128 columns take the warp kernel, 2000 the shared-memory one
    x = torch.ones(8, cols, device=cuda)
    before = reject_kernel.argsort_rows.launches
    with pytest.raises(RuntimeError, match="cudaErrorInvalidConfiguration"):
        reject_kernel.argsort_rows(
            x, block_threads=2 * reject_kernel.MAX_BLOCK_THREADS)
    assert reject_kernel.argsort_rows.launches == before
    got = reject_kernel.argsort_rows(x)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), torch.arange(cols, dtype=torch.int32)
                       .expand(8, cols))


@pytest.mark.gpu
def test_launch_floor_probe_runs_uncounted(cuda):
    from kubernetes_tpu_torch.kubemark.gpu_evidence import launch_floor_ms
    before = reject_kernel.argsort_rows.launches
    reject_kernel.empty_launch(cuda)
    torch.cuda.synchronize()
    assert 0.0 < launch_floor_ms(cuda) < 1.0
    assert reject_kernel.argsort_rows.launches == before


@pytest.mark.gpu
def test_kernels_evidence_section_holds(cuda):
    from kubernetes_tpu_torch.kubemark.gpu_evidence import section_kernels
    out = section_kernels(cuda)
    assert out["ok"], out


@pytest.mark.gpu
def test_turns_against_this_checkout(cuda):
    import os
    from kubernetes_tpu_torch.kubemark.gpu_evidence import (TURNS,
                                                           section_turns)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = section_turns(root, cuda)
    assert set(out["kernels"]) == {"argsort_rows 8x128",
                                   "filter_masks 8192x5000",
                                   "filter_masks 1x5000",
                                   "probe 8192x5000", "probe 1x5000",
                                   "scan_chunk 256x5000",
                                   "scan_chunk 8192x5120",
                                   "victim_search 5120x16",
                                   "prologue 500+1274",
                                   "prologue 5000+5000"}
    for name, rec in out["kernels"].items():
        assert rec["order"] == list(TURNS)
        assert len(rec["ms"]) == len(rec["launch_floor_ms"]) == len(TURNS)
        # K1 at the e2e chunk takes tens of ms; the rest under 10
        top = 1000.0 if name.endswith("8192x5120") else 10.0
        assert all(0.0 < t < top for t in rec["ms"]), (name, rec)
        assert ("library_ms" in rec) == name.startswith("argsort")
        assert rec["smi_samples"] >= 2 and rec["sm_clock_mhz"][2] > 0


def _wait(cond, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def _tiled_pipeline(device, n_nodes=40, n_pods=160, tile=32):
    """The live batch loop over pods that all sit in the FIFO before it
    starts, in tiles of `tile`, so tiles chain on the device carry.
    -> ({pod: node}, chained tiles)."""
    from kubernetes_tpu_torch.api.client import InProcClient
    from kubernetes_tpu_torch.api.registry import Registry
    from kubernetes_tpu_torch.kubemark.benchmark import _bench_pod
    from kubernetes_tpu_torch.sched.batch import BatchScheduler
    from kubernetes_tpu_torch.sched.factory import ConfigFactory
    from kubernetes_tpu_torch.utils.metrics import MetricsRegistry
    metrics = MetricsRegistry()
    client = InProcClient(Registry())
    factory = ConfigFactory(client, rate_limit=False).start()
    sched = None
    try:
        for node in mixed_snapshot(3, n_nodes, 0, 0).nodes:
            client.create("nodes", node)
        assert _wait(lambda: len(factory.node_lister.list()) == n_nodes)
        client.create_batch("pods", [_bench_pod(i) for i in range(n_pods)],
                            "default")
        assert _wait(lambda: len(factory.pod_queue.list()) == n_pods)
        sched = BatchScheduler(factory.create_batch(
            engine=BatchEngine(device=device), tile_size=tile,
            metrics=metrics)).run()
        assert _wait(lambda: all(
            p.spec.node_name for p in client.list("pods", "default")[0]))
        sched.drain_commits()
        return ({p.metadata.name: p.spec.node_name
                 for p in client.list("pods", "default")[0]},
                metrics.counter("batch_tiles_total", {"chained": "true"}))
    finally:
        if sched is not None:
            sched.stop()
        factory.stop()


@pytest.mark.gpu
def test_pipeline_on_card_matches_cpu(cuda):
    from kubernetes_tpu_torch.kubemark.gpu_evidence import section_e2e
    got = section_e2e(20, 200, device=cuda)
    want = section_e2e(20, 200, device="cpu")
    assert got["scheduled"] == want["scheduled"] == 200
    assert (got["counts_sha256"], got["counts_bound"]) == \
        (want["counts_sha256"], want["counts_bound"])
    # the chained path: tiles that start from the previous tile's state
    # on the card bind as the CPU run does
    card, chained = _tiled_pipeline(cuda)
    cpu, _ = _tiled_pipeline("cpu")
    assert chained > 0
    assert card == cpu and all(card.values())


# ------------------------------------------------- K3: dirty-row scatter

def _scatter_columns(n, device, rng):
    """One column of every kind the mirror holds, plus two whose rows
    start off their word: an int32 [N, 3] column sliced one row in, and
    an int32 [N, 2] column of 8-byte rows at a 4-byte address."""
    def i(dtype, *shape):
        return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, shape)
                                .astype(dtype)).to(device)
    cols = [torch.from_numpy(rng.random(n) < 0.5).to(device),
            i(np.int32, n), i(np.int64, n), i(np.int32, n, 1),
            i(np.int32, n, 3), i(np.int32, n + 1, 3)[1:],
            i(np.int32, 2 * n + 1)[1:].view(n, 2)]
    return cols


def _scatter_rows_for(cols, r, rng):
    rows = []
    for t in cols:
        shape = (r,) + tuple(t.shape[1:])
        if t.dtype == torch.bool:
            rows.append(rng.random(shape) < 0.5)
        else:
            dt = np.int64 if t.dtype == torch.int64 else np.uint32
            rows.append(rng.integers(0, 2 ** 32, shape).astype(dt))
    return rows


@pytest.mark.gpu
@pytest.mark.parametrize("n,r", [(1, 1), (5000, 1), (5000, 7), (37, 13),
                                 (5001, 5001), (5120, 5000)])
def test_scatter_kernel_matches_plain(cuda, n, r):
    from kubernetes_tpu_torch.sched.device import scatter_kernel as sk
    rng = np.random.default_rng(n * 7 + r)
    cols = _scatter_columns(n, cuda, rng)
    assert cols[-1].data_ptr() % 8 == 4
    idx = rng.choice(n, r, replace=False).astype(np.int64)
    rows = _scatter_rows_for(cols, r, rng)
    plain = [c.clone() for c in cols]
    library = [c.clone() for c in cols]
    before = sk.launch_staged.launches
    moved = sk.scatter_rows(cols, idx, rows)
    torch.cuda.synchronize()
    assert sk.launch_staged.launches == before + 1
    assert moved == 8 * r + sum(a.nbytes for a in rows)
    pro = sk.Prologue()
    pro.scatter(plain, idx, rows)
    sk.prologue_plain(pro.stage(cuda))
    for t, a in zip(library, rows):
        t.index_copy_(0, torch.from_numpy(idx).to(cuda),
                      torch.from_numpy(sk._host_view(a)).to(cuda))
    for got, want, lib in zip(cols, plain, library):
        assert torch.equal(got, want) and torch.equal(got, lib)


@pytest.mark.gpu
def test_mirror_on_card_matches_cpu(cuda):
    """The engine's delta path on the card: the same churn through a
    card engine and a CPU engine, each with its mirror; the scatter
    kernel launched, both arms' assignments and tile counts equal."""
    from kubernetes_tpu_torch.sched.device import scatter_kernel as sk
    from kubernetes_tpu_torch.sched.device.incremental import \
        IncrementalEncoder
    rng = np.random.default_rng(4)
    inc = IncrementalEncoder()
    snap = mixed_snapshot(5, 300, 0, 0)
    for node in snap.nodes:
        inc.on_node_add(node)
    card, cpu = BatchEngine(device=cuda), BatchEngine(device="cpu")
    before = sk.launch_staged.launches
    for tick in range(4):
        pods = mixed_snapshot(tick, 300, 40, 0).pending_pods
        for p in pods:
            p.metadata.name = f"t{tick}-{p.metadata.name}"
            p.spec.node_name = ""
            p.spec.containers[0].ports = []
            p.spec.volumes = []
        enc = inc.encode_tile(pods, [], [])
        got, _ = card.run_chunked(enc, 64)
        want, _ = cpu.run_chunked(enc, 64)
        assert (got == want).all() and (got >= 0).any()
        inc.assume_assigned(enc, pods, want)
        if tick == 1:
            node = snap.nodes[int(rng.integers(300))]
            inc.on_node_delete(node)
    assert sk.launch_staged.launches > before
    assert card.upload_stats == cpu.upload_stats
    assert card.upload_stats["delta_tiles"] >= 1


# ------------------------------------------------- K4: victim search

def _random_victim_args(n, v, seed, device, zero_req=False, prio=None):
    """Victim tables with every edge: capacities of 0 (unlimited), pod
    caps at or under the count, victims unsorted and with holes in the
    valid mask, priorities around the preemptor's."""
    from kubernetes_tpu_torch.sched.device import victim_kernel as vk
    rng = np.random.default_rng(seed)

    def i64(lo, hi, *shape):
        return torch.from_numpy(rng.integers(lo, hi, shape)).to(device)
    return vk.VictimArgs(
        cand=torch.from_numpy(rng.random(n) < 0.8).to(device),
        cpu_cap=i64(0, 4000, n) * (i64(0, 5, n) > 0),
        mem_cap=i64(0, 4000, n), pod_cap=i64(0, 40, n),
        cpu_used=i64(0, 5000, n), mem_used=i64(0, 5000, n),
        pod_count=i64(0, 40, n),
        tie_rank=torch.from_numpy(rng.permutation(n)).to(device),
        v_prio=i64(-1000, 1000, n, v), v_cpu=i64(0, 900, n, v),
        v_mem=i64(0, 900, n, v),
        v_valid=torch.from_numpy(rng.random((n, v)) < 0.8).to(device),
        prio=int(rng.integers(-500, 500)) if prio is None else prio,
        req_cpu=0 if zero_req else int(rng.integers(1, 3000)),
        req_mem=0 if zero_req else int(rng.integers(0, 3000)),
        zero_req=zero_req)


def _victims_equal_plain(args):
    from kubernetes_tpu_torch.sched.device import victim_kernel as vk
    before = vk.victim_search.launches
    pick, kstar, score = vk.victim_search(args)
    torch.cuda.synchronize()
    assert vk.victim_search.launches == before + 1
    p_pick, p_kstar, p_score = vk.victim_search_plain(args)
    assert int(pick) == int(p_pick)
    assert torch.equal(kstar, p_kstar) and torch.equal(score, p_score)
    return int(pick), kstar, score


@pytest.mark.gpu
@pytest.mark.parametrize("n,v", [(1, 1), (7, 1), (255, 3), (256, 16),
                                 (257, 16), (5000, 16), (5120, 32),
                                 (5001, 1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_victim_kernel_matches_plain(cuda, n, v, seed):
    _victims_equal_plain(_random_victim_args(n, v, seed, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("v", [1, 8, 16, 33, 64])
@pytest.mark.parametrize("n", [1, 31, 5000, 5120])
def test_victim_kernel_on_its_grid_matches_plain(cuda, n, v):
    """The preempt fixture's widths and the chunk edges, one launch
    each, bit-equal to the plain version; with a zero-request preemptor
    and on a fleet where nothing is feasible."""
    from kubernetes_tpu_torch.sched.device import victim_kernel as vk
    for kw in ({}, {"zero_req": True}, {"prio": -2000}):
        args = _random_victim_args(n, v, n + v, cuda, **kw)
        if "prio" in kw:
            args = args._replace(pod_count=args.pod_cap.clone())
        want = vk.victim_search_plain(args)
        before = vk.victim_search.launches
        got = vk.victim_search(args)
        torch.cuda.synchronize()
        assert vk.victim_search.launches == before + 1
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        if "prio" in kw:
            assert int(want[0]) == 0 and bool((want[2] == -1).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 300, 5000])
def test_victim_kernel_all_infeasible_picks_zero(cuda, n):
    # nothing evictable (every victim outranks) and no room anywhere
    args = _random_victim_args(n, 8, n, cuda, prio=-2000)
    args = args._replace(pod_count=args.pod_cap.clone())
    pick, kstar, score = _victims_equal_plain(args)
    assert pick == 0 and bool((score == -1).all())
    assert bool((kstar == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n,v", [(64, 1), (5000, 16)])
def test_victim_kernel_zero_request(cuda, n, v):
    pick, kstar, score = _victims_equal_plain(
        _random_victim_args(n, v, 9, cuda, zero_req=True))
    assert bool((score >= 0).any())


@pytest.mark.gpu
def test_find_victims_on_card_equals_the_oracle(cuda):
    """The engine's victim search through the kernel on an encoder's
    tables: equal to the serial oracle, field for field."""
    from kubernetes_tpu_torch.kubemark import fixtures as fx
    from kubernetes_tpu_torch.sched.preemption import oracle_find_victims
    spec = fx.preempt_spec(n_nodes=300, n_preemptors=16)
    inc = fx.preempt_encoder(spec)
    engine = BatchEngine(device=cuda)
    for pod in fx.preempt_pods(spec):
        table = inc.victim_table(pod)
        got, want = engine.find_victims(table), oracle_find_victims(table)
        assert (got.pick, got.kstar, got.feasible) == \
            (want.pick, want.kstar, want.feasible)
        assert np.array_equal(got.node_kstar, want.node_kstar)
        assert np.array_equal(got.node_score, want.node_score)
        assert got.victim_keys(table) == want.victim_keys(table)


@pytest.mark.gpu
def test_refused_victim_launch_raises_through_find_victims(cuda):
    from kubernetes_tpu_torch.kubemark import fixtures as fx
    from kubernetes_tpu_torch.sched.device import victim_kernel as vk
    spec = fx.preempt_spec(n_nodes=40, n_preemptors=2)
    table = fx.preempt_encoder(spec).victim_table(fx.preempt_pods(spec)[1])
    engine = BatchEngine(device=cuda)
    real = vk._launch
    before = vk.victim_search.launches
    try:
        vk._launch = lambda a, out, plan: real(
            a, out, plan._replace(threads=2048))
        with pytest.raises(RuntimeError, match="victim kernel launch"):
            engine.find_victims(table)
    finally:
        vk._launch = real
    assert vk.victim_search.launches == before
    assert engine.find_victims(table).pick >= 0


@pytest.mark.gpu
def test_refused_scatter_launch_raises_through_run_chunked(cuda):
    """No fallback: a refused scatter launch in the real one's place
    makes run_chunked raise on a tile off the mirror; the mirror's
    generations move only past scatters that landed, so the same tile
    then scatters again and binds as the CPU engine does."""
    from kubernetes_tpu_torch.kubemark import fixtures as fx
    from kubernetes_tpu_torch.sched.device import scatter_kernel as sk
    inc = fx.preempt_encoder(fx.preempt_spec(n_nodes=64, n_preemptors=0))
    tile = [fx._preempt_pod(f"z{i}", "", 0, 0, 0) for i in range(8)]
    engine = BatchEngine(device=cuda)
    enc = inc.encode_tile(tile, [], [])
    assigned, _ = engine.run_chunked(enc, 8)
    inc.assume_assigned(enc, tile, assigned)
    enc = inc.encode_tile(tile[:1], [], [])
    ones = torch.ones(8, 128, device=cuda)
    scratch = torch.empty(8, 128, dtype=torch.int32, device=cuda)
    real = sk._launch
    before = sk.launch_staged.launches
    try:
        sk._launch = lambda staged: reject_kernel._launch(
            ones, scratch, reject_kernel.launch_plan(
                8, 128, 2 * reject_kernel.MAX_BLOCK_THREADS))
        with pytest.raises(RuntimeError, match="scatter kernel launch"):
            engine.run_chunked(enc, 8)
    finally:
        sk._launch = real
    assert sk.launch_staged.launches == before
    got, _ = engine.run_chunked(enc, 8)
    want, _ = BatchEngine(device="cpu").run_chunked(enc, 8)
    assert (got == want).all()
    assert sk.launch_staged.launches == before + 1


# the scan (K1) and probe (K5) kernels on the cases chip_smoke's scan
# phase runs: each tier and each edge in both layouts
SCAN_CASES = scan_cases()


def _scan_parity(cuda, name):
    from kubernetes_tpu_torch.kubemark.fixtures import scan_tables
    from kubernetes_tpu_torch.kubemark.gpu_evidence import (scan_args,
                                                            scan_parity)
    from kubernetes_tpu_torch.sched.device import engine as eng
    from kubernetes_tpu_torch.sched.device import scan_kernel as sk
    case = SCAN_CASES[name]
    a = scan_args(*(eng._upload(t, cuda)
                    for t in scan_tables(**case["tables"])))
    before = (sk.scan_chunk.launches, sk.probe.launches)
    got = scan_parity(a, case["weights"], case["anti_weight"],
                      case["has_aff"], case["has_spread"])
    # K5 on its three launches: the case's pods, a block a pod, pod 0
    assert (sk.scan_chunk.launches, sk.probe.launches) == \
        (before[0] + 1, before[1] + 3)
    clusters = got["probe_clusters"]
    assert clusters["probe_block"] == 1 and clusters["probe_p1"] >= 8
    assert got["equal"], [f for f, ok in got["fields"].items() if not ok]
    assert got["max_abs_err"] == 0
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(
    c for c in SCAN_CASES if c.split("/")[0] in SCAN_TIERS))
def test_scan_and_probe_kernels_match_plain(cuda, name):
    assert _scan_parity(cuda, name)["placed"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(
    c for c in SCAN_CASES if c.split("/")[0] in SCAN_EDGES))
def test_scan_and_probe_kernels_match_plain_at_the_edges(cuda, name):
    got = _scan_parity(cuda, name)
    assert (got["placed"] == 0) == (name.split("/")[0] in SCAN_DEGENERATE)


@pytest.mark.gpu
def test_scan_kernel_carries_across_chunks(cuda):
    """Two launches over halves of a batch, the State carried on the
    card, equal one plain run over the whole batch."""
    from kubernetes_tpu_torch.kubemark.fixtures import scan_tables
    from kubernetes_tpu_torch.kubemark.gpu_evidence import scan_args
    from kubernetes_tpu_torch.sched.device import engine as eng
    from kubernetes_tpu_torch.sched.device import scan_kernel as sk
    tables = scan_tables(5, 96, 700, False, 2, 2, 2)
    a = scan_args(*(eng._upload(t, cuda) for t in tables))
    b = a._replace(state=eng._clone_state(a.state))
    got = torch.cat([sk.scan_chunk(a.pod_slice(lo, lo + 48), (1, 1, 1), 2,
                                   True, True) for lo in (0, 48)])
    want = sk.scan_chunk_plain(b, (1, 1, 1), 2, True, True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert all(torch.equal(x, y) for x, y in zip(a.state, b.state))


def refused_plan(plan):
    """A launch the card refuses: K1 on a cluster of 32 CTAs (past the
    16 it takes), K5 with 2048 threads a block."""
    from kubernetes_tpu_torch.sched.device import scan_kernel as sk
    if plan.kind == sk.SCAN:
        return plan._replace(cluster=2 * sk.MAX_CLUSTER,
                             grid=2 * sk.MAX_CLUSTER)
    return plan._replace(threads=2048)


@pytest.mark.gpu
def test_refused_scan_and_probe_launches_raise_through_the_engine(cuda):
    from kubernetes_tpu_torch.sched.device import scan_kernel as sk
    enc = encode_snapshot(mixed_snapshot(7, 64, 8, 10))
    # 160 pods take K5's block a pod, 8 its cluster a pod
    batch = encode_snapshot(mixed_snapshot(7, 64, 160, 10))
    engine = BatchEngine(device=cuda)
    real = sk._launch
    before = (sk.scan_chunk.launches, sk.probe.launches)
    try:
        sk._launch = lambda plan, dims, ptrs, device: real(
            refused_plan(plan), dims, ptrs, device)
        with pytest.raises(RuntimeError, match="scan kernel launch"):
            engine.run_chunked(enc, 8)
        for e in (enc, batch):
            with pytest.raises(RuntimeError, match="probe kernel launch"):
                engine.probe(e)
    finally:
        sk._launch = real
    assert (sk.scan_chunk.launches, sk.probe.launches) == before
    cpu = BatchEngine(device="cpu")
    assert (engine.run_chunked(enc, 8)[0] == cpu.run_chunked(enc, 8)[0]).all()
    for e in (enc, batch):
        for x, y in zip(engine.probe(e), cpu.probe(e)):
            assert (x == y).all()


@pytest.mark.gpu
@pytest.mark.parametrize("plain", [True, False])
def test_engine_on_card_matches_cpu_on_the_smoke_fixture(cuda, plain):
    """The smoke's engine fixture (node-local, or SelectorSpread with the
    `web` service) at 600 nodes x 2000 pods: one kernel launch a chunk,
    no eager step, the CPU engine's assignment and probe."""
    from kubernetes_tpu_torch.kubemark.fixtures import engine_snapshot
    from kubernetes_tpu_torch.sched.device import scan_kernel as sk
    enc = encode_snapshot(engine_snapshot(600, 2000, plain),
                          pod_pad_to=2048)
    card, cpu = BatchEngine(device=cuda), BatchEngine(device="cpu")
    before = sk.scan_chunk.launches
    got, _ = card.run_chunked(enc, 512)
    assert sk.scan_chunk.launches == before + 4
    assert card.scan_stats["eager_steps"] == 0
    want, _ = cpu.run_chunked(enc, 512)
    assert (got == want).all() and (got[:enc.n_pods] >= 0).all()
    for x, y in zip(card.probe(enc), cpu.probe(enc)):
        assert (x == y).all()


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CLUSTER_EDGES))
@pytest.mark.parametrize("tiers", [(0, 0, 0), (1, 1, 1)])
def test_scan_kernel_matches_plain_at_the_cluster_edges(cuda, name, tiers):
    """N below C x threads, one slot, fewer slots than CTAs (empty
    ranges), every slot fitting, pods pinned to slots of other CTAs."""
    from kubernetes_tpu_torch.kubemark.fixtures import cluster_edge_tables
    from kubernetes_tpu_torch.kubemark.gpu_evidence import scan_args
    from kubernetes_tpu_torch.sched.device import engine as eng
    from kubernetes_tpu_torch.sched.device import scan_kernel as sk
    kw = CLUSTER_EDGES[name]
    tables = cluster_edge_tables(name)
    a = scan_args(*(eng._upload(t, cuda) for t in tables))
    b = a._replace(state=eng._clone_state(a.state))
    spread, aff, anti = tiers
    flags = ((1, 1, 1), 2 * anti, bool(aff), bool(spread))
    got = sk.scan_chunk(a, *flags)
    want = sk.scan_chunk_plain(b, *flags)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert all(torch.equal(x, y) for x, y in zip(a.state, b.state))
    if name == "every_fits":
        assert (got >= 0).all()
    if name == "pinned_across":
        pins = kw["pins"]
        assert got[8:8 + len(pins)].cpu().tolist() == list(pins)


@pytest.mark.gpu
def test_run_chunked_by_1024_equals_one_long_run(cuda):
    """Eight launches of 1024 pods, the State carried on the card,
    equal one launch of the whole batch and the CPU engine."""
    from kubernetes_tpu_torch.kubemark.fixtures import engine_snapshot
    from kubernetes_tpu_torch.sched.device import scan_kernel as sk
    enc = encode_snapshot(engine_snapshot(1000, 8192, False),
                          pod_pad_to=8192)
    card = BatchEngine(device=cuda)
    before = sk.scan_chunk.launches
    chunked, state_a = card.run_chunked(enc, 1024)
    assert sk.scan_chunk.launches == before + 8
    assert card.scan_stats["device_ms"] > 0
    long, state_b = card.run_chunked(enc, 8192)
    assert (chunked == long).all() and (chunked >= 0).any()
    assert all(torch.equal(x, y) for x, y in zip(state_a, state_b))
    want, _ = BatchEngine(device="cpu").run_chunked(enc, 8192)
    assert (chunked == want).all()


@pytest.mark.gpu
def test_scan_plan_runs_16_ctas_on_the_card(cuda):
    """The card schedules K1's 16-CTA cluster at the e2e chunk's and at
    the 20480-slot fleet's shared memory, in both layouts."""
    from kubernetes_tpu_torch.sched.device import scan_kernel as sk
    d = {"p": 8192, "n": 5120, "l": 1, "pw": 1, "k": 1, "g": 1, "t": 1,
         "d": 1, "s": 1, "z": 1}
    for n in (5120, 20480):
        for wide in (False, True):
            plan = sk.launch_plan(sk.SCAN, {**d, "n": n}, wide, False,
                                  False, False)
            assert plan.cluster == 16 and plan.grid == 16, plan


@pytest.mark.gpu
def test_probe_kernel_matches_plain_at_the_main_path_shapes(cuda):
    """K5 at 8192 x 5000 (the mixed snapshot) and 1 x 5000 (the
    extender's pod), bit-equal to its plain version."""
    from kubernetes_tpu_torch.kubemark.gpu_evidence import scan_args
    from kubernetes_tpu_torch.sched.device import scan_kernel as sk
    enc = encode_snapshot(mixed_snapshot(7, 5000, 8192, 20000))
    engine = BatchEngine(device=cuda)
    big = scan_args(*engine.device_args(enc))
    for a in (big, big.pod_slice(1, 2)):
        mask, total = sk.probe(a, engine.weights, 0, False)
        p_mask, p_total = sk.probe_plain(a, engine.weights, 0, False)
        torch.cuda.synchronize()
        assert torch.equal(mask, p_mask) and torch.equal(total, p_total)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CLUSTER_EDGES))
def test_probe_kernel_matches_plain_at_the_cluster_edges(cuda, name):
    """K5 at K1's cluster edges (one slot, fewer slots than CTAs, a slot
    past a multiple of 16, every slot fitting, pinned pods), every tier
    on and none, on its three launches: the edge's pods, a block a pod,
    the first pod alone on a cluster of 16 CTAs."""
    from kubernetes_tpu_torch.kubemark.fixtures import cluster_edge_tables
    from kubernetes_tpu_torch.kubemark.gpu_evidence import scan_args
    from kubernetes_tpu_torch.sched.device import engine as eng
    from kubernetes_tpu_torch.sched.device import scan_kernel as sk
    a = scan_args(*(eng._upload(t, cuda) for t in cluster_edge_tables(name)))
    for flags in (((1, 1, 1), 0, False), ((2, 3, 5), 4, True)):
        want = sk.probe_plain(a, *flags)
        for b, sms, rows in ((a, None, slice(None)), (a, 1, slice(None)),
                             (a.pod_slice(0, 1), None, slice(0, 1))):
            got = sk.probe(b, *flags, sms=sms)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0][rows])
            assert torch.equal(got[1], want[1][rows])


# ------------------------------------- K3: a delta tile's prologue


@pytest.mark.gpu
@pytest.mark.parametrize("r_node,r_state", [(1, 1), (500, 1274), (37, 0),
                                            (0, 900), (5000, 5000)])
def test_prologue_kernel_matches_plain_and_the_old_path(cuda, r_node,
                                                        r_state):
    """One launch of the scatter kernel over a delta tile's prologue on
    the e2e fleet's tables, its rows spread over the whole table: the
    mirror and the run's State bit-equal to the plain version over the
    same staging buffer and to the two one-table scatters plus
    _clone_state (the State copy skips the rows the scatter writes)."""
    from kubernetes_tpu_torch.kubemark.gpu_evidence import (prologue_staged,
                                                            prologue_tables)
    from kubernetes_tpu_torch.sched.device import engine as eng
    from kubernetes_tpu_torch.sched.device import scatter_kernel as sk
    sides = {}
    for who in ("kernel", "plain", "old"):
        node, state, nr, sr = prologue_tables(cuda, max(r_node, 1),
                                              max(r_state, 1))
        nr = (nr[0][:r_node], [a[:r_node] for a in nr[1]])
        sr = (sr[0][:r_state], [a[:r_state] for a in sr[1]])
        sides[who] = (node, state, nr, sr)
    node, state, nr, sr = sides["kernel"]
    pro = sk.Prologue()
    run = eng._alloc_like(state)
    g = None
    if r_node:
        pro.scatter([getattr(node, f) for f in eng._NODE_ROW_FIELDS], *nr)
    if r_state:
        g = pro.scatter([getattr(state, f) for f in eng._STATE_ROW_FIELDS],
                        *sr, also=[getattr(run, f)
                                   for f in eng._STATE_ROW_FIELDS])
    for f in eng.State._fields:
        pro.copy(getattr(run, f), getattr(state, f),
                 skip=g if f in eng._STATE_ROW_FIELDS else None)
    before = sk.launch_staged.launches
    sk.apply_staged(pro.stage(cuda))
    assert sk.launch_staged.launches == before + 1
    if r_node and r_state:
        p_node, p_state, p_nr, p_sr = sides["plain"]
        staged, p_run = prologue_staged(sk, cuda, p_node, p_state, p_nr, p_sr)
        sk.prologue_plain(staged)
    o_node, o_state, o_nr, o_sr = sides["old"]
    for tab, fields, (idx, rows) in ((o_node, eng._NODE_ROW_FIELDS, o_nr),
                                     (o_state, eng._STATE_ROW_FIELDS, o_sr)):
        if idx.size:
            sk.scatter_rows([getattr(tab, f) for f in fields], idx, rows)
    o_run = eng._clone_state(o_state)
    torch.cuda.synchronize()
    for got, want in zip((*node, *state, *run), (*o_node, *o_state, *o_run)):
        assert torch.equal(got, want)
    if r_node and r_state:
        for got, want in zip((*node, *state, *run),
                             (*p_node, *p_state, *p_run)):
            assert torch.equal(got, want)


@pytest.mark.gpu
def test_delta_tile_is_one_launch_and_one_copy(cuda):
    """A delta tile through run_chunked: one scatter launch and, by
    torch.profiler, one host-to-device copy for its prologue."""
    from kubernetes_tpu_torch.kubemark.gpu_evidence import profile_counts
    from kubernetes_tpu_torch.sched.device import scatter_kernel as sk
    from kubernetes_tpu_torch.sched.device.incremental import \
        IncrementalEncoder
    inc = IncrementalEncoder()
    snap = mixed_snapshot(5, 300, 0, 0)
    for node in snap.nodes:
        inc.on_node_add(node)
    engine = BatchEngine(device=cuda)
    for tick in range(2):
        pods = mixed_snapshot(tick, 300, 40, 0).pending_pods
        for p in pods:
            p.metadata.name = f"t{tick}-{p.metadata.name}"
            p.spec.node_name = ""
            p.spec.containers[0].ports = []
            p.spec.volumes = []
        enc = inc.encode_tile(pods, [], [])
        if tick:
            before = sk.launch_staged.launches
            flags = engine._enc_flags(enc)
            prof = profile_counts(lambda: engine._prologue(enc, flags, 64))
            assert sk.launch_staged.launches == before + 1
            assert prof["copy_calls"] <= 1 and prof["h2d_copies"] <= 1
            assert prof["launch_calls"] <= 1 and prof["kernels"] <= 1
            assert engine.upload_stats["delta_tiles"] == 1
            return
        got, _ = engine.run_chunked(enc, 64)
        inc.assume_assigned(enc, pods, got)


# ------------------------------------------- K6: speculative engine


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SCAN_CASES))
def test_spec_kernels_match_plain_and_k1(cuda, name):
    """K6a, K6b and the whole chunk (blocks of 256 and 7) bit-equal to
    their plain versions and K1 on each scan case's tables, on K6's
    tiers (the case's spread tier, no affinity, no ANTI)."""
    from kubernetes_tpu_torch.kubemark.fixtures import scan_tables
    from kubernetes_tpu_torch.kubemark.gpu_evidence import (scan_args,
                                                            spec_parity)
    from kubernetes_tpu_torch.sched.device import engine as eng
    from kubernetes_tpu_torch.sched.device import spec_kernel as spk
    case = SCAN_CASES[name]
    a = scan_args(*(eng._upload(t, cuda)
                    for t in scan_tables(**case["tables"])))
    before = (spk.spec_pass.launches, spk.spec_repair.launches)
    got = spec_parity(a, case["weights"], case["has_spread"])
    assert spk.spec_pass.launches > before[0]
    assert spk.spec_repair.launches > before[1]
    assert got["equal"], [f for f, ok in got["fields"].items() if not ok]
    assert got["max_abs_err"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("plain", [True, False])
def test_spec_engine_on_card_matches_the_scan(cuda, plain):
    """BatchEngine(speculative=True).run_chunked at the smoke's engine
    fixture (1000 nodes, 3000 pods) binds as the scan engine and the CPU
    speculative engine, every chunk through K6."""
    from kubernetes_tpu_torch.kubemark.fixtures import (engine_snapshot,
                                                        smoke_pod_pad)
    enc = encode_snapshot(engine_snapshot(1000, 3000, plain=plain),
                          pod_pad_to=smoke_pod_pad(3000))
    spec = BatchEngine(device=cuda, speculative=True)
    got, g_state = spec.run_chunked(enc, 1024)
    want, w_state = BatchEngine(device=cuda).run_chunked(enc, 1024)
    assert np.array_equal(got, want)
    assert all(torch.equal(x, y) for x, y in zip(g_state, w_state))
    assert spec.scan_stats["spec_chunks"] == enc.pod_batch.valid.shape[0] \
        // 1024
    assert spec.scan_stats["eager_steps"] == 0


@pytest.mark.gpu
def test_refused_spec_launches_raise_through_run_chunked(cuda):
    """No fallback: a K6a or K6b launch the card refuses (2048 threads a
    block) raises through run_chunked, counted nowhere; restored, the
    engine equals the CPU's."""
    from kubernetes_tpu_torch.sched.device import spec_kernel as spk
    enc = encode_snapshot(mixed_snapshot(7, 64, 8, 10))
    engine = BatchEngine(device=cuda, speculative=True)
    real = spk._launch
    for kind, fn in ((spk.PASS, spk.spec_pass),
                     (spk.REPAIR, spk.spec_repair)):
        before = fn.launches
        try:
            spk._launch = lambda p, *rest, kind=kind: real(
                p._replace(threads=2048) if p.kind == kind else p, *rest)
            with pytest.raises(RuntimeError, match="speculative"):
                engine.run_chunked(enc, 8)
        finally:
            spk._launch = real
        assert fn.launches == before
    got, _ = engine.run_chunked(enc, 8)
    want, _ = BatchEngine(device="cpu", speculative=True).run_chunked(enc, 8)
    assert (got == want).all()


@pytest.mark.gpu
@pytest.mark.parametrize("wide", [False, True])
def test_spec_latch_mid_block_hands_off_and_back(cuda, wide):
    """A spread group latches in the middle of a block: its later pods
    take the full-width rescore while the other groups' pods stay on
    K6b's pipeline, so the pipeline hands a step to the full width and
    takes the next one back within the block (the plain run's slow marks
    show it). The chunk at blocks of 256 equals its plain version
    (picks, slow marks, State) and K1."""
    from kubernetes_tpu_torch.kubemark.fixtures import scan_tables
    from kubernetes_tpu_torch.kubemark.gpu_evidence import (scan_args,
                                                            spec_parity)
    from kubernetes_tpu_torch.sched.device import engine as eng
    from kubernetes_tpu_torch.sched.device import spec_kernel as spk
    tables = scan_tables(seed=23, p=512, n=5120, wide=wide, groups=3,
                         terms=0, services=0)
    w = eng.DEFAULT_WEIGHTS
    plain = scan_args(*(eng._upload(t, "cpu") for t in tables))
    slow = torch.zeros(512, dtype=torch.bool)
    spk.spec_run_plain(plain, w, True, 256, slow)
    valid = plain.pods.valid.tolist()
    back = [i for i in range(511) if slow[i] and not slow[i + 1]
            and valid[i + 1] and (i + 1) % 256]
    assert back, "no pod returns to the pipeline after a slow one"
    a = scan_args(*(eng._upload(t, cuda) for t in tables))
    got = spec_parity(a, w, True, blocks=(256,))
    assert got["slow"] == int(slow.sum()) > 0
    assert got["equal"], [f for f, ok in got["fields"].items() if not ok]
    assert got["max_abs_err"] == 0


# ---------------------------------------------------------------- the mesh


SHARD_CASE_NAMES = sorted(name for name in scan_cases()
                          if name.split("/")[0] in SHARD_CASES)


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("name", SHARD_CASE_NAMES)
def test_sharded_scan_kernel_matches_its_twin_and_k1(cuda, name, shards):
    """The sharded K1 (K7 inside) on the scan cases' tables: the
    assignment and every State field bit-equal to the unsharded K1 and
    to the sharded plain twin, every shard's replicas equal to the
    State's after the chunk."""
    from kubernetes_tpu_torch.kubemark import gpu_evidence
    from kubernetes_tpu_torch.kubemark.fixtures import scan_tables, shard_pad
    from kubernetes_tpu_torch.sched.device import engine as eng_mod
    from kubernetes_tpu_torch.sched.device import scan_kernel as sk
    case = scan_cases()[name]
    tables = shard_pad(scan_tables(**case["tables"]), shards)
    a = gpu_evidence.scan_args(*(eng_mod._upload(t, cuda) for t in tables))
    before = sk.scan_chunk_sharded.launches
    got = gpu_evidence.shard_parity(a, case["weights"], case["anti_weight"],
                                    case["has_aff"], case["has_spread"],
                                    shards)
    assert sk.scan_chunk_sharded.launches == before + 1
    assert got["equal"], [f for f, ok in got["fields"].items() if not ok]


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_victim_kernel_matches_its_twin(cuda, shards):
    from kubernetes_tpu_torch.kubemark import gpu_evidence
    from kubernetes_tpu_torch.kubemark.fixtures import (preempt_encoder,
                                                        preempt_pods,
                                                        preempt_spec)
    from kubernetes_tpu_torch.sched.device import victim_kernel as vk
    spec = preempt_spec(n_nodes=600, n_preemptors=4)
    inc = preempt_encoder(spec)
    for pod in preempt_pods(spec):
        args = vk.VictimArgs.from_table(inc.victim_table(pod), cuda)
        got = gpu_evidence.victim_shard_parity(args, shards)
        assert got["equal"], got


@pytest.mark.gpu
def test_mesh_engine_on_card_matches_cpu_mesh(cuda):
    """BatchEngine(mesh=NodeMesh(["cuda:0"] * 4)) on a smoke-sized fixture
    equals the CPU mesh and the unsharded card engine."""
    from kubernetes_tpu_torch.kubemark.fixtures import engine_snapshot
    from kubernetes_tpu_torch.sched.device import NodeMesh
    from kubernetes_tpu_torch.sched.device import scan_kernel as sk
    snap = engine_snapshot(400, 900, plain=False)
    before = sk.scan_chunk_sharded.launches
    card = BatchEngine(mesh=NodeMesh(["cuda:0"] * 4)).schedule(snap,
                                                               chunk=512)[0]
    assert sk.scan_chunk_sharded.launches > before
    assert card == BatchEngine(mesh=NodeMesh(["cpu"] * 4)).schedule(
        snap, chunk=512)[0]
    assert card == BatchEngine(device=cuda).schedule(snap, chunk=512)[0]


@pytest.mark.gpu
def test_wedged_exchange_raises(cuda):
    """A shard that withholds a record traps the launch (in a process of
    its own): the synchronize raises instead of hanging."""
    from kubernetes_tpu_torch.kubemark import gpu_evidence
    got = gpu_evidence.shard_wedge_child()
    assert got["raised"] and got["rc"] == 0, got
