"""The port's speculative engine (K6),
`kubernetes_tpu_torch.sched.device.spec_kernel`, on the CPU: its plain
versions equal the JAX engine's `_make_spec_pass` and `_make_spec_run`
(assignment and final State, field for field) and the port's own scan,
on the node-local and spread tiers, in the i32-narrowed and the
i64-wide layout, at blocks of 1, 7 and 256 pods; the counterparts of
the JAX package's six speculative tests (tests/test_device_parity.py);
and BatchEngine's route. Every quantity is an integer or an f64 floor:
tolerance 0. The kernels themselves run on the card
(tests/test_torch_gpu.py)."""

import functools

import jax
import numpy as np
import pytest
import torch

from kubernetes_tpu.core import types as jax_api
from kubernetes_tpu.sched.device import BatchEngine as JaxEngine
from kubernetes_tpu.sched.device import ClusterSnapshot as JaxSnapshot
from kubernetes_tpu.sched.device.engine import (_make_spec_pass,
                                               _make_spec_run)
from kubernetes_tpu.sched.device.tables import \
    encode_snapshot as jax_encode
from kubernetes_tpu_torch.sched.device import BatchEngine
from kubernetes_tpu_torch.sched.device import engine as port_engine
from kubernetes_tpu_torch.sched.device import scan_kernel as sk
from kubernetes_tpu_torch.sched.device import spec_kernel as spk

from test_device_parity import (MI, bq, make_node, mq, oracle_schedule,
                                rand_cluster)
from test_torch_encode import POLICY, encodings, port_policy, to_port
from test_torch_scan import LAYOUTS, _case, _port_args
from test_affinity import with_random_affinity

SEED = 11
SPEC_TIERS = ("node_local", "spread")
BLOCKS = (1, 7, 256)


def _spread_free(snap):
    """rand_cluster always carries services and controllers (the spread
    tier); without them the node-local tier runs."""
    return JaxSnapshot(nodes=snap.nodes, existing_pods=snap.existing_pods,
                       services=[], controllers=[],
                       pending_pods=snap.pending_pods)


def _state_np(state):
    return {f: port_engine._host(np.asarray(getattr(state, f)))
            for f in state._fields}


@functools.cache
def _jax_spec(tier, layout, block):
    je, jax_enc, _, _ = _case(tier, layout, SEED)
    _, has_spread = je._enc_flags(jax_enc)
    run = jax.jit(_make_spec_run(je.weights, has_spread, block))
    state, assigned = run(*je.device_args(jax_enc))
    return np.asarray(assigned), _state_np(state)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("tier", SPEC_TIERS)
def test_spec_run_plain_matches_jax_and_the_scan(tier, layout, block):
    """spec_run_plain == JAX _make_spec_run == the port's scan: the
    assignment and every State field."""
    je, jax_enc, te, enc = _case(tier, layout, SEED)
    has_aff, has_spread = te._enc_flags(enc)
    assert not has_aff and has_spread == (tier == "spread")
    want, want_state = _jax_spec(tier, layout, block)
    a = _port_args(te, enc)
    got = spk.spec_run_plain(a, te.weights, has_spread, block)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert (want >= 0).any() and (want < 0).any()
    for f, t in zip(a.state._fields, a.state):
        assert np.array_equal(t.numpy(), want_state[f]), f
    scan = _port_args(te, enc)
    assert np.array_equal(
        sk.scan_chunk(scan, te.weights, 0, False, has_spread).numpy(), want)
    for x, y in zip(a.state, scan.state):
        assert torch.equal(x, y)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("tier", SPEC_TIERS)
def test_spec_pass_plain_matches_jax(tier, layout):
    je, jax_enc, te, enc = _case(tier, layout, SEED)
    _, has_spread = te._enc_flags(enc)
    want = jax.jit(_make_spec_pass(je.weights, has_spread))(
        *je.device_args(jax_enc))
    a = _port_args(te, enc)
    got = spk.spec_pass_plain(a, te.weights, has_spread)
    assert got.dtype == a.dtype
    assert np.array_equal(got.numpy(), np.asarray(want))
    # the wrapper on CPU tensors: a slice of the pods' top lists (K6a's
    # output), into buffers
    top = spk.Top(torch.empty((5, 5), dtype=a.dtype),
                  torch.empty((5, 5), dtype=torch.int32))
    assert spk.spec_pass(a, te.weights, has_spread, 3, 5, top) is top
    rows = np.asarray(want)[3:8]
    for k in range(5):
        fit = np.nonzero(rows[k] >= 0)[0]
        order = fit[np.argsort(-rows[k][fit], kind="stable")][:k + 1]
        want_c = np.full(5, -1, rows.dtype)
        want_n = np.full(5, -1, np.int32)
        want_c[:order.size], want_n[:order.size] = rows[k][order], order
        assert np.array_equal(top.comp[k].numpy(), want_c)
        assert np.array_equal(top.slot[k].numpy(), want_n)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spec_chunk_blocks_and_slow_marks(layout):
    """The wrappers on CPU tensors: spec_chunk is spec_run_plain; the
    pass and repair a block at a time (the card's launch order, no pad;
    the repair from the pass's top lists) give the same; the slow marks
    are a uint8 or bool output."""
    _, _, te, enc = _case("spread", layout, SEED)
    a = _port_args(te, enc)
    p = a.dims()["p"]
    want_slow = torch.zeros(p, dtype=torch.bool)
    want = spk.spec_run_plain(a, te.weights, True, 7, want_slow)
    b = _port_args(te, enc)
    slow = torch.zeros(p, dtype=torch.uint8)
    assert torch.equal(spk.spec_chunk(b, te.weights, True, 7, slow), want)
    assert torch.equal(slow.bool(), want_slow)
    c = _port_args(te, enc)
    out = torch.empty(p, dtype=torch.int32)
    marks = torch.zeros(p, dtype=torch.uint8)
    for k0 in range(0, p, 7):
        count = min(7, p - k0)
        top = spk.spec_pass(c, te.weights, True, k0, count)
        spk.spec_repair(c, top, k0, count, te.weights, True, out, marks)
    assert torch.equal(out, want) and torch.equal(marks.bool(), want_slow)
    for x, y in zip(b.state, c.state):
        assert torch.equal(x, y)


# --- the counterparts of tests/test_device_parity.py's speculative tests


def _schedule(snap, speculative, policy=None):
    engine = BatchEngine(policy=policy, device="cpu",
                         speculative=speculative)
    return engine.schedule(to_port(snap))[0], engine


@pytest.mark.parametrize("seed", range(6))
def test_speculative_matches_scan_and_oracle(seed):
    snap = _spread_free(rand_cluster(seed))
    spec, eng = _schedule(snap, True)
    assert eng.scan_stats["spec_chunks"] == 1
    assert spec == _schedule(snap, False)[0]
    assert spec == oracle_schedule(snap)


@pytest.mark.parametrize("seed", range(6))
def test_speculative_spread_tier_matches_scan_and_oracle(seed):
    """The spread tier rides the speculative engine through the
    block-start-max latch; parity holds with services and controllers
    active."""
    snap = rand_cluster(seed)
    spec, eng = _schedule(snap, True)
    assert eng.scan_stats["spec_chunks"] == 1
    assert spec == _schedule(snap, False)[0]
    assert spec == oracle_schedule(snap)


def _one_service(n_nodes=3, n_pods=40):
    nodes = [make_node(f"n-{i:02d}", 4000, 2048 * MI, 110)
             for i in range(n_nodes)]
    pods = [jax_api.Pod(
        metadata=jax_api.ObjectMeta(name=f"w-{j:03d}", namespace="default",
                                    labels={"app": "web"}),
        spec=jax_api.PodSpec(containers=[jax_api.Container(
            name="c", image="i",
            resources=jax_api.ResourceRequirements(requests={
                "cpu": mq(10), "memory": bq(MI)}))]))
        for j in range(n_pods)]
    svcs = [jax_api.Service(
        metadata=jax_api.ObjectMeta(name="web", namespace="default"),
        spec=jax_api.ServiceSpec(selector={"app": "web"}))]
    return JaxSnapshot(nodes=nodes, services=svcs, pending_pods=pods)


def test_speculative_spread_latch_exercised():
    """Pods of one service on few nodes lift the group's counts past the
    block-start max inside a block: the latch fires, flagged pods take
    the full-width rescore, and parity holds."""
    snap = _one_service()
    spec, _ = _schedule(snap, True)
    assert spec == _schedule(snap, False)[0]
    assert spec == oracle_schedule(snap)
    _, enc = encodings(snap)
    te = BatchEngine(device="cpu")
    a = _port_args(te, enc)
    slow = torch.zeros(a.dims()["p"], dtype=torch.bool)
    spk.spec_run_plain(a, te.weights, True, spk.SPEC_BLOCK, slow)
    assert 0 < int(slow.sum()) < a.dims()["p"]


def test_speculative_tight_capacity_and_no_fit():
    """Heavy oversubscription: touched-lane wins and pods that fit
    nowhere (-1 lanes in touched_idx)."""
    snap = _spread_free(rand_cluster(41, n_nodes=3, n_existing=5,
                                     n_pending=60))
    spec, _ = _schedule(snap, True)
    assert None in spec
    assert spec == _schedule(snap, False)[0]
    assert spec == oracle_schedule(snap)


def test_speculative_chunked_matches_scan_chunked():
    """run_chunked with a chunk of 300 (more than SPEC_BLOCK and not a
    multiple of it: each chunk's last block is short) and the State
    carried across chunks."""
    snap = _spread_free(rand_cluster(5, n_nodes=20, n_existing=10,
                                     n_pending=300))
    _, enc = encodings(snap)
    scan = BatchEngine(device="cpu")
    spec = BatchEngine(device="cpu", speculative=True)
    a_scan, s_scan = scan.run_chunked(enc, 300)
    a_spec, s_spec = spec.run_chunked(enc, 300)
    assert np.array_equal(a_scan, a_spec)
    assert spec.scan_stats["spec_chunks"] == 1
    assert scan.scan_stats["spec_chunks"] == 0
    for x, y in zip(s_scan, s_spec):
        assert torch.equal(x, y)
    # and against the JAX engine's speculative chunked run
    jax_enc = jax_encode(snap)
    want, _ = JaxEngine(speculative=True).run_chunked(jax_enc, 300)
    assert np.array_equal(a_spec, np.asarray(want))


def test_speculative_falls_back_on_affinity():
    """Inter-pod affinity scores move globally a commit: such batches
    take the scan, counted as no speculative chunk, and match JAX."""
    snap = with_random_affinity(rand_cluster(105), 5)
    spec, eng = _schedule(snap, True)
    assert eng._enc_flags(eng.schedule(to_port(snap))[1])[0]
    assert eng.scan_stats["spec_chunks"] == 0
    want = JaxEngine(speculative=True).schedule(snap)[0]
    assert spec == want


# --- the route


def test_route_defaults_off_and_skips_service_anti():
    """Off by default (as in JAX); on, a ServiceAntiAffinity policy (an
    anti weight) keeps the scan; the spread tier stays eligible."""
    snap = rand_cluster(3)
    off = BatchEngine(device="cpu")
    assert not off.speculative
    off.schedule(to_port(snap))
    assert off.scan_stats["spec_chunks"] == 0
    anti = BatchEngine(policy=port_policy(POLICY), device="cpu",
                       speculative=True)
    assert anti.speculative and anti._anti_weight
    got = anti.schedule(to_port(snap))[0]
    assert anti.scan_stats["spec_chunks"] == 0
    assert got == JaxEngine(policy=POLICY).schedule(snap)[0]
    spread = BatchEngine(device="cpu", speculative=True)
    assert spread._spec_route(has_aff=False)
    assert not spread._spec_route(has_aff=True)


def test_spec_work_counts_the_repairs_rescores():
    """spec_work reads what the repair did from its outputs: a fast pod
    at place k of its block reads k + 1 list entries and rescores the
    distinct slots the earlier pods of its block took."""
    assigned = np.array([3, 3, 5, -1, 7, 2, 2, 9], np.int32)
    valid = np.array([1, 1, 1, 1, 1, 1, 0, 1], bool)
    group = np.array([-1, 0, 0, -1, 0, -1, -1, 0])
    slow = np.array([0, 0, 0, 0, 1, 0, 0, 0], bool)
    # block 4: pods 0-3 read 1, 2, 3, 4 entries and see 0, 1, 1, 2
    # slots; pods 4-7: 4 is slow, 5 reads 2 and sees 1, the invalid 6 is
    # skipped, 7 reads 4 and sees 2 (2 was taken twice)
    e, r, rs, s = spk.spec_work(assigned, valid, group, slow, block=4)
    assert (e, r, rs, s) == (1 + 2 + 3 + 4 + 2 + 4,
                             0 + 1 + 1 + 2 + 1 + 2, 1 + 1 + 2, 1)


def test_repair_plan_and_its_shared_memory():
    """K6b's shared memory: two sets of count + 1 records of the block's
    commits (four resources in the carried type; pod count, port and disk
    words and, on the spread tier, the group counts), the block's pod
    rows, two words a spread group, a word a pod, a half-word a slot; one
    CTA of a chain warp and a producer thread for each list entry; K6a's:
    the pod's row, its N composites, the selected entries and a
    histogram; past the card's limit, or past SPEC_BLOCK pods, either
    plan raises."""
    d = {"p": 256, "n": 5120, "l": 1, "pw": 1, "k": 1, "g": 1, "t": 1,
         "d": 1, "s": 1, "z": 1}
    e = sk.pod_words(d, False, True, False, False)
    assert e == 5 + 4 + 1 + 1 + 4 + 1
    p = spk.plan(spk.REPAIR, d, False, True, 256)
    assert (p.kind, p.grid, p.threads) == (spk.REPAIR, 1, spk.REPAIR_THREADS)
    # a producer thread a list entry and a record: the warps off the
    # chain warp's scheduler (warp % 4 != 0) but the last (the as-if
    # scores) cover the longest block (spec_dispatch checks the same)
    warps = spk.REPAIR_THREADS // 32
    assert spk.REPAIR_THREADS % 32 == 0
    assert 32 * (warps - (warps + 3) // 4 - 1) >= spk.SPEC_BLOCK
    record = 4 * 4 + 4 * (1 + 1 + 2 * 1 + 1)
    assert 257 * record % 8 == 4   # the second set starts 4 bytes on
    assert p.smem == 257 * record + 4 + 257 * record + 4 * 256 * e + 8 \
        + 4 * 256 + 2 * 5120
    assert p.variant == sk.variant(False, True, False, False)
    # the node-local tier keeps no group counts in its records
    e0 = sk.pod_words(d, True, False, False, False)
    r = spk.plan(spk.REPAIR, d, True, False, 7)
    assert r.smem == 2 * 8 * (4 * 8 + 4 * (1 + 1 + 2)) + 4 * 7 * e0 + 8 \
        + 4 * 7 + 2 * 5120
    q = spk.plan(spk.PASS, d, True, False, 100)
    e64 = sk.pod_words(d, True, False, False, False)
    assert (q.grid, q.threads, q.smem) == (
        100, sk.PROBE_THREADS,
        -(-4 * e64 // 8) * 8 + 8 * (5120 + 256) + 4 * (256 + 256))
    with pytest.raises(ValueError, match="shared memory"):
        spk.plan(spk.REPAIR, {**d, "n": 300_000}, False, True, 256)
    with pytest.raises(ValueError, match="shared memory"):
        spk.plan(spk.PASS, {**d, "n": 30_000}, True, True, 256)
    for kind in (spk.PASS, spk.REPAIR):
        with pytest.raises(ValueError, match="at most 256"):
            spk.plan(kind, d, False, True, 257)


# --- the top-(k + 1) rule K6a and K6b are built on


def test_top_k_plus_one_rule_numpy_model():
    """Pod k of a block sees at most k touched slots; composites are
    injective, so its largest untouched fitting slot is among its top
    k + 1 fitting slots: the max over the untouched entries of the top
    k + 1 equals the max over the untouched slots of the whole row, for
    any touched set of at most k slots (random rows, many ties at -1)."""
    rng = np.random.default_rng(5)
    for trial in range(400):
        n = int(rng.integers(1, 60))
        k = int(rng.integers(0, 40))
        row = np.full(n, -1, np.int64)
        fit = rng.random(n) < rng.random()
        row[fit] = rng.permutation(n * 7)[:int(fit.sum())]
        touched = np.zeros(n, bool)
        touched[rng.choice(n, min(k, n), replace=False)] = True
        whole = row[~touched].max() if (~touched).any() else -1
        order = np.argsort(-row, kind="stable")[:k + 1]
        top = order[row[order] >= 0]
        cand = row[top][~touched[top]]
        got = cand.max() if cand.size else -1
        assert max(got, -1) == max(whole, -1), (trial, n, k)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("tier", SPEC_TIERS)
@pytest.mark.parametrize("block", [7, 256])
def test_repair_from_top_lists_equals_the_whole_row(tier, layout, block):
    """The repair from each pod's top list (spec_top_plain: K6a's output,
    K6b's function) equals JAX's repair from the whole frozen row, block
    by block over the chunk: assignment, slow marks and State."""
    _, _, te, enc = _case(tier, layout, SEED)
    _, has_spread = te._enc_flags(enc)
    a, b = _port_args(te, enc), _port_args(te, enc)
    p = a.dims()["p"]
    for lo in range(0, p, block):
        hi = min(lo + block, p)
        blk_a, blk_b = a.pod_slice(lo, hi), b.pod_slice(lo, hi)
        rows = spk.spec_pass_plain(blk_a, te.weights, has_spread)
        top = spk.spec_top_plain(rows, hi - lo)
        assert top[0].shape == (hi - lo, hi - lo)
        slow_a = torch.zeros(hi - lo, dtype=torch.bool)
        slow_b = torch.zeros(hi - lo, dtype=torch.bool)
        got = spk.spec_block_plain(blk_a, top, te.weights, has_spread,
                                   slow=slow_a)
        want = spk.spec_block_plain(blk_b, rows, te.weights, has_spread,
                                    slow=slow_b)
        assert torch.equal(got, want) and torch.equal(slow_a, slow_b)
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)


def test_top_lists_hold_each_pods_first_k_plus_one():
    rows = torch.tensor([[5, -1, 9, 2], [3, 8, -1, -1], [-1, -1, -1, 4]],
                        dtype=torch.int32)
    c, n = spk.spec_top_plain(rows, 3)
    assert c.tolist() == [[9, -1, -1], [8, 3, -1], [4, -1, -1]]
    assert n.tolist() == [[2, -1, -1], [1, 0, -1], [3, -1, -1]]
    c, n = spk.spec_top_plain(rows[:, :2], 3)     # fewer slots than pods
    assert c.tolist() == [[5, -1, -1], [8, 3, -1], [-1, -1, -1]]


# --- the exactness steps of K6a's selection and K6b's pipeline


def _radix_top_model(row, count, q):
    """K6a's selection as the kernel runs it, in numpy: pod q's K =
    min(q + 1, count) largest fitting entries of `row` (-1 where not
    fitting) by a radix select of the K-th largest key (8-bit digits of
    the composite from its highest set bit, then two of N - 1 - slot
    where composites tie; a pass stops once the chosen digit's bin holds
    exactly the entries still wanted), the entries above or on the
    chosen digits, each put at its rank -> (composites, slots) [count],
    -1 past them."""
    n = row.shape[0]
    valid = row >= 0
    k = min(q + 1, count)
    u = np.where(valid, row, 0).astype(np.uint64)
    key2 = (n - 1 - np.arange(n)).astype(np.int64)
    prefix = mask = np.uint64(0)
    sprefix = smask = 0
    m = int(valid.sum())
    if m > k:
        top = int(np.bitwise_or.reduce(u[valid])).bit_length() - 1
        left = k
        for level in range(max(top, 0) // 8 + 2, -1, -1):
            slot_level = level < 2
            shift = 8 * level if slot_level else 8 * (level - 2)
            match = valid & ((u & mask) == prefix) \
                & ((key2 & smask) == sprefix)
            dig = ((key2 >> shift) & 255) if slot_level else (
                (u >> np.uint64(shift)) & np.uint64(255)).astype(np.int64)
            hist = np.bincount(dig[match], minlength=256)
            above, d = 0, 255
            while above + hist[d] < left:
                above += hist[d]
                d -= 1
            if slot_level:
                sprefix |= d << shift
                smask |= 255 << shift
            else:
                prefix |= np.uint64(d) << np.uint64(shift)
                mask |= np.uint64(255) << np.uint64(shift)
            left -= above
            if hist[d] == left:
                break
    mu = u & mask
    sel = valid & ((mu > prefix)
                   | ((mu == prefix) & ((key2 & smask) >= sprefix)))
    idx = np.flatnonzero(sel)
    assert idx.size == min(m, k)
    c = row[idx]
    rank = np.array([np.sum((c > c[e]) | ((c == c[e]) & (idx < idx[e])))
                     for e in range(idx.size)], dtype=np.int64)
    out_c = np.full(count, -1, np.int64)
    out_n = np.full(count, -1, np.int64)
    out_c[rank], out_n[rank] = c, idx
    return out_c, out_n


def test_threshold_select_numpy_model_equals_the_top_lists():
    """K6a's radix select and rank placement give exactly spec_top_plain's
    lists: random rows with many -1 entries, fewer slots than pods
    (n < count), count == 1, all-invalid rows, composites up to 2^62,
    and composites that tie (the slot digits break them, as the stable
    sort does)."""
    rng = np.random.default_rng(3)
    for trial in range(1500):
        n = int(rng.integers(1, 80))
        b = 1 if trial % 10 == 0 else int(rng.integers(1, 40))
        rows = np.full((b, n), -1, np.int64)
        for q in range(b):
            fit = rng.random(n) < rng.random() * (trial % 7 != 0)
            hi = (n * 7, 5, 2 ** 40, 2 ** 62)[trial % 4]
            vals = rng.permutation(n * 7)[:int(fit.sum())] if hi == n * 7 \
                else rng.integers(0, hi, int(fit.sum()))
            rows[q, fit] = vals
        want_c, want_n = spk.spec_top_plain(torch.from_numpy(rows), b)
        for q in range(b):
            c, s = _radix_top_model(rows[q], b, q)
            assert np.array_equal(c, want_c[q].numpy()), (trial, q)
            assert np.array_equal(s, want_n[q].numpy()), (trial, q)


def _best_two(cands):
    """The best two (composite, slot) of distinct slots, as beats()
    orders them (the larger composite, then the smaller slot)."""
    out = sorted(cands, key=lambda e: (-e[0], e[1]))[:2]
    return out + [(-1, -1)] * (2 - len(out))


def test_pipeline_best_two_rule_numpy_model():
    """K6b's pipeline one pod deep against the sequential repair. Pod
    k + 1's candidates are taken as commit k - 1 left them (the entries
    of its top list on the slots pods before k took not, its rescores of
    the slots they took), split over the producer warps, each keeping
    its best two; meanwhile the chain marks j(k) taken, so the entry on
    j(k) is whatever the producers made of it (random here, and a new
    slot may look taken or not). The as-if thread takes pod k + 1's
    score on every candidate of pod k's pick (each warp's two and
    j(k-1)) as if pod k were committed there. At step k + 1 the chain
    takes from each warp its best less the entry on j(k), the best of
    those, and against it the as-if score on j(k), which is there
    whenever pod k took no full-width rescore. The picks equal the
    sequential repair's for random frozen rows, rescores that move with
    every commit to a slot (injective per pod), unfit slots, invalid
    pods and pods that take the full width."""
    rng = np.random.default_rng(9)
    for trial in range(400):
        b = int(rng.integers(1, 24))
        n = int(rng.integers(1, 12))
        warps = int(rng.integers(1, 5))
        tie = rng.permutation(n)
        # frozen composites, the rescore of slot s after c commits, the
        # live score of an untouched slot (for the full width)
        frozen = np.where(rng.random((b, n)) < 0.8,
                          rng.integers(0, 6, (b, n)) * n + tie, -1)
        moved = np.where(rng.random((b, n, b + 1)) < 0.8,
                         rng.integers(0, 6, (b, n, b + 1)) * n + tie[:, None],
                         -1)
        live = np.where(rng.random((b, n)) < 0.8,
                        rng.integers(0, 6, (b, n)) * n + tie, -1)
        valid = rng.random(b) < 0.9
        slow = rng.random(b) < 0.15
        top_c, top_n = (x.numpy() for x in
                        spk.spec_top_plain(torch.from_numpy(frozen), b))

        def rescore(k, s, commits):
            return int(moved[k, s, commits[s]])

        def full_width(k, commits, touched):
            vals = [(rescore(k, s, commits) if touched[s]
                     else int(live[k, s]), s) for s in range(n)]
            return _best_two([e for e in vals if e[0] >= 0])[0]

        # the sequential repair
        commits, touched = np.zeros(n, int), np.zeros(n, bool)
        want = []
        for k in range(b):
            pick = (-1, -1)
            if valid[k] and slow[k]:
                pick = full_width(k, commits, touched)
            elif valid[k]:
                c = [(int(v), int(s)) for v, s in
                     zip(top_c[k, :k + 1], top_n[k, :k + 1])
                     if v >= 0 and not touched[s]]
                c += [(rescore(k, s, commits), s) for s in range(n)
                      if touched[s] and rescore(k, s, commits) >= 0]
                pick = _best_two(c)[0]
            want.append(pick[1])
            if pick[1] >= 0:
                commits[pick[1]] += 1
                touched[pick[1]] = True

        # the pipeline
        commits, touched = np.zeros(n, int), np.zeros(n, bool)

        def prepare(m, commits, touched, racy, pairs, jprev):
            """Pod m's candidates as the producer warps see them (each
            warp's best two), and its as-if scores on the candidates of
            pod m - 1's pick (`pairs`, `jprev`)."""
            if m >= b:
                return None, {}
            c = []
            for v, s in zip(top_c[m, :m + 1], top_n[m, :m + 1]):
                # a slot taken before is known to be taken; the racy
                # slot, taken now, may or may not look taken
                if v >= 0 and not touched[s] \
                        and not (s == racy and rng.random() < 0.5):
                    c.append((int(v) if s != racy
                              else int(rng.integers(-1, 6 * n)), int(s)))
            for s in range(n):
                if touched[s] and s != racy:
                    c.append((rescore(m, s, commits), s))
                elif touched[s]:
                    c.append((int(rng.integers(-1, 6 * n)), s))
            c = [e for e in c if e[0] >= 0]
            split = rng.integers(0, warps, len(c))
            two = [_best_two([e for e, w in zip(c, split) if w == x])
                   for x in range(warps)]
            asif = {}
            if m > 0 and valid[m - 1] and not slow[m - 1]:
                for x in [e[1] for t in pairs for e in t] + [jprev]:
                    if x >= 0:
                        asif[x] = int(moved[m, x, commits[x] + 1])
            return two, asif

        pairs, asif = prepare(0, commits, touched, -1, [], -1)
        got, jprev = [], -1
        for k in range(b):
            pick = (-1, -1)
            if valid[k] and slow[k]:
                pick = full_width(k, commits, touched)
            elif valid[k]:
                best = [two[1] if two[0][1] == jprev else two[0]
                        for two in pairs]
                if jprev >= 0:
                    # the as-if score, there unless pod k - 1 was slow
                    assert jprev in asif or slow[k - 1], trial
                    r = asif[jprev] if jprev in asif \
                        else rescore(k, jprev, commits)
                    if r >= 0:
                        best.append((r, jprev))
                pick = _best_two([e for e in best if e[0] >= 0])[0]
            j = pick[1]
            before = (commits.copy(), touched.copy())
            if j >= 0:
                commits[j] += 1
                touched[j] = True
            pairs, asif = prepare(k + 1, *before, j, pairs, jprev)
            got.append(j)
            jprev = j
        assert got == want, trial
