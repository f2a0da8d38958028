"""The port's soaks on the CPU: the churn soak with its leak gates
(kubernetes_tpu_torch/kubemark/soak.py, tests/test_soak.py's shape and
time) and the shard-kill soak over NodeMesh(["cpu"] * 4)
(kubemark/shard_soak.py) against the JAX package's over conftest's 8
virtual CPU devices: the same result field for field at two shapes,
and tests/test_shard_failure.py's kill-plan and soak gates."""

import json
import sys

import pytest

from kubernetes_tpu.kubemark.shard_soak import \
    run_shard_kill_soak as jax_shard_kill_soak
from kubernetes_tpu_torch.chaos.crash import ShardKillChaos, ShardKillPlan
from kubernetes_tpu_torch.kubemark import shard_soak, soak
from kubernetes_tpu_torch.kubemark.shard_soak import run_shard_kill_soak
from kubernetes_tpu_torch.kubemark.soak import run_soak
from kubernetes_tpu_torch.utils.metrics import MetricsRegistry

SAMPLE_KEYS = {"t", "rss_kb", "watchers", "store_keys", "tombstones",
               "assumed", "ledger", "ledger_unknown_node", "threads"}


def test_soak_smoke_bounded_state():
    """tests/test_soak.py on the port: 45 s of churn at 100 nodes x 100
    pods a cycle with a 10,000-event watch window (its by-design fill
    ends before the baseline); the leak gates are the test."""
    r = run_soak(duration_s=45.0, n_nodes=100, pods_per_cycle=100,
                 sample_every_s=2.0, history_window=10_000, device="cpu")
    assert r.cycles >= 2, (r.cycles, r.duration_s)
    assert r.pods_churned >= 200
    # the JAX soak's sample fields; device_bytes only on the card
    assert set(r.baseline) == set(r.final) == SAMPLE_KEYS
    r.check()
    # the final sample waits for the encoder to drain the last deletes
    assert r.final["ledger"] == 0, r.final


# ------------------------------------------- shard-kill soak, both ways

@pytest.mark.multihost
@pytest.mark.parametrize("shape", [
    {},                                                  # 8 x 48, tile 8
    {"n_nodes": 64, "n_pods": 256, "tile": 32, "seed": 2},
    {"n_nodes": 40, "n_pods": 160, "tile": 16, "seed": 5},
], ids=["default", "64x256", "40x160"])
def test_shard_kill_soak_equals_jax(shape):
    """The same seeded kill, expiry, fence, re-shard, fenced drop and
    drain: every field of the result equal to the JAX soak's (but the
    flight bundle's path, empty on both when the gates hold). The 64
    slots of 4 shards re-round to 66 for the 3 survivors."""
    port = run_shard_kill_soak(device="cpu", **shape).as_dict()
    ref = jax_shard_kill_soak(**shape).as_dict()
    assert port.pop("flight_bundle") == ref.pop("flight_bundle") == ""
    assert port == ref
    assert port["converged"] and port["parity_ok"]


# -------------------------------------------- test_shard_failure.py

@pytest.mark.multihost
def test_shard_kill_plan_one_draw_contract():
    plan = ShardKillPlan(seed=7, n_shards=6, kills=2)
    for s in range(6):
        d = plan.draw(s)
        assert d == plan.draw(s)
        assert d == plan.stream(s).random()
        lo, hi = plan.window
        assert plan.fraction(s) == lo + d * (hi - lo)
    assert plan.victims() == \
        ShardKillPlan(seed=7, n_shards=6, kills=2).victims()
    assert plan.schedule(100) == plan.schedule(100)
    for s, p in plan.schedule(100).items():
        assert 0 < p < 100, (s, p)
    assert len(ShardKillPlan(seed=1, n_shards=4, kills=9).victims()) == 3
    assert ShardKillPlan(seed=1, n_shards=4, kills=0).victims() == ()


@pytest.mark.multihost
def test_shard_kill_plan_seed_sensitivity():
    picks = {ShardKillPlan(seed=s, n_shards=8, kills=1).victims()
             for s in range(16)}
    assert len(picks) > 1, "victim selection ignores the seed"


@pytest.mark.multihost
def test_shard_kill_chaos_trace_is_pure_replay():
    plan = ShardKillPlan(seed=3, n_shards=4, kills=2)
    chaos = ShardKillChaos(plan, total=40)
    fired = []
    while chaos.pending():
        point, shard = chaos.pending()[0]
        chaos.record(shard, point)
        fired.append((point, shard))
    assert chaos.trace() == plan.schedule(40)
    assert fired == plan.order(40)
    assert not chaos.pending()


@pytest.mark.multihost
def test_shard_kill_soak_converges(tmp_path):
    """The full acceptance soak at the tier-1 shape on a CPU mesh:
    seeded kill mid-tile, lease expiry on the FakeClock, fence, survivor
    re-shard, journal replay, epoch-fenced drop + head-of-line requeue,
    and bit-exact parity with an unfailed run of the surviving shape."""
    metrics = MetricsRegistry()
    res = run_shard_kill_soak(flight_dir=str(tmp_path), metrics=metrics,
                              device="cpu")
    assert res.converged, res.as_dict()
    assert res.schedule_replayed
    assert res.lease_expiry_detected
    assert res.fence_terms and all(t >= 2 for t in res.fence_terms)
    assert res.survivors == res.n_shards - len(res.victims)
    assert res.journal_replayed
    assert res.replay_rows == res.n_nodes
    assert res.stale_epoch_drops >= 1, "the kill never landed mid-tile"
    assert res.stale_epoch_bindings == 0
    assert res.duplicate_bindings == 0
    assert res.bound == res.n_pods
    assert res.parity_ok
    assert res.flight_bundle == "", "no gate violation, no bundle"
    assert metrics.counter("shard_reshards_total") == 1.0
    assert metrics.counter("shard_replay_rows_total") == res.replay_rows
    assert metrics.counter_sum("shard_lease_transitions_total") == \
        len(res.victims)


def test_shard_soak_main_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["shard_soak", "--cpu"])
    assert shard_soak.main() == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["converged"] and out["n_shards"] == 4


def test_soak_main_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "soak", "--cpu", "--minutes", "0.05", "--nodes", "10",
        "--pods-per-cycle", "10", "--no-check"])
    soak.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["platform"] == "cpu" and out["cycles"] >= 1
    assert set(out["gates"]) >= {"ok"}
