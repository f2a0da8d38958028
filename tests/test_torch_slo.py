"""The port's density SLO run and fan-out soak (kubernetes_tpu_torch/
kubemark/{slo,fanout_soak}.py) against the JAX package's.

tests/test_slo.py on the port: a scaled-down density pass over HTTP
(writers and probers through HttpClient to the port's ApiServer, the
fleet and the batch scheduler in-process, the engine on the CPU) under
the reference's hard gates, and SLOResult's three checks. Then the
result's keys and the SLO definitions equal the JAX package's, main()
runs with --cpu, the GIL switch interval comes back after a run, and
tests/test_serving.py's fast fan-out storm (2000 watchers x 2 workers)
passes its gate on the port. Without a device named, run_density_slo
needs a CUDA device and raises before it starts anything."""

import dataclasses
import gc
import json
import sys

import pytest
import torch

from kubernetes_tpu.kubemark import fanout_soak as jax_fanout
from kubernetes_tpu.kubemark import slo as jax_slo
from kubernetes_tpu_torch.kubemark import fanout_soak, slo
from kubernetes_tpu_torch.kubemark.slo import (API_P99_LIMIT_S,
                                               MIN_API_SAMPLES,
                                               STARTUP_P50_LIMIT_S,
                                               SLOResult, run_density_slo)


def test_density_slo_gates():
    before = (sys.getswitchinterval(), gc.get_threshold(),
              gc.get_freeze_count())
    r = run_density_slo(n_nodes=200, n_pods=800, timeout_s=120.0,
                        device="cpu")
    # the run's process-wide knobs come back: the switch interval and
    # the collector it tunes for the window
    assert (sys.getswitchinterval(), gc.get_threshold(),
            gc.get_freeze_count()) == before
    assert r.running == 800, (r.running, r.elapsed_s)
    # measurements are server-side and real, not defaults
    assert r.api_calls >= 50
    assert r.api_verbs, "server-side per-verb stats missing"
    assert any(k.startswith("POST") for k in r.api_verbs), r.api_verbs
    assert any(k.startswith("GET") for k in r.api_verbs), r.api_verbs
    assert "POST pods:batch" in r.api_verbs
    assert r.startup_p50_s > 0
    assert r.api_p99_limit_s == API_P99_LIMIT_S
    assert r.startup_p50_limit_s == STARTUP_P50_LIMIT_S
    # the reference's hard gates (sample floor relaxed for the
    # scaled-down fixture; the card's run holds the full floor)
    r.check(min_samples=50)


def _result(**kw):
    base = dict(n_nodes=1, n_pods=1, running=1, elapsed_s=1.0,
                api_p50_s=0.1, api_p90_s=0.2, api_p99_s=0.3,
                api_calls=2000, startup_p50_s=1.0, startup_p90_s=2.0,
                startup_p99_s=3.0,
                api_verbs={"GET pods": {"count": 2000, "p50_ms": 100.0,
                                        "p90_ms": 200.0, "p99_ms": 300.0}})
    base.update(kw)
    return base


def test_window_samples_exclude_the_warm_up_list(monkeypatch):
    """The server's latency metrics are reset when the window opens, as
    the reference's density run resets them: the warm-up LIST of the
    fleet before the window is not a sample (the JAX run counts it)."""
    lists = []

    class Client(slo.HttpClient):
        def list(self, resource, *a, **kw):
            out = super().list(resource, *a, **kw)
            if resource == "nodes":
                lists.append(resource)
            return out

    monkeypatch.setattr(slo, "HttpClient", Client)
    r = run_density_slo(n_nodes=20, n_pods=60, timeout_s=60.0,
                        device="cpu")
    assert r.running == 60 and lists
    assert r.api_verbs.get("GET nodes", {"count": 0})["count"] == \
        len(lists) - 1


def test_slo_check_raises_on_violation():
    bad_api = SLOResult(**_result(
        api_p50_s=0.5, api_p90_s=0.9, api_p99_s=2.0,
        api_verbs={"GET pods": {"count": 2000, "p50_ms": 500.0,
                                "p90_ms": 900.0, "p99_ms": 2000.0}}))
    with pytest.raises(AssertionError, match="p99"):
        bad_api.check()
    bad_startup = SLOResult(**_result(startup_p50_s=9.0, startup_p90_s=9.0,
                                      startup_p99_s=9.0))
    with pytest.raises(AssertionError, match="startup p50"):
        bad_startup.check()
    starved = SLOResult(**_result(api_calls=6, api_verbs={}))
    with pytest.raises(AssertionError, match="6 samples"):
        starved.check()


def test_api_gate_null_on_starved_samples():
    """A starved sample window surfaces api_slo_ok as None (JSON null),
    never true; the same latencies over a full window gate true."""
    starved = SLOResult(**_result(
        api_p50_s=0.001, api_p90_s=0.002, api_p99_s=0.003, api_calls=257,
        api_verbs={"GET pods": {"count": 200, "p50_ms": 1.0,
                                "p90_ms": 2.0, "p99_ms": 3.0}}))
    assert not starved.api_samples_valid
    assert starved.api_ok is None
    assert starved.as_dict()["api_slo_ok"] is None
    full = SLOResult(**_result(
        api_p50_s=0.001, api_p90_s=0.002, api_p99_s=0.003, api_calls=5000,
        api_verbs={"GET pods": {"count": 5000, "p50_ms": 1.0,
                                "p90_ms": 2.0, "p99_ms": 3.0}}))
    assert full.api_ok is True


@pytest.mark.parametrize("calls,verbs_p99,startup", [
    (2000, 300.0, 1.0), (999, 300.0, 1.0), (5000, 1000.0, 1.0),
    (5000, 999.0, 4.99), (5000, 999.0, 5.0), (0, 0.0, 0.0)])
def test_result_and_gates_equal_to_jax(calls, verbs_p99, startup):
    kw = _result(api_calls=calls, startup_p50_s=startup,
                 api_verbs={"GET pods": {"count": calls, "p50_ms": 1.0,
                                         "p90_ms": 2.0,
                                         "p99_ms": verbs_p99},
                            "POST pods:batch": {"count": 7, "p50_ms": 1.0,
                                                "p90_ms": 9e9,
                                                "p99_ms": 9e9}})
    a, b = jax_slo.SLOResult(**kw), SLOResult(**kw)
    assert list(a.as_dict()) == list(b.as_dict())
    assert a.as_dict() == b.as_dict()
    assert (a.api_ok, a.startup_ok, a.api_samples_valid) == \
        (b.api_ok, b.startup_ok, b.api_samples_valid)
    outcomes = []
    for r in (a, b):
        try:
            r.check()
            outcomes.append(None)
        except AssertionError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


def test_slo_definitions_equal_to_jax():
    assert (slo.API_P99_LIMIT_S, slo.STARTUP_P50_LIMIT_S,
            slo.MIN_API_SAMPLES, slo.MIN_ENDPOINT_SAMPLES,
            slo.LATENCY_METRIC) == (
        jax_slo.API_P99_LIMIT_S, jax_slo.STARTUP_P50_LIMIT_S,
        jax_slo.MIN_API_SAMPLES, jax_slo.MIN_ENDPOINT_SAMPLES,
        jax_slo.LATENCY_METRIC)
    assert (API_P99_LIMIT_S, STARTUP_P50_LIMIT_S, MIN_API_SAMPLES) == \
        (1.0, 5.0, 1000)
    assert [dataclasses.asdict(s) for s in slo.FLEET_SLOS] == \
        [dataclasses.asdict(s) for s in jax_slo.FLEET_SLOS]
    assert [f.name for f in dataclasses.fields(slo.SLOResult)] == \
        [f.name for f in dataclasses.fields(jax_slo.SLOResult)]
    for cls in ("FanoutSoakResult", "FanoutArm"):
        assert [f.name for f in dataclasses.fields(getattr(fanout_soak, cls))
                ] == [f.name for f in dataclasses.fields(
                    getattr(jax_fanout, cls))]


def test_main_runs_with_cpu(capsys):
    slo.main(["--cpu", "--nodes", "20", "--pods", "60", "--no-check"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(line)
    assert out["metric"] == "density_slo"
    assert out["running"] == 60 and out["nodes"] == 20
    assert list(out)[1:] == list(SLOResult(**_result()).as_dict())


def test_run_density_slo_needs_a_card_without_a_device(monkeypatch):
    import threading
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = (threading.active_count(), sys.getswitchinterval())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_density_slo(n_nodes=2, n_pods=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        slo.main(["--nodes", "2", "--pods", "2"])
    # nothing was started, and the switch interval was not touched
    assert threading.active_count() <= before[0]
    assert sys.getswitchinterval() == before[1]


def test_fast_fanout_storm_gate():
    """tests/test_serving.py's tier-1 storm on the port: 2k watchers x 2
    workers under a create-storm; exact delivery accounting, the
    watch-deliver SLO never stays tripped, per-shard lag from every
    worker, and the multi-consumer overlap witness."""
    r = fanout_soak.run_fanout_soak(n_watchers=2000, workers=2,
                                    storm_steps=3, creates_per_step=60,
                                    batch=30, http_watchers=2,
                                    settle_timeout_s=30.0,
                                    compare_single=False)
    assert r.arm.delivered_ok, (
        f"drained {r.arm.drained_events_total} != expected "
        f"{r.arm.drained_expected}")
    assert r.arm.watch_slo_ok, r.arm.alerts
    assert r.arm.cross_worker_ok, r.arm.cross_worker_lists
    assert r.ok
    assert set(r.arm.per_worker) == {"worker-0", "worker-1"}
    for name, d in r.arm.per_worker.items():
        assert d["lag_samples"] > 0, name
        assert d["delivered"] == r.arm.creates_total, name
    assert r.arm.http_events > 0
    ov = r.arm.overlap
    assert ov["max_concurrent"] >= 2 and ov["overlapped"] > 0, ov


def test_profile_slo_arms_run_on_the_cpu(capsys):
    """kubemark/profile_slo.py: each arm in a child process, the views
    per array or carved, the collector tuned or left alone; every pod
    Running in each, the warm-up LIST marked, the engine's steps read."""
    from kubernetes_tpu_torch.kubemark import profile_slo
    assert profile_slo.main(["--cpu", "--nodes", "20", "--pods", "60",
                             "--arms", "carve/tuned,per-array/default"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [a["arm"] for a in out["arms"]] == ["carve/tuned",
                                               "per-array/default"]
    for a in out["arms"]:
        assert a["result"]["running"] == 60
        assert a["steps"]["run_chunked"]["calls"] >= 1
        assert a["steps"]["views"]["calls"] == \
            a["steps"]["_prologue"]["calls"]
        warm = [x for x in a["node_lists"] if x["warm_up"]]
        assert len(warm) == 1 and "encode" in warm[0]
        assert a["gil_lag_ms"]["samples"] > 0
