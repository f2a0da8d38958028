"""The port's metrics plane (kubernetes_tpu_torch/obs/metricsplane.py)
against the JAX package's.

tests/test_metricsplane.py runs on the port as it stands: its source is
compiled here with every `kubernetes_tpu.` import pointed at
`kubernetes_tpu_torch.`, so each of its tests is also a test of the port
and the two files cannot drift apart. Then the two packages side by
side: the same-seed scraper export is byte-equal to the JAX package's,
the exposition parses alike, and the burn-rate evaluator trips and
clears at the same samples on the same series."""

import json
import os

import pytest

from kubernetes_tpu.obs import metricsplane as jax_mp
from kubernetes_tpu.utils import clock as jax_clock
from kubernetes_tpu.utils import metrics as jax_metrics
from kubernetes_tpu_torch.obs import metricsplane as port_mp
from kubernetes_tpu_torch.utils import clock as port_clock
from kubernetes_tpu_torch.utils import metrics as port_metrics

_JAX_TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "test_metricsplane.py")
with open(_JAX_TESTS) as _f:
    _SOURCE = _f.read()
assert _SOURCE.count("from kubernetes_tpu.") >= 5
exec(compile(_SOURCE.replace("from kubernetes_tpu.",
                             "from kubernetes_tpu_torch."),
             _JAX_TESTS, "exec"))

PKGS = {"jax": (jax_mp, jax_clock, jax_metrics),
        "port": (port_mp, port_clock, port_metrics)}


def _drive(pkg, seed, ticks=10):
    """A scraper over one registry target and one callable target, on
    the fake clock, with resets, label escapes and every metric kind."""
    mp, clock_mod, m = PKGS[pkg]
    clock = clock_mod.FakeClock()
    reg = m.MetricsRegistry()
    side = m.MetricsRegistry()
    sc = mp.FleetScraper(
        [mp.RegistryTarget("fleet", reg),
         mp.CallableTarget("side", side.render)],
        clock=clock, cadence_s=1.0, jitter_s=0.5, seed=seed)
    for t in range(ticks):
        reg.inc(m.CROWD_COUNTERS[0], by=float(3 + (t % 3)))
        reg.inc(m.CROWD_COUNTERS[1], by=3.0)
        reg.observe(m.WATCH_LAG_HISTOGRAM, 0.0007 * (t + 1) ** 2,
                    {"stream": 'p"o\\ds\n'})
        reg.observe(m.APISERVER_LATENCY_SUMMARY, 400.0 * (t + 1),
                    {"verb": "GET", "resource": "pods"})
        side.inc(m.APISERVER_WORKER_REQUESTS, by=float(t),
                 labels={"worker": "1"})
        if t == 5:
            # a restarted process: counters start over
            side = m.MetricsRegistry()
            sc.targets[1] = mp.CallableTarget("side", side.render)
        clock.step(1.0)
        sc.sample(t=float(t))
    return sc


@pytest.mark.parametrize("seed", [0, 1, 7, 42])
def test_same_seed_export_byte_equal_to_jax(seed):
    a = _drive("jax", seed).export_json()
    b = _drive("port", seed).export_json()
    assert a == b
    doc = json.loads(b)
    assert doc["seed"] == seed and doc["resets_total"] >= 1


def test_exposition_parses_alike():
    texts = []
    for pkg in ("jax", "port"):
        _mp, _c, m = PKGS[pkg]
        reg = m.MetricsRegistry()
        reg.inc("apiserver_request_count", {"verb": "GET"}, by=3.0)
        reg.observe(m.WATCH_LAG_HISTOGRAM, 0.02, {"stream": 'a"b'})
        reg.observe(m.APISERVER_LATENCY_SUMMARY, 12.5,
                    {"verb": "POST", "resource": "pods"})
        texts.append(reg.render())
    assert texts[0] == texts[1]

    def plain(families):
        return {name: (f.kind, f.points, f.sums,
                       {k: h.to_dict() for k, h in f.hists.items()})
                for name, f in families.items()}

    parsed = [plain(PKGS[p][0].parse_exposition(texts[0]))
              for p in ("jax", "port")]
    assert parsed[0] == parsed[1]
    assert parsed[1]["watch_publish_deliver_lag_seconds"][3]


def _series(pkg, bad):
    _mp, _c, m = PKGS[pkg]
    series, created, bound = [], 0.0, 0.0
    for t in range(16):
        created += 5.0
        bound += 0.0 if t in bad else 5.0
        series.append({
            "t": float(t),
            "counters": {m.CROWD_COUNTERS[0]: {"": created},
                         m.CROWD_COUNTERS[1]: {"": bound}},
            "gauges": {}, "histograms": {}, "resets": 0, "errors": 0})
    return series


@pytest.mark.parametrize("bad", [set(), {3}, {4, 5}, {2, 3, 4, 9},
                                 {0, 15}, set(range(6, 12))])
def test_burn_rate_edges_equal_on_the_same_series(bad):
    edges = []
    for pkg in ("jax", "port"):
        mp, _c, m = PKGS[pkg]
        slo = mp.SLODef(name="crowd", metric=m.CROWD_COUNTERS[0],
                        good_metric=m.CROWD_COUNTERS[1], objective=0.999,
                        fast_window=2, slow_window=8,
                        fast_burn=10.0, slow_burn=2.0)
        edges.append([e.to_dict()
                      for e in mp.evaluate_series([slo], _series(pkg, bad))])
    assert edges[0] == edges[1]


def test_fleet_slo_edges_equal_on_a_scraped_series():
    """The fleet's pinned SLO set (kubemark/slo.py) over the scraped
    series of both packages."""
    from kubernetes_tpu.kubemark.slo import FLEET_SLOS as JAX_SLOS
    from kubernetes_tpu_torch.kubemark.slo import FLEET_SLOS as PORT_SLOS
    out = []
    for pkg, slos in (("jax", JAX_SLOS), ("port", PORT_SLOS)):
        mp = PKGS[pkg][0]
        ev = mp.BurnRateEvaluator(list(slos))
        sc = _drive(pkg, 3, ticks=12)
        out.append([e.to_dict() for s in sc.series()
                    for e in ev.observe(s)])
    assert out[0] == out[1]
