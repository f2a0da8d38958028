"""K-reject: the port's row-wise argsort (kubernetes_tpu_torch.sched.device.
reject_kernel) against the JAX evidence tool's Pallas kernel, and the
port evidence tool's capture bookkeeping.

The JAX kernel body (`tpu_evidence._section_pallas._bad_call.bad_kernel`:
`o_ref[:] = jnp.argsort(x_ref[:], axis=-1).astype(jnp.int32)`) is built
here as a `pallas_call` with interpret=True, which the CPU runs (Mosaic
cannot lower it; the interpreter can). `argsort_rows_plain` — what the
wrapper computes on a CPU tensor and what the CUDA kernel is held to on
the card — must equal it exactly on the JAX section's all-ones input,
ties, +0 against -0, denormals, infinities and NaNs of both signs.
Tolerance 0: the outputs are indices.

The capture bookkeeping (`_Evidence`, `merge_best`) passes the cases of
tests/test_tpu_evidence.py, with the port's `kernels` section in place
of the JAX tool's `pallas` section."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kubernetes_tpu_torch.kubemark.gpu_evidence import (_Evidence,
                                                        merge_best,
                                                        reject_inputs)
from kubernetes_tpu_torch.sched.device import reject_kernel
from kubernetes_tpu_torch.sched.device.reject_kernel import (
    argsort_rows, argsort_rows_plain, default_block_threads)


def jax_bad_kernel(x: np.ndarray) -> np.ndarray:
    def bad_kernel(x_ref, o_ref):
        o_ref[:] = jnp.argsort(x_ref[:], axis=-1).astype(jnp.int32)

    return np.asarray(pl.pallas_call(
        bad_kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32),
        interpret=True)(jnp.asarray(x)))


SPECIALS = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1e-45,
                     -1e-45, 1.1754944e-38, -1.1754944e-38, 3.0, -3.0],
                    np.float32)


def _inputs():
    rng = np.random.default_rng(5)
    ties = rng.integers(-3, 4, size=(8, 128)).astype(np.float32)
    mixed = ties.copy()
    mixed[:, ::3] = rng.choice(SPECIALS, size=mixed[:, ::3].shape)
    zeros = np.where(rng.random((8, 128)) < 0.5, 0.0, -0.0).astype(
        np.float32)
    nans = np.where(rng.random((8, 128)) < 0.3, np.nan,
                    rng.normal(size=(8, 128))).astype(np.float32)
    nans[::2] *= -1.0                        # NaNs of both signs
    return {"ones": np.ones((8, 128), np.float32), "ties": ties,
            "mixed": mixed, "signed_zeros": zeros, "nans": nans,
            "ragged": rng.normal(size=(3, 37)).astype(np.float32),
            "evidence_ties": reject_inputs("cpu")["ties"].numpy()}


@pytest.mark.parametrize("name", sorted(_inputs()))
def test_plain_argsort_matches_the_jax_pallas_kernel(name):
    x = _inputs()[name]
    want = jax_bad_kernel(x)
    got = argsort_rows_plain(torch.from_numpy(x))
    assert got.dtype == torch.int32 and tuple(got.shape) == x.shape
    assert np.array_equal(got.numpy(), want)
    # the wrapper takes the plain version on a CPU tensor, no launch
    before = argsort_rows.launches
    assert np.array_equal(argsort_rows(torch.from_numpy(x)).numpy(), want)
    assert argsort_rows.launches == before


def test_order_differs_from_torch_only_where_jax_flushes_denormals():
    """torch.argsort(stable=True) is the timing yardstick, not the
    reference: it agrees on ties, signed zeros and NaNs, and orders a
    denormal apart from zero, where XLA (and so jnp.argsort) sees 0."""
    x = torch.tensor([[0.0, -1e-45, -0.0, np.nan, -np.nan, 2.0]])
    want = jax_bad_kernel(x.numpy())
    assert want.tolist() == [[0, 1, 2, 5, 3, 4]]
    assert argsort_rows_plain(x).tolist() == want.tolist()
    assert torch.argsort(x, dim=-1, stable=True).tolist() == \
        [[1, 0, 2, 5, 3, 4]]


def test_wrapper_checks():
    with pytest.raises(ValueError, match="f32"):
        argsort_rows(torch.ones(8, 128, dtype=torch.float64))
    with pytest.raises(ValueError, match="f32"):
        argsort_rows(torch.ones(128))
    assert default_block_threads(128) == 128
    assert default_block_threads(37) == 64
    assert default_block_threads(5000) == reject_kernel.MAX_BLOCK_THREADS


def _doc(ts, engine_rate, e2e_rate, p50, kernels_ok=True):
    return {
        "ts_start": ts,
        "sections": {
            "platform": {"status": "ok", "backend": "cuda"},
            "dispatch": {"status": "ok",
                         "roundtrip_ms": {"p50": p50, "p90": p50 + 5,
                                          "min": p50 - 2}},
            "kernels": {"status": "ok" if kernels_ok else "error",
                        "filter_parity": kernels_ok},
            "engine": {"status": "ok",
                       "5000x30000": {"pods_per_sec": engine_rate,
                                      "bound": 30000}},
            "e2e": {"status": "ok", "pods_per_sec": e2e_rate,
                    "scheduled": 30000, "nodes": 5000, "pods": 30000},
        },
    }


def test_merge_keeps_per_section_best(tmp_path):
    path = str(tmp_path / "best.json")
    merge_best(_doc("t1", engine_rate=40000.0, e2e_rate=3700.0, p50=71.0),
               path)
    merge_best(_doc("t2", engine_rate=33000.0, e2e_rate=7600.0, p50=65.0),
               path)
    best = json.load(open(path))["sections"]
    assert best["engine"]["5000x30000"]["pods_per_sec"] == 40000.0
    assert best["engine"]["5000x30000"]["ts"] == "t1"
    assert best["e2e"]["pods_per_sec"] == 7600.0
    assert best["e2e"]["ts"] == "t2"
    assert best["dispatch"]["roundtrip_ms"]["p50"] == 65.0
    assert best["dispatch"]["ts"] == "t2"


def test_merge_skips_error_sections(tmp_path):
    path = str(tmp_path / "best.json")
    merge_best(_doc("t1", 40000.0, 3700.0, 71.0), path)
    bad = _doc("t2", 99999.0, 99999.0, 1.0, kernels_ok=False)
    for name in ("engine", "e2e", "dispatch"):
        bad["sections"][name]["status"] = "error"
    merge_best(bad, path)
    best = json.load(open(path))["sections"]
    assert best["engine"]["5000x30000"]["pods_per_sec"] == 40000.0
    assert best["e2e"]["pods_per_sec"] == 3700.0
    assert best["kernels"]["filter_parity"] is True
    assert best["kernels"]["ts"] == "t1"


def test_degraded_kernels_never_replace_validated_record(tmp_path):
    path = str(tmp_path / "best.json")
    merge_best(_doc("t1", 40000.0, 3700.0, 71.0), path)
    flaky = _doc("t2", 1.0, 1.0, 999.0)
    flaky["sections"]["kernels"] = {
        "status": "ok", "filter_parity": False, "reject_parity": False,
        "rejection_raised": False, "no_fallback": False,
        "parity_after": False}
    merge_best(flaky, path)
    best = json.load(open(path))["sections"]
    assert best["kernels"]["filter_parity"] is True
    assert best["kernels"]["ts"] == "t1"


def test_no_improvement_does_not_bump_ts_updated(tmp_path):
    path = str(tmp_path / "best.json")
    merge_best(_doc("t1", 40000.0, 3700.0, 71.0), path)
    ts1 = json.load(open(path))["ts_updated"]
    wedged = _doc("t2", 99999.0, 99999.0, 1.0)
    for s in wedged["sections"].values():
        s["status"] = "error"
    merge_best(wedged, path)
    doc = json.load(open(path))
    assert doc["ts_updated"] == ts1
    assert doc["sections"]["e2e"]["ts"] == "t1"


def test_identical_recapture_does_not_bump_ts_updated(tmp_path):
    path = str(tmp_path / "best.json")
    doc1 = _doc("t1", 40000.0, 3700.0, 71.0)
    for s in doc1["sections"].values():
        s["elapsed_s"] = 1.0
    merge_best(doc1, path)
    ts1 = json.load(open(path))["ts_updated"]
    doc2 = _doc("t2", 40000.0, 3700.0, 71.0)
    for s in doc2["sections"].values():
        s["elapsed_s"] = 2.0
    merge_best(doc2, path)
    assert json.load(open(path))["ts_updated"] == ts1


def test_merge_tolerates_missing_and_corrupt_best_file(tmp_path):
    path = str(tmp_path / "best.json")
    with open(path, "w") as f:
        f.write("{not json")
    merge_best(_doc("t1", 40000.0, 3700.0, 71.0), path)
    best = json.load(open(path))["sections"]
    assert best["e2e"]["ts"] == "t1"


def test_evidence_flushes_every_section_and_records_failures(tmp_path):
    out, best = str(tmp_path / "ev.json"), str(tmp_path / "best.json")
    ev = _Evidence(out, best_path=best)
    ev.run_section("engine", lambda: {
        "5000x30000": {"pods_per_sec": 1.0, "bound": 1}})
    assert json.load(open(out))["sections"]["engine"]["status"] == "ok"

    def boom():
        raise RuntimeError("no card")
    rec = ev.run_section("e2e", boom)
    assert rec["status"] == "error" and "no card" in rec["tail"]
    doc = json.load(open(out))
    assert doc["sections"]["e2e"]["status"] == "error"
    assert "e2e" not in json.load(open(best))["sections"]
