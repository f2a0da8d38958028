"""The port's predicate-filter path (kubernetes_tpu_torch.sched.device.
filter_kernel) equals the JAX package's Pallas filter kernel, run in
interpret mode on the CPU as tests/test_pallas_filter.py runs it, and the
port's own probe mask, bit for bit. On the CPU the wrapper computes the
plain PyTorch version; the CUDA kernel itself is checked on the card by
tests/test_torch_gpu.py and chip_smoke.py."""

import random

import numpy as np
import pytest
import torch

from kubernetes_tpu.sched.device import BatchEngine as JaxEngine
from kubernetes_tpu.sched.device import pallas_filter
from kubernetes_tpu_torch.sched.device import BatchEngine, filter_kernel
from kubernetes_tpu_torch.sched.device.tables import encode_snapshot

from test_affinity import with_random_affinity
from test_device_parity import rand_cluster
from test_pallas_filter import _snapshot as filter_snapshot
from test_torch_encode import (FILTER_SHAPES, POLICY, encodings,
                               port_policy, to_port, wide_snapshot)


def _args(engine, enc):
    return filter_kernel.FilterArgs.from_engine(*engine.device_args(enc))


@pytest.mark.parametrize("n_nodes,n_pods,n_existing,seed", FILTER_SHAPES)
def test_filter_matches_pallas_interpret(n_nodes, n_pods, n_existing, seed):
    snap = filter_snapshot(random.Random(seed), n_nodes, n_pods, n_existing)
    jax_enc, enc = encodings(snap)
    assert filter_kernel.supports(enc) and pallas_filter.supports(jax_enc)
    want = pallas_filter.filter_masks(jax_enc)
    engine = BatchEngine(device="cpu")
    got = engine.filter_masks(enc)
    assert got.dtype == np.bool_ and got.shape == want.shape
    assert np.array_equal(got, want)
    # the wrapper on CPU tensors is the plain version, which is also the
    # probe's mask half
    mask = filter_kernel.filter_masks(_args(engine, enc))
    assert torch.equal(mask, filter_kernel.filter_masks_plain(
        _args(engine, enc)))
    probe_mask, _ = engine.probe(enc)
    assert np.array_equal(mask.numpy(), probe_mask)


@pytest.mark.parametrize("case", ["wide", "affinity", "narrow"])
def test_supports_agrees_with_pallas(case):
    if case == "wide":
        snap = wide_snapshot()
    elif case == "affinity":
        snap = with_random_affinity(rand_cluster(100), 0)
    else:
        snap = rand_cluster(3)
    jax_enc, enc = encodings(snap)
    assert filter_kernel.supports(enc) == pallas_filter.supports(jax_enc)
    assert filter_kernel.supports(enc) == (case == "narrow")


@pytest.mark.parametrize("case", ["wide", "affinity", "policy"])
def test_ineligible_encodings_take_the_probe(case, monkeypatch):
    """Encodings the kernel does not take (i64-wide, affinity terms, a
    policy) answer through the probe, as the JAX engine routes them."""
    policy = POLICY if case == "policy" else None
    if case == "wide":
        snap = wide_snapshot()
    elif case == "affinity":
        snap = with_random_affinity(rand_cluster(101), 1)
    else:
        snap = rand_cluster(5)
    jax_enc, enc = encodings(snap, policy=policy)
    want = JaxEngine(policy=policy).filter_masks(jax_enc)
    engine = BatchEngine(policy=port_policy(policy), device="cpu")
    calls = []
    monkeypatch.setattr(filter_kernel, "filter_masks", calls.append)
    got = engine.filter_masks(enc)
    assert not calls
    assert np.array_equal(got, want)


def test_filter_masks_first_row_agrees_with_scan():
    snap = to_port(filter_snapshot(random.Random(11), 64, 1, 40))
    enc = encode_snapshot(snap)
    engine = BatchEngine(device="cpu")
    masks = engine.filter_masks(enc)
    assigned, _ = engine.run(enc)
    assert bool(masks[0].any()) == (assigned[0] >= 0)
    if assigned[0] >= 0:
        assert masks[0, assigned[0]]


def test_no_degrade_latch():
    """A kernel that fails raises; there is no process-wide fallback."""
    assert not hasattr(BatchEngine, "_pallas_broken")
    assert not hasattr(filter_kernel, "_pallas_broken")


def test_wrapper_rejects_bad_inputs():
    snap = to_port(filter_snapshot(random.Random(2), 9, 4, 3))
    args = _args(BatchEngine(device="cpu"), encode_snapshot(snap))
    filter_kernel._check(args)
    with pytest.raises(ValueError, match="cpu_cap"):
        filter_kernel._check(args._replace(cpu_cap=args.cpu_cap.long()))
    with pytest.raises(ValueError, match="psel"):
        filter_kernel._check(args._replace(psel=args.psel[:, :0]))
    with pytest.raises(ValueError, match="contiguous"):
        filter_kernel._check(args._replace(
            labels=args.labels.repeat(1, 2)[:, ::2]))
    meta = args._replace(**{f: getattr(args, f).to("meta")
                            for f in args._fields})
    with pytest.raises(ValueError, match="runs on cuda"):
        filter_kernel.filter_masks(meta)


def test_pod_slice_and_nbytes():
    snap = to_port(filter_snapshot(random.Random(4), 30, 10, 5))
    args = _args(BatchEngine(device="cpu"), encode_snapshot(snap))
    one = args.pod_slice(3, 4)
    assert one.shape == (1, 30)
    assert torch.equal(filter_kernel.filter_masks(one),
                       filter_kernel.filter_masks(args)[3:4])
    # inputs read once plus the bool [P, N] output written once
    assert args.nbytes() == sum(t.numel() * t.element_size()
                                for t in args) + 10 * 30
