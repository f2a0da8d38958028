"""The port's CUDA kernels against their plain PyTorch versions on the
card, the evidence tool's kernels section, and the live pipeline on the
card against its CPU run. Every test here needs a CUDA device and skips without one. This
file imports nothing of JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.kubemark.fixtures import mixed_snapshot
from kubernetes_tpu_torch.sched.device import BatchEngine, encode_snapshot
from kubernetes_tpu_torch.sched.device import filter_kernel

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
    from kubernetes_tpu_torch.sched.device import reject_kernel
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


@pytest.mark.gpu
def test_refused_launch_raises_and_context_survives(cuda):
    from kubernetes_tpu_torch.sched.device import reject_kernel
    x = torch.ones(8, 128, device=cuda)
    before = reject_kernel.argsort_rows.launches
    with pytest.raises(RuntimeError, match="cudaErrorInvalidConfiguration"):
        reject_kernel.argsort_rows(
            x, block_threads=2 * reject_kernel.MAX_BLOCK_THREADS)
    assert reject_kernel.argsort_rows.launches == before
    got = reject_kernel.argsort_rows(x)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), torch.arange(128, dtype=torch.int32)
                       .expand(8, 128))


@pytest.mark.gpu
def test_kernels_evidence_section_holds(cuda):
    from kubernetes_tpu_torch.kubemark.gpu_evidence import section_kernels
    out = section_kernels(cuda)
    assert out["ok"], out


@pytest.mark.gpu
def test_pipeline_on_card_matches_cpu(cuda):
    from kubernetes_tpu_torch.kubemark.gpu_evidence import section_e2e
    got = section_e2e(20, 200, device=cuda)
    want = section_e2e(20, 200, device="cpu")
    assert got["scheduled"] == want["scheduled"] == 200
    assert (got["counts_sha256"], got["counts_bound"]) == \
        (want["counts_sha256"], want["counts_bound"])
