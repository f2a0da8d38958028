"""The port's CUDA kernels against their plain PyTorch versions on the
card. Every test here needs a CUDA device and skips without one. This
file imports nothing of JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

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
