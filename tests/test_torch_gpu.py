"""Tests of the port that need the card; each skips without a CUDA device.

This file imports nothing of JAX, so it runs on the machine with the card,
which has no JAX (``tests/conftest.py`` imports it, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.engine.predict import make_packed_predict_step
from multimodal_auv_torch.models.model_utils import (
    ArchConfig,
    make_multimodal_bundle,
)
from multimodal_auv_torch.ops import kernels
from multimodal_auv_torch.ops import sampling as S

pytestmark = pytest.mark.gpu

RAGGED_P = 512 * 128 + 1024  # one full block and a partial one


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.parametrize("fast_math", [False, True], ids=["f32", "bf16fast"])
@pytest.mark.parametrize("num_draws", [1, 2, 3])
def test_kernel_bit_equal_plain(fast_math, num_draws):
    """The kernel (built with --fmad=false) and the plain version round at
    the same places: outputs are equal bit for bit."""
    _cuda_or_skip()
    dt = torch.bfloat16 if fast_math else torch.float32
    g = torch.Generator().manual_seed(0)
    mu = torch.randn(RAGGED_P, generator=g).to(dt).cuda()
    sg = torch.rand(RAGGED_P, generator=g).to(dt).cuda()
    before = kernels.LAUNCHES["split_sampler"]
    got = S.gaussian_shift_scale_split(mu, sg, (3, 5), num_draws,
                                       out_dtype=dt, fast_math=fast_math)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["split_sampler"] == before + 1
    want = S.split_plain(mu, sg, (3, 5), num_draws, dt, fast_math)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_card_step_matches_cpu_step():
    """The micro() packed predict step on the card (kernel) and on the CPU
    (plain version) from the same seeds: draws are bit-equal, so the f32
    forwards (TF32 off) agree to summation order, atol 1e-4 on the
    uncertainties."""
    _cuda_or_skip()
    arch = ArchConfig.micro()
    rng = np.random.default_rng(0)
    u8 = [rng.integers(0, 256, (3, 32, 32, c), dtype=np.uint8)
          for c in (3, 3, 1)]
    mask = np.array([True, True, False])
    outs = []
    for dev in ("cuda", "cpu"):
        bundle = make_multimodal_bundle(7, BNNPriorSpec(),
                                        torch.Generator().manual_seed(0),
                                        arch, device=dev)
        step = make_packed_predict_step(bundle, 4)
        out = step(bundle.post, bundle.batch_stats,
                   tuple(torch.from_numpy(a).to(dev) for a in u8),
                   torch.Generator().manual_seed(1),
                   torch.from_numpy(mask).to(dev))
        outs.append(out["csv_cols"].cpu().numpy())
    np.testing.assert_array_equal(outs[0][0, :2], outs[1][0, :2])
    np.testing.assert_allclose(outs[0][1:, :2], outs[1][1:, :2], atol=1e-4)
