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
from multimodal_auv_torch.ops import probe_rng_split as PR
from multimodal_auv_torch.ops import sampler_times as ST
from multimodal_auv_torch.ops import sampling as S

pytestmark = pytest.mark.gpu

RAGGED_P = 512 * 128 + 1024  # one full block and a partial one
# P's whose last block ends inside its first, second, third, fourth quarter
QUARTER_PS = [65536 + 128, 65536 + 16384 + 256, 65536 + 32768 + 384,
              65536 + 49152 + 512]


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


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("num_draws", [1, 2, 3])
def test_stacked_and_eps_kernels_bit_equal_plain(out_dtype, num_draws):
    """The stacked sampler (f32 mu and sigma in) and the eps kernel equal
    their plain versions bit for bit, and the eps kernel's noise is the
    samplers' noise at (mu, sigma) = (0, 1)."""
    _cuda_or_skip()
    g = torch.Generator().manual_seed(1)
    mu = torch.randn(RAGGED_P, generator=g).cuda()
    sg = torch.rand(RAGGED_P, generator=g).cuda()
    before = dict(kernels.LAUNCHES)
    got = S.gaussian_shift_scale(mu, sg, (3, 5), num_draws,
                                 out_dtype=out_dtype)
    eps = S.gaussian_noise(RAGGED_P, (3, 5), num_draws, "cuda")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["stacked_sampler"] == before["stacked_sampler"] + 1
    assert kernels.LAUNCHES["eps"] == before["eps"] + 1
    assert torch.equal(got, S.stacked_plain(mu, sg, (3, 5), num_draws,
                                            out_dtype))
    assert torch.equal(eps, S.eps_plain(RAGGED_P, (3, 5), num_draws, "cuda"))
    zeros, ones = torch.zeros_like(mu), torch.ones_like(mu)
    at01 = S.gaussian_shift_scale(zeros, ones, (3, 5), num_draws)
    split = S.gaussian_shift_scale_split(zeros, ones, (3, 5), num_draws)
    assert torch.equal(at01, eps)
    assert all(torch.equal(s, e) for s, e in zip(split, eps))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["out_f32", "out_bf16"])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16],
                         ids=["in_f32", "in_bf16"])
@pytest.mark.parametrize("num_draws", [1, 2, 3])
def test_reparam_kernel_bit_equal_plain(in_dtype, out_dtype, num_draws):
    """Kernel #4 (the softplus inside) equals ``reparam_plain`` bit for bit
    with rho over [-30, 25], so both branches of softplus_k run; one
    launch."""
    _cuda_or_skip()
    g = torch.Generator().manual_seed(3)
    mu = torch.randn(RAGGED_P, generator=g).to(in_dtype).cuda()
    rho = (torch.rand(RAGGED_P, generator=g) * 55 - 30).to(in_dtype).cuda()
    before = kernels.LAUNCHES["reparam_sampler"]
    got = S.gaussian_reparam(mu, rho, (3, 5), num_draws, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["reparam_sampler"] == before + 1
    assert got.shape == (num_draws, RAGGED_P) and got.dtype == out_dtype
    want = S.reparam_plain(mu, rho, (3, 5), num_draws, out_dtype)
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())


@pytest.mark.parametrize("num_draws", [1, 2, 3])
def test_reparam_kernel_noise_is_the_eps_kernels(num_draws):
    """At mu = 0 and rho = 32 softplus_k takes its x > 20 branch, so sigma is
    exactly 32 and w / 32 is the eps kernel's output bit for bit; the
    wrapper refuses inputs that require grad."""
    _cuda_or_skip()
    mu = torch.zeros(RAGGED_P, device="cuda")
    rho = torch.full((RAGGED_P,), 32.0, device="cuda")
    w = S.gaussian_reparam(mu, rho, (7, 1), num_draws)
    eps = S.gaussian_noise(RAGGED_P, (7, 1), num_draws, "cuda")
    assert torch.equal(w / 32.0, eps)
    with pytest.raises(ValueError, match="no backward"):
        S.gaussian_reparam(mu.requires_grad_(), rho, (7, 1))


def test_backward_on_card_matches_plain_autograd():
    """dmu and dsigma of the kernels' autograd Function on the card equal
    autograd through mu + sigma * eps_plain, to 1e-6 relative (both sum
    the same f32 products over 3 draws)."""
    _cuda_or_skip()
    g = torch.Generator().manual_seed(2)
    mu = torch.randn(RAGGED_P, generator=g).cuda().requires_grad_()
    sg = torch.rand(RAGGED_P, generator=g).cuda().requires_grad_()
    cot = torch.randn(3, RAGGED_P, generator=g).cuda()
    before = kernels.LAUNCHES["eps"]
    dmu, dsg = torch.autograd.grad(
        S.gaussian_shift_scale(mu, sg, (9, 4), 3), (mu, sg), cot)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["eps"] == before + 1
    w = mu + sg * S.eps_plain(RAGGED_P, (9, 4), 3, "cuda")
    want_mu, want_sg = torch.autograd.grad(w, (mu, sg), cot)
    torch.testing.assert_close(dmu, want_mu, rtol=1e-6, atol=0)
    torch.testing.assert_close(dsg, want_sg, rtol=1e-6, atol=1e-7)


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


@pytest.mark.parametrize("P", QUARTER_PS, ids=["q0", "q1", "q2", "q3"])
def test_samplers_bit_equal_plain_at_quarter_ends(P):
    """All four samplers equal their plain versions bit for bit where the
    last block ends inside each of its quarters, and share their eps."""
    _cuda_or_skip()
    g = torch.Generator().manual_seed(P)
    mu = torch.randn(P, generator=g).cuda()
    sg = (torch.rand(P, generator=g) + 0.01).cuda()
    rho = (torch.rand(P, generator=g) * 55 - 30).cuda()
    seed = (P, 77)
    for fast, dt in ((False, torch.float32), (True, torch.bfloat16)):
        got = S.gaussian_shift_scale_split(mu.to(dt), sg.to(dt), seed, 3,
                                           out_dtype=dt, fast_math=fast)
        want = S.split_plain(mu.to(dt), sg.to(dt), seed, 3, dt, fast)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(S.gaussian_shift_scale(mu, sg, seed, 3, out_dtype=dt),
                           S.stacked_plain(mu, sg, seed, 3, dt))
        assert torch.equal(S.gaussian_reparam(mu.to(dt), rho.to(dt), seed, 3),
                           S.reparam_plain(mu.to(dt), rho.to(dt), seed, 3, dt))
    eps = S.gaussian_noise(P, seed, 3, "cuda")
    assert torch.equal(eps, S.eps_plain(P, seed, 3, "cuda"))
    ones = torch.ones(P, device="cuda")
    assert torch.equal(S.gaussian_shift_scale(ones * 0, ones, seed, 3), eps)
    assert torch.equal(S.gaussian_reparam(ones * 0, ones * 32, seed, 3) / 32,
                       eps)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["rng_bits", "rng_bmlite", "eps_fast", "eps"])
@pytest.mark.parametrize("P", [RAGGED_P] + QUARTER_PS,
                         ids=["ragged", "q0", "q1", "q2", "q3"])
def test_probe_kernels_bit_equal_plain(P, name, out_dtype):
    """Every kernel the RNG-split probe launches equals its plain version
    bit for bit (eps_fast is bf16-out only; the eps kernel, the probe's
    ``bm``, in bf16 is the f32 eps cast), one launch each."""
    _cuda_or_skip()
    if name == "eps_fast" and out_dtype != torch.bfloat16:
        pytest.skip("eps_fast writes bf16 only")
    fn, plain = PR.LAUNCHED[name]
    before = kernels.LAUNCHES[name]
    got = fn(P, (5, P), 3, "cuda", out_dtype)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    assert got.shape == (3, P) and got.dtype == out_dtype
    assert torch.equal(got, plain(P, (5, P), 3, "cuda", out_dtype))


def test_samplers_refuse_unaligned_inputs():
    """The kernels load mu and sigma as 16-byte vectors: the wrappers refuse
    inputs that do not start on a 16-byte boundary instead of faulting."""
    _cuda_or_skip()
    mu = torch.zeros(256 + 2, device="cuda")[2:]
    with pytest.raises(ValueError, match="16-byte"):
        S.gaussian_shift_scale_split(mu, mu, (1, 2), 1)
    with pytest.raises(ValueError, match="16-byte"):
        S.gaussian_reparam(mu, mu, (1, 2))


def test_import_on_card_equals_cpu(tmp_path):
    """A tiny() checkpoint in the published form imported into a bundle on
    the card and into the same bundle on the CPU (a 7 -> 4 head swap): the
    stats are equal and mu, rho, det and batch_stats bit-equal, on the card
    (the import is numpy on the host, moved to the device once)."""
    _cuda_or_skip()
    from multimodal_auv_torch.interop.torch_export import save_torch_checkpoint
    from multimodal_auv_torch.interop.torch_import import (
        load_and_prepare_multimodal_model,
    )

    arch = ArchConfig.tiny()
    src = make_multimodal_bundle(7, BNNPriorSpec(),
                                 torch.Generator().manual_seed(3), arch,
                                 device="cpu")
    src.post.mu += 0.01 * (torch.arange(src.post.mu.numel()) % 7)
    path = str(tmp_path / "pytorch_model.bin")
    save_torch_checkpoint(src, path, published=True)
    out = {}
    for dev in ("cuda", "cpu"):
        b = make_multimodal_bundle(4, BNNPriorSpec(),
                                   torch.Generator().manual_seed(0), arch,
                                   device=dev)
        out[dev] = load_and_prepare_multimodal_model(b, path, num_classes=4)
    (card, card_stats), (cpu, cpu_stats) = out["cuda"], out["cpu"]
    assert card_stats == cpu_stats and card_stats["dropped"] == 4
    assert card.post.mu.device.type == "cuda"

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + (k,))
        else:
            yield path, tree

    for a, b in ((card.post.mu, cpu.post.mu), (card.post.rho, cpu.post.rho)):
        assert torch.equal(a.cpu(), b)
    for ta, tb in ((card.post.det, cpu.post.det),
                   (card.batch_stats, cpu.batch_stats)):
        la, lb = dict(leaves(ta)), dict(leaves(tb))
        assert la.keys() == lb.keys()
        assert all(v.device.type == "cuda" and torch.equal(v.cpu(), lb[k])
                   for k, v in la.items())


@pytest.mark.parametrize("fast_math", [False, True], ids=["f32", "bf16fast"])
@pytest.mark.parametrize("P", [RAGGED_P] + QUARTER_PS,
                         ids=["ragged", "q0", "q1", "q2", "q3"])
def test_split_op_reads_device_seeds_bit_equal_plain(P, fast_math):
    """``torch.ops.auv.split_sampler`` on CUDA tensors, its seed words in a
    device tensor (one row of an (nchunks, 2) int64 tensor, as the main
    path passes them), equals ``split_plain`` bit for bit; one launch."""
    _cuda_or_skip()
    dt = torch.bfloat16 if fast_math else torch.float32
    g = torch.Generator().manual_seed(P)
    mu = torch.randn(P, generator=g).to(dt).cuda()
    sg = (torch.rand(P, generator=g) + 0.01).to(dt).cuda()
    seeds = torch.tensor([[P, 3], [(1 << 32) + 7, 0xFFFFFFFF]],
                         dtype=torch.int64, device="cuda")
    for k in range(2):
        before = kernels.LAUNCHES["split_sampler"]
        got = torch.ops.auv.split_sampler(mu, sg, seeds[k], 2, dt, fast_math)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["split_sampler"] == before + 1
        want = S.split_plain(mu, sg, tuple(seeds[k].tolist()), 2, dt,
                             fast_math)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_split_op_traces_with_torch_export_on_card():
    """A module calling the op exports on the card (the fake implementation
    gives the output's shape), and the exported program's output equals
    the eager op's bit for bit."""
    _cuda_or_skip()

    class Draws(torch.nn.Module):
        def forward(self, mu, sigma, seeds):
            return torch.stack([w.float().sum() for w in
                                S.gaussian_shift_scale_split(
                                    mu, sigma, seeds[0], 2,
                                    out_dtype=torch.bfloat16,
                                    fast_math=True)])

    mu = torch.randn(RAGGED_P, device="cuda").bfloat16()
    sg = torch.rand(RAGGED_P, device="cuda").bfloat16()
    seeds = torch.tensor([[5, 9]], dtype=torch.int64, device="cuda")
    ep = torch.export.export(Draws(), (mu, sg, seeds), strict=False)
    assert any("auv.split_sampler" in str(n.target) for n in ep.graph.nodes)
    before = kernels.LAUNCHES["split_sampler"]
    got = ep.module()(mu, sg, seeds)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["split_sampler"] == before + 1
    assert torch.equal(got, Draws()(mu, sg, seeds))


def test_split_launch_failure_raises_without_fallback():
    """A launch the kernel refuses (zero draws) raises and counts nothing;
    seeds that are not a (2,) int64 tensor on mu's device raise before any
    launch; nothing falls back to the plain version."""
    _cuda_or_skip()
    mu = torch.zeros(RAGGED_P, device="cuda")
    seeds = torch.tensor([1, 2], dtype=torch.int64, device="cuda")
    before = kernels.LAUNCHES["split_sampler"]
    with pytest.raises(RuntimeError, match="CUDA error"):
        S._launch("split_sampler", mu, mu, seeds, 0, torch.float32, (0,))
    for bad in (seeds.cpu(), seeds.int(), seeds[:1]):
        with pytest.raises(ValueError, match="seeds"):
            torch.ops.auv.split_sampler(mu, mu, bad, 1, torch.float32, False)
    assert kernels.LAUNCHES["split_sampler"] == before


def test_artifact_on_card_equals_in_process_step(tmp_path):
    """A micro() artifact exported and loaded on the card equals the
    in-process packed predict step on the card at the same seeds, bit for
    bit; one split launch per chunk; loading it for the CPU raises."""
    _cuda_or_skip()
    from multimodal_auv_torch.serving import (
        export_predict_artifact,
        load_predict_artifact,
    )

    bundle = make_multimodal_bundle(3, BNNPriorSpec(),
                                    torch.Generator().manual_seed(0),
                                    ArchConfig.micro(), device="cuda")
    d = str(tmp_path / "art")
    export_predict_artifact(bundle, d, batch_size=4, num_mc_samples=4,
                            image_size=32)
    art = load_predict_artifact(d)
    assert art.meta["platforms"] == ["cuda"]
    rng = np.random.default_rng(0)
    u8 = [rng.integers(0, 256, (4, 32, 32, c), dtype=np.uint8)
          for c in (3, 3, 1)]
    before = kernels.LAUNCHES["split_sampler"]
    out = art.predict(*u8, key=7)
    assert kernels.LAUNCHES["split_sampler"] == before + 2
    step = make_packed_predict_step(bundle, 4)
    ref = step(bundle.post, bundle.batch_stats,
               tuple(torch.from_numpy(a).cuda() for a in u8),
               torch.Generator().manual_seed(7),
               torch.ones(4, device="cuda"))
    np.testing.assert_array_equal(out["csv_cols"],
                                  ref["csv_cols"].cpu().numpy())
    np.testing.assert_array_equal(out["mean_prob"],
                                  ref["mean_prob"].cpu().numpy())
    with pytest.raises(ValueError, match="exported for"):
        load_predict_artifact(d, device="cpu")


def test_mc_sharded_artifact_on_two_cards(tmp_path):
    """An mc-sharded micro() artifact exported on cuda:0 and loaded with
    its default devices runs shard 1 on cuda:1 (the program moved there,
    kernel #2 launched with cuda:1 current): the gathered logits equal the
    one-process stacked path on cuda:0 bit for bit, one stacked launch per
    shard."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from multimodal_auv_torch.engine.mc import mc_logits
    from multimodal_auv_torch.ops.preprocess import normalize_multimodal
    from multimodal_auv_torch.serving import (
        export_predict_artifact,
        load_predict_artifact,
    )

    bundle = make_multimodal_bundle(3, BNNPriorSpec(),
                                    torch.Generator().manual_seed(0),
                                    ArchConfig.micro(), device="cuda:0")
    d = str(tmp_path / "art")
    export_predict_artifact(bundle, d, batch_size=4, num_mc_samples=4,
                            image_size=32, mc_shards=2)
    art = load_predict_artifact(d)
    assert art.devices == [torch.device("cuda", 0), torch.device("cuda", 1)]
    rng = np.random.default_rng(0)
    u8 = [rng.integers(0, 256, (4, 32, 32, c), dtype=np.uint8)
          for c in (3, 3, 1)]
    before = kernels.LAUNCHES["stacked_sampler"]
    got = art.predict_logits(*u8, key=7)
    torch.cuda.synchronize(1)
    assert kernels.LAUNCHES["stacked_sampler"] == before + 2
    assert got.device == torch.device("cuda", 0)
    with torch.inference_mode():
        ref = mc_logits(bundle.module, bundle.meta, bundle.post,
                        bundle.batch_stats,
                        normalize_multimodal(*(torch.from_numpy(a).cuda(0)
                                               for a in u8)),
                        torch.Generator().manual_seed(7), 4, mc_chunk=4,
                        train=True, remat=False,
                        sample_dtype=torch.bfloat16,
                        batch_mask=torch.ones(4, device="cuda:0"))
    assert torch.equal(got, ref)


def test_data_sharded_artifact_on_two_cards(tmp_path):
    """A data_shards=2 micro() artifact exported on cuda:0 and loaded with
    its default devices runs data shard 1 on cuda:1 (the program moved
    there, its worker with cuda:1 current, the BN sums meeting across the
    cards): the gathered logits on cuda:0 equal the same artifact's with
    both shards on cuda:0 bit for bit, and the unsharded artifact's within
    1e-5 of the largest; one split launch per shard and chunk."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from multimodal_auv_torch.serving import (
        export_predict_artifact,
        load_predict_artifact,
    )

    bundle = make_multimodal_bundle(3, BNNPriorSpec(),
                                    torch.Generator().manual_seed(0),
                                    ArchConfig.micro(), device="cuda:0")
    one, d = str(tmp_path / "one"), str(tmp_path / "d2")
    export_predict_artifact(bundle, one, batch_size=4, num_mc_samples=4,
                            image_size=32)
    export_predict_artifact(bundle, d, batch_size=4, num_mc_samples=4,
                            image_size=32, data_shards=2)
    rng = np.random.default_rng(0)
    u8 = [rng.integers(0, 256, (4, 32, 32, c), dtype=np.uint8)
          for c in (3, 3, 1)]
    mask = np.array([1, 1, 1, 0], np.float32)
    art = load_predict_artifact(d)
    same = load_predict_artifact(d, devices=["cuda:0", "cuda:0"])
    try:
        assert art.devices == [torch.device("cuda", 0),
                               torch.device("cuda", 1)]
        before = kernels.LAUNCHES["split_sampler"]
        got = art.predict_logits(*u8, key=7, mask=mask)
        torch.cuda.synchronize(1)
        assert kernels.LAUNCHES["split_sampler"] == before + 2 * 2
        assert got.device == torch.device("cuda", 0)
        assert torch.equal(got, same.predict_logits(*u8, key=7, mask=mask))
    finally:
        art.close()
        same.close()
    want = load_predict_artifact(one).predict_logits(*u8, key=7, mask=mask)
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) <= 1e-5


def test_dvp_data_sharded_artifact_on_two_cards(tmp_path):
    """A data_shards=2 DVP micro() artifact exported on cuda:0 and loaded
    with its default devices runs data shard 1 on cuda:1 (its moment BN
    sums and its two feature gathers meeting across the cards, its own
    rows kept by its worker's shard index): the logits on cuda:0 equal the
    same artifact's with both shards on cuda:0 bit for bit, and the
    unsharded DVP artifact's within 1e-5 of the largest; one split launch
    per shard (each draws the whole batch's features)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from multimodal_auv_torch.serving import (
        export_predict_artifact,
        load_predict_artifact,
    )

    bundle = make_multimodal_bundle(3, BNNPriorSpec(),
                                    torch.Generator().manual_seed(0),
                                    ArchConfig.micro(), device="cuda:0")
    one, d = str(tmp_path / "one"), str(tmp_path / "d2")
    kw = dict(batch_size=4, num_mc_samples=4, image_size=32, mode="dvp")
    export_predict_artifact(bundle, one, **kw)
    export_predict_artifact(bundle, d, data_shards=2, **kw)
    rng = np.random.default_rng(0)
    u8 = [rng.integers(0, 256, (4, 32, 32, c), dtype=np.uint8)
          for c in (3, 3, 1)]
    art = load_predict_artifact(d)
    same = load_predict_artifact(d, devices=["cuda:0", "cuda:0"])
    try:
        assert art.meta["mode"] == "dvp" and art.devices == [
            torch.device("cuda", 0), torch.device("cuda", 1)]
        before = kernels.LAUNCHES["split_sampler"]
        got = art.predict_logits(*u8, key=7)
        torch.cuda.synchronize(1)
        assert kernels.LAUNCHES["split_sampler"] == before + 2
        assert got.device == torch.device("cuda", 0)
        assert torch.equal(got, same.predict_logits(*u8, key=7))
    finally:
        art.close()
        same.close()
    want = load_predict_artifact(one).predict_logits(*u8, key=7)
    err = (got - want).abs().max() / want.abs().max()
    assert float(err) <= 1e-5


@pytest.mark.parametrize("noise", S.NOISE_MODES)
def test_noise_parts_bit_equal_plain_all_words(noise):
    """The device functions of every noise kernel (radius of b1, sin and
    cos of b2) on all 2^24 words equal the plain versions bit by bit, -0
    apart from +0: the exact forms and the division and square root
    without range checks, over every input they meet. One launch."""
    _cuda_or_skip()
    n = 1 << 24
    before = kernels.LAUNCHES["noise_parts"]
    got = S.noise_parts(n, noise, "cuda")
    assert kernels.LAUNCHES["noise_parts"] == before + 1
    want = S.noise_parts_plain(n, noise, "cuda")
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _bf16_stacked_posteriors(P, seed):
    """Random, MOPED-like (sigma = 0.1 |mu|), sigma = |mu| and f32 mu on
    bf16 ties for draw 0 of ``seed`` (``sampler_times.tie_posterior``), each
    with bf16 or f32 mu and sigma, on the card."""
    g = torch.Generator().manual_seed(P)
    mu = torch.randn(P, generator=g).cuda()
    w = mu * 0.05
    out = {"random f32": (mu, torch.rand(P, generator=g).cuda() + 0.01),
           "moped f32": (w, 0.1 * w.abs()),
           "sigma=|mu| f32": (w, w.abs()),
           "ties f32": ST.tie_posterior(w, seed)}
    for name in ("random", "moped", "sigma=|mu|"):
        m, s = out[f"{name} f32"]
        out[f"{name} bf16"] = (m.bfloat16(), s.bfloat16())
    return out


@pytest.mark.parametrize("P", [RAGGED_P] + QUARTER_PS)
def test_bf16_stacked_kernel_bit_equal_plain(P):
    """The stacked sampler's bf16 kernel (approximate noise, the bf16
    bracket, the exact path) equals ``stacked_plain`` bit for bit at P's
    whose last block ends in each quarter, for 1-3 and 10 draws, bf16 and
    f32 in, through the op (device seed) and the autograd path (words by
    value); the ties posterior takes the exact path (the kernel's count)."""
    _cuda_or_skip()
    for n in (1, 2, 3, 10):
        seed = (17 * n + P % 1000, 0xFFFFFF00)
        for name, (mu, sg) in _bf16_stacked_posteriors(P, seed).items():
            want = S.stacked_plain(mu, sg, seed, n, torch.bfloat16)
            got, calls = S.stacked_exact_calls(mu, sg, seed, n)
            by_value = S.gaussian_shift_scale(mu, sg, seed, n,
                                              out_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            for x in (got, by_value):
                assert torch.equal(x.view(torch.int16),
                                   want.view(torch.int16)), (name, n)
            if name.startswith("ties"):
                assert calls > 0, (name, n)


def test_bf16_stacked_bracket_covers_all_words():
    """Every word's approximate radius and angle (``approx_parts``, the
    MUFU functions the kernel's fast path calls) lies within the bracket
    constants the library holds, with the f32 evaluation of E's factor."""
    _cuda_or_skip()
    n = 1 << 24
    dev_r, dev_sc, c_max = S.bracket_deviations(
        S.noise_parts(n, "f32", "cuda"), S.approx_parts(n, "cuda"))
    need_r, need_sc = S.bracket_constants(
        dev_r, S.bracket_bucket(torch.arange(n, device="cuda")), dev_sc,
        c_max, 1 + 2.0 ** -20)
    have_r, have_sc = S.library_bracket_constants()
    assert all(a <= b for a, b in zip(need_r, have_r)) and need_sc <= have_sc
