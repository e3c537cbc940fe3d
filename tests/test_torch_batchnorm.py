"""The BatchNorm kernels' plain twins (``ops/batchnorm.py``) on the CPU.

``bn_stats`` and ``bn_apply`` on CPU tensors run their plain versions, which
must equal the plain BatchNorm composition bit for bit: flax's train-mode
BatchNorm as plain operations, followed by ``torch.relu`` or by
``relu(bn3 + identity)``, as the bottleneck composed them. The kernels
themselves run on the card only (``tests/test_torch_gpu.py``); here the path
choice, the geometry and the fault seam are checked with the card's side
of the predicate stubbed.
"""
import pytest
import torch

from multimodal_auv_torch.models import resnet
from multimodal_auv_torch.models.model_utils import ArchConfig
from multimodal_auv_torch.ops import batchnorm as BN

EPS = 1e-5


def composed(x, scale, bias, stats, train, mask, dtype, mutable=False):
    """flax train-mode BatchNorm as plain operations: statistics in f32
    over the masked rows, E[x^2] - E[x]^2 clipped at 0, normalisation in
    f32 and a cast; with ``mutable`` the running statistics' update."""
    x32 = x.to(torch.float32)
    if train:
        rows = x32.shape[0]
        if mask is not None:
            x32 = torch.where(mask.view(-1, 1, 1, 1), x32, 0.0)
            rows = mask.sum().to(torch.float32)
        sums = torch.cat([x32.sum(dim=(0, 2, 3)),
                          (x32 * x32).sum(dim=(0, 2, 3))])
        mean, mean2 = (sums / (rows * (x32.shape[2] * x32.shape[3]))).chunk(2)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        x32 = x.to(torch.float32)
    else:
        mean, var = stats["mean"], stats["var"]
    new = None
    if mutable:
        new = {k: 0.9 * stats[k] + 0.1 * v for k, v in (("mean", mean),
                                                         ("var", var))}
    y = x32 - mean.view(1, -1, 1, 1)
    mul = torch.rsqrt(var + EPS) * scale
    y = y * mul.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
    return y.to(dtype), new


def _case(layout, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(6, 8, 5, 4, generator=g) * 2 + 0.5).to(dtype)
    res = torch.randn(6, 8, 5, 4, generator=g).to(dtype)
    fmt = {"nchw": torch.contiguous_format,
           "channels_last": torch.channels_last}[layout]
    return (x.contiguous(memory_format=fmt), res.contiguous(memory_format=fmt),
            torch.rand(8, generator=g) + 0.5, torch.randn(8, generator=g),
            {"mean": torch.randn(8, generator=g),
             "var": torch.rand(8, generator=g) + 0.1})


EPILOGUES = {"none": (False, False), "relu": (True, False),
             "relu_residual": (True, True)}


@pytest.mark.parametrize("epilogue", list(EPILOGUES))
@pytest.mark.parametrize("mode", ["train", "eval", "mutable"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_twins_equal_plain_composition(layout, dtype, masked, mode, epilogue):
    """``bn_stats`` then ``bn_apply`` (the ops' CPU bodies, the kernels'
    twins) and ``batch_norm`` with the epilogue equal the plain composition
    followed by ``torch.relu`` / ``relu(bn + identity)`` bit for bit, in
    the input's layout; with ``mutable`` the running statistics too."""
    x, res, scale, bias, stats = _case(layout, dtype)
    mask = torch.tensor([1, 1, 0, 1, 1, 0], dtype=torch.bool) \
        if masked else None
    relu, add = EPILOGUES[epilogue]
    train = mode != "eval"
    want, want_new = composed(x, scale, bias, stats, train, mask, dtype,
                              mutable=mode == "mutable")
    if add:
        want = want + res
    if relu:
        want = torch.relu(want)
    r = res if add else None
    if train:
        st = torch.ops.auv.bn_stats(x, mask, True)
        assert st.dtype == torch.float32 and st.shape == (17,)
        first, second, var_given = st[:8], st[8:16], False
    else:
        first, second, var_given = stats["mean"], stats["var"], True
    got = torch.ops.auv.bn_apply(x, first, second, scale, bias, EPS,
                                 var_given, r, relu)
    assert torch.equal(got, want) and got.stride() == x.stride()
    y, new = resnet.batch_norm(x, {"scale": scale, "bias": bias}, stats,
                               train, mask, dtype, mutable=mode == "mutable",
                               relu=relu, residual=r)
    assert torch.equal(y, want) and y.dtype == dtype
    if mode == "mutable":
        assert all(torch.equal(new[k], want_new[k]) for k in ("mean", "var"))


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_stats_twin_sums_and_count(masked):
    """Without ``means`` the statistics are the sums of x and x^2 over the
    kept rows and their element count, in f32."""
    x, _, _, _, _ = _case("channels_last", torch.bfloat16, 1)
    mask = torch.tensor([1, 0, 1, 1, 1, 1], dtype=torch.bool) \
        if masked else torch.ones(6, dtype=torch.bool)
    st = torch.ops.auv.bn_stats(x, mask if masked else None, False)
    keep = torch.where(mask.view(-1, 1, 1, 1), x.float(), 0.0)
    assert torch.equal(st[:8], keep.sum(dim=(0, 2, 3)))
    assert torch.equal(st[8:16], (keep * keep).sum(dim=(0, 2, 3)))
    assert float(st[16]) == int(mask.sum()) * 20


class _Card:
    """Attributes ``on_kernels`` reads, of a tensor on the card."""

    def __init__(self, requires_grad=False, dtype=torch.bfloat16):
        self.is_cuda, self.dtype = True, dtype
        self.requires_grad = requires_grad


@pytest.mark.parametrize("case,grad,want", [
    ("no grad needed", True, True),
    ("x records", True, False),
    ("scale records", True, False),
    ("x records under no_grad", False, True),
    ("f16", True, False),
])
def test_path_choice_predicate(case, grad, want):
    """The kernels take a card tensor of f32 or bf16 where autograd records
    nothing through the layer; a CPU tensor never."""
    x = _Card(requires_grad=case.startswith("x records"),
              dtype=torch.float16 if case == "f16" else torch.bfloat16)
    scale = _Card(requires_grad=case == "scale records")
    with torch.set_grad_enabled(grad):
        assert BN.on_kernels(x, scale, None) is want
    assert not BN.on_kernels(torch.zeros(1, 2, 1, 1))


@pytest.fixture
def card_stub(monkeypatch):
    """Every tensor counts as on the card, so ``batch_norm`` takes the
    kernels' path, which on CPU tensors runs the ops' plain bodies; the
    ops' calls are counted there (the plain path calls ``apply_plain``
    under ``models.resnet``'s own name)."""
    calls = {"stats": 0, "apply": 0}
    monkeypatch.setattr(BN, "_on_card", lambda x: True)
    for name, fn in (("stats", BN.stats_plain), ("apply", BN.apply_plain)):
        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(BN, f"{name}_plain", counted)
    return calls


def _trunk_inputs():
    arch = ArchConfig.tiny()
    module = resnet.ResNet(arch.stage_sizes, arch.width, 5, torch.float32)
    p, s = module.init(torch.Generator().manual_seed(0), 3)
    p = resnet.forward_layout(p)
    x = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    return module, p, s, x, torch.tensor([1.0, 1.0, 1.0, 0.0])


def test_inference_takes_kernels_recording_autograd_does_not(card_stub):
    """Under ``inference_mode`` every BatchNorm layer of a trunk makes one
    statistics and one apply call, and the logits equal the plain path's
    bit for bit; a forward that autograd records makes neither call and
    still has its gradients."""
    module, p, s, x, mask = _trunk_inputs()
    layers = 1 + 3 * 4 + 4  # tiny(): one bottleneck a stage
    with torch.inference_mode():
        got = module(p, s, x, True, mask)
    assert card_stub == {"stats": layers, "apply": layers}
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(BN, "_on_card", lambda t: False)
        want = module(p, s, x, True, mask)
    assert torch.equal(got, want)
    x = x.clone().requires_grad_(True)
    out = module(p, s, x, True, mask)
    assert card_stub == {"stats": layers, "apply": layers}
    assert torch.equal(out, want)
    out.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_mutable_statistics_on_kernels_path(card_stub):
    """``mutable=True`` outside autograd (``refresh_batch_stats``) runs the
    kernels and returns the plain update of the running statistics, keyed
    as before (bn1, bn2, bn3, downsample_bn)."""
    module, p, s, x, mask = _trunk_inputs()
    with torch.no_grad():
        y, new = module(p, s, x, True, mask, mutable=True)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(BN, "_on_card", lambda t: False)
            y0, new0 = module(p, s, x, True, mask, mutable=True)
    assert card_stub["apply"] > 0 and torch.equal(y, y0)
    assert list(new["layer1_0"]) == ["bn1", "bn2", "bn3", "downsample_bn"]
    flat = lambda t: [v for k in sorted(t) for v in (
        flat(t[k]) if isinstance(t[k], dict) else [t[k]])]
    assert all(torch.equal(a, b) for a, b in zip(flat(new), flat(new0)))


@pytest.mark.parametrize("on_kernels", [False, True], ids=["plain", "kernels"])
def test_half_batch_fault_moves_statistics(monkeypatch, on_kernels):
    """The benchmark's ``half_batch`` fault patches ``_batch_moments``: it
    still changes BatchNorm's statistics on either path."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "port_bench"))
    from harness import faults

    monkeypatch.setattr(BN, "_on_card", lambda t: on_kernels)
    x, res, scale, bias, _ = _case("channels_last", torch.bfloat16, 2)
    p = {"scale": scale, "bias": bias}
    with torch.inference_mode():
        clean, _ = resnet.batch_norm(x, p, None, True, None, torch.bfloat16)
        saved = faults.plant("half_batch")
        try:
            faulty, _ = resnet.batch_norm(x, p, None, True, None,
                                          torch.bfloat16)
        finally:
            faults.undo(saved)
    assert not torch.equal(clean, faulty)


@pytest.mark.parametrize("stats", [True, False], ids=["stats", "apply"])
@pytest.mark.parametrize("C,HW,vec", [(64, 16384, 8), (192, 4096, 8),
                                      (6144, 64, 8), (2048, 64, 4),
                                      (10, 9, 1), (3, 1, 1)])
def test_geometry_fits_the_kernels(C, HW, vec, stats):
    """A launch's geometry: ``tx`` divides the row's C / vec vectors and
    is at most 32; at least one block, about four an SM (132) in all."""
    tx, grid = BN.geometry(128, C, HW, vec, 132, stats)
    cv = C // vec
    assert grid >= 1
    assert 1 <= tx <= BN.TILE and cv % tx == 0
    assert grid * (cv // tx) <= BN.BLOCKS_PER_SM * 132 + cv // tx


def test_layouts_chosen_from_strides():
    """Channels-last is the kernels' layout (where both hold too) and
    contiguous NCHW is told apart, to be converted; any other layout is
    refused."""
    x = torch.zeros(2, 8, 4, 4)
    assert BN.rows_layout(x.contiguous(memory_format=torch.channels_last))
    assert not BN.rows_layout(x)
    assert BN.rows_layout(torch.zeros(2, 8, 1, 1))
    with pytest.raises(ValueError, match="channels-last or contiguous"):
        BN.rows_layout(x.transpose(2, 3))
    with pytest.raises(ValueError, match=r"\(N, C, H, W\)"):
        BN.rows_layout(torch.zeros(2, 8))


def test_ops_trace_with_torch_export():
    """Both ops export (their fake implementations give the shapes and
    the input's layout), and the program gives the eager ops' values."""

    class Layer(torch.nn.Module):
        def forward(self, x, scale, bias, mask, res):
            st = torch.ops.auv.bn_stats(x, mask, True)
            return torch.ops.auv.bn_apply(x, st[:8], st[8:16], scale, bias,
                                          EPS, False, res, True)

    x, res, scale, bias, _ = _case("channels_last", torch.bfloat16, 3)
    mask = torch.tensor([1, 1, 1, 0, 1, 1], dtype=torch.bool)
    args = (x, scale, bias, mask, res)
    ep = torch.export.export(Layer(), args, strict=False)
    targets = [str(n.target) for n in ep.graph.nodes]
    assert sum("auv.bn_stats" in t for t in targets) == 1
    assert sum("auv.bn_apply" in t for t in targets) == 1
    assert torch.equal(ep.module()(*args), Layer()(*args))


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_synced_statistics_go_through_sync_sums(monkeypatch, masked):
    """Where other ranks or shards add to the sums (a BN axis of more than
    one), the kernels' path hands the sums and the count to ``sync_sums``
    and divides after it: the count is the kernel's where a mask gave it,
    else the batch's as a number, as on the plain path; alone, the kernel
    divides itself. Both give the plain path's moments."""
    seen = []

    def local_sums(sums, count):
        seen.append(count)
        return sums, count

    x, _, _, _, _ = _case("channels_last", torch.bfloat16, 4)
    mask = torch.tensor([1, 1, 1, 0, 1, 1], dtype=torch.bool) \
        if masked else None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BN, "_on_card", lambda t: False)
        want = resnet._batch_moments(x, mask)
    monkeypatch.setattr(BN, "_on_card", lambda t: True)
    monkeypatch.setattr(resnet, "sync_sums", local_sums)
    for synced in (True, False):
        monkeypatch.setattr(resnet, "bn_synced", lambda: synced)
        got = resnet._batch_moments(x, mask)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(seen) == 1 and isinstance(seen[0], torch.Tensor) == masked
