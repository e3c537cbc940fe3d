"""ResNet-50 trunks and the unimodal classifier ``ResNet50Custom`` (port of
``multimodal_auv_tpu/models/resnet.py``).

The modules are functional, as flax's are: they hold the architecture, and
``forward`` takes the parameter subtree and the BatchNorm statistics as
nested dicts keyed by flax's names (``conv1``, ``bn1``, ``layer{s}_{b}``,
``downsample_conv``, ``downsample_bn``, ``fc``). The MC loop feeds a fresh
sampled tree to every forward, so no weight lives in the module.

Conv kernels in the trees given to ``forward`` are torch's OIHW (what
``PackMeta.unpack`` gives); ``init`` returns the JAX layout (HWIO conv,
(in, out) dense), which is what the packed posterior stores. Inputs are
NHWC, as in the JAX package, and are permuted to NCHW inside.

BatchNorm follows flax, not ``nn.BatchNorm2d``: statistics in f32 with the
biased variance E[x^2] - E[x]^2 (clipped at 0), taken in train mode over
the rows where ``batch_mask`` is true; eps 1e-5; normalisation in f32, then
a cast to the activation dtype. Running statistics are read in eval mode.
Under ``parallel.collectives.bn_sync(axis)`` the train-mode statistics are
the global batch's: the sums over every rank of the data axis. Where no
gradient is recorded through a layer on the card, BatchNorm and the ReLU
and residual add after it run as two kernels (``ops/batchnorm.py``) with
the same roundings; elsewhere as plain operations.
With ``mutable=True`` (train mode only) ``forward`` also returns them
advanced by flax's update, ra = 0.9 ra + (1 - 0.9) batch_stat with the
biased batch variance over the ``batch_mask`` rows, detached. The update
is functional: it returns new tensors and mutates nothing, so a forward
that ``torch.utils.checkpoint`` runs again in the backward changes nothing.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_auv_torch.ops import batchnorm as bn_kernels
from multimodal_auv_torch.ops.batchnorm import (
    apply_plain,
    masked_sums,
    on_kernels,
)
from multimodal_auv_torch.parallel.collectives import bn_synced, sync_sums
from multimodal_auv_torch.utils.profiling import span

Tree = Dict[str, object]

EXPANSION = 4
MOMENTUM = 0.9


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.to(dtype)``, written only where the dtype changes: the same
    tensor otherwise, as ``.to`` returns, but no cast node in an exported
    graph (serving.py), where no-op casts were ~30% of the nodes."""
    return x if x.dtype == dtype else x.to(dtype)


def conv(x: torch.Tensor, kernel: torch.Tensor, stride: int,
         dtype: torch.dtype) -> torch.Tensor:
    """Bias-free conv with flax's explicit (k//2, k//2) padding."""
    k = kernel.shape[-1]
    with span("auv.conv"):
        return F.conv2d(cast(x, dtype), cast(kernel, dtype), stride=stride,
                        padding=k // 2)


def dense(x: torch.Tensor, p: Tree, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense: x @ kernel (in, out) + bias, in the activation dtype."""
    return (cast(x, dtype) @ cast(p["kernel"], dtype)
            + cast(p["bias"], dtype))


def batch_norm(x: torch.Tensor, p: Tree, stats: Tree, train: bool,
               batch_mask: Optional[torch.Tensor], dtype: torch.dtype,
               eps: float = 1e-5, mutable: bool = False, relu: bool = False,
               residual: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[Tree]]:
    """flax BatchNorm over NCHW ``x`` (a conv output, in ``dtype``);
    ``batch_mask`` is a bool (B,). ``residual`` (x's shape, in ``dtype``)
    is added to the result and ``relu`` applies ReLU last: the
    bottleneck's epilogue. Returns (y, new running statistics if
    ``mutable`` else None).

    Where no gradient is recorded through it, on the card
    (``ops.batchnorm.on_kernels``), the layer is two kernels, the
    statistics (inside ``_batch_moments``) and the normalisation with its
    epilogue (``auv::bn_apply``); elsewhere it is the plain operations."""
    with span("auv.bn"):
        fused = on_kernels(x, p["scale"], p["bias"], residual)
        xs = x if fused else cast(x, torch.float32)
        var = second = None
        if train:
            mean, second = _batch_moments(xs, batch_mask)
            if mutable or not fused:
                var = torch.clamp_min(second - mean * mean, 0.0)
        else:
            mean, var = stats["mean"], stats["var"]
        new = None
        if mutable:
            if not train:
                raise ValueError("running statistics update only in train "
                                 "mode")
            new = {k: MOMENTUM * stats[k] + (1 - MOMENTUM) * v.detach()
                   for k, v in (("mean", mean), ("var", var))}
        if fused:
            y = bn_kernels.apply(x, mean, second if var is None else var,
                                 p["scale"], p["bias"], eps, var is not None,
                                 residual, relu)
        else:
            y = apply_plain(xs, mean, var, p["scale"], p["bias"], eps, True,
                            residual, relu, dtype)
        return y, new


def _batch_moments(x: torch.Tensor, batch_mask: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E[x], E[x^2]) per channel over the (masked) rows of every rank of
    the BN axis: the sums and sums of squares, and their count, summed by
    one (2C + 1) differentiable all_reduce (parallel/collectives.py::
    sync_sums; nothing on an axis of size 1). From the statistics kernel
    where ``x`` is on the card with no gradient to record (it divides by
    the count itself when no other rank adds to the sums), else from the
    plain sums of ``x`` in f32."""
    if on_kernels(x):
        c = x.shape[1]
        alone = not bn_synced()
        out = bn_kernels.stats(x, batch_mask, alone)
        if alone:
            return out[:c], out[c:2 * c]
        count = (out[2 * c] if batch_mask is not None
                 else x.shape[0] * x.shape[2] * x.shape[3])
        sums, count = sync_sums(out[:2 * c], count)
    else:
        sums, count = sync_sums(*masked_sums(cast(x, torch.float32),
                                             batch_mask))
    return (sums / count).chunk(2)


def _conv_init(gen, k, cin, cout):
    # lecun-normal scale (std 1/sqrt(fan_in)), HWIO as flax stores it
    return torch.randn((k, k, cin, cout), generator=gen) / (k * k * cin) ** 0.5


def _bn_init(c):
    return ({"scale": torch.ones(c), "bias": torch.zeros(c)},
            {"mean": torch.zeros(c), "var": torch.ones(c)})


def dense_init(gen, fin, fout):
    return {"kernel": torch.randn((fin, fout), generator=gen) / fin ** 0.5,
            "bias": torch.zeros(fout)}


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 -> 3x3(stride) -> 1x1(x4) + skip."""

    def __init__(self, planes: int, stride: int = 1, downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.planes, self.stride, self.downsample = planes, stride, downsample
        self.dtype = dtype

    def init(self, gen: torch.Generator, cin: int) -> Tuple[Tree, Tree]:
        p, s = {}, {}
        out = self.planes * EXPANSION
        convs = [("conv1", 1, cin, self.planes), ("conv2", 3, self.planes,
                                                    self.planes),
                 ("conv3", 1, self.planes, out)]
        if self.downsample:
            convs.append(("downsample_conv", 1, cin, out))
        for name, k, ci, co in convs:
            p[name] = {"kernel": _conv_init(gen, k, ci, co)}
            bn = name.replace("conv", "bn")
            p[bn], s[bn] = _bn_init(co)
        return p, s

    def forward(self, p: Tree, s: Tree, x: torch.Tensor, train: bool = True,
                batch_mask: Optional[torch.Tensor] = None,
                mutable: bool = False):
        """The block's output, and with ``mutable`` its new statistics."""
        dt = self.dtype
        # keys bn1, bn2, bn3, downsample_bn, though downsample_bn runs
        # before bn3 (its output is bn3's residual)
        new_s = dict.fromkeys(("bn1", "bn2", "bn3") + (
            ("downsample_bn",) if self.downsample else ()))

        def bn(name, y, relu=True, residual=None):
            y, new_s[name] = batch_norm(y, p[name], s.get(name), train,
                                        batch_mask, dt, mutable=mutable,
                                        relu=relu, residual=residual)
            return y

        out = bn("bn1", conv(x, p["conv1"]["kernel"], 1, dt))
        out = bn("bn2", conv(out, p["conv2"]["kernel"], self.stride, dt))
        identity = x
        if self.downsample:
            identity = bn("downsample_bn", conv(
                x, p["downsample_conv"]["kernel"], self.stride, dt),
                relu=False)
        out = bn("bn3", conv(out, p["conv3"]["kernel"], 1, dt),
                 residual=identity)
        return (out, new_s) if mutable else out


class ResNet(nn.Module):
    """ResNet trunk. ``num_classes=None`` => feature extractor emitting
    (batch, feature_size) pooled features."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 width: int = 64, num_classes: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stage_sizes, self.width = tuple(stage_sizes), width
        self.num_classes, self.dtype = num_classes, dtype
        self.block_names = []
        planes = width
        for stage, blocks in enumerate(self.stage_sizes):
            for b in range(blocks):
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, Bottleneck(
                    planes, 2 if (stage > 0 and b == 0) else 1,
                    downsample=(b == 0), dtype=dtype))
                self.block_names.append(name)
            planes *= 2

    @property
    def feature_size(self) -> int:
        return self.width * 2 ** (len(self.stage_sizes) - 1) * EXPANSION

    def init(self, gen: torch.Generator, cin: int) -> Tuple[Tree, Tree]:
        p = {"conv1": {"kernel": _conv_init(gen, 7, cin, self.width)}}
        s = {}
        p["bn1"], s["bn1"] = _bn_init(self.width)
        c = self.width
        for name in self.block_names:
            block = getattr(self, name)
            p[name], s[name] = block.init(gen, c)
            c = block.planes * EXPANSION
        if self.num_classes is not None:
            p["fc"] = dense_init(gen, c, self.num_classes)
        return p, s

    def forward(self, p: Tree, s: Tree, x: torch.Tensor, train: bool = True,
                batch_mask: Optional[torch.Tensor] = None,
                mutable: bool = False):
        """(B, feature_size) features or (B, num_classes) logits, and with
        ``mutable`` the trunk's new running statistics."""
        if batch_mask is not None:
            batch_mask = batch_mask.reshape(-1).to(torch.bool)
        dt = self.dtype
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW (a view)
        x = conv(x, p["conv1"]["kernel"], 2, dt)
        x, new_s = batch_norm(x, p["bn1"], s.get("bn1"), train, batch_mask,
                              dt, mutable=mutable, relu=True)
        new_s = {"bn1": new_s}
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # -inf pad
        for name in self.block_names:
            x = getattr(self, name)(p[name], s.get(name, {}), x, train,
                                    batch_mask, mutable)
            if mutable:
                x, new_s[name] = x
        x = x.mean(dim=(2, 3))  # global average pool -> (B, C)
        if self.num_classes is not None:
            x = dense(x, p["fc"], dt)
        return (x, new_s) if mutable else x


def resnet50(num_classes: Optional[int] = None,
             dtype: torch.dtype = torch.float32,
             param_dtype: torch.dtype = torch.float32, width: int = 64,
             stage_sizes: Sequence[int] = (3, 4, 6, 3)) -> ResNet:
    """The ResNet trunk (a classifier with ``num_classes``), the JAX
    package's ``resnet50`` signature. ``param_dtype``: f32 only, the
    port's parameters are f32 (``dtype`` is the activations')."""
    if param_dtype != torch.float32:
        raise ValueError(f"param_dtype {param_dtype}: the port's "
                         f"parameters are f32")
    return ResNet(stage_sizes, width, num_classes, dtype)


def forward_layout(params: Tree) -> Tree:
    """A parameter tree in the JAX layout (what ``init`` returns) in the
    layout ``forward`` takes: 4-D HWIO conv kernels permuted to OIHW."""
    if isinstance(params, dict):
        return {k: forward_layout(v) for k, v in params.items()}
    return params.permute(3, 2, 0, 1).contiguous() if params.dim() == 4 \
        else params


class ResNet50Custom(nn.Module):
    """Unimodal classifier: a ResNet trunk with its fc head, taking 1 or 3
    input channels (set by the data). The trunk is the submodule
    ``model``, so parameter and statistics paths start with ``model`` as
    flax's do (the reference's torch prefix ``model.``)."""

    def __init__(self, num_classes: int,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes, self.dtype = num_classes, dtype
        self.model = ResNet(stage_sizes, width, num_classes, dtype)

    def init(self, gen: torch.Generator, cin: int) -> Tuple[Tree, Tree]:
        """(params, batch_stats) in the JAX layout, under ``model``."""
        p, s = self.model.init(gen, cin)
        return {"model": p}, {"model": s}

    def forward(self, p: Tree, s: Tree, x: torch.Tensor, train: bool = True,
                batch_mask: Optional[torch.Tensor] = None,
                mutable: bool = False):
        """(B, num_classes) logits, and with ``mutable`` the new running
        statistics."""
        out = self.model(p["model"], s.get("model", {}), x, train, batch_mask,
                         mutable)
        if mutable:
            return out[0], {"model": out[1]}
        return out

    def get_feature_size(self) -> int:
        return self.model.feature_size
