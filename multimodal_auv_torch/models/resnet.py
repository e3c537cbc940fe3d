"""ResNet-50 trunks (port of ``multimodal_auv_tpu/models/resnet.py``).

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
a cast to the activation dtype. Running statistics are read only in eval
mode; inference never updates them.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Tree = Dict[str, object]

EXPANSION = 4


def conv(x: torch.Tensor, kernel: torch.Tensor, stride: int,
         dtype: torch.dtype) -> torch.Tensor:
    """Bias-free conv with flax's explicit (k//2, k//2) padding."""
    k = kernel.shape[-1]
    return F.conv2d(x.to(dtype), kernel.to(dtype), stride=stride,
                    padding=k // 2)


def dense(x: torch.Tensor, p: Tree, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense: x @ kernel (in, out) + bias, in the activation dtype."""
    return x.to(dtype) @ p["kernel"].to(dtype) + p["bias"].to(dtype)


def batch_norm(x: torch.Tensor, p: Tree, stats: Tree, train: bool,
               batch_mask: Optional[torch.Tensor], dtype: torch.dtype,
               eps: float = 1e-5) -> torch.Tensor:
    """flax BatchNorm over NCHW ``x``; ``batch_mask`` is a bool (B,)."""
    x32 = x.to(torch.float32)
    if train:
        if batch_mask is None:
            mean = x32.mean(dim=(0, 2, 3))
            mean2 = (x32 * x32).mean(dim=(0, 2, 3))
        else:
            m = batch_mask.view(-1, 1, 1, 1)
            count = batch_mask.sum().to(torch.float32) * (x.shape[2]
                                                          * x.shape[3])
            xm = torch.where(m, x32, 0.0)
            mean = xm.sum(dim=(0, 2, 3)) / count
            mean2 = (xm * xm).sum(dim=(0, 2, 3)) / count
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
    else:
        mean, var = stats["mean"], stats["var"]
    y = x32 - mean.view(1, -1, 1, 1)
    mul = torch.rsqrt(var + eps) * p["scale"]
    y = y * mul.view(1, -1, 1, 1) + p["bias"].view(1, -1, 1, 1)
    return y.to(dtype)


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
                batch_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype

        def bn(name, y):
            return batch_norm(y, p[name], s.get(name), train, batch_mask, dt)

        out = torch.relu(bn("bn1", conv(x, p["conv1"]["kernel"], 1, dt)))
        out = torch.relu(bn("bn2", conv(out, p["conv2"]["kernel"],
                                        self.stride, dt)))
        out = bn("bn3", conv(out, p["conv3"]["kernel"], 1, dt))
        identity = x
        if self.downsample:
            identity = bn("downsample_bn", conv(
                x, p["downsample_conv"]["kernel"], self.stride, dt))
        return torch.relu(out + identity)


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
                batch_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if batch_mask is not None:
            batch_mask = batch_mask.reshape(-1).to(torch.bool)
        dt = self.dtype
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW (a view)
        x = conv(x, p["conv1"]["kernel"], 2, dt)
        x = torch.relu(batch_norm(x, p["bn1"], s.get("bn1"), train,
                                  batch_mask, dt))
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf
        for name in self.block_names:
            x = getattr(self, name)(p[name], s.get(name, {}), x, train,
                                    batch_mask)
        x = x.mean(dim=(2, 3))  # global average pool -> (B, C)
        if self.num_classes is not None:
            x = dense(x, p["fc"], dt)
        return x
