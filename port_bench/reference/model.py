"""Plain forward passes of the two configurations (float32, PyTorch ops).

A ResNet-50 trunk as torchvision's Bottleneck (1x1 -> 3x3 with the
stride -> 1x1 x4, projection on each stage's first block), bias-free
convolutions with (k // 2) padding, BatchNorm in train mode (statistics
of the current batch over its real rows, biased variance, eps 1e-5),
ReLU, a 3x3 / 2 max-pool after the stem and a global average pool. The
multimodal model runs three trunks, an additive attention per trunk
(softmax(W_a tanh(Q + K)) gating V elementwise), and three dense layers
with no nonlinearity between them.

``quant``: None computes in float32; "fp8" rounds every conv's and
dense layer's input and weight to float8 e4m3 with a per-tensor scale
(amax -> 448) before the float32 product, its gradient passed through
unrounded: the control of a lower precision than the configurations
state.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from reference.layout import ATTENTIONS, TRUNKS, Layout, block_plan

BN_EPS = 1e-5
FP8_MAX = 448.0


def q(x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    if quant is None:
        return x
    if quant != "fp8":
        raise ValueError(f"quant {quant!r}")
    with torch.no_grad():
        s = FP8_MAX / x.abs().max().clamp_min(1e-30)
        r = (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s
    # the gradient passes the rounding unchanged (a straight-through
    # estimator): the backward stays float32
    return x + (r - x).detach()


def unpack(w: torch.Tensor, lay: Layout) -> Dict[Tuple[str, ...], torch.Tensor]:
    """Leaves of a flat float32 weight vector by path; conv kernels
    permuted from HWIO to OIHW."""
    out = {}
    for e in lay.entries:
        leaf = w[e.offset:e.offset + e.size].view(e.shape)
        if leaf.dim() == 4:
            leaf = leaf.permute(3, 2, 0, 1)
        out[e.path] = leaf
    return out


def conv(x, k, stride, quant):
    return F.conv2d(q(x, quant), q(k, quant), stride=stride,
                    padding=k.shape[-1] // 2)


def dense(x, p, prefix, quant):
    return q(x, quant) @ q(p[prefix + ("kernel",)], quant) + \
        p[prefix + ("bias",)]


def batch_norm(x, scale, bias, mask, stats: Optional[List], path):
    """Train-mode BatchNorm over the rows where ``mask`` is true; the
    batch statistics are appended to ``stats`` as (path, mean, var)."""
    m = mask.view(-1, 1, 1, 1).to(x.dtype)
    count = m.sum() * x.shape[2] * x.shape[3]
    mean = (x * m).sum(dim=(0, 2, 3)) / count
    var = (((x - mean.view(1, -1, 1, 1)) * m) ** 2).sum(dim=(0, 2, 3)) / count
    if stats is not None:
        stats.append((path, mean.detach(), var.detach()))
    inv = torch.rsqrt(var + BN_EPS) * scale
    return (x - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1) + \
        bias.view(1, -1, 1, 1)


def trunk(p, bn, prefix, x_nhwc, cfg, mask, quant, stats, classes=False):
    """Pooled features (B, F), or logits with ``classes``."""
    def norm(y, name):
        path = prefix + name
        return batch_norm(y, bn[path + ("scale",)], bn[path + ("bias",)],
                          mask, stats, path)

    x = x_nhwc.permute(0, 3, 1, 2)
    x = torch.relu(norm(conv(x, p[prefix + ("conv1", "kernel")], 2, quant),
                        ("bn1",)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for name, _, stride, down in block_plan(cfg["stage_sizes"], cfg["width"]):
        b = prefix + (name,)
        y = torch.relu(norm(conv(x, p[b + ("conv1", "kernel")], 1, quant),
                            (name, "bn1")))
        y = torch.relu(norm(conv(y, p[b + ("conv2", "kernel")], stride,
                                 quant), (name, "bn2")))
        y = norm(conv(y, p[b + ("conv3", "kernel")], 1, quant), (name, "bn3"))
        if down:
            x = norm(conv(x, p[b + ("downsample_conv", "kernel")], stride,
                          quant), (name, "downsample_bn"))
        x = torch.relu(y + x)
    x = x.mean(dim=(2, 3))
    if classes:
        x = dense(x, p, prefix + ("fc",), quant)
    return x


def forward(cfg: Dict, p, bn, inputs, mask, quant=None,
            stats: Optional[List] = None) -> torch.Tensor:
    """(B, classes) float32 logits. ``p``: ``unpack``'s leaves; ``bn``:
    {path + ("scale"|"bias",): tensor}; ``inputs``: normalised float32
    NHWC tensors, one per modality."""
    if cfg["model"] == "unimodal":
        return trunk(p, bn, ("model",), inputs[0], cfg, mask, quant, stats,
                     classes=True)
    attended = []
    for (name, _), attn, x in zip(TRUNKS, ATTENTIONS, inputs):
        f = trunk(p, bn, (name,), x, cfg, mask, quant, stats)
        a = (attn,)
        keys = dense(f, p, a + ("key_projection",), quant)
        values = dense(f, p, a + ("value_projection",), quant)
        queries = dense(f, p, a + ("query_projection",), quant)
        scores = torch.tanh(queries + keys)
        weights = torch.softmax(dense(scores, p, a + ("attention_mechanism",),
                                      quant), dim=1)
        attended.append(values * weights)
    x = torch.cat(attended, dim=1)
    for name in ("fc", "fc1", "fc2"):
        x = dense(x, p, (name,), quant)
    return x


def softplus(rho: torch.Tensor) -> torch.Tensor:
    """log(1 + e^rho) in float64, rounded to float32."""
    r = rho.to(torch.float64)
    return (torch.clamp_min(r, 0.0) + torch.log1p(torch.exp(-r.abs()))
            ).to(torch.float32)
