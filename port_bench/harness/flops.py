"""Model FLOPs counted from the layer shapes (2 per multiply-add).

Convolutions and dense layers only: BatchNorm, ReLU, pooling, softmax
and the elementwise gate are left out, as an MFU's model FLOPs leave
them out. A conv of kernel k, stride s, padding k // 2 over an H x W
input gives ceil(H / s) x ceil(W / s) outputs.
"""
from __future__ import annotations

from typing import Dict, Sequence

from reference.layout import ATTENTIONS, TRUNKS, block_plan, feature_size

EXPANSION = 4


def _out(n: int, stride: int) -> int:
    return -(-n // stride)


def conv_macs(h: int, w: int, cin: int, cout: int, k: int, stride: int):
    """(MACs, output h, output w)."""
    ho, wo = _out(h, stride), _out(w, stride)
    return ho * wo * cout * cin * k * k, ho, wo


def trunk_macs(image: int, cin: int, stage_sizes: Sequence[int],
               width: int) -> int:
    """Multiply-adds of one ResNet trunk's convolutions for one image."""
    macs, h, w = conv_macs(image, image, cin, width, 7, 2)
    h, w = _out(h, 2), _out(w, 2)  # the 3x3 / 2 max-pool
    c = width
    for _, planes, stride, down in block_plan(stage_sizes, width):
        out = planes * EXPANSION
        m1, _, _ = conv_macs(h, w, c, planes, 1, 1)
        m2, h2, w2 = conv_macs(h, w, planes, planes, 3, stride)
        m3, _, _ = conv_macs(h2, w2, planes, out, 1, 1)
        macs += m1 + m2 + m3
        if down:
            macs += conv_macs(h, w, c, out, 1, stride)[0]
        h, w, c = h2, w2, out
    return macs


def model_macs(cfg: Dict) -> int:
    """Multiply-adds of one forward of one image (one MC draw)."""
    stages, width, image = cfg["stage_sizes"], cfg["width"], cfg["image_size"]
    feat = feature_size(stages, width)
    if cfg["model"] == "unimodal":
        return (trunk_macs(image, cfg["input_channels"], stages, width)
                + feat * cfg["num_classes"])
    macs = sum(trunk_macs(image, cin, stages, width) for _, cin in TRUNKS)
    hidden = cfg["attention_hidden"]
    macs += len(ATTENTIONS) * (3 * feat * hidden + hidden * hidden)
    dims = [3 * hidden] + list(cfg["fusion_dims"]) + [cfg["num_classes"]]
    macs += sum(a * b for a, b in zip(dims, dims[1:]))
    return macs


def forward_flops(cfg: Dict) -> float:
    return 2.0 * model_macs(cfg)
