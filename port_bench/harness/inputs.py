"""A run's inputs, made from ``--seed``: the posterior and the batches.

The posterior is made on the device in a few large calls: one normal
draw over the packed vector, scaled per layer to the published init
(LeCun normal, std 1 / sqrt(fan-in), for every conv and dense kernel;
biases 0), then MOPED (sigma = delta |mu|, at least 1e-12; rho =
log(expm1(sigma))), with the pad at the prior's values. BatchNorm starts
at bias 0, running mean 0 and variance 1, and scale 1, but the
configuration's ``residual_bn_scale`` on the last BatchNorm of each
residual branch. The batches are drawn
on the device from the seed and kept on the host, where the program's
loops take them: uint8 NHWC patches for packed inference, float32 NHWC
in [0, 1) for the unimodal paths, integer labels for training.

Independent streams (posterior, batches, the program's generator) come
from ``numpy.random.SeedSequence([seed, stream])``, so any whole seed,
however large, gives 63-bit generator seeds.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from reference.layout import Layout, fan_in, layout, model_tree

STREAMS = {"posterior": 0, "batches": 1, "program": 2, "sample": 3}


def stream_seed(seed: int, stream: str) -> int:
    word = np.random.SeedSequence([int(seed), STREAMS[stream]]).generate_state(
        1, np.uint64)[0]
    return int(word) & ((1 << 63) - 1)


def device_generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def host_generator(seed: int, stream: str) -> torch.Generator:
    return torch.Generator().manual_seed(stream_seed(seed, stream))


def posterior(cfg: Dict, seed: int, device):
    """(layout, mu, rho) as float32 vectors on ``device``."""
    lay = layout(model_tree(cfg))
    prior = cfg["prior"]
    sizes = [e.size for e in lay.entries] + [lay.n_padded - lay.n_real]
    scale = torch.tensor([1.0 / math.sqrt(fan_in(e)) if fan_in(e) else 0.0
                          for e in lay.entries] + [0.0], device=device)
    size_t = torch.tensor(sizes, device=device)
    g = device_generator(seed, "posterior", device)
    mu = torch.randn(lay.n_padded, generator=g, device=device)
    mu.mul_(torch.repeat_interleave(scale, size_t, output_size=lay.n_padded))
    sigma = torch.clamp_min(prior["moped_delta"] * mu.abs(), 1e-12)
    rho = torch.log(torch.expm1(sigma))
    mu[lay.n_real:] = prior["prior_mu"]
    rho[lay.n_real:] = math.log(math.expm1(prior["prior_sigma"]))
    return lay, mu, rho


def bn_init(lay: Layout, device, residual_scale: float = 1.0) -> Dict:
    """{group path + (leaf,): tensor}: bias 0, scale 1, but
    ``residual_scale`` for the last BatchNorm of each residual branch
    (``bn3``)."""
    out = {}
    for path, c in _bn_channels(lay, device):
        scale = residual_scale if path[-1] == "bn3" else 1.0
        out[path + ("scale",)] = torch.full((c,), scale, device=device)
        out[path + ("bias",)] = torch.zeros(c, device=device)
    return out


def stats_init(lay: Layout, device) -> Dict:
    """{group path: (running mean 0, running variance 1)}."""
    return {path: (torch.zeros(c, device=device), torch.ones(c, device=device))
            for path, c in _bn_channels(lay, device)}


def _bn_channels(lay: Layout, device):
    # every BatchNorm follows the conv whose path it shares up to the
    # last name: bn1 <- conv1, downsample_bn <- downsample_conv
    out_ch = {e.path[:-1]: e.shape[-1] for e in lay.entries
              if e.path[-1] == "kernel"}
    for path in lay.bn_paths:
        conv = path[:-1] + (path[-1].replace("bn", "conv"),)
        yield path, out_ch[conv]


def batches(seed: int, pool: int, batch: int, image: int, channels: List[int],
            dtype: str, num_classes: int, device) -> List[Dict]:
    """``pool`` distinct batches: {"x": [per modality NHWC numpy],
    "labels": int64 numpy}."""
    g = device_generator(seed, "batches", device)
    out = []
    for _ in range(pool):
        xs = []
        for c in channels:
            shape = (batch, image, image, c)
            if dtype == "uint8":
                t = torch.randint(0, 256, shape, generator=g, device=device,
                                  dtype=torch.uint8)
            else:
                t = torch.rand(shape, generator=g, device=device)
            xs.append(t.cpu().numpy())
        labels = torch.randint(0, num_classes, (batch,), generator=g,
                               device=device).cpu().numpy()
        out.append({"x": xs, "labels": labels})
    return out
