"""On-device preprocessing: batches arrive as uint8, normalise on the card.

Port of ``multimodal_auv_tpu/ops/preprocess.py``: u8 -> /255 -> per-channel
(x - mean) / std in f32, then a cast. Layout stays NHWC, as in the JAX
package; the models permute to NCHW themselves.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from multimodal_auv_torch.config import OPTICAL_MEAN, OPTICAL_STD


def _channel_constants(values: Sequence[float], dev) -> torch.Tensor:
    """(C,) f32 on ``dev``, filled there: no copy from the host, so no wait
    on the device's queue (and no host tensor traced into an exported
    program). Each value is the f32 rounding of the Python float, as
    ``torch.tensor`` gives."""
    return torch.stack([torch.full((), float(v), dtype=torch.float32,
                                   device=dev) for v in values])


def normalize_images(u8_batch: torch.Tensor,
                     mean: Optional[Sequence[float]] = None,
                     std: Optional[Sequence[float]] = None,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., C) uint8 -> normalised float. mean/std default to identity
    (plain /255, the reference's ToTensor for bathy/SSS; (x - 0) / 1 is x
    exactly, so the identity is not computed)."""
    x = u8_batch.to(torch.float32) * (1.0 / 255.0)
    if mean is None and std is None:
        return x.to(dtype)
    c, dev = u8_batch.shape[-1], u8_batch.device
    mean = (torch.zeros(c, device=dev) if mean is None
            else _channel_constants(mean, dev))
    std = (torch.ones(c, device=dev) if std is None
           else _channel_constants(std, dev))
    return ((x - mean) / std).to(dtype)


def normalize_optical(u8_batch: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The survey-wide optical normalisation constants."""
    return normalize_images(u8_batch, OPTICAL_MEAN, OPTICAL_STD, dtype)


def normalize_multimodal(main_u8, bathy_u8, sss_u8,
                         dtype: torch.dtype = torch.float32
                         ) -> Tuple[torch.Tensor, ...]:
    return (normalize_optical(main_u8, dtype),
            normalize_images(bathy_u8, dtype=dtype),
            normalize_images(sss_u8, dtype=dtype))
