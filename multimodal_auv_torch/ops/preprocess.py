"""On-device preprocessing: batches arrive as uint8, normalise on the card.

Port of ``multimodal_auv_tpu/ops/preprocess.py``: u8 -> /255 -> per-channel
(x - mean) / std in f32, then a cast. Layout stays NHWC, as in the JAX
package; the models permute to NCHW themselves.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from multimodal_auv_torch.config import OPTICAL_MEAN, OPTICAL_STD


def normalize_images(u8_batch: torch.Tensor,
                     mean: Optional[Sequence[float]] = None,
                     std: Optional[Sequence[float]] = None,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., C) uint8 -> normalised float. mean/std default to identity
    (plain /255, the reference's ToTensor for bathy/SSS)."""
    c = u8_batch.shape[-1]
    dev = u8_batch.device
    mean = (torch.zeros(c) if mean is None
            else torch.tensor(mean, dtype=torch.float32)).to(dev)
    std = (torch.ones(c) if std is None
           else torch.tensor(std, dtype=torch.float32)).to(dev)
    x = u8_batch.to(torch.float32) * (1.0 / 255.0)
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
