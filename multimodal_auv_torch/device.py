"""Device resolution for the port's entry points.

``device=None`` means the card. Without one the entry points raise: the
port never carries on on the CPU unless the caller asks for it (the tests
pass ``device="cpu"``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises if a CUDA device is asked for and there
    is none. On CUDA, f32 convolutions and matmuls are set to full f32
    (no TF32), so an f32 configuration computes what it says; the bf16
    main path is unaffected."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card unless the caller "
                "passes device='cpu'")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
