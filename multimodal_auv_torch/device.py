"""Device resolution for the port's entry points.

``device=None`` means the card. Without one the entry points raise: the
port never carries on on the CPU unless the caller asks for it (the tests
pass ``device="cpu"``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def local_device_index(rank: Optional[int] = None) -> int:
    """This process's card: ``LOCAL_RANK`` if set (torchrun sets it), else
    ``rank`` (default: the process group's, else 0) modulo the cards on
    the host."""
    import os

    if os.environ.get("LOCAL_RANK") is not None:
        return int(os.environ["LOCAL_RANK"])
    if rank is None:
        import torch.distributed as dist

        grouped = dist.is_available() and dist.is_initialized()
        rank = dist.get_rank() if grouped else 0
    return rank % max(torch.cuda.device_count(), 1)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the card: ``cuda``, or ``cuda:<local rank>`` once a
    process group is up (one process per card); raises if a CUDA device is
    asked for and there is none. On CUDA, f32 convolutions and matmuls are
    set to full f32 (no TF32), so an f32 configuration computes what it
    says; the bf16 main path is unaffected."""
    import torch.distributed as dist

    if device is None:
        grouped = dist.is_available() and dist.is_initialized()
        dev = torch.device(f"cuda:{local_device_index()}" if grouped
                           else "cuda")
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card unless the caller "
                "passes device='cpu'")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
