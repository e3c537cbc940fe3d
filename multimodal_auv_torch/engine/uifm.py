"""Underwater Image Formation Model (UIFM) degradation — input-domain fault
injection for robustness studies (port of
``multimodal_auv_tpu/engine/uifm.py``).

The reference's "Example training with image noise.py":55-93. Per-channel
attenuation beta = (0.8, 0.5, 0.3) * turbidity (R, G, B), ambient
backscatter B_inf = (0.1, 0.3, 0.5):

    I(x) = J(x) * exp(-beta * d) + B_inf * (1 - exp(-beta * d)),  clamp [0,1]

Torch ops on the batch's device, in the steps' image layout (NHWC, channel
last: ``engine/loops.py::_device_batch`` places the loader's arrays as
they are). XLA fuses the JAX version into one pass; here it is a few
elementwise launches per batch.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

BETA_RGB = (0.8, 0.5, 0.3)
B_INF_RGB = (0.1, 0.3, 0.5)

Scalar = Union[float, torch.Tensor]


def simulate_underwater_degradation(
    clean_image: torch.Tensor,     # (B, H, W, 3); nominally in [0, 1]
    distance_map: torch.Tensor,    # (B, H, W, 1) or broadcastable; uniform=1.0
    turbidity_factor: Scalar,      # scalar
    depth_value: Scalar,           # scalar (normalized 0..1)
) -> torch.Tensor:
    """PARITY QUIRK: the noise study (pipelines/noise_study.py) applies
    this to mean/std-NORMALIZED images (range ~[-1.5, 4.6]), where the
    [0, 1] clip saturates below-mean pixels to 0 — exactly what the
    reference does (torch.clamp on normalized tensors, "Example training
    with image noise.py":88-93), so the degradation severity matches the
    reference's study, not a physically-calibrated UIFM on raw images.

    The operations and their order are the JAX function's, in the image's
    dtype: beta scaled by the turbidity, the distance by the depth."""
    dt, dev = clean_image.dtype, clean_image.device
    turbidity = torch.as_tensor(turbidity_factor, dtype=dt, device=dev)
    depth = torch.as_tensor(depth_value, dtype=dt, device=dev)
    beta = torch.tensor(BETA_RGB, dtype=dt, device=dev).reshape(1, 1, 1, 3)
    beta = beta * turbidity
    b_inf = torch.tensor(B_INF_RGB, dtype=dt, device=dev).reshape(1, 1, 1, 3)

    d = distance_map * depth
    transmission = torch.exp(-beta * d)
    degraded = clean_image * transmission + b_inf * (1.0 - transmission)
    return torch.clamp(degraded, 0.0, 1.0)


def degrade_uniform(clean_image: torch.Tensor, turbidity: float,
                    depth_value: float = 1.0) -> torch.Tensor:
    """Flat-seabed convenience wrapper (uniform unit distance map —
    broadcastable (1,1,1,1), not a full B*H*W map of ones)."""
    dmap = torch.ones((1, 1, 1, 1), dtype=clean_image.dtype,
                      device=clean_image.device)
    return simulate_underwater_degradation(clean_image, dmap, turbidity,
                                           depth_value)


def sample_turbidity(generator: torch.Generator,
                     turbidity_range: Tuple[float, float]) -> float:
    """A turbidity drawn uniformly from [lo, hi) by ``generator`` (where
    JAX draws from a key: the two packages agree on the range, not on the
    value)."""
    lo, hi = turbidity_range
    u = torch.rand((), generator=generator, dtype=torch.float64)
    return float(lo + (hi - lo) * u)
