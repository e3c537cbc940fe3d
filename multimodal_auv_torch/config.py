"""Configuration constants of the port (copied from
``multimodal_auv_tpu/config.py``; the port imports nothing of that package).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict


@dataclass(frozen=True)
class BNNPriorSpec:
    """Variational/prior parameters, named as the reference's
    ``const_bnn_prior_parameters``: a unit Gaussian prior, a
    Reparameterization posterior, and MOPED initialisation (posterior mean
    = deterministic weight, sigma = moped_delta * |w|)."""

    prior_mu: float = 0.0
    prior_sigma: float = 1.0
    posterior_mu_init: float = 0.0
    posterior_rho_init: float = -3.0
    type: str = "Reparameterization"
    moped_enable: bool = True
    moped_delta: float = 0.1

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BNNPriorSpec":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# The 7 benthic habitat classes of the pretrained model.
HABITAT_CLASSES = (
    "Sand", "Mud", "Rock", "Gravel", "Burrowed Mud", "Kelp forest",
    "Horse Mussel reef",
)

# Per-channel optical normalisation constants of the survey.
OPTICAL_MEAN = (62.19902423 / 255.0, 62.31835042 / 255.0, 61.53444229 / 255.0)
OPTICAL_STD = (41.46890313 / 255.0, 43.39430715 / 255.0, 41.72083641 / 255.0)

IMAGE_SIZE = 256
