"""Configuration constants of the port (copied from
``multimodal_auv_tpu/config.py``; the port imports nothing of that package).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional


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


@dataclass(frozen=True)
class MeshSpec:
    """Layout of the ranks: ``data`` ranks split each batch's rows (batch
    data parallelism), ``mc`` ranks split each chunk's Monte-Carlo draws
    (ensemble parallelism). One process drives one card, so a mesh of
    data x mc needs exactly that many processes; rank = d * mc + m.
    ``data=0`` takes the world size // mc. ``fsdp`` shards the packed
    posterior's Adam moments over all ranks."""

    data: int = 1
    mc: int = 1
    fsdp: bool = False


@dataclass(frozen=True)
class DistSpec:
    """Multi-process launch: every process runs the same command with its
    own ``process_id``; ``coordinator`` is rank 0's "host:port", where the
    process group meets. ``backend``: None = NCCL on the card, gloo on the
    CPU. ``from_env`` reads AUV_COORDINATOR / AUV_NUM_PROCESSES /
    AUV_PROCESS_ID, else torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE
    / RANK, so a launcher can set the topology without flags."""

    coordinator: Optional[str] = None
    num_processes: int = 1
    process_id: Optional[int] = None
    initialization_timeout: int = 300
    backend: Optional[str] = None

    @classmethod
    def from_env(cls) -> Optional["DistSpec"]:
        import os

        env = os.environ
        coord = env.get("AUV_COORDINATOR")
        nproc = env.get("AUV_NUM_PROCESSES")
        pid = env.get("AUV_PROCESS_ID")
        if not coord and env.get("MASTER_ADDR") and env.get("WORLD_SIZE"):
            coord = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
            nproc, pid = env["WORLD_SIZE"], env.get("RANK")
        if not coord or not nproc or int(nproc) <= 1:
            return None
        return cls(coordinator=coord, num_processes=int(nproc),
                   process_id=int(pid) if pid is not None else None)
