"""Monte-Carlo inference, plain: the draws w = mu + softplus(rho) * eps
of every chunk seed, one forward per draw, and the uncertainty
reductions of the published model (mean softmax, the per-class variance
over the draws averaged over classes, the mean per-draw entropy with eps
1e-7).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from reference import noise
from reference.layout import Layout
from reference.model import forward, softplus, unpack

_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


def normalise(cfg: Dict, u8: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """NHWC batches -> float32: uint8 ones over 255, then (x - mean) / std
    per channel where the configuration gives them for a modality; float
    ones are taken as already scaled."""
    out = []
    for (name, _), x in zip(cfg["modalities"], u8):
        norm = cfg.get("input_norm", {}).get(name)
        if x.dtype != torch.uint8:
            out.append(x)
            continue
        x = x.to(torch.float32) / 255.0
        if norm is not None:
            mean = torch.tensor(norm["mean"], dtype=torch.float32,
                                device=x.device)
            std = torch.tensor(norm["std"], dtype=torch.float32,
                               device=x.device)
            x = (x - mean) / std
        out.append(x)
    return out


def mc_logits(cfg: Dict, lay: Layout, mu: torch.Tensor, rho: torch.Tensor,
              bn: Dict, inputs: Sequence[torch.Tensor], mask: torch.Tensor,
              seeds: Sequence[Tuple[int, int]], chunk: int,
              sample_dtype: Optional[str], quant: Optional[str] = None
              ) -> torch.Tensor:
    """(len(seeds) * chunk, B, classes) float32 logits: draw j of chunk k
    from stream j of seed k, rounded to ``sample_dtype`` if it is given."""
    sigma = softplus(rho)
    cast = _DTYPES[sample_dtype]
    out = []
    for seed in seeds:
        for j in range(chunk):
            w = mu + sigma * noise.eps(mu.numel(), seed, j, mu.device)
            if cast is not None:
                w = w.to(cast).to(torch.float32)
            out.append(forward(cfg, unpack(w, lay), bn, inputs, mask, quant))
            del w
    return torch.stack(out)


def reductions(logits: torch.Tensor) -> Dict[str, torch.Tensor]:
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    mean = probs.mean(dim=0)
    return {
        "mean_prob": mean,
        "predicted": mean.argmax(dim=-1),
        "predictive_uncertainty": probs.var(dim=0, correction=1).mean(-1),
        "aleatoric_uncertainty":
            (-(probs * torch.log(probs + 1e-7)).sum(-1)).mean(0),
    }
