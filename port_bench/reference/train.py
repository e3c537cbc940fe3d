"""MC-ELBO training steps, plain (float32; the KL in float64).

Each step: the draws w_d = mu + softplus(rho) * eps_d of its chunk
seeds, one train-mode forward per draw, output = the mean of the draws'
logits, loss = CE(output, labels) over the real rows + KL(q || prior) /
batch_scale * kl_weight; the BatchNorm running statistics advance once
per draw (r <- 0.9 r + 0.1 batch statistic, biased variance); then Adam
(betas 0.9 / 0.999, eps 1e-8) with its weight decay added to the
gradient (coupled L2) over mu, rho and every BatchNorm scale and bias.

The gradient is taken one draw at a time: every draw's logits are
computed first without a graph, which gives the output and the CE's
gradient with respect to each draw's logits, then each draw's forward is
run again with a graph and back-propagated alone, so at most one draw's
activations are held.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from reference import noise
from reference.layout import Layout
from reference.model import forward, softplus, unpack

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
MOMENTUM = 0.9


def kl_divergence(mu, rho, prior_mu: float, prior_sigma: float):
    """Closed-form KL(N(mu, softplus(rho)^2) || N(prior_mu, prior_sigma^2))
    summed over every element, in float64."""
    mu = mu.to(torch.float64)
    sigma = softplus(rho).to(torch.float64)
    ps = torch.tensor(prior_sigma, dtype=torch.float64, device=mu.device)
    return (torch.log(ps) - torch.log(sigma)
            + (sigma ** 2 + (mu - prior_mu) ** 2) / (2.0 * ps ** 2)
            - 0.5).sum()


def run_steps(cfg: Dict, lay: Layout, mu: torch.Tensor, rho: torch.Tensor,
              bn: Dict, stats: Dict, batches: Sequence[Tuple],
              seeds: Sequence[Sequence[Tuple[int, int]]], chunk: int,
              kl_weight: float, batch_scale: float, lr: float,
              weight_decay: float, quant=None) -> Dict:
    """Follow ``len(batches)`` steps from (mu, rho, bn, stats), which are
    not modified. ``batches``: (x NHWC float32, labels, mask float32);
    ``seeds[t]``: step t's chunk seeds. Returns per-step losses and CEs,
    the first step's gradients as Adam takes them (decay included), and
    the parameters and running statistics after the last step."""
    leaves = {"mu": mu.detach().clone().requires_grad_(True),
              "rho": rho.detach().clone().requires_grad_(True)}
    for k, v in bn.items():
        leaves[k] = v.detach().clone().requires_grad_(True)
    stats = {k: (m.clone(), v.clone()) for k, (m, v) in stats.items()}
    moments = {k: (torch.zeros_like(v), torch.zeros_like(v))
               for k, v in leaves.items()}
    prior = cfg["prior"]
    out = {"loss": [], "ce": [], "grad1": None}
    P = mu.numel()
    for t, ((x, labels, mask), step_seeds) in enumerate(zip(batches, seeds)):
        draws = [(s, j) for s in step_seeds for j in range(chunk)]
        bnp = {k: v for k, v in leaves.items() if k not in ("mu", "rho")}

        def weights(seed, j):
            e = noise.eps(P, seed, j, mu.device)
            return leaves["mu"] + softplus(leaves["rho"]) * e

        with torch.no_grad():
            logits = []
            for seed, j in draws:
                st: List = []
                logits.append(forward(cfg, unpack(weights(seed, j), lay), bnp,
                                      [x], mask, quant, st))
                for path, m, v in st:
                    rm, rv = stats[path]
                    stats[path] = (MOMENTUM * rm + (1 - MOMENTUM) * m,
                                   MOMENTUM * rv + (1 - MOMENTUM) * v)
            output = torch.stack(logits).mean(dim=0)
            count = mask.sum().clamp_min(1.0)
            ce = (F.cross_entropy(output, labels, reduction="none")
                  * mask).sum() / count
            onehot = F.one_hot(labels, output.shape[-1]).to(output.dtype)
            g_out = ((torch.softmax(output, -1) - onehot) * mask[:, None]
                     / count / len(draws))
        for seed, j in draws:
            y = forward(cfg, unpack(weights(seed, j), lay), bnp, [x], mask,
                        quant)
            (y * g_out).sum().backward()
            del y
        kl = kl_divergence(leaves["mu"], leaves["rho"], prior["prior_mu"],
                           prior["prior_sigma"])
        scaled_kl = kl / batch_scale * kl_weight
        scaled_kl.backward()
        out["loss"].append(float(ce.double() + scaled_kl.detach()))
        out["ce"].append(float(ce))
        with torch.no_grad():
            b1, b2 = BETAS
            step = t + 1
            grads = {}
            for k, p in leaves.items():
                g = p.grad + weight_decay * p
                grads[k] = g
                m, v = moments[k]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v.sqrt() / (1 - b2 ** step) ** 0.5).add_(ADAM_EPS)
                p.addcdiv_(m, denom, value=-lr / (1 - b1 ** step))
                p.grad = None
            if t == 0:
                out["grad1"] = grads
    out["params"] = {k: v.detach() for k, v in leaves.items()}
    out["stats"] = stats
    return out
