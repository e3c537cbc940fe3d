"""Monte-Carlo forward machinery (port of ``multimodal_auv_tpu/engine/mc.py``,
split-sampling path).

``mc_logits`` samples the packed posterior a chunk at a time with one
launch of the split sampler (``ops/sampling.py``), then runs one
sequential forward per draw. Each chunk takes its own seed pair from a
``torch.Generator``, as the JAX package takes one key per chunk.

BatchNorm: the reference runs BN in train mode even at inference, so the
forward normalises by the current batch's statistics (real rows only when
``batch_mask`` is given) and never updates the running statistics.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from multimodal_auv_torch.bayes.packing import PackedPosterior, PackMeta, softplus
from multimodal_auv_torch.ops.sampling import gaussian_shift_scale_split

_LATER = ("is not ported yet: ROADMAP.md, Open items, 1 'Modules to port' "
          "item {item}")


def _not_ported(flag: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{flag} " + _LATER.format(item=item))


def chunk_seeds(generator: torch.Generator, nchunks: int
                ) -> Sequence[Tuple[int, int]]:
    """One (seed0, seed1) pair of 32-bit words per chunk."""
    words = torch.randint(0, 1 << 32, (nchunks, 2), generator=generator,
                          dtype=torch.int64)
    return [(int(a), int(b)) for a, b in words.tolist()]


def _resolve_fast(fast_sampling: Optional[bool],
                  sample_dtype: Optional[torch.dtype]) -> bool:
    """None -> fast noise exactly when sampling straight to bf16."""
    if fast_sampling is None:
        return sample_dtype == torch.bfloat16
    return bool(fast_sampling)


def mc_logits(module, meta: PackMeta, post: PackedPosterior, batch_stats,
              inputs: Sequence[torch.Tensor], generator: torch.Generator,
              num_mc: int, *, mc_chunk: int = 1, train: bool = True,
              sample_dtype: Optional[torch.dtype] = None, batch_mask=None,
              split_sampling: bool = True, fast_sampling: Optional[bool] = None,
              antithetic: bool = False, ws_sharding=None,
              return_batch_stats: bool = False,
              pipelined: bool = False) -> torch.Tensor:
    """Stacked logits over MC draws: (num_mc, batch, num_classes).

    ``sample_dtype``: dtype of the sampled weights; mu and sigma are cast to
    it once, before sampling (None: mu's dtype). ``fast_sampling``:
    the bf16-budget noise polynomials (None = exactly when sampling to
    bf16). ``train``: BN from batch statistics (else running statistics)."""
    if antithetic:
        raise _not_ported("antithetic", "5 (training, kernel #2)")
    if ws_sharding is not None:
        raise _not_ported("ws_sharding", "8 (parallel)")
    if return_batch_stats:
        raise _not_ported("return_batch_stats", "5 (training, kernel #2)")
    if pipelined:
        raise _not_ported("pipelined", "4 (MC inference, pipelined variant)")
    if not split_sampling:
        raise _not_ported("the stacked sampling path",
                          "5 (training, kernel #2)")
    if num_mc % mc_chunk != 0:
        raise ValueError(f"num_mc={num_mc} must be divisible by "
                         f"mc_chunk={mc_chunk}")
    nchunks = num_mc // mc_chunk

    # sigma = softplus(rho) is loop-invariant across draws: computed once
    # (f32), then cast with mu for the sampling kernel.
    mu = post.mu
    sigma = softplus(post.rho.to(torch.float32))
    if sample_dtype is not None:
        mu = mu.to(sample_dtype)
    sigma = sigma.to(mu.dtype)
    fast = _resolve_fast(fast_sampling, sample_dtype)

    logits = []
    for seed in chunk_seeds(generator, nchunks):
        ws = gaussian_shift_scale_split(mu, sigma, seed, mc_chunk,
                                        out_dtype=sample_dtype,
                                        fast_math=fast)
        for w in ws:
            params = meta.unpack(w, post.det)
            logits.append(module(params, batch_stats, *inputs, train=train,
                                 batch_mask=batch_mask))
    return torch.stack(logits)
