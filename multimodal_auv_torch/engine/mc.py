"""Monte-Carlo forward machinery (port of ``multimodal_auv_tpu/engine/mc.py``).

``mc_logits`` samples the packed posterior a chunk at a time, then runs one
sequential forward per draw. Each chunk takes its own seed pair from a
``torch.Generator``, as the JAX package takes one key per chunk; every path
draws the seeds the same way and in the same order (``chunk_seed_words``).

Two ways to consume a chunk:

* split (inference, ``split_mc_logits``): one launch of the split sampler
  gives separate weight vectors (``gaussian_shift_scale_split``); not
  differentiable. The seeds go to the device as one (nchunks, 2) tensor,
  and the sampler reads chunk k's words from row k, so the path is a
  function of tensors alone: ``torch.export`` traces it (serving.py).
* stacked (training): the differentiable ``gaussian_shift_scale``. With
  ``remat`` and a chunk of at most 4 draws, sampling and the chunk's
  forwards run under one ``torch.utils.checkpoint``, so the backward
  samples the weights again from the chunk's seed and regenerates eps from
  it: nothing but the seed pair is kept per chunk. The seeds are drawn from
  the generator before any checkpoint, so the re-forward sees the same
  weights.

BatchNorm: the reference runs BN in train mode even at inference, so the
forward normalises by the current batch's statistics (real rows only when
``batch_mask`` is given). ``return_batch_stats`` chains the running-statistics
update through the draws, one momentum step per stochastic forward, as the
reference's training does; otherwise the running statistics are untouched.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from multimodal_auv_torch.bayes.packing import PackedPosterior, PackMeta, softplus
from multimodal_auv_torch.ops.sampling import (
    chunk_seed_words,
    chunk_seeds,
    draw_offset_seed,
    gaussian_shift_scale,
    gaussian_shift_scale_split,
)
from multimodal_auv_torch.parallel.collectives import LOCAL, gather_draws


def not_ported(flag: str, item: str) -> NotImplementedError:
    """The error of a flag whose path is not ported yet, naming its item
    in ROADMAP.md."""
    return NotImplementedError(
        f"{flag} is not ported yet: ROADMAP.md, Open items, 1 'Modules to "
        f"port' item {item}")


def _resolve_fast(fast_sampling: Optional[bool],
                  sample_dtype: Optional[torch.dtype]) -> bool:
    """None -> fast noise exactly when sampling straight to bf16."""
    if fast_sampling is None:
        return sample_dtype == torch.bfloat16
    return bool(fast_sampling)


def _sampling_posterior(post: PackedPosterior,
                        sample_dtype: Optional[torch.dtype],
                        cast_posterior: bool = True):
    """(mu, sigma) as the sampler takes them. sigma = softplus(rho) is
    loop-invariant across draws: computed once (f32), then cast with mu
    for the sampling kernel."""
    mu = post.mu
    sigma = softplus(post.rho.to(torch.float32))
    if sample_dtype is not None and cast_posterior:
        return mu.to(sample_dtype), sigma.to(sample_dtype)
    return mu, sigma.to(mu.dtype)


def split_mc_logits(module, meta: PackMeta, post: PackedPosterior,
                    batch_stats, inputs: Sequence[torch.Tensor],
                    seeds: torch.Tensor, *, mc_chunk: int, train: bool = True,
                    sample_dtype: Optional[torch.dtype] = None,
                    batch_mask=None,
                    fast_sampling: Optional[bool] = None) -> torch.Tensor:
    """The split path of ``mc_logits``: (nchunks * mc_chunk, batch,
    num_classes) logits, chunk k's draws from the seed words in row k of
    ``seeds``, an (nchunks, 2) int64 tensor on the posterior's device. A
    function of tensors alone (no generator, no host value), so
    ``torch.export`` traces it; not differentiable."""
    mu, sigma = _sampling_posterior(post, sample_dtype)
    fast = _resolve_fast(fast_sampling, sample_dtype)
    logits = []
    for k in range(seeds.shape[0]):
        for w in gaussian_shift_scale_split(mu, sigma, seeds[k], mc_chunk,
                                            out_dtype=sample_dtype,
                                            fast_math=fast):
            logits.append(module(meta.unpack(w, post.det), batch_stats,
                                 *inputs, train=train,
                                 batch_mask=batch_mask))
    return torch.stack(logits)


def mc_logits(module, meta: PackMeta, post: PackedPosterior, batch_stats,
              inputs: Sequence[torch.Tensor], generator: torch.Generator,
              num_mc: int, *, mc_chunk: int = 1, train: bool = True,
              remat: bool = True, ws_sharding=None,
              sample_dtype: Optional[torch.dtype] = None,
              cast_posterior: bool = True, antithetic: bool = False,
              batch_mask=None, return_batch_stats: bool = False,
              split_sampling: bool = False, pipelined: bool = False,
              fast_sampling: Optional[bool] = None):
    """Stacked logits over MC draws: (num_mc, batch, num_classes); with
    ``return_batch_stats`` the pair (logits, new running statistics).

    ``sample_dtype``: dtype of the sampled weights (None: mu's dtype).
    ``cast_posterior``: with ``sample_dtype`` set, cast mu and sigma to it
    before sampling (inference); False keeps them f32 and casts only the
    sampler's output (training: f32 master posterior and f32 gradients).
    ``split_sampling``: the split sampler; ignored (stacked) with
    ``return_batch_stats`` or ``ws_sharding``. ``ws_sharding``: a mesh
    (``parallel/mesh.py``) whose mc axis splits each chunk's draws:
    rank m draws rows [m k, (m + 1) k) of every chunk, k = mc_chunk / mc,
    from the chunk's seed with its draw offset folded in
    (``draw_offset_seed``), so the rows equal the unsharded stack's, and
    the logits are gathered over the mc axis (differentiably: each rank's
    backward takes its own draws' gradient). ``fast_sampling``: the
    bf16-budget noise on the split path (None = exactly when sampling to
    bf16); the stacked path always uses the f32 noise its backward
    regenerates. ``train``: BN from batch statistics (else running
    statistics). ``remat``: checkpoint each chunk's sampling and forwards
    when gradients are being recorded."""
    if antithetic:
        raise not_ported("antithetic", "5 (training: antithetic draws)")
    if pipelined:
        raise not_ported("pipelined", "4 (MC inference, pipelined variant)")
    if num_mc % mc_chunk != 0:
        raise ValueError(f"num_mc={num_mc} must be divisible by "
                         f"mc_chunk={mc_chunk}")
    if return_batch_stats and not train:
        raise ValueError("return_batch_stats requires train=True")
    nchunks = num_mc // mc_chunk
    axis = LOCAL if ws_sharding is None else ws_sharding.mc_axis
    if mc_chunk % axis.size:
        raise ValueError(f"mc_chunk={mc_chunk} must be divisible by the mc "
                         f"axis ({axis.size})")
    if return_batch_stats and axis.size > 1:
        raise ValueError("return_batch_stats: chained BN updates are "
                         "sequential per draw, incompatible with mc-sharded "
                         "draws (refresh_batch_stats instead)")
    if split_sampling and not return_batch_stats and ws_sharding is None:
        seeds = chunk_seed_words(generator, nchunks)
        return split_mc_logits(
            module, meta, post, batch_stats, inputs,
            seeds.to(post.mu.device, non_blocking=True), mc_chunk=mc_chunk,
            train=train, sample_dtype=sample_dtype, batch_mask=batch_mask,
            fast_sampling=fast_sampling)

    mu, sigma = _sampling_posterior(post, sample_dtype, cast_posterior)
    P = mu.shape[0]
    # seeds come from the generator here, outside any checkpoint: drawn
    # inside, the re-forward would sample other weights
    seeds = chunk_seeds(generator, nchunks)

    def fwd(w, bs):
        params = meta.unpack(w, post.det)
        if return_batch_stats:
            return module(params, bs, *inputs, train=True,
                          batch_mask=batch_mask, mutable=True)
        return module(params, batch_stats, *inputs, train=train,
                      batch_mask=batch_mask), bs

    recording = torch.is_grad_enabled() and (mu.requires_grad
                                             or sigma.requires_grad)
    # under an mc axis this rank draws rows [d0, d0 + k) of every chunk
    k = mc_chunk // axis.size
    d0 = axis.index * k
    if remat and recording and k > 4:
        raise not_ported("remat with mc_chunk > 4 (per-draw checkpoints "
                         "keeping the sampled weights)", "5 (training)")

    def chunk(seed, bs):
        ws = gaussian_shift_scale(mu, sigma, draw_offset_seed(seed, d0, P),
                                  k, out_dtype=sample_dtype)
        outs = []
        for w in ws.unbind(0):
            out, bs = fwd(w, bs)
            outs.append(out)
        return torch.stack(outs), bs

    bs = batch_stats if return_batch_stats else None
    logits = []
    for seed in seeds:
        if remat and recording:
            out, bs = checkpoint(chunk, seed, bs, use_reentrant=False,
                                 preserve_rng_state=False)
        else:
            out, bs = chunk(seed, bs)
        logits.append(out)
    logits = torch.cat(logits)
    if axis.size > 1:
        # [rank 0's draws of every chunk | rank 1's | ...] -> chunk order
        logits = gather_draws(logits, axis).view(
            (axis.size, nchunks, k) + tuple(logits.shape[1:]))
        logits = logits.transpose(0, 1).reshape((num_mc,)
                                                + tuple(logits.shape[3:]))
    return (logits, bs) if return_batch_stats else logits


def refresh_batch_stats(module, meta: PackMeta, post: PackedPosterior,
                        batch_stats, inputs, batch_mask=None):
    """One posterior-mean forward that advances the running statistics
    (momentum 0.9, as torch BN momentum=0.1); returns the new statistics."""
    with torch.no_grad():
        params = meta.unpack(post.mu, post.det)
        _, new = module(params, batch_stats, *inputs, train=True,
                        batch_mask=batch_mask, mutable=True)
    return new
