"""Monte-Carlo forward machinery (port of ``multimodal_auv_tpu/engine/mc.py``).

``mc_logits`` samples the packed posterior a chunk at a time, then runs one
sequential forward per draw. Each chunk takes its own seed pair from a
``torch.Generator``, as the JAX package takes one key per chunk; every path
draws the seeds the same way and in the same order (``chunk_seed_words``).

Three ways to consume a chunk:

* split (inference, ``split_mc_logits``): one launch of the split sampler
  gives separate weight vectors (``gaussian_shift_scale_split``); not
  differentiable. The seeds go to the device as one (nchunks, 2) tensor,
  and the sampler reads chunk k's words from row k, so the path is a
  function of tensors alone: ``torch.export`` traces it (serving.py).
* pipelined (inference): the split path's draws, seeds and order, with
  chunk k + 1 sampled on a second CUDA stream while chunk k's forwards run
  on the current one, so the logits equal the split path's bit for bit.
  On the CPU the same order runs on one stream.
* stacked (training): the differentiable ``gaussian_shift_scale``. With
  ``remat`` and at most 4 forwards per chunk, sampling and the chunk's
  forwards run under one ``torch.utils.checkpoint``, so the backward
  samples the weights again from the chunk's seed and regenerates eps from
  it: nothing but the seed pair is kept per chunk. Larger chunks sample
  once, outside any checkpoint, keep the (k, P) stack for the backward,
  and checkpoint each draw's forward on its own (per-draw remat): one
  sampler and one eps launch per chunk. The seeds are drawn from the
  generator before any checkpoint, so the re-forward sees the same
  weights. ``antithetic`` pairs each draw w with its mirror 2 mu - w on
  this path.

BatchNorm: the reference runs BN in train mode even at inference, so the
forward normalises by the current batch's statistics (real rows only when
``batch_mask`` is given). ``return_batch_stats`` chains the running-statistics
update through the draws, one momentum step per stochastic forward, as the
reference's training does; otherwise the running statistics are untouched.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
from torch._higher_order_ops.map import map as draw_map
from torch.utils.checkpoint import checkpoint

from multimodal_auv_torch.bayes.packing import PackedPosterior, PackMeta, softplus
from multimodal_auv_torch.ops.sampling import (
    chunk_seed_words,
    chunk_seeds,
    draw_offset_seed,
    gaussian_shift_scale,
    gaussian_shift_scale_split,
    stacked_draws,
)
from multimodal_auv_torch.parallel.collectives import LOCAL, gather_draws

# a chunk of at most this many forwards (on this rank) samples inside its
# checkpoint; a larger one keeps its sampled stack (per-draw remat)
SAMPLE_IN_REMAT_MAX = 4


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


def _pipelined(sample: Callable[[int], List[torch.Tensor]],
               forward: Callable[[torch.Tensor], torch.Tensor],
               nchunks: int, device: torch.device,
               inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Chunk k's forwards, in order, with chunk k + 1 sampled first: on a
    CUDA device on a side stream, so the sampler overlaps the forwards.
    ``inputs``: the tensors ``sample`` reads, made on the current stream."""
    if device.type != "cuda":
        logits, ws = [], sample(0)
        for k in range(nchunks):
            nxt = sample(k + 1) if k + 1 < nchunks else None
            logits += [forward(w) for w in ws]
            ws = nxt
        return logits
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device=device)  # raises where none can be made
    # mu, sigma (cast here) and the seed words (copied non_blocking) are
    # made on the current stream: the side stream waits for them
    side.wait_stream(cur)
    for t in inputs:
        t.record_stream(side)

    def on_side(k):
        with torch.cuda.stream(side):
            ws = sample(k)
            done = torch.cuda.Event()
            done.record(side)
        return ws, done

    logits, (ws, done) = [], on_side(0)
    for k in range(nchunks):
        nxt = on_side(k + 1) if k + 1 < nchunks else None
        cur.wait_event(done)
        for w in ws:
            # allocated on the side stream, read on this one: the
            # allocator must not hand its block out before these forwards
            w.record_stream(cur)
        logits += [forward(w) for w in ws]
        if nxt is not None:
            ws, done = nxt
    return logits


def split_mc_logits(module, meta: PackMeta, post: PackedPosterior,
                    batch_stats, inputs: Sequence[torch.Tensor],
                    seeds: torch.Tensor, *, mc_chunk: int, train: bool = True,
                    sample_dtype: Optional[torch.dtype] = None,
                    batch_mask=None,
                    fast_sampling: Optional[bool] = None,
                    pipelined: bool = False) -> torch.Tensor:
    """The split path of ``mc_logits``: (nchunks * mc_chunk, batch,
    num_classes) logits, chunk k's draws from the seed words in row k of
    ``seeds``, an (nchunks, 2) int64 tensor on the posterior's device. A
    function of tensors alone (no generator, no host value), so
    ``torch.export`` traces it; not differentiable. ``pipelined`` (two
    chunks or more): chunk k + 1 is sampled on a second CUDA stream while
    chunk k's forwards run, with the same draws in the same order, so the
    logits are the same bit for bit (not for ``torch.export``)."""
    mu, sigma = _sampling_posterior(post, sample_dtype)
    fast = _resolve_fast(fast_sampling, sample_dtype)

    def sample(k):
        return gaussian_shift_scale_split(mu, sigma, seeds[k], mc_chunk,
                                          out_dtype=sample_dtype,
                                          fast_math=fast)

    def forward(w):
        return module(meta.unpack(w, post.det), batch_stats, *inputs,
                      train=train, batch_mask=batch_mask)

    nchunks = seeds.shape[0]
    if pipelined and nchunks >= 2:
        return torch.stack(_pipelined(sample, forward, nchunks, mu.device,
                                      (mu, sigma, seeds)))
    return torch.stack([forward(w) for k in range(nchunks)
                        for w in sample(k)])


def stacked_mc_logits(module, meta: PackMeta, post: PackedPosterior,
                      batch_stats, inputs: Sequence[torch.Tensor],
                      seeds: torch.Tensor, *, rows: int, train: bool = True,
                      sample_dtype: Optional[torch.dtype] = None,
                      batch_mask=None) -> torch.Tensor:
    """The stacked path as a function of tensors: (nchunks * rows, batch,
    num_classes) logits, ``rows`` draws with the f32 noise from the seed
    words in row k of ``seeds`` ((nchunks, 2) int64 on the posterior's
    device), through the op ``auv::stacked_sampler`` (``stacked_draws``),
    so ``torch.export`` traces it; not differentiable. Given an mc rank's
    words (``draw_offset_seed`` of the chunk's seed at the rank's first
    row), the logits are that rank's rows of ``mc_logits``' stacked path
    bit for bit: what an mc-sharded serving program runs. A chunk's
    forwards are one ``map`` over its draws (torch's higher-order op, the
    same forward per row), so an exported program holds one draw's
    forward, not ``rows`` copies of it: its export, save and load cost
    one draw's graph."""
    mu, sigma = _sampling_posterior(post, sample_dtype)

    def forward(w, det, stats, inputs, mask):
        return module(meta.unpack(w, det), stats, *inputs, train=train,
                      batch_mask=mask)

    return torch.cat([
        draw_map(forward, stacked_draws(mu, sigma, seeds[k], rows,
                                        out_dtype=sample_dtype),
                 post.det, batch_stats, tuple(inputs), batch_mask)
        for k in range(seeds.shape[0])])


def _mirror(mu: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """The antithetic rows of ``ws``: 2 mu - w, formed in f32 and cast to
    the draws' dtype (mu: the sampling mu)."""
    return (2.0 * mu.to(torch.float32) - ws.to(torch.float32)).to(ws.dtype)


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
    ``split_sampling``: the split sampler, a hint: ignored (stacked) with
    ``return_batch_stats``, ``antithetic`` or ``ws_sharding``.
    ``antithetic``: each chunk runs 2 x mc_chunk draws, its mc_chunk
    sampled rows ws and their mirrors 2 mu - ws (formed in f32 and cast;
    mu the sampling mu, so the bf16 one under ``cast_posterior``), on the
    stacked sampler; num_mc must divide by 2 x mc_chunk; refused with
    ``return_batch_stats``. ``pipelined``: the split path with chunk k + 1
    sampled on a second CUDA stream during chunk k's forwards (the same
    logits); a hint, inactive under remat while gradients are recorded,
    antithetic, an mc axis, chained BN or a single chunk. ``ws_sharding``:
    a mesh (``parallel/mesh.py``) whose mc axis splits each chunk's rows:
    rank m takes rows [m k, (m + 1) k) of every chunk, k = rows / mc, from
    the chunk's seed with its draw offset folded in
    (``draw_offset_seed``; a mirror row draws the row it mirrors), so the
    rows equal the unsharded stack's, and the logits are gathered over the
    mc axis (differentiably: each rank's backward takes its own draws'
    gradient). ``fast_sampling``: the bf16-budget noise on the split path
    (None = exactly when sampling to bf16); the stacked path always uses
    the f32 noise its backward regenerates. ``train``: BN from batch
    statistics (else running statistics). ``remat``: when gradients are
    being recorded, checkpoint each chunk's sampling and forwards (at most
    4 forwards per chunk on this rank), else each draw's forward with the
    chunk's sampled stack kept."""
    rows = mc_chunk * (2 if antithetic else 1)
    if num_mc % rows != 0:
        raise ValueError(f"num_mc={num_mc} must be divisible by "
                         f"{'2*' if antithetic else ''}mc_chunk={mc_chunk}")
    if return_batch_stats and not train:
        raise ValueError("return_batch_stats requires train=True")
    nchunks = num_mc // rows
    axis = LOCAL if ws_sharding is None else ws_sharding.mc_axis
    if rows % axis.size:
        raise ValueError(f"{'2*' if antithetic else ''}mc_chunk={mc_chunk} "
                         f"must be divisible by the mc axis ({axis.size})")
    if return_batch_stats and (axis.size > 1 or antithetic):
        raise ValueError("return_batch_stats: chained BN updates are "
                         "sequential per draw, incompatible with mc-sharded "
                         "or antithetic draws (refresh_batch_stats instead)")
    recording = torch.is_grad_enabled() and (post.mu.requires_grad
                                             or post.rho.requires_grad)
    # the chained-BN, antithetic and mc-sharded draws need the stacked
    # layout: the split and pipelined hints give way to them
    stacked = return_batch_stats or antithetic or ws_sharding is not None
    pipe = (pipelined and not stacked and not (remat and recording)
            and nchunks > 1)
    if pipe or (split_sampling and not stacked):
        seeds = chunk_seed_words(generator, nchunks)
        return split_mc_logits(
            module, meta, post, batch_stats, inputs,
            seeds.to(post.mu.device, non_blocking=True), mc_chunk=mc_chunk,
            train=train, sample_dtype=sample_dtype, batch_mask=batch_mask,
            fast_sampling=fast_sampling, pipelined=pipe)

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

    # under an mc axis this rank takes rows [r0, r0 + k) of every chunk
    k = rows // axis.size
    r0 = axis.index * k
    sample_in_remat = remat and recording and k <= SAMPLE_IN_REMAT_MAX
    per_draw = remat and recording and not sample_in_remat

    def draws(seed, d0, n):
        return gaussian_shift_scale(mu, sigma, draw_offset_seed(seed, d0, P),
                                    n, out_dtype=sample_dtype)

    def sample(seed):
        """This rank's k rows of the chunk of ``seed``: sampled rows below
        mc_chunk, mirrors of rows [0, mc_chunk) above it."""
        if not antithetic:
            return draws(seed, r0, k)
        parts = []
        lo, hi = r0, r0 + k
        if lo < mc_chunk:
            parts.append(draws(seed, lo, min(hi, mc_chunk) - lo))
        if hi > mc_chunk:
            a, b = max(lo, mc_chunk) - mc_chunk, hi - mc_chunk
            # from row 0 this rank sampled every row its mirrors need
            ws = parts[0][a:b] if lo == 0 else draws(seed, a, b - a)
            parts.append(_mirror(mu, ws))
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    def chunk(seed, bs):
        outs = []
        for w in sample(seed).unbind(0):
            if per_draw:
                out, bs = checkpoint(fwd, w, bs, use_reentrant=False,
                                     preserve_rng_state=False)
            else:
                out, bs = fwd(w, bs)
            outs.append(out)
        return torch.stack(outs), bs

    bs = batch_stats if return_batch_stats else None
    logits = []
    for seed in seeds:
        if sample_in_remat:
            out, bs = checkpoint(chunk, seed, bs, use_reentrant=False,
                                 preserve_rng_state=False)
        else:
            out, bs = chunk(seed, bs)
        logits.append(out)
    logits = torch.cat(logits)
    if axis.size > 1:
        # [rank 0's rows of every chunk | rank 1's | ...] -> chunk order
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
