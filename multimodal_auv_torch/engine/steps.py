"""Train and eval steps: the MC-ELBO recipe (port of
``multimodal_auv_tpu/engine/steps.py``).

Loss semantics are the reference's (train/multimodal.py:104-130):

    logits_mc  : num_mc stochastic forwards (weights re-sampled per draw)
    output     = mean(logits_mc, axis=0)
    scaled_kl  = KL(q || prior) / batch_size * kl_weight
    loss       = CrossEntropy(output, labels) + scaled_kl

(The per-draw KL is a deterministic function of (mu, rho), so it is
computed once.) A step whose loss or gradients are not finite updates
neither the posterior nor the Adam state, as the reference skips such
batches (multimodal.py:133-145). The JAX step selects branchlessly inside
one program; here the guard costs one host sync per step.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_auv_torch.bayes.packing import kl_divergence
from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.engine import uncertainty as U
from multimodal_auv_torch.engine.mc import mc_logits, refresh_batch_stats
from multimodal_auv_torch.engine.optim import (
    BayesTrainState,
    ShardedAdam,
    full_posterior,
    trainable_leaves,
)
from multimodal_auv_torch.ops.preprocess import normalize_multimodal
from multimodal_auv_torch.parallel.collectives import (
    LOCAL,
    Axis,
    all_reduce_,
    bn_sync,
)


logger = logging.getLogger(__name__)


def _masked_ce_sum(output: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """The CE summed over the real rows."""
    ce_vec = F.cross_entropy(output, labels.long(), reduction="none")
    return (ce_vec * mask).sum()


def _data_axis(mesh) -> Axis:
    """The axis the batch's rows are split over (one rank without a
    mesh)."""
    return LOCAL if mesh is None else mesh.data_axis


def make_elbo_loss_fn(module, meta, spec: BNNPriorSpec, num_mc: int, *,
                      mc_chunk: int = 1, sample_dtype=None,
                      packed_inputs: bool = False, remat: bool = True,
                      mesh=None, update_batch_stats: bool = True):
    """The training ELBO that ``make_train_step`` differentiates.

    Returns loss_fn(post, batch_stats, inputs, labels, mask, generator,
    kl_weight, bs_scale) -> (loss, (output, ce, scaled_kl,
    new_batch_stats)). ``mask`` is f32 (batch,): 1.0 for real rows, 0.0
    for the padding of a ragged last batch. The running statistics are
    chained through the draws (``mc_logits(return_batch_stats=True)``).

    ``mesh`` (``parallel/mesh.py``; run under ``bn_sync(mesh.data_axis)``):
    ``inputs`` are this rank's rows. The CE is this rank's share of the
    global one, the sum over its real rows over the global count (JAX's
    normalisation), and the KL, which every rank computes in full, enters
    as 1/world of it, so the ranks' losses (and gradients) sum to the
    global ELBO's. Under an mc axis the draws are split over it
    (``ws_sharding``), and the chained BN update, sequential in the draws,
    gives way to one posterior-mean refresh (``refresh_batch_stats``), as
    in the JAX package. ``update_batch_stats=False``: the running
    statistics are returned as they came in (neither chained nor
    refreshed)."""
    chained = update_batch_stats and (mesh is None or mesh.mc == 1)
    world = 1 if mesh is None else mesh.world_axis.size

    def loss_fn(post, batch_stats, inputs, labels, mask, generator,
                kl_weight, bs_scale):
        if packed_inputs:
            inputs = normalize_multimodal(*inputs)
        kw = dict(mc_chunk=mc_chunk, train=True, remat=remat,
                  batch_mask=mask, sample_dtype=sample_dtype,
                  cast_posterior=False)
        if chained:
            logits, new_bs = mc_logits(
                module, meta, post, batch_stats, inputs, generator, num_mc,
                return_batch_stats=True, **kw)
        else:
            logits = mc_logits(module, meta, post, batch_stats, inputs,
                               generator, num_mc, ws_sharding=mesh, **kw)
            new_bs = (refresh_batch_stats(module, meta, post, batch_stats,
                                          inputs, batch_mask=mask)
                      if update_batch_stats else batch_stats)
        output = logits.to(torch.float32).mean(dim=0)
        # this rank's share of the CE over the global count of real rows
        count = all_reduce_(mask.sum().reshape(1), _data_axis(mesh))[0]
        ce = (_masked_ce_sum(output, labels, mask)
              / torch.clamp_min(count, 1.0))
        scaled_kl = kl_divergence(post, spec) / bs_scale * kl_weight
        return ce + scaled_kl / world, (output, ce, scaled_kl, new_bs)

    return loss_fn


def _all_reduce_grads(post, mesh) -> None:
    """Sum every trainable leaf's gradient over all ranks: one all_reduce
    of their concatenation (nothing on one rank). Leaves without a
    gradient are left out (under fsdp the shard's mu and rho, whose
    gradients come by reduce-scatter)."""
    if mesh is None or mesh.world_axis.size == 1:
        return
    leaves = [p for p in trainable_leaves(post) if p.grad is not None]
    if not leaves:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in leaves])
    all_reduce_(flat, mesh.world_axis)
    for p, g in zip(leaves, flat.split([p.numel() for p in leaves])):
        p.grad.copy_(g.view_as(p.grad))


def device_memory_budget(device) -> Optional[int]:
    """Bytes a step may still allocate on ``device``: the card's total
    memory x 0.95 less what this process has allocated; None off the card
    (no budget)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    total = torch.cuda.mem_get_info(device)[1]
    return int(total * 0.95) - torch.cuda.memory_allocated(device)


def _is_oom(e: BaseException) -> bool:
    return (isinstance(e, torch.OutOfMemoryError)
            or "out of memory" in str(e).lower())


def saved_bytes(fn: Callable[[], Any]) -> int:
    """The bytes autograd keeps for the backward of ``fn()``'s graph: the
    tensors saved for it, each storage counted once. ``fn`` runs with
    gradients recorded; its graph is dropped before this returns."""
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[(st.device, st.data_ptr())] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    del out
    return sum(seen.values())


class AutoRematTrainStep:
    """``remat="auto"``: per-draw remat keeps training memory flat in
    num_mc but pays a re-forward in every backward; when the no-remat
    step's residuals fit the card, keeping them is faster. Resolves on
    the first call, with its real arguments:

    * The measure: trial forwards of the no-remat loss over one and two
      units of draws (a unit: 1 draw, or one per rank of the mesh's mc
      axis); their saved tensors (``saved_bytes``) give the bytes of the
      step's fixed part and of each unit, scaled to num_mc draws. The
      trials consume no draw of the caller's generator (they draw from a
      copy), set no ``.grad``, step no optimizer and keep no BN
      statistics, so the step chosen computes what the explicitly chosen
      remat computes.
    * The budget: ``device_memory_budget`` (the card's total x 0.95 less
      what is allocated). Without one (the CPU) the choice is remat on,
      with no trial.
    * The trial running out of memory falls back to remat on; any other
      error is raised. Under a process group every rank takes the same
      choice (remat off only if it fits on every rank).

    ``remat_used``, ``need_bytes`` and ``budget_bytes`` tell the choice,
    which is also logged."""

    def __init__(self, build: Callable[[bool], Callable],
                 trial_loss_fn: Callable[[int], Callable], num_mc: int,
                 unit: int = 1, mesh=None):
        self._build = build          # build(remat: bool) -> step
        self._trial_loss_fn = trial_loss_fn  # (draws) -> no-remat loss_fn
        self._unit = unit
        self._units = num_mc // unit
        self._mesh = mesh
        self._step = None
        self.remat_used: Optional[bool] = None
        self.need_bytes: Optional[int] = None
        self.budget_bytes: Optional[int] = None

    def __call__(self, state, inputs, labels, mask, generator, kl_weight,
                 batch_size_scale):
        if self._step is None:
            self.remat_used = not self._fits(state, inputs, labels, mask,
                                             generator, kl_weight,
                                             batch_size_scale)
            self._step = self._build(self.remat_used)
        return self._step(state, inputs, labels, mask, generator, kl_weight,
                          batch_size_scale)

    def _trial(self, post, state, inputs, labels, mask, generator,
               kl_weight, bs_scale) -> int:
        def kept(units):
            loss_fn = self._trial_loss_fn(units * self._unit)
            trial_gen = torch.Generator(device=generator.device)
            trial_gen.set_state(generator.get_state())
            return saved_bytes(lambda: loss_fn(
                post, state.batch_stats, inputs, labels, mask,
                trial_gen, kl_weight, bs_scale))

        with torch.enable_grad(), bn_sync(_data_axis(self._mesh)):
            one = kept(1)
            if self._units == 1:
                return one
            return one + (self._units - 1) * (kept(2) - one)

    def _fits(self, *args) -> bool:
        state = args[0]
        # under fsdp the step's gathered mu and rho are allocated before
        # the budget is read, so it counts them, and the trial runs on them
        post = full_posterior(state, requires_grad=True)
        budget = device_memory_budget(state.post.mu.device)
        self.budget_bytes = budget
        if budget is None:
            fits = False
            logger.info("remat=auto: no memory budget on %s, remat on",
                        state.post.mu.device)
        else:
            try:
                self.need_bytes = self._trial(post, *args)
                fits = self.need_bytes <= budget
            except Exception as e:
                if not _is_oom(e):
                    raise
                fits = False
                logger.info("remat=auto: the no-remat trial ran out of "
                            "memory (%s)", e)
            logger.info(
                "remat=auto: the no-remat step keeps %s GiB for its "
                "backward, budget %.2f GiB -> remat %s",
                "n/a" if self.need_bytes is None
                else f"{self.need_bytes / 2**30:.2f}", budget / 2**30,
                "off" if fits else "on")
        if self._mesh is not None and self._mesh.world_axis.size > 1:
            # the choice of every rank: off only if it fits on all
            misfits = torch.tensor([float(not fits)],
                                   device=state.post.mu.device)
            fits = float(all_reduce_(misfits, self._mesh.world_axis)) == 0.0
        del post
        return fits


def make_train_step(module, meta, spec: BNNPriorSpec, num_mc: int, *,
                    mc_chunk: int = 1, sample_dtype=None,
                    packed_inputs: bool = False, remat="on", mesh=None,
                    update_batch_stats: bool = True):
    """Returns (state, inputs, labels, mask, generator, kl_weight,
    batch_size_scale) -> (state, metrics). ``mask`` is f32[batch]
    (1.0 = real row, 0.0 = ragged-tail padding) and sits BEFORE the
    generator. The state's posterior and Adam state are updated in place;
    the step's gradients stay in the leaves' ``.grad`` until the next step.

    BN running statistics are chained through the MC loop (one momentum
    update per stochastic forward, the reference's semantics) at no extra
    forward; ``update_batch_stats=False`` leaves them unchanged (frozen
    fine-tuning), and under a mesh with an mc axis it decides whether the
    one posterior-mean refresh runs.

    ``sample_dtype``: dtype of the sampled weights fed to the forward
    (``torch.bfloat16``: mixed precision; mu, rho, gradients and Adam stay
    f32). ``remat``: "on" (checkpoint each chunk's sampling and forwards,
    or each draw's forward above 4 draws a chunk: memory flat in num_mc),
    "off", or "auto" (an ``AutoRematTrainStep``: off when the no-remat
    step fits the card's budget, ``device_memory_budget``).

    ``mesh`` (``parallel/mesh.py``): the step takes this rank's rows
    (``parallel.mesh.wrap_train_step`` slices them from the loops'
    global batches). BatchNorm statistics are the global batch's, the
    draws are split over the mc axis, the gradients are summed over all
    ranks before the update (one all_reduce), and the metrics' scalars are
    global; ``predicted`` holds this rank's rows. A state sharded by
    fsdp (``parallel.mesh.shard_state``) has mu and rho gathered at entry
    (``ShardedAdam.gather``), their gradients reduce-scattered onto the
    shard (the deterministic leaves' still all-reduced) and the full
    vectors freed before the step returns; the verdict of the NaN guard
    is summed over all ranks, so every rank steps or skips together."""
    if remat == "auto":
        kw = dict(mc_chunk=mc_chunk, sample_dtype=sample_dtype,
                  packed_inputs=packed_inputs, mesh=mesh,
                  update_batch_stats=update_batch_stats)
        unit = 1 if mesh is None else mesh.mc
        return AutoRematTrainStep(
            lambda r: make_train_step(module, meta, spec, num_mc, remat=r,
                                      **kw),
            lambda n: make_elbo_loss_fn(
                module, meta, spec, n, mc_chunk=unit,
                sample_dtype=sample_dtype, packed_inputs=packed_inputs,
                remat=False, mesh=mesh,
                update_batch_stats=update_batch_stats),
            num_mc, unit, mesh)
    remat = remat if isinstance(remat, bool) else {"on": True,
                                                   "off": False}[remat]
    loss_fn = make_elbo_loss_fn(module, meta, spec, num_mc,
                                mc_chunk=mc_chunk, sample_dtype=sample_dtype,
                                packed_inputs=packed_inputs, remat=remat,
                                mesh=mesh,
                                update_batch_stats=update_batch_stats)

    def step(state: BayesTrainState, inputs, labels, mask, generator,
             kl_weight, batch_size_scale) -> Tuple[BayesTrainState, Any]:
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        sharded = isinstance(opt, ShardedAdam)
        post = full_posterior(state, requires_grad=True)
        with bn_sync(_data_axis(mesh)):
            loss, (output, ce, scaled_kl, new_bs) = loss_fn(
                post, state.batch_stats, inputs, labels, mask,
                generator, kl_weight, batch_size_scale)
            loss.backward()
        predicted = output.detach().argmax(dim=-1)
        correct = ((predicted == labels) * mask).sum()
        total = mask.sum()
        _all_reduce_grads(state.post, mesh)
        if sharded:
            opt.scatter_grads(post, state.post)
        del post, loss, output  # the gathered vectors and their graph
        ce, correct, total = all_reduce_(torch.stack(
            [ce.detach(), correct.to(ce.dtype), total]),
            _data_axis(mesh)).unbind()
        scaled_kl = scaled_kl.detach()
        loss = ce + scaled_kl
        grads = [p.grad for p in trainable_leaves(state.post)
                 if p.grad is not None]
        finite = torch.stack([torch.isfinite(loss)]
                             + [torch.isfinite(g).all() for g in grads])
        if sharded:  # each rank checked its own shard: every rank's verdict
            finite = all_reduce_((~finite).to(torch.float32),
                                 opt.axis) == 0
        loss_ok, *grads_ok = finite.tolist()  # the step's one host sync
        ok = loss_ok and all(grads_ok)
        if ok:
            opt.step()

        loss = loss.detach()
        loss_out = loss if loss_ok else torch.full_like(loss, float("nan"))
        skipped = torch.tensor(float(not ok), device=loss.device)
        metrics = {
            "loss": loss_out,
            "cross_entropy": ce.detach(),
            "scaled_kl": scaled_kl.detach(),
            "correct": correct,
            "total": total,
            "skipped": not ok,
            "predicted": predicted,
            # every scalar and the per-sample vector as one f32 tensor: one
            # device-to-host copy per batch (parse with unfuse_train_metrics)
            "fused": torch.cat([
                torch.stack([loss_out, ce.detach(), scaled_kl.detach(),
                             correct.to(torch.float32), total, skipped]),
                predicted.to(torch.float32)]),
        }
        new_state = BayesTrainState(post=state.post, opt_state=opt,
                                    batch_stats=new_bs, step=state.step + 1)
        return new_state, metrics

    return step


def make_eval_step(module, meta, spec: BNNPriorSpec, num_mc: int, *,
                   mc_chunk: int = 1, packed_inputs: bool = False,
                   mesh=None):
    """Returns (post, batch_stats, inputs, labels, mask, generator,
    kl_scale) -> metrics with both uncertainty families, on the split
    sampling path with f32 noise. ``kl_scale`` absorbs the call site's
    divisor and the annealed kl_weight (multimodal eval divides the KL by
    len(dataloader), the reference's multimodal.py:293).

    ``mesh``: this rank's rows in, global scalars out (one all_reduce over
    the data axis), per-sample outputs of this rank's rows
    (``parallel.mesh.wrap_eval_step`` gathers them); the draws split over
    the mc axis on the stacked path. Under fsdp ``post`` is the whole
    posterior, gathered the train step's way by ``engine/optim.py::
    full_posterior`` (the loops gather it once per evaluation)."""
    ws = None if mesh is None or mesh.mc == 1 else mesh

    @torch.no_grad()
    def step(post, batch_stats, inputs, labels, mask, generator, kl_scale):
        if packed_inputs:
            inputs = normalize_multimodal(*inputs)
        with bn_sync(_data_axis(mesh)):
            logits = mc_logits(module, meta, post, batch_stats, inputs,
                               generator, num_mc, mc_chunk=mc_chunk,
                               train=True, remat=False, batch_mask=mask,
                               split_sampling=True, ws_sharding=ws)
        probs = U.softmax_probs(logits)
        output_mean = logits.to(torch.float32).mean(dim=0)
        predicted = output_mean.argmax(dim=-1)
        correct = ((predicted == labels) * mask).sum()
        total = mask.sum()
        ce_sum, correct, total = all_reduce_(torch.stack(
            [_masked_ce_sum(output_mean, labels, mask),
             correct.to(torch.float32), total]), _data_axis(mesh)).unbind()
        ce = ce_sum / torch.clamp_min(total, 1.0)
        kl_scaled = kl_divergence(post, spec) * kl_scale
        ent = U.entropy_decomposition(probs, eps=1e-8)
        mean_prob = U.mean_probs(probs)
        epi_var = U.variance_uncertainty(probs)
        alea_mc = U.aleatoric_uncertainty(probs, eps=1e-7)
        loss = ce + kl_scaled
        f32 = lambda t: t.to(torch.float32)
        return {
            "loss": loss,
            "cross_entropy": ce,
            "kl_scaled": kl_scaled,
            "predicted": predicted,
            "mean_prob": mean_prob,
            "correct": correct,
            "total": total,
            # entropy-decomposition family (the reference's multimodal eval)
            "predictive_entropy": ent.predictive,
            "aleatoric_entropy": ent.aleatoric,
            "model_uncertainty": ent.model,
            # variance family (the reference's unimodal eval; eps 1e-7)
            "epistemic_variance": epi_var,
            "aleatoric_mc_entropy": alea_mc,
            # one-copy bundle, parse with unfuse_eval_metrics
            "fused": torch.cat([
                torch.stack([loss, ce, kl_scaled, f32(correct), total]),
                f32(predicted), f32(ent.predictive), f32(ent.aleatoric),
                f32(ent.model), f32(epi_var), f32(alea_mc),
                f32(mean_prob).reshape(-1)]),
        }

    return step


def unfuse_train_metrics(vec) -> dict:
    """Host-side parse of ``make_train_step``'s ``fused`` tensor."""
    vec = np.asarray(vec)
    return {
        "loss": float(vec[0]),
        "cross_entropy": float(vec[1]),
        "scaled_kl": float(vec[2]),
        "correct": float(vec[3]),
        "total": float(vec[4]),
        "skipped": bool(vec[5]),
        "predicted": vec[6:].astype(np.int32),
    }


def unfuse_eval_metrics(vec, batch_size: int) -> dict:
    """Host-side parse of ``make_eval_step``'s ``fused`` tensor: 5 scalars,
    6 per-sample vectors of length ``batch_size``, then the (batch, C)
    mean_prob raveled."""
    vec = np.asarray(vec)
    b = batch_size
    names = ["predicted", "predictive_entropy", "aleatoric_entropy",
             "model_uncertainty", "epistemic_variance", "aleatoric_mc_entropy"]
    out = {
        "loss": float(vec[0]),
        "cross_entropy": float(vec[1]),
        "kl_scaled": float(vec[2]),
        "correct": float(vec[3]),
        "total": float(vec[4]),
    }
    off = 5
    for n in names:
        out[n] = vec[off:off + b]
        off += b
    out["predicted"] = out["predicted"].astype(np.int32)
    out["mean_prob"] = vec[off:].reshape(b, -1)
    return out
