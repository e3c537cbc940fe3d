"""Deterministic variance propagation (DVP): a single probabilistic forward
pass (port of ``multimodal_auv_tpu/engine/moment.py``).

An opt-in fast-inference mode: instead of num_mc sampled forwards,
propagate the activation mean and (diagonal) variance analytically through
the trunks,

  conv/dense:  m' = conv(m, Mw);  v' = conv(v, Mw^2) + conv(m^2 + v, Vw)
  ReLU:        Gaussian closed form via Phi/phi
  BatchNorm:   train-mode statistics of the mean map (+ mean input variance)
  pool/GAP:    max-of-means / independence-sum approximations

and Monte-Carlo sample only the pooled features and the small fusion head.
The approximation (diagonal covariance, moment-matched ReLU, the BN and
pool closures) was validated near MOPED-tight posteriors only, so
``make_dvp_predict_step`` measures the posterior's spread and, beyond
``DVP_SPREAD_THRESHOLD``, warns or falls back to the exact MC step.

Layout: activations are NCHW f32 inside the trunk (inputs arrive NHWC and
are permuted once); conv kernels are OIHW, as ``PackMeta.unpack`` gives
them, and go through the forward's own ``models.resnet.conv`` (padding
k // 2, the stem's 3 at stride 2 included). TF32 is off on the card
(``device.resolve_device``), so the moment pass is full f32.

The noise. What DVP samples has the form mu + sigma * eps: the features
f = fm + sqrt(fv) * eps and every head weight w = mu + sqrt(var) * eps
(the three attention blocks' four dense layers, fc, fc1 and fc2). Per
batch the step lays out one mean vector [head mu | features fm] and one
scale vector [sqrt(head var) | sqrt(fv)] (``DrawLayout``), and draws all
``num_feature_samples`` draws of both with ONE call of the split sampler
(kernel #1, ``torch.ops.auv.split_sampler``: f32 out, f32 polynomials),
seeded by the (seed0, seed1) words the step draws from its
``torch.Generator`` (``chunk_seed_words``) and reads from a device tensor.
So the noise follows the port's noise contract (``ops/sampling.py``), and
the step is a function of tensors that ``torch.export`` traces
(``serving.py``). The JAX package draws the same quantities from threefry
keys (one key per draw, split and folded per leaf); the two streams cannot
match, so parity with it is held under injected noise, as on the MC path.
The head then runs as a batch over the draws (``torch.bmm``).
"""
from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from multimodal_auv_torch.bayes.packing import (
    PackedPosterior,
    PackMeta,
    softplus,
)
from multimodal_auv_torch.engine.predict import _mc_outputs, mesh_predict_step
from multimodal_auv_torch.models.model_utils import ModelBundle
from multimodal_auv_torch.models.resnet import conv
from multimodal_auv_torch.ops.preprocess import normalize_multimodal
from multimodal_auv_torch.ops.sampling import (
    LANES,
    chunk_seed_words,
    split_draws,
)
from multimodal_auv_torch.parallel.collectives import (
    gather_rows,
    own_rows,
    sync_sums,
)

logger = logging.getLogger(__name__)

_SQRT2 = math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_F32 = torch.float32

# the multimodal model's trunks and their attention blocks, in forward order
_TRUNKS = ("image_model_feat", "bathy_model_feat", "sss_model_feat")
_ATTN = ("attention_image", "attention_bathy", "attention_sss")
_FC = ("fc", "fc1", "fc2")

# 1.5x the MOPED-validated regime (spread ~= moped_delta = 0.1 at the
# default init); beyond it the guardrail trips. The JAX package's on-chip
# probe (scripts/probe_dvp_spread.py) found argmax agreement holding
# through spread 0.3; 0.15 is kept because the uncertainty columns'
# fidelity beyond it is not bounded by that probe.
DVP_SPREAD_THRESHOLD = 0.15


# ---------------------------------------------------------------------------
# moment primitives (NCHW activations, OIHW kernels)
# ---------------------------------------------------------------------------

def relu_moments(m: torch.Tensor, v: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """E[max(0, X)], Var[max(0, X)] for X ~ N(m, v), elementwise; a
    degenerate v (<= 1e-12) gives the plain ReLU and zero variance."""
    sd = torch.sqrt(torch.clamp_min(v, 1e-12))
    a = m / sd
    cdf = 0.5 * (1.0 + torch.erf(a / _SQRT2))
    pdf = _INV_SQRT_2PI * torch.exp(-0.5 * a * a)
    mean = m * cdf + sd * pdf
    second = (m * m + v) * cdf + m * sd * pdf
    var = torch.clamp_min(second - mean * mean, 0.0)
    degenerate = v <= 1e-12
    mean = torch.where(degenerate, torch.clamp_min(m, 0.0), mean)
    var = torch.where(degenerate, 0.0, var)
    return mean, var


def conv_moments(m: torch.Tensor, v: torch.Tensor, mu_k: torch.Tensor,
                 var_k: torch.Tensor, stride: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaussian weights (mu_k, var_k), independent of inputs with moments
    (m, v): m' = m * Mw; v' = v * Mw^2 + (m^2 + v) * Vw (* = convolution),
    clamped at 0."""
    m_out = conv(m, mu_k, stride, _F32)
    v_out = conv(v, mu_k * mu_k, stride, _F32) + conv(m * m + v, var_k,
                                                      stride, _F32)
    return m_out, torch.clamp_min(v_out, 0.0)


def dense_moments(m: torch.Tensor, v: torch.Tensor, mu_w: torch.Tensor,
                  var_w: torch.Tensor, mu_b: Optional[torch.Tensor] = None,
                  var_b: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense layer's moments, (in, out) kernels; variance clamped at 0."""
    m_out = m @ mu_w
    v_out = v @ (mu_w * mu_w) + (m * m + v) @ var_w
    if mu_b is not None:
        m_out = m_out + mu_b
    if var_b is not None:
        v_out = v_out + var_b
    return m_out, torch.clamp_min(v_out, 0.0)


def _channels(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A (C,) vector shaped to broadcast over dimension 1 of ``ndim``-D."""
    return t.view((1, -1) + (1,) * (ndim - 2))


def batchnorm_moments(m: torch.Tensor, v: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, eps: float = 1e-5
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-mode BN approximation over channel dimension 1: the batch
    statistics are the mean map's (population variance) plus the mean
    input variance; the output variance is scaled by the same factor."""
    axes = (0,) + tuple(range(2, m.dim()))
    # [sum m | sum v] over the BN axis, then the sum of squares centred on
    # that global mean (two all_reduces under a mesh, none without)
    sums, count = sync_sums(torch.cat([m.sum(dim=axes), v.sum(dim=axes)]),
                            m.numel() // m.shape[1])
    mean_m, mean_v = (sums / count).chunk(2)
    centred = m - _channels(mean_m, m.dim())
    bv = sync_sums((centred * centred).sum(dim=axes))[0] / count + mean_v
    inv = scale / torch.sqrt(bv + eps)
    m_out = centred * _channels(inv, m.dim()) + _channels(bias, m.dim())
    v_out = v * _channels(inv * inv, m.dim())
    return m_out, v_out


def maxpool_moments(m: torch.Tensor, v: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """3x3 stride 2 pad 1 (-inf padding): max of means; the variance map is
    max-pooled on its own, an upper bound of the variance at the argmax."""
    return (F.max_pool2d(m, 3, stride=2, padding=1),
            F.max_pool2d(v, 3, stride=2, padding=1))


def gap_moments(m: torch.Tensor, v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global average pool: mean of means; variance sum / n^2 under
    independence."""
    n = m.shape[2] * m.shape[3]
    return m.mean(dim=(2, 3)), v.sum(dim=(2, 3)) / (n * n)


# ---------------------------------------------------------------------------
# the moment ResNet trunk (models/resnet.py's topology)
# ---------------------------------------------------------------------------

def _conv_m(trees, name, m, v, stride):
    mp, vp = trees
    return conv_moments(m, v, mp[name]["kernel"], vp[name]["kernel"], stride)


def _bn_m(trees, name, m, v):
    p = trees[0][name]
    return batchnorm_moments(m, v, p["scale"], p["bias"])


def _sub(trees, name):
    return tuple(t[name] for t in trees)


def _bottleneck_moments(trees, m, v, stride: int, downsample: bool):
    im, iv = m, v
    m, v = _conv_m(trees, "conv1", m, v, 1)
    m, v = relu_moments(*_bn_m(trees, "bn1", m, v))
    m, v = _conv_m(trees, "conv2", m, v, stride)
    m, v = relu_moments(*_bn_m(trees, "bn2", m, v))
    m, v = _conv_m(trees, "conv3", m, v, 1)
    m, v = _bn_m(trees, "bn3", m, v)
    if downsample:
        im, iv = _conv_m(trees, "downsample_conv", im, iv, stride)
        im, iv = _bn_m(trees, "downsample_bn", im, iv)
    return relu_moments(m + im, v + iv)


def moment_resnet_features(mu_params: Dict, var_params: Dict,
                           x: torch.Tensor,
                           stage_sizes: Sequence[int] = (3, 4, 6, 3)
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, var), each (B, feature_size), of the pooled features for a
    deterministic NHWC input ``x``, in f32. ``mu_params``: the trunk's mean
    tree (OIHW kernels, BN affine leaves); ``var_params``: its kernels'
    variances."""
    trees = (mu_params, var_params)
    x = x.to(_F32).permute(0, 3, 1, 2)
    m, v = _conv_m(trees, "conv1", x, torch.zeros_like(x), 2)
    m, v = maxpool_moments(*relu_moments(*_bn_m(trees, "bn1", m, v)))
    for stage, blocks in enumerate(stage_sizes):
        for blk in range(blocks):
            stride = 2 if (stage > 0 and blk == 0) else 1
            m, v = _bottleneck_moments(_sub(trees, f"layer{stage + 1}_{blk}"),
                                       m, v, stride, downsample=(blk == 0))
    return gap_moments(m, v)


def _split_trees(meta: PackMeta, post: PackedPosterior):
    """(mean tree, variance tree, flat variance): the mean tree is the
    posterior mean with its deterministic (BN) leaves; the variance tree
    holds the variational leaves only (the BN leaves have no variance).
    var = softplus(rho)^2, softplus as ``jax.nn.softplus``."""
    sigma = softplus(post.rho.to(_F32))
    var = sigma * sigma
    return meta.unpack(post.mu.to(_F32), post.det), meta.unpack(var, {}), var


# ---------------------------------------------------------------------------
# the guardrail
# ---------------------------------------------------------------------------

def posterior_spread(post: PackedPosterior, meta: Optional[PackMeta] = None
                     ) -> float:
    """Mean relative posterior width, mean(sigma / (|mu| + 1e-8)), over the
    real (non-pad) packed region: the statistic that gates DVP. Computed
    on the posterior's device (the ratio in f32, its sum in f64); one
    float comes back to the host."""
    n = meta.n_real if meta is not None else post.mu.shape[0]
    sigma = softplus(post.rho[:n].to(_F32))
    ratio = sigma / (post.mu[:n].to(_F32).abs() + 1e-8)
    return float(ratio.sum(dtype=torch.float64) / n)


# ---------------------------------------------------------------------------
# the sampled part: one draw vector per batch, kernel #1
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DrawLayout:
    """Where each sampled quantity sits in a (S, n) draw of one batch:
    first the head's variational leaves, gathered in packed order from
    ``ranges`` ([start, end) of the packed vector, adjacent entries merged)
    and zero-padded to ``head`` elements (a multiple of the sampler's
    LANES); then the pooled features, (trunks, batch, row), each row the
    ``features`` values zero-padded to ``row`` (a multiple of LANES, so the
    total is one for any batch size). ``offsets``: leaf path -> (offset in
    a draw, shape)."""

    ranges: Tuple[Tuple[int, int], ...]
    offsets: Dict[Tuple[str, ...], Tuple[int, Tuple[int, ...]]]
    head: int
    trunks: int
    features: int
    row: int


def _pad_to_lanes(n: int) -> int:
    return -(-n // LANES) * LANES


def draw_layout(meta: PackMeta, groups: Sequence[Tuple[str, ...]],
                trunks: int, features: int) -> DrawLayout:
    """The layout of the leaves whose path starts with one of ``groups``
    and of ``trunks`` pooled feature vectors of ``features`` values."""
    ranges, offsets, n = [], {}, 0
    for e in meta.entries:
        if not any(e.path[:len(g)] == g for g in groups):
            continue
        offsets[e.path] = (n, e.shape)
        n += e.size
        if ranges and ranges[-1][1] == e.offset:
            ranges[-1] = (ranges[-1][0], e.offset + e.size)
        else:
            ranges.append((e.offset, e.offset + e.size))
    if not ranges:
        raise ValueError(f"no packed leaf under {groups}")
    return DrawLayout(tuple(ranges), offsets, _pad_to_lanes(n), trunks,
                      features, _pad_to_lanes(features))


def noise_vectors(layout: DrawLayout, mu: torch.Tensor, var: torch.Tensor,
                  fm: torch.Tensor, fv: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (mean, scale) vectors the sampler draws from: [head mu | fm] and
    sqrt([head var | fv]), in ``layout``. ``mu``, ``var``: the packed (P,)
    mean and variance; ``fm``, ``fv``: (trunks, batch, features)."""
    gathered = sum(b - a for a, b in layout.ranges)
    pad_f = layout.row - layout.features

    def vector(flat, feats):
        parts = [flat[a:b] for a, b in layout.ranges]
        if layout.head > gathered:
            parts.append(flat.new_zeros(layout.head - gathered))
        parts.append(F.pad(feats, (0, pad_f)).reshape(-1))
        return torch.cat(parts)

    return vector(mu, fm), torch.sqrt(vector(var, fv))


def _leaf(draws: torch.Tensor, layout: DrawLayout, path) -> torch.Tensor:
    """(S, *shape) view of one head leaf in the draws."""
    off, shape = layout.offsets[path]
    return draws[:, off:off + math.prod(shape)].view(draws.shape[0], *shape)


def feature_draws(draws: torch.Tensor, layout: DrawLayout) -> torch.Tensor:
    """(S, trunks, batch, features) view of the sampled features."""
    rows = draws[:, layout.head:].unflatten(1, (layout.trunks, -1,
                                                layout.row))
    return rows[..., :layout.features]


def _dense(x: torch.Tensor, draws: torch.Tensor, layout: DrawLayout,
           prefix: Tuple[str, ...]) -> torch.Tensor:
    """x (S, B, in) @ the draws' kernel (S, in, out) + bias, per draw."""
    return (torch.bmm(x, _leaf(draws, layout, prefix + ("kernel",)))
            + _leaf(draws, layout, prefix + ("bias",)).unsqueeze(1))


def _multimodal_head(draws: torch.Tensor, layout: DrawLayout
                     ) -> torch.Tensor:
    """(S, B, C) logits: each trunk's sampled features through its sampled
    AdditiveAttention, concatenated, then fc, fc1, fc2 (no nonlinearity
    between them), as ``models/fusion.py``, batched over the S draws."""
    feats = feature_draws(draws, layout)
    outs = []
    for i, att in enumerate(_ATTN):
        f = feats[:, i]
        keys = _dense(f, draws, layout, (att, "key_projection"))
        vals = _dense(f, draws, layout, (att, "value_projection"))
        quer = _dense(f, draws, layout, (att, "query_projection"))
        scores = torch.tanh(quer + keys)
        wts = torch.softmax(_dense(scores, draws, layout,
                                   (att, "attention_mechanism")), dim=-1)
        outs.append(vals * wts)
    x = torch.cat(outs, dim=-1)
    for fc in _FC:
        x = _dense(x, draws, layout, (fc,))
    return x


def _draw(layout: DrawLayout, mu, var, fm, fv, seeds: torch.Tensor,
          num_draws: int) -> torch.Tensor:
    """One split-sampler call: (num_draws, n) f32 draws of ``layout``,
    seed words from row 0 of ``seeds`` ((1, 2) int64 on the device)."""
    mean, scale = noise_vectors(layout, mu, var, fm, fv)
    return split_draws(mean, scale, seeds[0], num_draws, out_dtype=_F32,
                       fast_math=False)


def make_dvp_logits_fn(bundle: ModelBundle, num_feature_samples: int,
                       packed_inputs: bool = False, mesh=None) -> Callable:
    """(post, batch_stats, inputs, seeds, mask) -> (S, B, C) f32 logits of
    the multimodal DVP step, S = ``num_feature_samples``, its draws from
    the seed words in row 0 of ``seeds`` ((1, 2) int64 on the posterior's
    device): a function of tensors, which ``serving.py`` exports.
    ``packed_inputs``: uint8 NHWC batches, normalised on the device
    (ops/preprocess.py); else normalised float NHWC.

    ``batch_stats`` and ``mask`` are accepted for the predict steps'
    signature and not used: the moment BN takes its statistics from the
    mean map of the whole batch, so the pad rows of a ragged tail enter
    them, as in the JAX package (an approximation on top of an
    approximate mode; exact MC keeps its masked BN).

    ``mesh``: ``inputs`` are this data rank's rows (under
    ``bn_sync(mesh.data_axis)``, so the moment BN's statistics are the
    global batch's); the pooled feature moments are gathered over the data
    axis, the draws and the head run on the global batch, as without a
    mesh, and the logits of this rank's rows are returned (``own_rows``).
    On a mesh whose data axis is ``local_shards(N)`` (``parallel/mesh.py::
    local_shards_mesh``) the gather and the slice are the ops
    ``auv::shard_gather`` and ``auv::shard_rows``, which ``torch.export``
    traces (serving.py's data-sharded DVP program)."""
    module, meta = bundle.module, bundle.meta
    trunk = getattr(module, _TRUNKS[0])
    stage_sizes = trunk.stage_sizes
    layout = draw_layout(meta, [(a,) for a in _ATTN + _FC], len(_TRUNKS),
                         trunk.feature_size)

    def logits_fn(post, batch_stats, inputs, seeds, mask=None):
        if packed_inputs:
            inputs = normalize_multimodal(*inputs)
        mu_tree, var_tree, var = _split_trees(meta, post)
        moments = [moment_resnet_features(mu_tree[n], var_tree[n], x,
                                          stage_sizes)
                   for n, x in zip(_TRUNKS, inputs)]
        fm = torch.stack([m for m, _ in moments])
        fv = torch.stack([v for _, v in moments])
        if mesh is not None:
            # the noise is laid out by global row: draw for the whole batch
            fm, fv = (gather_rows(t.transpose(0, 1).contiguous(),
                                  mesh.data_axis).transpose(0, 1)
                      for t in (fm, fv))
        draws = _draw(layout, post.mu, var, fm, fv, seeds,
                      num_feature_samples)
        logits = _multimodal_head(draws, layout)
        if mesh is not None:
            logits = own_rows(logits, mesh.data_axis, dim=1)
        return logits

    logits_fn.layout = layout
    return logits_fn


def _step_of(logits_fn: Callable, mesh=None) -> Callable:
    """The predict step over a logits function: one seed pair per batch
    from the generator, sent to the device without a wait. ``mesh``: the
    step of ``engine.predict.mesh_predict_step``."""

    def logits_of(post, batch_stats, inputs, generator, mask=None):
        seeds = chunk_seed_words(generator, 1).to(post.mu.device,
                                                  non_blocking=True)
        return logits_fn(post, batch_stats, inputs, seeds, mask)

    if mesh is not None:
        step = mesh_predict_step(logits_of, mesh)
    else:
        @torch.inference_mode()
        def step(post, batch_stats, inputs, generator, mask=None):
            return _mc_outputs(logits_of(post, batch_stats, inputs,
                                         generator, mask))

    step.logits_fn = logits_fn
    return step


def make_unimodal_dvp_predict_step(bundle: ModelBundle,
                                   num_feature_samples: int = 20) -> Callable:
    """Single-pass DVP for a unimodal ``ResNet50Custom`` bundle: the trunk
    moment-propagated; the features and the fc head sampled
    (``num_feature_samples`` draws, one split-sampler call per batch).
    ``step(post, batch_stats, (x,), generator, mask)`` over normalised
    float NHWC ``x``; ``batch_stats`` and ``mask`` unused, as in the
    multimodal step."""
    meta, trunk = bundle.meta, bundle.module.model
    layout = draw_layout(meta, [("model", "fc")], 1, trunk.feature_size)

    def logits_fn(post, batch_stats, inputs, seeds, mask=None):
        mu_tree, var_tree, var = _split_trees(meta, post)
        (x,) = inputs
        fm, fv = moment_resnet_features(mu_tree["model"], var_tree["model"],
                                        x, trunk.stage_sizes)
        draws = _draw(layout, post.mu, var, fm[None], fv[None], seeds,
                      num_feature_samples)
        return _dense(feature_draws(draws, layout)[:, 0], draws, layout,
                      ("model", "fc"))

    logits_fn.layout = layout
    return _step_of(logits_fn)


def make_dvp_predict_step(bundle: ModelBundle, num_feature_samples: int = 20,
                          *, spread_threshold: float = DVP_SPREAD_THRESHOLD,
                          on_excess: str = "warn",
                          packed_inputs: bool = False,
                          mc_chunk: Optional[int] = None,
                          return_mode: bool = False,
                          spread: Optional[float] = None, mesh=None):
    """Single-probabilistic-pass predict step for the multimodal bundle:
    moment-propagated trunks, MC over the features and head weights only.
    ``step(post, batch_stats, inputs, generator, mask)`` -> the outputs
    dict of ``engine.predict``'s steps (``csv_cols`` included); its
    ``logits_fn`` attribute is ``make_dvp_logits_fn``'s function.

    Guardrail: DVP is approximate and validated only near MOPED-tight
    posteriors. At build time the posterior spread (``posterior_spread``,
    or ``spread`` if the caller measured it already) is held against
    ``spread_threshold``; beyond it ``on_excess`` decides:

    * "warn" (default): log a warning and build DVP (the caller opted in);
    * "mc": log and return the EXACT MC predict step with
      ``num_feature_samples`` draws (``make_packed_predict_step`` with
      ``packed_inputs``, else ``make_predict_step``), chunked by
      ``mc_chunk``, which only this fallback uses.

    ``return_mode=True`` returns ``(step, mode)``, mode "dvp" or "mc": the
    one record of which step was built (``serving.py`` writes it to the
    artifact's meta.json). ``mesh``: the trunks' rows over its data axis
    (``make_dvp_logits_fn``), every mc rank running the one pass; the MC
    fallback splits its draws over the mc axis."""
    if on_excess not in ("warn", "mc"):
        # anything else would silently act as "warn": the accuracy loss the
        # guardrail exists to prevent
        raise ValueError(
            f"on_excess must be 'warn' or 'mc', got {on_excess!r}")

    def ret(step, mode):
        return (step, mode) if return_mode else step

    if spread is None:
        spread = posterior_spread(bundle.post, bundle.meta)
    if spread > spread_threshold:
        if on_excess == "mc":
            from multimodal_auv_torch.engine.predict import (
                make_packed_predict_step,
                make_predict_step,
            )

            logger.warning(
                "DVP guardrail: posterior spread %.3f exceeds the validated "
                "regime (threshold %.3f) — falling back to the exact MC "
                "predict step (%d draws).", spread, spread_threshold,
                num_feature_samples)
            make = make_packed_predict_step if packed_inputs else \
                make_predict_step
            return ret(make(bundle, num_feature_samples, mc_chunk=mc_chunk,
                            mesh=mesh), "mc")
        logger.warning(
            "DVP guardrail: posterior spread %.3f exceeds the validated "
            "regime (threshold %.3f) — DVP estimators may diverge from "
            "exact MC; pass on_excess='mc' to fall back automatically.",
            spread, spread_threshold)
    return ret(_step_of(make_dvp_logits_fn(bundle, num_feature_samples,
                                           packed_inputs, mesh), mesh), "dvp")
