"""Packed Gaussian variational posterior (port of
``multimodal_auv_tpu/bayes/packing.py``).

Every Conv/Dense ``kernel`` and ``bias`` of the parameter tree is packed, in
the sorted order of ``iter_variational_paths``, into two flat f32 tensors
``mu`` and ``rho`` of one length; BatchNorm stays deterministic (``det``).
The layout is the JAX package's: the same entries and offsets, HWIO conv
kernels and (in, out) dense kernels in the flat vector, and a pad to a
multiple of 1024 at prior values (zero KL). So a flat ``mu``, ``rho`` or
sampled ``w`` from JAX drops in unchanged; the permute of 4-D kernels to
torch's OIHW happens at ``PackMeta.unpack``.

Parameter trees are nested dicts keyed like flax's, e.g.
``{"image_model_feat": {"conv1": {"kernel": ...}, ...}, ...}``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.ops.sampling import chunk_seeds, gaussian_reparam

Params = Dict[str, Any]


@dataclass
class PackedPosterior:
    """Packed (mu, rho) plus the deterministic rest of the param tree."""

    mu: torch.Tensor
    rho: torch.Tensor
    det: Params

    def to(self, device) -> "PackedPosterior":
        return PackedPosterior(self.mu.to(device), self.rho.to(device),
                               tree_to(self.det, device))


@dataclass(frozen=True)
class PackEntry:
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    offset: int
    size: int


@dataclass(frozen=True)
class PackMeta:
    """Static description of the packing layout."""

    entries: Tuple[PackEntry, ...]
    n_real: int
    n_padded: int
    _split_sizes: Tuple[int, ...] = field(init=False, repr=False,
                                          compare=False)

    def __post_init__(self):
        object.__setattr__(self, "_split_sizes", tuple(
            [e.size for e in self.entries] + [self.n_padded - self.n_real]))

    def unpack(self, w_flat: torch.Tensor, det: Params) -> Params:
        """The full param tree from a flat weight vector and the
        deterministic leaves: one ``torch.split`` into views, each viewed to
        its shape; 4-D (HWIO) kernels are permuted to OIHW. The entries tile
        [0, n_real) in order, so the split's backward is one concatenation
        (no per-leaf P-sized pad)."""
        params = _clone_structure(det)
        pieces = torch.split(w_flat, self._split_sizes)
        for e, piece in zip(self.entries, pieces):
            leaf = piece.view(e.shape)
            if leaf.dim() == 4:
                leaf = leaf.permute(3, 2, 0, 1)
            _set_path(params, e.path, leaf)
        return params


def _clone_structure(tree):
    if isinstance(tree, dict):
        return {k: _clone_structure(v) for k, v in tree.items()}
    return tree


def _set_path(tree: Dict, path: Tuple[str, ...], value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def tree_to(tree, device):
    """Move every tensor leaf of a nested dict to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def iter_variational_paths(params: Params):
    """Yield (path, leaf) for every variational leaf in sorted order: a
    group that owns a ``kernel`` is a Conv/Dense module, so its ``kernel``
    and ``bias`` are variational; groups with ``scale`` (BatchNorm) stay
    deterministic. The same walk as the JAX package, so the same keys give
    the same entries and offsets."""

    def rec(node, path):
        if not isinstance(node, dict):
            return
        keys = sorted(node.keys())
        if "kernel" in node and not isinstance(node["kernel"], dict):
            for k in keys:
                if k in ("kernel", "bias") and not isinstance(node[k], dict):
                    yield path + (k,), node[k]
            for k in keys:
                if isinstance(node[k], dict):
                    yield from rec(node[k], path + (k,))
        else:
            for k in keys:
                if isinstance(node[k], dict):
                    yield from rec(node[k], path + (k,))

    yield from rec(params, ())


def softplus_inv(y: float) -> float:
    """rho such that softplus(rho) == y."""
    return float(np.log(np.expm1(y)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it:
    max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def build_meta(params: Params, pad_multiple: int = 1024) -> PackMeta:
    """The packing layout of a param tree (only the leaves' shapes are
    read)."""
    entries: List[PackEntry] = []
    offset = 0
    for path, leaf in iter_variational_paths(params):
        shape = tuple(int(s) for s in leaf.shape)
        size = int(np.prod(shape)) if shape else 1
        entries.append(PackEntry(path, shape, offset, size))
        offset += size
    n_padded = int(math.ceil(max(offset, 1) / pad_multiple) * pad_multiple)
    return PackMeta(entries=tuple(entries), n_real=offset, n_padded=n_padded)


def bayesianize(params: Params, spec: BNNPriorSpec, *,
                generator: Optional[torch.Generator] = None,
                pad_multiple: int = 1024) -> Tuple[PackedPosterior, PackMeta]:
    """A deterministic param tree (JAX layout) -> PackedPosterior.

    MOPED: mu = w, sigma = moped_delta * |w| clamped to >= 1e-12 (so a zero
    weight gets a finite rho), rho = softplus_inv(sigma). Without MOPED,
    bayesian-torch's init: for each leaf in layout order, mu ~
    N(posterior_mu_init, 0.1) and rho ~ N(posterior_rho_init, 0.1) in f32,
    drawn from ``generator`` (a CPU generator; None: one seeded 0, as the
    JAX package defaults to ``PRNGKey(0)``); the weights' values are not
    read. The pad holds (prior_mu, softplus_inv(prior_sigma)) either
    way."""
    meta = build_meta(params, pad_multiple)
    if not spec.moped_enable and generator is None:
        generator = torch.Generator().manual_seed(0)
    mu_parts: List[torch.Tensor] = []
    rho_parts: List[torch.Tensor] = []
    for e in meta.entries:
        flat = _get_path(params, e.path).to(torch.float32).reshape(-1)
        if spec.moped_enable:
            mu_parts.append(flat)
            sigma = torch.clamp_min(spec.moped_delta * flat.abs(), 1e-12)
            rho_parts.append(torch.log(torch.expm1(sigma)))
            continue
        for init, parts in ((spec.posterior_mu_init, mu_parts),
                            (spec.posterior_rho_init, rho_parts)):
            noise = torch.randn(flat.shape, generator=generator,
                                dtype=torch.float32)
            parts.append((init + 0.1 * noise).to(flat.device))
    pad = meta.n_padded - meta.n_real
    if pad:
        dev = mu_parts[0].device if mu_parts else None
        mu_parts.append(torch.full((pad,), spec.prior_mu, device=dev))
        rho_parts.append(torch.full((pad,), softplus_inv(spec.prior_sigma),
                                    device=dev))
    post = PackedPosterior(mu=torch.cat(mu_parts), rho=torch.cat(rho_parts),
                           det=deterministic_part(params, meta))
    return post, meta


def deterministic_part(params: Params, meta: PackMeta) -> Params:
    """The param tree without its variational leaves: the BatchNorm
    affine leaves that ``PackedPosterior.det`` holds."""
    det = _clone_structure(params)
    for e in meta.entries:
        _set_path(det, e.path, None)
    return prune_none(det)


def _get_path(tree: Dict, path: Tuple[str, ...]):
    node = tree
    for p in path:
        node = node[p]
    return node


def prune_none(tree):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                pruned = prune_none(v)
                if pruned:
                    out[k] = pruned
            elif v is not None:
                out[k] = v
        return out
    return tree


def sigma_of(rho: torch.Tensor) -> torch.Tensor:
    return softplus(rho)


def sample_weights(post: PackedPosterior,
                   generator: torch.Generator) -> torch.Tensor:
    """One Monte-Carlo weight draw w = mu + softplus_k(rho) * eps, (P,):
    one seed pair from ``generator`` (as ``engine/mc.py`` draws a chunk's)
    through ``ops.sampling.gaussian_reparam``, whose kernel takes the
    softplus itself. Not differentiable (see ``gaussian_reparam``)."""
    (seed,) = chunk_seeds(generator, 1)
    return gaussian_reparam(post.mu, post.rho, seed)


def kl_divergence(post: PackedPosterior, spec: BNNPriorSpec) -> torch.Tensor:
    """Closed-form KL(q || prior) summed over every packed element, in f32
    (the sum the reference's ``get_kl_loss`` accumulates per layer). The
    pad holds the prior's values, so it contributes exactly zero."""
    mu = post.mu.to(torch.float32)
    sigma = sigma_of(post.rho.to(torch.float32))
    ps = torch.tensor(spec.prior_sigma, dtype=torch.float32, device=mu.device)
    kl = (torch.log(ps) - torch.log(sigma)
          + (sigma ** 2 + (mu - spec.prior_mu) ** 2) / (2.0 * ps ** 2) - 0.5)
    return kl.sum()


def mean_params(post: PackedPosterior, meta: PackMeta) -> Params:
    """Deterministic parameters at the posterior mean (no sampling)."""
    return meta.unpack(post.mu, post.det)
