"""Non-MOPED posterior init of the port (``bayes/packing.py::bayesianize``
with ``moped_enable=False``) against the JAX package's: the layout
(entries, offsets, padded size, pad values) equal, the draws held by their
moments (the JAX package's ``jax.random`` stream cannot be matched), and
the draws a function of the generator.
"""
import jax
import numpy as np
import pytest
import torch

from multimodal_auv_torch.bayes.packing import bayesianize, softplus_inv
from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.models.model_utils import (
    ArchConfig,
    make_multimodal_bundle,
    make_unimodal_bundle,
    multimodal_module,
)
from multimodal_auv_tpu.bayes.packing import bayesianize as jbayesianize
from multimodal_auv_tpu.config import BNNPriorSpec as JSpec
from multimodal_auv_tpu.models.model_utils import ArchConfig as JArch
from multimodal_auv_tpu.models.model_utils import make_multimodal_bundle as jmake

SPEC = BNNPriorSpec(moped_enable=False)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Small graphs: one intra-op thread, so no idle OpenMP threads spin on
    the cores the suite's other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    params, _ = multimodal_module(7, ArchConfig.micro()).init(
        torch.Generator().manual_seed(0))
    return params


def test_layout_equals_jax(params):
    """The entries, offsets, n_real and n_padded of the port's non-MOPED
    posterior equal JAX's ``bayesianize(moped_enable=False)`` of the same
    model, and the pad holds the prior (mu = prior_mu, rho =
    softplus_inv(prior_sigma)) in both."""
    jb = jmake(7, JSpec(moped_enable=False), jax.random.PRNGKey(0),
               JArch.micro())
    jpost, jmeta = jbayesianize(
        jax.tree_util.tree_map(np.asarray, _jax_params(jb)),
        JSpec(moped_enable=False), rng=jax.random.PRNGKey(1))
    post, meta = bayesianize(params, SPEC)
    assert [(e.path, e.shape, e.offset, e.size) for e in meta.entries] == [
        (e.path, e.shape, e.offset, e.size) for e in jmeta.entries]
    assert (meta.n_real, meta.n_padded) == (jmeta.n_real, jmeta.n_padded)
    assert meta.n_padded > meta.n_real
    pad = slice(meta.n_real, meta.n_padded)
    for got, want in ((post.mu, 0.0),
                      (post.rho, softplus_inv(SPEC.prior_sigma))):
        assert torch.all(got[pad] == torch.tensor(want, dtype=torch.float32))
    np.testing.assert_array_equal(np.asarray(jpost.mu)[pad], post.mu[pad])
    np.testing.assert_array_equal(np.asarray(jpost.rho)[pad], post.rho[pad])
    assert post.mu.dtype == post.rho.dtype == torch.float32


def _jax_params(jb):
    """A JAX bundle's deterministic param tree back from its posterior
    (mu at the variational leaves): the tree ``bayesianize`` takes."""
    return jb.meta.unpack(jb.post.mu, jb.post.det)


def test_moments(params):
    """Over the n real elements, mu's mean is posterior_mu_init within
    4 sigma / sqrt(n) and its standard deviation 0.1 within 1%; rho's the
    same about posterior_rho_init; the weights' values are not read (the
    same draws for other weights)."""
    post, meta = bayesianize(params, SPEC)
    n = meta.n_real
    for x, init in ((post.mu[:n], SPEC.posterior_mu_init),
                    (post.rho[:n], SPEC.posterior_rho_init)):
        x = x.double()
        assert abs(float(x.mean()) - init) < 4 * 0.1 / np.sqrt(n)
        assert abs(float(x.std()) / 0.1 - 1.0) < 0.01
    zeros = {k: _zeros(v) for k, v in params.items()}
    again, _ = bayesianize(zeros, SPEC)
    assert torch.equal(again.mu, post.mu) and torch.equal(again.rho, post.rho)


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def test_draws_follow_the_generator(params):
    """The same generator gives the same posterior, another one another;
    no generator is one seeded 0, as the JAX package defaults to
    ``PRNGKey(0)``. MOPED ignores the generator."""
    a, _ = bayesianize(params, SPEC, generator=torch.Generator().manual_seed(3))
    b, _ = bayesianize(params, SPEC, generator=torch.Generator().manual_seed(3))
    c, _ = bayesianize(params, SPEC, generator=torch.Generator().manual_seed(4))
    d, _ = bayesianize(params, SPEC)
    e, _ = bayesianize(params, SPEC, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a.mu, b.mu) and torch.equal(a.rho, b.rho)
    assert not torch.equal(a.mu, c.mu)
    assert torch.equal(d.mu, e.mu) and torch.equal(d.rho, e.rho)
    m1, _ = bayesianize(params, BNNPriorSpec(),
                        generator=torch.Generator().manual_seed(3))
    m2, _ = bayesianize(params, BNNPriorSpec())
    assert torch.equal(m1.mu, m2.mu)


@pytest.mark.parametrize("kind", ["multimodal", "unimodal"])
def test_bundles_pass_their_generator(kind):
    """The bundle makers draw the non-MOPED posterior from the generator
    they were given (after the init, as the JAX package passes its rng):
    one seed, one bundle; another seed, another posterior."""
    def make(seed):
        g = torch.Generator().manual_seed(seed)
        if kind == "multimodal":
            return make_multimodal_bundle(7, SPEC, g, ArchConfig.micro(),
                                          device="cpu")
        return make_unimodal_bundle(3, 7, SPEC, g, ArchConfig.micro(),
                                    device="cpu")

    a, b, c = make(5), make(5), make(6)
    assert torch.equal(a.post.mu, b.post.mu)
    assert torch.equal(a.post.rho, b.post.rho)
    assert not torch.equal(a.post.rho, c.post.rho)
    n = a.meta.n_real
    assert abs(float(a.post.rho[:n].double().mean())
               - SPEC.posterior_rho_init) < 4 * 0.1 / np.sqrt(n)
