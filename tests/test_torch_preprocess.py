"""The port's on-device preprocess and MC uncertainty estimators against
the JAX package's, on random stacks made with numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_auv_torch.engine import uncertainty as U
from multimodal_auv_torch.ops import preprocess as P
from multimodal_auv_tpu.engine import uncertainty as JU
from multimodal_auv_tpu.ops import preprocess as JP


def test_normalize_multimodal_equals_jax():
    """u8 -> /255 -> (x - mean) / std in f32: the same ops in the same
    order, so f32 outputs agree to one rounding (rtol 1e-6, atol 1e-7)."""
    rng = np.random.default_rng(0)
    u8 = [rng.integers(0, 256, (2, 16, 16, c), dtype=np.uint8)
          for c in (3, 3, 1)]
    want = JP.normalize_multimodal(*[jnp.asarray(a) for a in u8])
    got = P.normalize_multimodal(*[torch.from_numpy(a) for a in u8])
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    bf = P.normalize_optical(torch.from_numpy(u8[0]), dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("logit_dtype", ["float32", "bfloat16"])
def test_uncertainty_equals_jax(logit_dtype):
    """Softmax in f32, unbiased variance, eps 1e-7 aleatoric and the 1e-8
    entropy decomposition, on a (num_mc=6, B=5, C=7) logit stack; f32
    reductions in another order: rtol 1e-5, atol 1e-7."""
    rng = np.random.default_rng(1)
    logits = (3.0 * rng.standard_normal((6, 5, 7))).astype(np.float32)
    jl = jnp.asarray(logits).astype(logit_dtype)
    tl = torch.from_numpy(logits).to(getattr(torch, logit_dtype))
    jprobs, tprobs = JU.softmax_probs(jl), U.softmax_probs(tl)
    close = lambda g, w: np.testing.assert_allclose(
        g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)
    close(tprobs, jprobs)
    close(U.mean_probs(tprobs), JU.mean_probs(jprobs))
    np.testing.assert_array_equal(U.predicted_class(tprobs).numpy(),
                                  np.asarray(JU.predicted_class(jprobs)))
    close(U.variance_uncertainty(tprobs), JU.variance_uncertainty(jprobs))
    close(U.aleatoric_uncertainty(tprobs), JU.aleatoric_uncertainty(jprobs))
    for g, w in zip(U.entropy_decomposition(tprobs),
                    JU.entropy_decomposition(jprobs)):
        close(g, w)
