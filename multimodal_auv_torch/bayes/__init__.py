"""The packed posterior's public names (the JAX package's
``multimodal_auv_tpu/bayes/__init__.py``), imported on first use."""

from multimodal_auv_torch._lazy import lazy_exports

_EXPORTS = {
    "PackedPosterior": "multimodal_auv_torch.bayes.packing",
    "PackMeta": "multimodal_auv_torch.bayes.packing",
    "PackEntry": "multimodal_auv_torch.bayes.packing",
    "bayesianize": "multimodal_auv_torch.bayes.packing",
    "iter_variational_paths": "multimodal_auv_torch.bayes.packing",
    "kl_divergence": "multimodal_auv_torch.bayes.packing",
    "mean_params": "multimodal_auv_torch.bayes.packing",
    "sample_weights": "multimodal_auv_torch.bayes.packing",
    "sigma_of": "multimodal_auv_torch.bayes.packing",
    "softplus_inv": "multimodal_auv_torch.bayes.packing",
}
__all__, __getattr__ = lazy_exports(__name__, _EXPORTS)
