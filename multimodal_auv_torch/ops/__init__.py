"""The ops' public names (the JAX package's ``multimodal_auv_tpu/ops/__init__.py``),
imported on first use: importing the package builds no kernel."""

from multimodal_auv_torch._lazy import lazy_exports

_EXPORTS = {
    "normalize_images": "multimodal_auv_torch.ops.preprocess",
    "normalize_multimodal": "multimodal_auv_torch.ops.preprocess",
    "normalize_optical": "multimodal_auv_torch.ops.preprocess",
    "gaussian_reparam": "multimodal_auv_torch.ops.sampling",
    "gaussian_shift_scale": "multimodal_auv_torch.ops.sampling",
}
__all__, __getattr__ = lazy_exports(__name__, _EXPORTS)
