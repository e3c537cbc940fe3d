"""The utilities' public names (the JAX package's
``multimodal_auv_tpu/utils/__init__.py``), imported on first use."""

from multimodal_auv_torch._lazy import lazy_exports

_EXPORTS = {
    "check_model_devices": "multimodal_auv_torch.utils.devices",
    "get_available_devices": "multimodal_auv_torch.utils.devices",
    "setup_environment_and_devices": "multimodal_auv_torch.utils.devices",
    "setup_pipeline_logging": "multimodal_auv_torch.utils.logging_utils",
    "SummaryWriter": "multimodal_auv_torch.utils.tb",
}
__all__, __getattr__ = lazy_exports(__name__, _EXPORTS)
