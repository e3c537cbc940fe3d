"""The engine's public names (the JAX package's
``multimodal_auv_tpu/engine/__init__.py``), imported on first use."""

from multimodal_auv_torch._lazy import lazy_exports

_EXPORTS = {
    "mc_logits": "multimodal_auv_torch.engine.mc",
    "refresh_batch_stats": "multimodal_auv_torch.engine.mc",
    "BayesTrainState": "multimodal_auv_torch.engine.optim",
    "StepLR": "multimodal_auv_torch.engine.optim",
    "define_optimizers_and_schedulers": "multimodal_auv_torch.engine.optim",
    "kl_annealing_weight": "multimodal_auv_torch.engine.optim",
    "make_optimizer": "multimodal_auv_torch.engine.optim",
    "make_eval_step": "multimodal_auv_torch.engine.steps",
    "make_train_step": "multimodal_auv_torch.engine.steps",
}
__all__, __getattr__ = lazy_exports(__name__, _EXPORTS)
