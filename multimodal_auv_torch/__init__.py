"""multimodal_auv_torch — the PyTorch / CUDA port of multimodal_auv_tpu.

Bayesian multimodal benthic-habitat classification from AUV survey data,
on an NVIDIA H100: PyTorch for the models, hand-written CUDA kernels
(``csrc/``) for what the JAX package wrote in Pallas. The port imports
nothing of JAX or of ``multimodal_auv_tpu``.

Entry points run on the card (``device=None``) unless the caller passes
``device="cpu"``, where every kernel runs its plain PyTorch version.
"""

from multimodal_auv_torch._lazy import lazy_exports

__version__ = "0.1.0"

# the reference's package-level pipeline API, as the JAX package exports it
__all__, __getattr__ = lazy_exports(__name__, {
    name: "multimodal_auv_torch.pipelines"
    for name in ("run_auv_inference", "run_auv_retraining",
                 "run_auv_preprocessing", "run_AUV_training_from_scratch")})
