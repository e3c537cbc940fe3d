"""multimodal_auv_torch — the PyTorch / CUDA port of multimodal_auv_tpu.

Bayesian multimodal benthic-habitat classification from AUV survey data,
on an NVIDIA H100: PyTorch for the models, hand-written CUDA kernels
(``csrc/``) for what the JAX package wrote in Pallas. The port imports
nothing of JAX or of ``multimodal_auv_tpu``.

Entry points run on the card (``device=None``) unless the caller passes
``device="cpu"``, where every kernel runs its plain PyTorch version.
"""

__version__ = "0.1.0"
