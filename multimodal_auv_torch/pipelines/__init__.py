"""Public pipeline API of the port (the JAX package's
``multimodal_auv_tpu/pipelines/__init__.py``, for the pipelines ported so
far)."""
from multimodal_auv_torch.pipelines.inference import (  # noqa: F401
    run_auv_inference,
)
from multimodal_auv_torch.pipelines.training import (  # noqa: F401
    run_AUV_training_from_scratch,
    run_auv_retraining,
)


def run_unimodal_training(*args, **kwargs):
    from multimodal_auv_torch.pipelines.unimodal import (
        run_unimodal_training as _impl,
    )

    return _impl(*args, **kwargs)
