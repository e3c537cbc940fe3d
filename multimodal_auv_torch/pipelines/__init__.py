"""Public pipeline API of the port (the JAX package's
``multimodal_auv_tpu/pipelines/__init__.py``)."""
from multimodal_auv_torch.pipelines.inference import (  # noqa: F401
    export_auv_serving_artifact,
    run_auv_inference,
)
from multimodal_auv_torch.pipelines.training import (  # noqa: F401
    run_AUV_training_from_scratch,
    run_auv_retraining,
)


def run_auv_preprocessing(*args, **kwargs):
    from multimodal_auv_torch.pipelines.preprocessing import (
        run_auv_preprocessing as _impl,
    )

    return _impl(*args, **kwargs)


def run_noise_study(*args, **kwargs):
    from multimodal_auv_torch.pipelines.noise_study import (
        run_noise_study as _impl,
    )

    return _impl(*args, **kwargs)


def run_patch_size_sweep(*args, **kwargs):
    from multimodal_auv_torch.pipelines.sweep import (
        run_patch_size_sweep as _impl,
    )

    return _impl(*args, **kwargs)


def run_unimodal_training(*args, **kwargs):
    from multimodal_auv_torch.pipelines.unimodal import (
        run_unimodal_training as _impl,
    )

    return _impl(*args, **kwargs)
