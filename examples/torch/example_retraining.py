"""Foundation-model retraining on a new dataset on the card — the
Example_Retraining_model.py equivalent (frozen-geometry head swap when
num_classes != 7; the reference's optimizer-on-wrong-model bug is fixed in
the pipeline, see pipelines/training.py)."""
import _bootstrap  # noqa: F401  (source-checkout sys.path setup)

import argparse

from multimodal_auv_torch import run_auv_retraining

if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", required=True)
    p.add_argument("--num_classes", type=int, required=True)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--num_mc", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--model_weights", default=None)
    p.add_argument("--allow_random_init", action="store_true")
    _bootstrap.add_common(p)
    a = p.parse_args()
    run_auv_retraining(
        root_dir=a.data_dir,
        num_classes=a.num_classes,
        lr_multimodal=a.lr,
        epochs_multimodal=a.epochs,
        num_mc=a.num_mc,
        batch_size_multimodal=a.batch_size,
        model_weights_path=a.model_weights,
        allow_random_init=a.allow_random_init,
        arch=_bootstrap.arch(a),
        device=a.device,
    )
