"""Multimodal BNN inference over a survey directory on the card — the
Example_Inference_model.py equivalent (reference canonical operating point:
batch 4, 20 MC samples, 7 classes)."""
import _bootstrap  # noqa: F401  (source-checkout sys.path setup)

import argparse

from multimodal_auv_torch import run_auv_inference

if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_csv", default="inference_results.csv")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_mc_samples", type=int, default=20)
    p.add_argument("--num_classes", type=int, default=7)
    p.add_argument("--model_weights", default=None)
    p.add_argument("--allow_random_init", action="store_true")
    _bootstrap.add_common(p)
    a = p.parse_args()
    run_auv_inference(
        data_directory=a.data_dir,
        batch_size=a.batch_size,
        output_csv=a.output_csv,
        num_mc_samples=a.num_mc_samples,
        num_classes=a.num_classes,
        model_weights_path=a.model_weights,
        allow_random_init=a.allow_random_init,
        arch=_bootstrap.arch(a),
        device=a.device,
    )
