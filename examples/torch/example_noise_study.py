"""UIFM robustness sweep on the card — "Example training with image
noise.py" (and with --depth-sweep, the `_safe` multi-depth variant): 6
turbidity centers linspace(0.05, 2.05), extended metrics (AUROC / F1 /
ECE / Emax) per step."""
import _bootstrap  # noqa: F401  (source-checkout sys.path setup)

import argparse

import numpy as np

from multimodal_auv_torch.pipelines.noise_study import run_noise_study

if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--root_dir", required=True)
    p.add_argument("--csv_dir", default="noise_study_csvs")
    p.add_argument("--num_mc", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--train_epochs_per_step", type=int, default=0)
    p.add_argument("--model_weights", default=None)
    p.add_argument("--depth-sweep", action="store_true",
                   help="6 depth levels x 6 turbidity steps (the _safe variant)")
    _bootstrap.add_common(p)
    a = p.parse_args()
    depths = list(np.linspace(1.0 / 6, 1.0, 6)) if a.depth_sweep else [1.0]
    results = run_noise_study(
        a.root_dir, a.csv_dir,
        depth_levels=depths,
        train_epochs_per_step=a.train_epochs_per_step,
        num_mc=a.num_mc, batch_size=a.batch_size,
        model_weights_path=a.model_weights,
        arch=_bootstrap.arch(a), device=a.device)
    for r in results:
        print(r)
