"""Unimodal optical noise study on the card — "Example unimodal training
with image noise.py" equivalent: the UIFM turbidity sweep on the
single-trunk optical BNN."""
import _bootstrap  # noqa: F401  (source-checkout sys.path setup)

import argparse

from multimodal_auv_torch.pipelines.noise_study import run_noise_study

if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--root_dir", required=True)
    p.add_argument("--csv_dir", default="unimodal_noise_csvs")
    p.add_argument("--num_mc", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--train_epochs_per_step", type=int, default=0)
    _bootstrap.add_common(p)
    a = p.parse_args()
    results = run_noise_study(
        a.root_dir, a.csv_dir, modality="image",
        num_mc=a.num_mc, batch_size=a.batch_size,
        train_epochs_per_step=a.train_epochs_per_step,
        arch=_bootstrap.arch(a), device=a.device)
    for r in results:
        print(r)
