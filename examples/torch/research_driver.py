"""Research driver on the card — the reference main.py analogue: unimodal
training for all three modalities, then the multimodal patch-size grid
search ({2,5,10,30,50} m bathy x sss, main.py:94-184 — commented out
there, runnable here)."""
import _bootstrap  # noqa: F401  (source-checkout sys.path setup)

import argparse

from multimodal_auv_torch.pipelines.sweep import run_patch_size_sweep
from multimodal_auv_torch.pipelines.unimodal import run_unimodal_training

if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--root_dir", required=True)
    p.add_argument("--csv_dir", default="research_csvs")
    p.add_argument("--unimodal_epochs", type=int, default=10)
    p.add_argument("--sweep_epochs", type=int, default=5)
    p.add_argument("--num_mc", type=int, default=12)
    p.add_argument("--skip_unimodal", action="store_true")
    p.add_argument("--grid", type=int, nargs="+", default=[2, 5, 10, 30, 50])
    _bootstrap.add_common(p, tiny_help="test architecture (smoke runs)")
    a = p.parse_args()

    arch = _bootstrap.arch(a)

    if not a.skip_unimodal:
        for model_type in ("image", "sss", "bathy"):
            run_unimodal_training(a.root_dir, model_type=model_type,
                                  num_epochs=a.unimodal_epochs,
                                  num_mc=a.num_mc, csv_dir=a.csv_dir,
                                  arch=arch, device=a.device)

    results = run_patch_size_sweep(
        a.root_dir, a.csv_dir, bathy_sizes=a.grid, sss_sizes=a.grid,
        num_epochs=a.sweep_epochs, num_mc=a.num_mc, arch=arch,
        device=a.device)
    best = max((r for r in results if r["accuracy"]),
               key=lambda r: float(r["accuracy"]), default=None)
    print("Best combo:", best)
