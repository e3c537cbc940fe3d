"""From-scratch multimodal training on the card —
Example_training_from_scratch.py equivalent with the reference's canonical
hyperparameters (its main.py:276-317)."""
import _bootstrap  # noqa: F401  (source-checkout sys.path setup)

import argparse

from multimodal_auv_torch import run_AUV_training_from_scratch
from multimodal_auv_torch.config import BNNPriorSpec

if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--root_dir", required=True)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--num_mc", type=int, default=12)
    p.add_argument("--batch_size", type=int, default=12)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--num_classes", type=int, default=0)
    p.add_argument("--bathy_patch_base", type=int, default=30)
    p.add_argument("--sss_patch_base", type=int, default=30)
    _bootstrap.add_common(p)
    a = p.parse_args()
    run_AUV_training_from_scratch(
        const_bnn_prior_parameters=BNNPriorSpec().to_dict(),
        lr_multimodal_model=a.lr,
        num_epochs_multimodal=a.epochs,
        num_mc=a.num_mc,
        bathy_patch_base_raw=a.bathy_patch_base,
        sss_patch_base_raw=a.sss_patch_base,
        batch_size_multimodal=a.batch_size,
        root_dir=a.root_dir,
        num_classes=a.num_classes,
        arch=_bootstrap.arch(a),
        device=a.device,
    )
