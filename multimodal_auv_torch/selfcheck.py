"""Self-check of the port on synthetic data (port of
``multimodal_auv_tpu/selfcheck.py``): a tiny synthetic survey tree in a
temporary directory, inference and a 2-epoch from-scratch training run
through the public API on a small architecture, the output ledgers
checked; exits non-zero on any failure:

    python -m multimodal_auv_torch.selfcheck                 # on the card
    python -m multimodal_auv_torch.selfcheck --device cpu    # plain versions
    python -m multimodal_auv_torch.selfcheck --full          # full ResNet-50
"""
from __future__ import annotations

import argparse
import logging
import os
import shutil
import sys
import tempfile
import time

logger = logging.getLogger(__name__)


def _make_survey(root: str, n: int, labeled: bool) -> str:
    """Synthetic folders that the dataset scans accept: a frame JPEG, an
    SSS PNG and a combined bathymetry image (plus patches, a label file
    and normalised_meta.csv for the labelled training layout)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    labels = ("Sand", "Mud", "Rock")
    for i in range(n):
        d = os.path.join(root, f"sample_{i:03d}")
        os.makedirs(d, exist_ok=True)
        # the training scan wants a lowercase '*frame*.jpg' (the
        # reference's rule); the inference scan takes '[fF]rame*.jpg'
        main_name = (f"frame_{i:03d}.jpg" if labeled
                     else f"Frame_{i:03d}.jpg")
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(
            os.path.join(d, main_name))
        Image.fromarray(rng.integers(1, 255, (64, 64), np.uint8)).save(
            os.path.join(d, f"line_SSS_{i}.png"))
        if labeled:
            Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(
                os.path.join(d, "combined_rgb_bathymetry.jpg"))
            Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(
                os.path.join(d, "patch_30m_combined_bathy.png"))
            Image.fromarray(rng.integers(1, 255, (64, 64), np.uint8)).save(
                os.path.join(d, "patch_30m_line_SSS.png"))
            with open(os.path.join(d, f"{labels[i % len(labels)]}.txt"), "w"):
                pass
            with open(os.path.join(d, "normalised_meta.csv"), "w") as f:
                f.write("easting,northing\n1,2\n")
        else:
            Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(
                os.path.join(d, "patch_30m_combined_bathy.png"))
    return root


def _check(name: str, ok: bool, detail: str = "") -> bool:
    print(f"{'PASS' if ok else 'FAIL'} {name} {detail}".rstrip())
    return bool(ok)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--full", action="store_true",
                   help="use the full ResNet-50 architecture")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the card, default) or 'cpu'")
    p.add_argument("--keep", action="store_true",
                   help="keep the temporary work directory (prints its path)")
    args = p.parse_args(argv)

    # offline by contract: a networked host would otherwise download the
    # full published checkpoint only for the import to drop every tensor
    # against the tiny architecture
    os.environ.setdefault("HF_HUB_OFFLINE", "1")

    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.models.model_utils import ArchConfig
    from multimodal_auv_torch.pipelines import (
        run_auv_inference,
        run_AUV_training_from_scratch,
    )

    arch = ArchConfig() if args.full else ArchConfig.tiny(image_size=64)
    work = tempfile.mkdtemp(prefix="auv_selfcheck_")
    results = []
    t0 = time.time()
    cwd = os.getcwd()
    try:
        os.chdir(work)  # the pipelines write logs/ and tensorboard_logs/

        # 1. inference: survey tree -> reference-schema CSV; a crash is a
        # FAIL line and the training checks still run
        infer_root = _make_survey(os.path.join(work, "survey"), 4,
                                  labeled=False)
        out_csv = os.path.join(work, "inference_results.csv")
        try:
            run_auv_inference(data_directory=infer_root, batch_size=2,
                              output_csv=out_csv, num_mc_samples=2,
                              num_classes=7, allow_random_init=True,
                              arch=arch, device=args.device)
            with open(out_csv) as f:
                rows = f.read().strip().splitlines()
            results.append(_check(
                "inference CSV header",
                rows[0] == "Image Name,Predicted Class,"
                           "Predictive Uncertainty,Aleatoric Uncertainty"))
            results.append(_check("inference CSV rows", len(rows) == 1 + 4,
                                  f"{len(rows) - 1}/4"))
        except Exception as e:
            logger.error("inference pipeline crashed", exc_info=True)
            results.append(_check("inference pipeline ran", False, repr(e)))

        # 2. from-scratch training: labelled tree -> ledgers and
        # checkpoints; a crash is a FAIL line too
        train_root = _make_survey(os.path.join(work, "train"), 9,
                                  labeled=True)
        try:
            ok = run_AUV_training_from_scratch(
                const_bnn_prior_parameters=BNNPriorSpec().to_dict(),
                lr_multimodal_model=1e-3, num_epochs_multimodal=2, num_mc=2,
                bathy_patch_base_raw=30, sss_patch_base_raw=30,
                batch_size_multimodal=3, root_dir=train_root, num_classes=3,
                arch=arch, device=args.device)
            results.append(_check("training pipeline returned ok", bool(ok)))
            tcsv = os.path.join(train_root, "csvs",
                                "multimodal_train_results.csv")
            results.append(_check("training ledger written",
                                  os.path.exists(tcsv)))
            if os.path.exists(tcsv):
                with open(tcsv) as f:
                    n = len(f.read().strip().splitlines())
                results.append(_check("training ledger rows", n == 1 + 2,
                                      f"{n - 1}/2 epochs"))
        except Exception as e:
            logger.error("training pipeline crashed", exc_info=True)
            results.append(_check("training pipeline ran", False, repr(e)))
    finally:
        os.chdir(cwd)
        if args.keep:
            print(f"# work dir kept: {work}")
        else:
            shutil.rmtree(work, ignore_errors=True)

    print(f"\n{sum(results)}/{len(results)} checks passed "
          f"({time.time() - t0:.1f}s)")
    return 0 if results and all(results) else 1


if __name__ == "__main__":
    logging.basicConfig(level=logging.WARNING)
    sys.exit(main())
