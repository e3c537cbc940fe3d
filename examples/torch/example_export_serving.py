"""Export a serving artifact on the card and serve a batch from it.

The export side needs the full port; the serving side needs only torch,
numpy and the port's ops (serving.py) — the exported programs ship with
the posterior state, so serving processes never trace or rebuild the
model.

``--batch_size poly`` exports one batch-polymorphic artifact that serves
any batch size; ``--dvp`` exports the single-pass moment-propagation
program (same ABI, guardrailed at export time).
"""
import _bootstrap  # noqa: F401  (source-checkout sys.path setup)

import argparse

import numpy as np

from multimodal_auv_torch.pipelines import export_auv_serving_artifact
from multimodal_auv_torch.serving import load_predict_artifact


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--output_dir", required=True)
    p.add_argument("--batch_size", default="4",
                   help="int, or 'poly' for a batch-polymorphic artifact")
    p.add_argument("--num_mc_samples", type=int, default=20)
    p.add_argument("--model_weights", default=None)
    p.add_argument("--allow_random_init", action="store_true")
    p.add_argument("--dvp", action="store_true")
    _bootstrap.add_common(p)
    args = p.parse_args()

    export_auv_serving_artifact(
        args.output_dir,
        batch_size=("poly" if args.batch_size == "poly"
                    else int(args.batch_size)),
        num_mc_samples=args.num_mc_samples,
        model_weights_path=args.model_weights,
        allow_random_init=args.allow_random_init,
        use_dvp=args.dvp,
        arch=_bootstrap.arch(args),
        device=args.device)

    art = load_predict_artifact(args.output_dir, device=args.device)
    s = art.image_size
    b = 4 if art.batch_size == "poly" else art.batch_size
    rng = np.random.default_rng(0)

    def batch():
        return (rng.integers(0, 255, (b, s, s, 3), dtype=np.uint8),
                rng.integers(0, 255, (b, s, s, 3), dtype=np.uint8),
                rng.integers(0, 255, (b, s, s, 1), dtype=np.uint8))

    # production loop shape: stream with the one-batch-lagged fetch
    for i, out in enumerate(art.predict_batches(batch() for _ in range(3))):
        print(f"batch {i} ({art.mode}): predicted={out['predicted']} "
              f"pu={np.round(out['predictive_uncertainty'], 4)}")


if __name__ == "__main__":
    main()
