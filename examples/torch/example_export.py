"""Export a trained posterior back to the PyTorch reference stack.

Loads a checkpoint trained with the port (a ``save_model`` file, as the
training loops write under ``models/``, or a bayesian-torch-named .pth),
rebuilds the bundle, and writes either a single bayesian-torch-named .pth
(consumable by the reference's load_and_fix_state_dict /
load_and_prepare_multimodal_model, Example_Inference_model.py:82-112) or
the full HF repo layout (<out>/multimodal-bnn/pytorch_model.bin) ready for
huggingface_hub.upload_folder. Orbax directories are the JAX package's:
export those with its own examples/example_export.py."""
import _bootstrap  # noqa: F401  (source-checkout sys.path setup)

import argparse

import torch

from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.engine.checkpointing import load_and_fix_state_dict
from multimodal_auv_torch.interop.hub import export_for_hub
from multimodal_auv_torch.interop.torch_export import save_torch_checkpoint
from multimodal_auv_torch.models.model_utils import make_multimodal_bundle

if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True,
                   help="save_model file or torch .pth trained here")
    p.add_argument("--num_classes", type=int, default=7)
    p.add_argument("--out", default="export.pth",
                   help=".pth path, or a directory with --hub-layout")
    p.add_argument("--hub_layout", action="store_true",
                   help="write <out>/multimodal-bnn/pytorch_model.bin")
    _bootstrap.add_common(p)
    a = p.parse_args()

    bundle = make_multimodal_bundle(a.num_classes, BNNPriorSpec(),
                                    torch.Generator().manual_seed(0),
                                    _bootstrap.arch(a), device=a.device)
    if a.checkpoint.endswith((".pth", ".bin", ".pt")):
        from multimodal_auv_torch.interop.torch_import import (
            load_and_prepare_multimodal_model,
        )

        bundle, _ = load_and_prepare_multimodal_model(
            bundle, a.checkpoint, num_classes=a.num_classes)
    else:
        post, ok = load_and_fix_state_dict(bundle.post, a.checkpoint)
        if not ok:
            raise SystemExit(f"could not restore {a.checkpoint}")
        bundle.post = post
    if a.hub_layout:
        path = export_for_hub(bundle, a.out)
    else:
        save_torch_checkpoint(bundle, a.out)
        path = a.out
    print(f"exported -> {path}")
