"""Console entry points of the port (port of ``multimodal_auv_tpu/cli.py``):

    python -m multimodal_auv_torch.cli {inference,retrain,train-scratch,selfcheck} [args...]

Every flag of the JAX package's CLI, with its defaults; ``--devices`` is
accepted and informational. One flag is added: ``--device`` (default
``cuda``, the card; ``cpu`` runs every kernel's plain version). Flags of
paths not ported yet, and the ``data-prep`` and ``export-serving``
subcommands, exit non-zero with a message naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import logging
import sys
from typing import Optional


class NotPorted(Exception):
    """A flag or subcommand whose path is not ported yet."""


def _arch(args):
    from multimodal_auv_torch.models.model_utils import ArchConfig

    return (ArchConfig.tiny(image_size=64) if getattr(args, "tiny", False)
            else ArchConfig())


def _add_device_flag(parser):
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on: 'cuda' (the card, "
                             "default) or 'cpu' (every kernel's plain "
                             "PyTorch version; tests and small runs)")


def _add_mesh_flags(parser):
    parser.add_argument("--mesh_data", type=int, default=0,
                        help="data-parallel mesh axis (not ported yet)")
    parser.add_argument("--mesh_mc", type=int, default=1,
                        help="MC-ensemble mesh axis (not ported yet)")
    parser.add_argument("--fsdp", action="store_true",
                        help="shard the posterior and Adam moments (not "
                             "ported yet)")


def _mesh_spec(args) -> None:
    if args.mesh_data > 0 or args.mesh_mc > 1 or args.fsdp:
        raise NotPorted("--mesh_data / --mesh_mc / --fsdp are not ported "
                        "yet: ROADMAP.md, Open items, 1 'Modules to port' "
                        "item 8 (parallel)")
    return None


def _add_dist_flags(parser):
    parser.add_argument("--coordinator", type=str, default=None,
                        help="multi-host coordinator 'host:port' (not "
                             "ported yet)")
    parser.add_argument("--num_processes", type=int, default=0,
                        help="multi-host: total number of processes (not "
                             "ported yet)")
    parser.add_argument("--process_id", type=int, default=None,
                        help="multi-host: this process's index")
    parser.add_argument("--dist_timeout", type=int, default=300,
                        help="multi-host: rendezvous timeout (seconds)")


def _dist_spec(args) -> None:
    if args.coordinator is not None or args.num_processes > 1:
        raise NotPorted("--coordinator / --num_processes are not ported "
                        "yet: ROADMAP.md, Open items, 1 'Modules to port' "
                        "item 8 (parallel)")
    return None


def _refuse_training_flags(args) -> None:
    if args.async_checkpoints:
        raise NotPorted("--async_checkpoints is not ported yet: ROADMAP.md, "
                        "Open items, 1 'Modules to port' item 5 (training: "
                        "async checkpoints)")
    if args.remat == "auto":
        raise NotPorted("--remat auto is not ported yet: ROADMAP.md, Open "
                        "items, 1 'Modules to port' item 5 (training: "
                        "remat='auto')")


def inference_cli(argv=None):
    parser = argparse.ArgumentParser(
        description="Multimodal AUV BNN inference with MC uncertainty.")
    parser.add_argument("--data_dir", type=str, required=True,
                        help="Path to the input data directory for inference.")
    parser.add_argument("--output_csv", type=str, required=True,
                        help="Path to save the inference results CSV.")
    parser.add_argument("--batch_size", type=int, default=4,
                        help="Batch size for inference (default: 4).")
    parser.add_argument("--num_mc_samples", type=int, default=20,
                        help="Number of Monte Carlo samples (default: 20).")
    parser.add_argument("--num_classes", type=int, default=7)
    parser.add_argument("--model_weights", type=str, default=None,
                        help="Local torch checkpoint (skips the HF download; "
                             "required where there is no network).")
    parser.add_argument("--allow_random_init", action="store_true")
    parser.add_argument("--mc_chunk", type=int, default=1)
    parser.add_argument("--packed_loader", action="store_true",
                        help="decode-once serving: pack the survey into "
                             "uint8 memmaps, normalize on the card")
    parser.add_argument("--dvp", action="store_true",
                        help="single-pass moment-propagated serving (not "
                             "ported yet)")
    parser.add_argument("--fast_sampling", choices=("auto", "on", "off"),
                        default="auto",
                        help="bf16-budget fast-math sampling noise (auto = "
                             "on exactly when sampling straight to bf16; "
                             "'off' forces the ~1e-6 polynomials)")
    parser.add_argument("--bn_mode", choices=("train", "eval"),
                        default="train",
                        help="BatchNorm statistics at inference: 'train' "
                             "(the reference's current-batch statistics) or "
                             "'eval' (frozen running statistics)")
    _add_device_flag(parser)
    parser.add_argument("--tiny", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.dvp:
        raise NotPorted("--dvp is not ported yet: ROADMAP.md, Open items, 1 "
                        "'Modules to port' item 6 (DVP)")

    from multimodal_auv_torch.pipelines import run_auv_inference

    run_auv_inference(
        data_directory=args.data_dir,
        batch_size=args.batch_size,
        output_csv=args.output_csv,
        num_mc_samples=args.num_mc_samples,
        num_classes=args.num_classes,
        model_weights_path=args.model_weights,
        allow_random_init=args.allow_random_init,
        arch=_arch(args),
        mc_chunk=args.mc_chunk,
        use_packed_loader=args.packed_loader,
        use_dvp=args.dvp,
        fast_sampling={"auto": None, "on": True, "off": False}[
            args.fast_sampling],
        bn_mode=args.bn_mode,
        device=args.device,
    )
    return 0


def _add_training_flags(parser):
    """The flags the retrain and train-scratch subcommands share."""
    parser.add_argument("--bathy_patch_base", type=int, default=30)
    parser.add_argument("--sss_patch_base", type=int, default=30)
    parser.add_argument("--mc_chunk", type=int, default=1)
    parser.add_argument("--bf16_weights", action="store_true",
                        help="mixed-precision training: bf16 sampled "
                             "weights, f32 master posterior")
    parser.add_argument("--strict_errors", action="store_true",
                        help="re-raise mid-epoch exceptions instead of the "
                             "reference's swallow-into-zero-metrics (the "
                             "crash-save still happens)")
    parser.add_argument("--async_checkpoints", action="store_true",
                        help="background checkpoint commits (not ported "
                             "yet)")
    parser.add_argument("--resume_checkpoint", type=str, default=None,
                        help="path for true resume: posterior + optimizer "
                             "+ epoch + scheduler state saved every epoch; "
                             "a restarted run with the same arguments "
                             "resumes bit-reproducibly")
    parser.add_argument("--packed_loader", action="store_true",
                        help="decode-once training: uint8 memmap batches, "
                             "normalize on the card")
    parser.add_argument("--remat", choices=("on", "off", "auto"),
                        default="on",
                        help="MC-draw rematerialisation: on (memory flat in "
                             "num_mc), off (store residuals), auto (not "
                             "ported yet)")
    _add_mesh_flags(parser)
    _add_dist_flags(parser)
    _add_device_flag(parser)
    parser.add_argument("--tiny", action="store_true", help=argparse.SUPPRESS)


def retraining_cli(argv=None):
    parser = argparse.ArgumentParser(
        description="Retrain the pretrained multimodal AUV BNN on new data.")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--batch_size_multimodal", type=int, default=20)
    parser.add_argument("--num_epochs_multimodal", type=int, default=20)
    parser.add_argument("--num_mc_samples", type=int, default=20)
    parser.add_argument("--learning_rate_multimodal", type=float, default=0.001)
    parser.add_argument("--weight_decay_multimodal", type=float, default=1e-5)
    parser.add_argument("--num_classes", type=int, default=10)
    parser.add_argument("--devices", type=str, default="tpu",
                        help="Informational; --device picks the device.")
    parser.add_argument("--model_weights", type=str, default=None,
                        help="Local torch checkpoint (skips the HF download; "
                             "required where there is no network).")
    parser.add_argument("--allow_random_init", action="store_true")
    parser.add_argument("--freeze_backbone", action="store_true",
                        help="Train only the fusion head (foundation-model "
                             "fine-tuning with frozen ResNet trunks).")
    _add_training_flags(parser)
    args = parser.parse_args(argv)
    _refuse_training_flags(args)
    mesh_spec, dist_spec = _mesh_spec(args), _dist_spec(args)

    from multimodal_auv_torch.engine.preemption import (
        PREEMPTED_EXIT_CODE,
        PreemptionGuard,
    )
    from multimodal_auv_torch.pipelines import run_auv_retraining

    guard = PreemptionGuard()
    with guard:
        ok = run_auv_retraining(
            root_dir=args.data_dir,
            num_classes=args.num_classes,
            lr_multimodal=args.learning_rate_multimodal,
            multimodal_weight_decay=args.weight_decay_multimodal,
            epochs_multimodal=args.num_epochs_multimodal,
            num_mc=args.num_mc_samples,
            bathy_patch_base=args.bathy_patch_base,
            sss_patch_base=args.sss_patch_base,
            batch_size_multimodal=args.batch_size_multimodal,
            model_weights_path=args.model_weights,
            allow_random_init=args.allow_random_init,
            freeze_backbone=args.freeze_backbone,
            bf16_weights=args.bf16_weights,
            use_packed_loader=args.packed_loader,
            strict_errors=args.strict_errors,
            async_checkpoints=args.async_checkpoints,
            resume_checkpoint=args.resume_checkpoint,
            arch=_arch(args),
            mc_chunk=args.mc_chunk,
            remat=args.remat,
            mesh_spec=mesh_spec,
            dist_spec=dist_spec,
            preemption_guard=guard,
            device=args.device,
        )
    if guard.triggered:
        # EX_TEMPFAIL: schedulers re-run the job, which resumes from the
        # checkpoint
        return PREEMPTED_EXIT_CODE
    return 0 if ok else 1


def training_from_scratch_cli(argv=None):
    parser = argparse.ArgumentParser(
        description="Train the multimodal AUV BNN from scratch.")
    parser.add_argument("--root_dir", type=str, required=True)
    parser.add_argument("--epochs_multimodal", type=int, default=20)
    parser.add_argument("--num_mc", type=int, default=20)
    parser.add_argument("--batch_size_multimodal", type=int, default=20)
    parser.add_argument("--lr_multimodal", type=float, default=0.001)
    parser.add_argument("--num_classes", type=int, default=10)
    parser.add_argument("--devices", type=str, default="tpu",
                        help="Informational; --device picks the device.")
    parser.add_argument("--batch_size_unimodal", type=int, default=8)
    parser.add_argument("--pretrained_trunks", type=str, default=None,
                        help="torchvision-named ResNet-50 state dict (.pth): "
                             "MOPED-initialise all three feature trunks "
                             "(offline stand-in for IMAGENET1K_V1)")
    _add_training_flags(parser)
    args = parser.parse_args(argv)
    _refuse_training_flags(args)
    mesh_spec, dist_spec = _mesh_spec(args), _dist_spec(args)

    from multimodal_auv_torch.config import BNNPriorSpec
    from multimodal_auv_torch.engine.preemption import (
        PREEMPTED_EXIT_CODE,
        PreemptionGuard,
    )
    from multimodal_auv_torch.pipelines import run_AUV_training_from_scratch

    guard = PreemptionGuard()
    with guard:
        ok = run_AUV_training_from_scratch(
            const_bnn_prior_parameters=BNNPriorSpec().to_dict(),
            lr_multimodal_model=args.lr_multimodal,
            num_epochs_multimodal=args.epochs_multimodal,
            num_mc=args.num_mc,
            bathy_patch_base_raw=args.bathy_patch_base,
            sss_patch_base_raw=args.sss_patch_base,
            batch_size_multimodal=args.batch_size_multimodal,
            root_dir=args.root_dir,
            num_classes=args.num_classes,
            arch=_arch(args),
            mc_chunk=args.mc_chunk,
            pretrained_trunks=args.pretrained_trunks,
            bf16_weights=args.bf16_weights,
            use_packed_loader=args.packed_loader,
            strict_errors=args.strict_errors,
            async_checkpoints=args.async_checkpoints,
            resume_checkpoint=args.resume_checkpoint,
            remat=args.remat,
            mesh_spec=mesh_spec,
            dist_spec=dist_spec,
            preemption_guard=guard,
            device=args.device,
        )
    if guard.triggered:
        return PREEMPTED_EXIT_CODE
    return 0 if ok else 1


def selfcheck_cli(argv=None):
    """The self-check on synthetic data (``selfcheck.py``)."""
    from multimodal_auv_torch.selfcheck import main as selfcheck_main

    return selfcheck_main(argv)


def _not_ported_command(name: str, item: str):
    def refuse(argv=None):
        raise NotPorted(f"the {name} subcommand is not ported yet: "
                        f"ROADMAP.md, Open items, 1 'Modules to port' item "
                        f"{item}")

    return refuse


_COMMANDS = {
    "data-prep": _not_ported_command(
        "data-prep", "9 (studies: pipelines/preprocessing.py)"),
    "inference": inference_cli,
    "retrain": retraining_cli,
    "train-scratch": training_from_scratch_cli,
    "export-serving": _not_ported_command("export-serving", "7 (serving)"),
    "selfcheck": selfcheck_cli,
}


def main(argv: Optional[list] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in _COMMANDS:
        print("usage: python -m multimodal_auv_torch.cli "
              f"{{{','.join(_COMMANDS)}}} [args...]", file=sys.stderr)
        return 2
    try:
        return _COMMANDS[argv[0]](argv[1:])
    except NotPorted as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
