"""Console entry points of the port (port of ``multimodal_auv_tpu/cli.py``):

    python -m multimodal_auv_torch.cli {data-prep,inference,retrain,train-scratch,export-serving,selfcheck} [args...]

Every flag of the JAX package's CLI, with its defaults; ``--devices`` is
accepted and informational. One flag is added: ``--device`` (default
``cuda``, the card; ``cpu`` runs every kernel's plain version);
``data-prep`` is host work and takes none. The flags of the sharded
serving artifacts, not ported yet, exit non-zero with a message naming
their ROADMAP item.
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
                        help="data-parallel mesh axis: each batch's rows "
                             "split over this many processes (0 = the "
                             "process count // mesh_mc)")
    parser.add_argument("--mesh_mc", type=int, default=1,
                        help="MC-ensemble mesh axis: each chunk's draws "
                             "split over this many processes")
    parser.add_argument("--fsdp", action="store_true",
                        help="shard the posterior's Adam moments over every "
                             "process")


def _mesh_spec(args):
    if args.mesh_data <= 0 and args.mesh_mc <= 1 and not args.fsdp:
        return None
    from multimodal_auv_torch.config import MeshSpec

    # data=0 means "the process count // mc" in make_mesh
    return MeshSpec(data=max(args.mesh_data, 0), mc=max(args.mesh_mc, 1),
                    fsdp=args.fsdp)


def _add_dist_flags(parser):
    parser.add_argument("--coordinator", type=str, default=None,
                        help="multi-process run: rank 0's 'host:port', where "
                             "the process group meets; every process runs "
                             "this same command with its own --process_id")
    parser.add_argument("--num_processes", type=int, default=0,
                        help="multi-process run: total number of processes, "
                             "one per card")
    parser.add_argument("--process_id", type=int, default=None,
                        help="multi-process run: this process's rank")
    parser.add_argument("--dist_timeout", type=int, default=300,
                        help="multi-process run: rendezvous timeout "
                             "(seconds)")


def _dist_spec(args):
    if args.num_processes and args.num_processes > 1:
        from multimodal_auv_torch.config import DistSpec

        return DistSpec(coordinator=args.coordinator,
                        num_processes=args.num_processes,
                        process_id=args.process_id,
                        initialization_timeout=args.dist_timeout)
    return None  # the pipelines still read the AUV_* environment


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
                        help="single-pass moment-propagated serving "
                             "(approximate; falls back to exact MC "
                             "outside the validated posterior-spread "
                             "regime)")
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
                        help="background checkpoint commits (the copy to "
                             "the host before the call returns, the write "
                             "in a background thread)")
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
                             "num_mc), off (store residuals), auto (off when "
                             "the no-remat step fits the card)")
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


def export_serving_cli(argv=None):
    """Export a serving artifact: the ``torch.export``ed MC predict
    programs + posterior state (serving.py)."""
    parser = argparse.ArgumentParser(
        description="Export a serving artifact (torch.export'ed predict "
                    "programs + posterior state). A serving host loads it "
                    "with torch, numpy and the port's ops alone.")
    parser.add_argument("--output_dir", type=str, required=True,
                        help="Artifact directory to write.")
    parser.add_argument("--batch_size", default="4",
                        help="Static serving batch size (pad + mask ragged "
                             "tails), or 'poly' for a batch-polymorphic "
                             "artifact (any size).")
    parser.add_argument("--num_mc_samples", type=int, default=20)
    parser.add_argument("--num_classes", type=int, default=7)
    parser.add_argument("--model_weights", type=str, default=None,
                        help="Local torch checkpoint (skips the HF download; "
                             "required where there is no network).")
    parser.add_argument("--allow_random_init", action="store_true")
    parser.add_argument("--mc_chunk", type=int, default=None)
    parser.add_argument("--dvp", action="store_true",
                        help="Export the single-pass moment-propagation "
                             "program (guardrailed at export time, see "
                             "--dvp_on_excess).")
    parser.add_argument("--mc_shards", type=int, default=1,
                        help="MC ensemble over M devices: each runs "
                             "num_mc/M draws of every batch (exact MC "
                             "only, static --batch_size); the loader runs "
                             "the shards on the first M cards or on the "
                             "devices it is given.")
    parser.add_argument("--data_shards", type=int, default=1,
                        help="batch sharded over N devices (not ported yet)")
    parser.add_argument("--dvp_on_excess", choices=("warn", "mc"),
                        default="mc",
                        help="Guardrail action if the posterior spread "
                             "exceeds the DVP-validated regime: 'mc' "
                             "exports the exact MC program instead "
                             "(recorded in meta.json), 'warn' exports DVP "
                             "anyway.")
    parser.add_argument("--platforms", type=str, default=None,
                        help="Comma-separated targets; the program is traced "
                             "on --device and runs there, so only that "
                             "device's type is accepted (default: it).")
    parser.add_argument("--fast_sampling", choices=("auto", "on", "off"),
                        default="auto",
                        help="bf16-budget fast-math sampling noise, traced "
                             "into the exported program (auto = on exactly "
                             "when sampling to bf16; recorded in meta.json).")
    parser.add_argument("--bn_mode", choices=("train", "eval"),
                        default="train",
                        help="BatchNorm statistics traced into the program: "
                             "'train' (the reference's current-batch "
                             "statistics) or 'eval' (frozen running "
                             "statistics; recorded in meta.json).")
    _add_device_flag(parser)
    parser.add_argument("--tiny", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.data_shards > 1:
        raise NotPorted("--data_shards is not ported yet: ROADMAP.md, Open "
                        "items, 1 'Modules to port' item 8b (data_shards "
                        "serving artifacts)")

    from multimodal_auv_torch.pipelines import export_auv_serving_artifact

    export_auv_serving_artifact(
        output_dir=args.output_dir,
        batch_size=("poly" if args.batch_size == "poly"
                    else int(args.batch_size)),
        num_mc_samples=args.num_mc_samples,
        num_classes=args.num_classes,
        model_weights_path=args.model_weights,
        allow_random_init=args.allow_random_init,
        arch=_arch(args),
        mc_chunk=args.mc_chunk,
        platforms=(args.platforms.split(",") if args.platforms else None),
        use_dvp=args.dvp,
        dvp_on_excess=args.dvp_on_excess,
        data_shards=args.data_shards,
        mc_shards=args.mc_shards,
        fast_sampling={"auto": None, "on": True, "off": False}[
            args.fast_sampling],
        bn_mode=args.bn_mode,
        device=args.device,
    )
    return 0


def data_preparation_cli(argv=None):
    """``run_auv_preprocessing`` with the JAX package's flags: host work,
    no device."""
    parser = argparse.ArgumentParser(
        description="Prepare AUV survey data: optical preprocessing, "
                    "GeoTIFF patch extraction, bathy channel combine.")
    parser.add_argument("--raw_optical_images_folder", type=str, required=True,
                        help="Folder of raw optical JPEGs (scanned recursively).")
    parser.add_argument("--geotiff_folder", type=str, required=True,
                        help="Folder containing bathymetry/SSS GeoTIFFs.")
    parser.add_argument("--output_folder", type=str, required=True,
                        help="Destination folder for per-sample directories.")
    parser.add_argument("--exiftool_path", type=str, default="exiftool",
                        help="Path to the exiftool binary (optional here; a "
                             "built-in EXIF reader is the fallback).")
    parser.add_argument("--window_size_meters", type=float, default=20.0,
                        help="Patch window size in meters.")
    parser.add_argument("--image_enhancement_method", type=str,
                        default="AverageSubtraction",
                        choices=["AverageSubtraction", "CLAHE"],
                        help="Optical enhancement method.")
    parser.add_argument("--skip_bathy_combine", action="store_true",
                        help="Skip the bathy channel-combine step.")
    args = parser.parse_args(argv)

    from multimodal_auv_torch.pipelines import run_auv_preprocessing

    run_auv_preprocessing(
        raw_optical_images_folder=args.raw_optical_images_folder,
        geotiff_folder=args.geotiff_folder,
        output_folder=args.output_folder,
        exiftool_path=args.exiftool_path,
        window_size_meters=args.window_size_meters,
        image_enhancement_method=args.image_enhancement_method,
        skip_bathy_combine=args.skip_bathy_combine,
    )
    return 0


def selfcheck_cli(argv=None):
    """The self-check on synthetic data (``selfcheck.py``)."""
    from multimodal_auv_torch.selfcheck import main as selfcheck_main

    return selfcheck_main(argv)


_COMMANDS = {
    "data-prep": data_preparation_cli,
    "inference": inference_cli,
    "retrain": retraining_cli,
    "train-scratch": training_from_scratch_cli,
    "export-serving": export_serving_cli,
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
