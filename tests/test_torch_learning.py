"""The port learns: the counterparts of tests/test_learning.py on the CPU,
where every kernel runs its plain version. The same data and geometry as
the JAX tests, through the port's own train and eval steps and its
training pipeline; the gates are the JAX tests' gates.
"""
import os

import numpy as np
import pytest
import torch

from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.engine.optim import BayesTrainState, make_optimizer
from multimodal_auv_torch.engine.steps import make_eval_step, make_train_step
from multimodal_auv_torch.models.model_utils import (
    ArchConfig,
    make_unimodal_bundle,
)
from chip_smoke import learning_gates
from tests.test_learning import S, _data


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Small graphs: one intra-op thread, so no idle OpenMP threads spin on
    the cores the suite's other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_unimodal_bnn_learns_synthetic_classes():
    """tests/test_learning.py:31 in the port: a two-stage width-8 f32
    unimodal BNN (non-MOPED init) trained 30 steps at 2 MC draws and
    kl_weight 1e-6 on 24 separable 16 px images of 3 classes reaches >= 90%
    accuracy under a 4-draw eval, with finite epistemic variance."""
    spec = BNNPriorSpec(moped_enable=False)  # random init, rho ~ N(-3, 0.1)
    arch = ArchConfig(stage_sizes=(1, 1), width=8, image_size=S,
                      dtype=torch.float32)
    bundle = make_unimodal_bundle(3, 3, spec, torch.Generator().manual_seed(0),
                                  arch, device="cpu")
    state = BayesTrainState(post=bundle.post,
                            opt_state=make_optimizer(3e-3).init(bundle.post),
                            batch_stats=bundle.batch_stats)
    step = make_train_step(bundle.module, bundle.meta, spec, num_mc=2)
    estep = make_eval_step(bundle.module, bundle.meta, spec, num_mc=4)

    imgs, labels = _data(24)
    x, y = (torch.from_numpy(imgs),), torch.from_numpy(labels).long()
    mask = torch.ones(24)
    gen = torch.Generator().manual_seed(1)
    kl_weight = 1e-6  # tiny anneal weight early in training (2^(e+1)/2^E)
    for _ in range(30):
        state, m = step(state, x, y, mask, gen, kl_weight, 24.0)
    assert np.isfinite(float(m["loss"]))

    ev = estep(state.post, state.batch_stats, x, y, mask,
               torch.Generator().manual_seed(2), 0.0)
    acc = float(ev["correct"]) / float(ev["total"])
    assert acc >= 0.9, f"training failed to learn: accuracy={acc}"
    # epistemic uncertainty should be finite on seen data
    assert torch.isfinite(ev["epistemic_variance"]).all()


@pytest.mark.slow
def test_multimodal_pipeline_learns_and_calibrates(tmp_path, monkeypatch):
    """tests/test_learning.py:64 in the port: ``run_AUV_training_from_scratch``
    on a separable synthetic survey tree (3 classes x 8, 32 px, micro(),
    10 epochs, 2 MC draws, non-MOPED init), the end-of-training state
    restored through ``restore_train_state``, then an unseen probe tree of
    clean and ambiguous samples predicted at 16 MC draws. The JAX test's
    four gates: clean held-out accuracy >= 0.9; mean predictive
    uncertainty on the ambiguous samples > 1.2x the clean ones'; a finite
    clean-set ECE < 0.30; AUROC(uncertainty -> error) > 0.5 when the probe
    set has both hits and errors."""
    from tests.fixtures.make_tree import make_separable_training_tree

    from multimodal_auv_torch.data.datasets import MultimodalFolderDataset
    from multimodal_auv_torch.data.loaders import DataLoader
    from multimodal_auv_torch.engine.checkpointing import restore_train_state
    from multimodal_auv_torch.engine.loops import select_patch
    from multimodal_auv_torch.engine.predict import make_predict_step
    from multimodal_auv_torch.models.model_utils import make_multimodal_bundle
    from multimodal_auv_torch.pipelines.training import (
        run_AUV_training_from_scratch,
    )

    monkeypatch.chdir(tmp_path)  # the pipeline's logs/ and tensorboard_logs/
    spec = BNNPriorSpec(moped_enable=False)
    arch = ArchConfig.micro(image_size=32)
    train_root = make_separable_training_tree(str(tmp_path / "train"),
                                              n_per_class=8, seed=0)
    ckpt = str(tmp_path / "ckpt.pt")
    ok = run_AUV_training_from_scratch(
        const_bnn_prior_parameters=spec.to_dict(),
        lr_multimodal_model=3e-3, num_epochs_multimodal=10, num_mc=2,
        bathy_patch_base_raw=10, sss_patch_base_raw=10,
        batch_size_multimodal=6, root_dir=train_root, num_classes=0,
        arch=arch, seed=0, strict_errors=True, handle_preemption=False,
        resume_checkpoint=ckpt, device="cpu")
    assert ok is True

    # restore the end-of-training state through the resume path
    bundle = make_multimodal_bundle(3, spec, torch.Generator().manual_seed(0),
                                    arch, device="cpu")
    template = BayesTrainState(
        post=bundle.post,
        opt_state=make_optimizer(3e-3, 1e-5).init(bundle.post),
        batch_stats=bundle.batch_stats)
    state, epoch, _ = restore_train_state(ckpt, template)
    assert epoch == 10
    bundle.post, bundle.batch_stats = state.post, state.batch_stats

    # an unseen probe tree: clean and ambiguous samples (another seed)
    probe_root = make_separable_training_tree(
        str(tmp_path / "probe"), n_per_class=6, ambiguous_per_class=6,
        seed=1)
    ds = MultimodalFolderDataset(probe_root, image_size=32)
    batch = next(iter(DataLoader(ds, batch_size=len(ds), shuffle=False)))
    names = [os.path.basename(os.path.dirname(p["main_image"]))
             for p in ds.data_paths]
    is_ambig = np.asarray([n.startswith("ambig") for n in names])
    inputs = tuple(torch.from_numpy(np.asarray(a, np.float32)) for a in (
        batch["main_image"], select_patch(batch, "patch_10_bathy", "bathy"),
        select_patch(batch, "patch_10_sss", "sss")))
    labels = np.asarray(batch["label"], np.int64)

    step = make_predict_step(bundle, 16, sample_dtype=None)
    out = step(bundle.post, bundle.batch_stats, inputs,
               torch.Generator().manual_seed(3))
    pred = out["predicted"].numpy()
    prob = out["mean_prob"].to(torch.float32).numpy()
    unc = out["predictive_uncertainty"].to(torch.float32).numpy()
    # the gates of chip_smoke.py's learning phase, the JAX test's four
    report = learning_gates(pred, prob, unc, labels, is_ambig)
    print(f"learning: {report}")
