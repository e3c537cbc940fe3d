"""The port's noise-study metrics (engine/metrics.py) against sklearn and
the JAX package: macro-F1 and the uncertainty-error AUROC in numpy to
sklearn's rules at 1e-12 on random and edge cases (ties, classes absent
from one side, one class -> NaN and a warning, as sklearn 1.9), calibration against
JAX's at 1e-12, and the CSV helpers writing files byte-equal to JAX's."""
import csv

import numpy as np
import pytest
from sklearn.metrics import f1_score, roc_auc_score

from multimodal_auv_torch.engine import metrics as TM
from multimodal_auv_tpu.engine import metrics as JM

TOL = 1e-12


def _cases():
    """(predicted, labels, uncertainty) from a seed: random draws, ties,
    classes seen on one side only."""
    rng = np.random.default_rng(0)
    out = []
    for n, k in ((50, 7), (200, 3), (13, 5), (1000, 7)):
        lab = rng.integers(0, k, n)
        pred = np.where(rng.random(n) < 0.6, lab, rng.integers(0, k, n))
        out.append((pred, lab, rng.random(n)))
    # tied scores (a quarter of the values repeat), predicted classes the
    # labels never hold and labels never predicted
    lab = rng.integers(0, 4, 80)
    pred = rng.integers(2, 7, 80)
    out.append((pred, lab, np.round(rng.random(80), 1)))
    # every score equal
    lab = rng.integers(0, 3, 30)
    out.append((rng.integers(0, 3, 30), lab, np.full(30, 0.5)))
    return out


@pytest.mark.parametrize("case", range(6))
def test_macro_f1_and_auroc_match_sklearn(case):
    pred, lab, unc = _cases()[case]
    want_f1 = f1_score(lab, pred, average="macro", zero_division=0)
    assert abs(TM.macro_f1(pred, lab) - want_f1) <= TOL
    assert abs(TM.macro_f1(list(pred), list(lab)) - JM.macro_f1(pred, lab)) \
        <= TOL
    err = (pred != lab).astype(int)
    want = roc_auc_score(err, unc)
    assert abs(TM.uncertainty_error_auroc(pred, lab, unc) - want) <= TOL
    assert abs(TM.uncertainty_error_auroc(pred, lab, unc)
               - JM.uncertainty_error_auroc(pred, lab, unc)) <= TOL


@pytest.mark.parametrize("all_right", [True, False])
def test_auroc_one_class_as_sklearn(all_right):
    """No error (or nothing right): sklearn warns and returns NaN, so the
    noise study writes "nan" in the AUROC column; the port does the same.
    No samples at all raises ValueError in both."""
    lab = np.array([0, 1, 2, 1])
    pred = lab if all_right else (lab + 1) % 3
    unc = [0.1, 0.2, 0.3, 0.4]
    with pytest.warns(Warning, match="one class"):
        want = JM.uncertainty_error_auroc(pred, lab, unc)
    with pytest.warns(RuntimeWarning, match="one class"):
        got = TM.uncertainty_error_auroc(pred, lab, unc)
    assert np.isnan(want) and np.isnan(got)
    assert "%.6f" % got == "%.6f" % want == "nan"
    with pytest.raises(ValueError):
        JM.uncertainty_error_auroc([], [], [])
    with pytest.raises(ValueError):
        TM.uncertainty_error_auroc([], [], [])


def test_auroc_non_finite_scores_raise():
    with pytest.raises(ValueError):
        JM.uncertainty_error_auroc([0, 1], [0, 0], [0.1, np.nan])
    with pytest.raises(ValueError):
        TM.uncertainty_error_auroc([0, 1], [0, 0], [0.1, np.nan])


def test_macro_f1_edge_cases():
    """One class on both sides, disjoint label sets, a single sample."""
    for pred, lab in (([1, 1, 1], [1, 1, 1]), ([0, 0], [1, 1]), ([3], [3]),
                      ([0, 1, 2], [2, 1, 0])):
        want = f1_score(lab, pred, average="macro", zero_division=0)
        assert abs(TM.macro_f1(pred, lab) - want) <= TOL
        assert abs(TM.macro_f1(pred, lab) - JM.macro_f1(pred, lab)) <= TOL


@pytest.mark.parametrize("n_bins", [15, 4])
def test_calibration_matches_jax(n_bins):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(300, 7)) * 3
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    lab = rng.integers(0, 7, 300)
    got = TM.calibration_metrics(probs, lab, n_bins)
    want = JM.calibration_metrics(probs, lab, n_bins)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # the golden cases of tests/test_noise_and_metrics.py
    eye = np.eye(3)[np.array([0, 1, 2, 0])]
    assert TM.calibration_metrics(eye, np.array([0, 1, 2, 0])) == (0.0, 0.0)
    assert TM.calibration_metrics(eye, np.array([1, 2, 0, 1])) == (1.0, 1.0)


def test_csv_helpers_byte_equal(tmp_path):
    """append_fields_to_last_row and save_per_sample_metrics write the
    same bytes as the JAX package's."""
    data = {"label": [0, 1, 2], "prediction": [0, 2, 2],
            "predictive_uncertainty": [0.1, 1.25, 0.5]}
    paths = {}
    for name, mod in (("jax", JM), ("torch", TM)):
        d = tmp_path / name
        d.mkdir()
        p = str(d / "eval.csv")
        with open(p, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["Epoch", "Acc"])
            w.writerow([1, 0.5])
            w.writerow([2, 0.6])
        assert mod.append_fields_to_last_row(p, {"F1_Score": "0.7",
                                                 "ECE": "0.1"})
        assert not mod.append_fields_to_last_row(str(d / "none.csv"),
                                                 {"x": "1"})
        per = mod.save_per_sample_metrics(p, "multimodal", 2, "30", "10",
                                          data)
        paths[name] = (p, per)
    for a, b in zip(paths["jax"], paths["torch"]):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert paths["torch"][1].endswith(
        "per_sample_metrics/per_sample_run_multimodal_E3_B30_S10.csv")
