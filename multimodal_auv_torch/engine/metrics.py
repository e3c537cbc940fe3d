"""Extended evaluation metrics of the noise study (port of
``multimodal_auv_tpu/engine/metrics.py``).

The reference's "Example training with image noise.py":498-681: macro-F1,
uncertainty-error AUROC and 15-bin ECE / Emax calibration, appended to
the main metrics CSV by read-modify-write, plus per-sample CSVs. The JAX
package takes F1 and AUROC from sklearn, which the machine with the card
does not have: here they are numpy, to sklearn's rules (tested against
sklearn).
"""
from __future__ import annotations

import csv
import logging
import os
import warnings
from typing import Dict, List, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def calibration_metrics(probabilities: np.ndarray, labels: np.ndarray,
                        n_bins: int = 15) -> Tuple[float, float]:
    """(ECE, Emax) with the reference's binning: confidences in
    (b_i, b_{i+1}] over n_bins equal-width bins."""
    confidences = np.max(probabilities, axis=1)
    predictions = np.argmax(probabilities, axis=1)
    accuracies = predictions == labels

    bounds = np.linspace(0, 1, n_bins + 1)
    ece = 0.0
    emax = 0.0
    for i in range(n_bins):
        in_bin = (confidences > bounds[i]) & (confidences <= bounds[i + 1])
        prop = np.mean(in_bin)
        if prop > 0:
            gap = abs(np.mean(accuracies[in_bin]) - np.mean(confidences[in_bin]))
            ece += gap * prop
            emax = max(emax, gap)
    return float(ece), float(emax)


def _average_ranks(x: np.ndarray) -> np.ndarray:
    """1-based ranks of ``x``, tied values sharing their average rank."""
    _, inverse, counts = np.unique(x, return_inverse=True, return_counts=True)
    ends = np.cumsum(counts)
    return ((ends - counts + 1 + ends) / 2.0)[inverse]


def uncertainty_error_auroc(predicted: Sequence[int], labels: Sequence[int],
                            uncertainty: Sequence[float]) -> float:
    """AUROC of uncertainty as a predictor of misclassification:
    sklearn's ``roc_auc_score`` as the Mann-Whitney statistic, tied scores
    at their average rank. As sklearn (1.9) does: one class only (no
    error, or nothing right) warns and returns NaN; no samples or a
    non-finite score raises ValueError."""
    errors = np.asarray(predicted) != np.asarray(labels)
    scores = np.asarray(uncertainty, np.float64).reshape(-1)
    if scores.shape != errors.shape:
        raise ValueError(f"{scores.shape[0]} scores for {errors.shape[0]} "
                         f"samples")
    if scores.size == 0:
        raise ValueError("Found array with 0 sample(s)")
    if not np.isfinite(scores).all():
        raise ValueError("Input contains NaN or infinity.")
    n_pos = int(errors.sum())
    n_neg = errors.size - n_pos
    if n_pos == 0 or n_neg == 0:
        warnings.warn("Only one class is present in y_true. ROC AUC score "
                      "is not defined in that case.", RuntimeWarning)
        return float("nan")
    rank_sum = _average_ranks(scores)[errors].sum()
    return float((rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def macro_f1(predicted: Sequence[int], labels: Sequence[int]) -> float:
    """sklearn's ``f1_score(labels, predicted, average="macro")``: the
    unweighted mean over the sorted union of both label sets of
    2 tp / (2 tp + fp + fn), a zero division counting 0."""
    y_pred = np.asarray(predicted).reshape(-1)
    y_true = np.asarray(labels).reshape(-1)
    classes = np.union1d(y_true, y_pred)
    if classes.size == 0:
        return 0.0
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in classes],
                  np.float64)
    denom = np.array([np.sum(y_true == c) + np.sum(y_pred == c)
                      for c in classes], np.float64)
    f1 = np.divide(2.0 * tp, denom, out=np.zeros_like(tp), where=denom > 0)
    return float(np.mean(f1))


def append_fields_to_last_row(csv_path: str, fields: Dict[str, str]) -> bool:
    """Read-modify-write: add columns to the last data row of a CSV
    (the reference's AUROC/F1/ECE append mechanism)."""
    try:
        with open(csv_path, newline="") as f:
            reader = csv.DictReader(f)
            rows = list(reader)
            fieldnames = list(reader.fieldnames or [])
        if not rows:
            return False
        for k, v in fields.items():
            if k not in fieldnames:
                fieldnames.append(k)
            rows[-1][k] = v
        # write-then-rename: an in-place open('w') truncates first, so a
        # crash mid-write (OOM/SIGKILL between epochs of a sweep) would
        # destroy every prior epoch's rows of the study ledger
        tmp = csv_path + ".tmp"
        with open(tmp, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fieldnames)
            w.writeheader()
            w.writerows(rows)
        os.replace(tmp, csv_path)
        return True
    except Exception as e:
        logger.warning("Could not append fields to %s: %s", csv_path, e)
        return False


def save_per_sample_metrics(csv_path: str, model_type: str, epoch: int,
                            bathy_patch_size: str, sss_patch_size: str,
                            data: Dict[str, List]) -> str:
    """Per-sample CSV under <csv_dir>/per_sample_metrics/ with the
    reference's filename scheme."""
    parent = os.path.dirname(os.path.abspath(csv_path))
    out_dir = os.path.join(parent, "per_sample_metrics")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir,
        f"per_sample_run_{model_type}_E{epoch + 1}"
        f"_B{bathy_patch_size}_S{sss_patch_size}.csv")
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(data.keys()))
        w.writeheader()
        w.writerows([dict(zip(data, t)) for t in zip(*data.values())])
    return path
