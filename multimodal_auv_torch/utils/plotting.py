"""Confusion-matrix PNG artifacts (port of
``multimodal_auv_tpu/utils/plotting.py``).

Path scheme and filename match the reference (its train/multimodal.py:
322-347): ``{dirname(csv_path)}/confusion_matrices/
conf_matrix_model_{type}_{epoch}.png``. The matrix is counted with numpy;
matplotlib is imported inside the function, and any plotting failure (its
absence included) is a warning, as in the reference.
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def _full_label_set(all_labels, all_predicted, class_names):
    """(labels, display_names) covering every class AND every observed
    index: a head wider than the class list (e.g. num_classes=7 on a
    3-class survey) can predict indices >= len(class_names), which a matrix
    pinned to range(len(class_names)) would silently drop."""
    names = [str(c) for c in class_names]
    hi = max([int(v) for v in list(all_labels)]
             + [int(v) for v in list(all_predicted)]
             + [len(names) - 1])
    names += [f"class_{i}" for i in range(len(names), hi + 1)]
    return list(range(len(names))), names


def confusion_matrix(all_labels, all_predicted, labels) -> np.ndarray:
    """Counts of (true label, predicted label) pairs over ``labels``, rows
    true and columns predicted; pairs outside ``labels`` are not counted."""
    index = {int(v): i for i, v in enumerate(labels)}
    cm = np.zeros((len(index), len(index)), np.int64)
    for t, q in zip(all_labels, all_predicted):
        if int(t) in index and int(q) in index:
            cm[index[int(t)], index[int(q)]] += 1
    return cm


def save_confusion_matrix(all_labels, all_predicted, csv_path: str,
                          model_type: str, epoch: int,
                          class_names: Optional[Sequence[str]] = None
                          ) -> Optional[str]:
    fig = None
    try:
        if class_names is not None:
            labels, display = _full_label_set(all_labels, all_predicted,
                                              class_names)
        else:  # the observed classes only
            labels = sorted({int(v) for v in list(all_labels)
                             + list(all_predicted)})
            display = [str(v) for v in labels]
        cm = confusion_matrix(all_labels, all_predicted, labels)
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 8))
        im = ax.imshow(cm, cmap="Blues")
        fig.colorbar(im, ax=ax)
        ticks = np.arange(len(display))
        ax.set_xticks(ticks, display, rotation=45, ha="right")
        ax.set_yticks(ticks, display)
        ax.set_xlabel("Predicted label")
        ax.set_ylabel("True label")
        for (i, j), v in np.ndenumerate(cm):
            ax.text(j, i, str(v), ha="center", va="center")
        plt.title(f"Confusion Matrix for Epoch {epoch}")

        folder = os.path.join(os.path.dirname(csv_path), "confusion_matrices")
        os.makedirs(folder, exist_ok=True)
        path = os.path.join(folder,
                            f"conf_matrix_model_{model_type}_{epoch}.png")
        plt.savefig(path)
        logger.info("Confusion matrix saved to: %s", path)
        return path
    except Exception as e:
        logger.warning("Confusion matrix not saved due to plotting error: %s",
                       e)
        return None
    finally:
        if fig is not None:
            import matplotlib.pyplot as plt

            plt.close(fig)
