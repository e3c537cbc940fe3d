"""Folder-scanning datasets with the reference's discovery rules (port of
``multimodal_auv_tpu/data/datasets.py``).

* ``MultimodalFolderDataset`` (labelled, training and eval): per sample
  folder a ``*frame*.jpg`` main image, the max-nonzero ``*SSS*`` image
  (excluding ``patch_`` files), ``combined_rgb_bathymetry.jpg``, at least
  one ``patch_<N>m_combined_bathy.png`` / ``patch_<N>m_*_SSS.(png|jpg)``
  patch, a ``normalised_meta.csv``, and a label from the newest
  non-underscore ``.txt`` basename. Labels are encoded alphabetically
  (``LabelEncoder``, sklearn's rule without sklearn). Missing patch sizes
  yield zero dummies so every sample carries the full discovered set.
* ``InferenceFolderDataset`` (unlabelled): main = ``[fF]rame*.jpg``, bathy =
  ``patch_30m_combined_bathy.png`` or ``combined_bathy.jpg``, SSS = the
  non-patch ``*SSS*`` image with the most nonzero pixels; folders with
  missing or all-black images are skipped; per-image decode failures fall
  back to black images.

A decode failure of any kind (``except Exception``, as in the JAX package:
a missing PIL, PIL's decompression-bomb guard, a corrupt file) skips the
folder or falls back to a dummy image, and the log names its cause.

Samples are NHWC float32 numpy arrays. PIL is imported only inside the
decode functions (data/transforms.py).
"""
from __future__ import annotations

import glob
import logging
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from multimodal_auv_torch.config import IMAGE_SIZE
from multimodal_auv_torch.data import transforms as T

logger = logging.getLogger(__name__)

_SSS_SUFFIXES = (".png", ".jpg", ".jpeg", ".tif", ".bmp")
_PATCH_TYPE_SIZE_RE = re.compile(r"patch_(\d+m?)_")
_BATHY_PATCH_RE = re.compile(r"patch_(\d+m)_combined_bathy\.png")
_SSS_PATCH_RE = re.compile(r"patch_(\d+m)_.*_SSS\.(png|jpg)")


def resolve_patch_size(patch_type, kind: str, available) -> Optional[str]:
    """The reference's patch-type resolution (its train/multimodal.py:
    93-102), shared by the epoch loops (``select_patch``) and the packer:
    the size key to take from ``available``, or None for the
    full-resolution fallback (``patch_30_<kind>`` aliases the full
    tensor). Accepts ``patch_10m_bathy`` and the reference's bare ``10m``
    spelling."""
    if not patch_type or patch_type == f"patch_30_{kind}":
        return None
    s = str(patch_type)
    m = _PATCH_TYPE_SIZE_RE.match(s)
    if m and m.group(1) in available:
        return m.group(1)
    if s in available:
        return s
    return None


class LabelEncoder:
    """sklearn's LabelEncoder rule: classes are the sorted unique labels,
    a label's code its index among them."""

    def fit(self, labels: Sequence[str]) -> "LabelEncoder":
        self.classes_ = np.unique(np.asarray(labels))
        return self

    def fit_transform(self, labels: Sequence[str]) -> np.ndarray:
        return self.fit(labels).transform(labels)

    def transform(self, labels: Sequence[str]) -> np.ndarray:
        labels = np.asarray(labels)
        codes = np.searchsorted(self.classes_, labels)
        if len(labels) and not np.array_equal(
                self.classes_[np.minimum(codes, len(self.classes_) - 1)],
                labels):
            raise ValueError("labels not seen in fit")
        return codes

    def inverse_transform(self, codes) -> np.ndarray:
        return self.classes_[np.asarray(codes)]


class MultimodalFolderDataset:
    """Labelled multimodal dataset (training and eval)."""

    def __init__(self, root_dir: str, image_size: int = IMAGE_SIZE):
        self.image_size = image_size
        self.root_dir = root_dir
        self.data_paths: List[Dict] = []
        discovered: set = set()
        all_labels: List[str] = []
        for folder in os.listdir(root_dir):
            folder_path = os.path.join(root_dir, folder)
            if os.path.isdir(folder_path):
                item = self._scan(folder_path, discovered)
                if item is not None:
                    self.data_paths.append(item[0])
                    all_labels.append(item[1])
        if not self.data_paths:
            raise RuntimeError(
                "No valid data samples found in root_dir. "
                "Check your data paths and filters.")
        self.label_encoder = LabelEncoder().fit(all_labels)
        self.labels = self.label_encoder.transform(all_labels)
        self.all_discovered_patch_sizes = sorted(discovered)
        logger.info("Discovered patch sizes: %s",
                    self.all_discovered_patch_sizes)

    @staticmethod
    def _scan(folder_path: str, discovered: set):
        """(paths record, label) of one sample folder, or None to skip."""
        files = os.listdir(folder_path)
        mains = glob.glob(os.path.join(folder_path, "*frame*.jpg"))
        sss = [os.path.join(folder_path, f) for f in files
               if "SSS" in f and "patch_" not in f]
        labels = [f for f in files
                  if f.endswith(".txt") and not f.startswith("_")]
        bathy = os.path.join(folder_path, "combined_rgb_bathymetry.jpg")
        if not (mains and sss and labels and os.path.exists(bathy)):
            logger.debug("Skipping %s (main, SSS, label or bathy missing)",
                         folder_path)
            return None
        try:
            sss_image = max(sss, key=lambda p: T.image_nonzero_count(p, "L"))
        except Exception as e:
            logger.debug("Skipping %s (SSS): %s", folder_path, e)
            return None
        labels.sort(key=lambda x: os.path.getmtime(
            os.path.join(folder_path, x)), reverse=True)
        patch_bathy: Dict[str, str] = {}
        patch_sss: Dict[str, str] = {}
        for f in files:
            m, s = _BATHY_PATCH_RE.match(f), _SSS_PATCH_RE.match(f)
            if m:
                patch_bathy[m.group(1)] = os.path.join(folder_path, f)
                discovered.add(m.group(1))
            elif s:
                patch_sss[s.group(1)] = os.path.join(folder_path, f)
                discovered.add(s.group(1))
        if not patch_bathy and not patch_sss:
            logger.debug("Skipping %s (no patches)", folder_path)
            return None
        if not os.path.exists(os.path.join(folder_path,
                                           "normalised_meta.csv")):
            logger.debug("Skipping %s (no normalised_meta.csv)", folder_path)
            return None
        return ({"main_image": mains[0], "bathy_image": bathy,
                 "sss_image": sss_image, "patch_bathy": patch_bathy,
                 "patch_sss": patch_sss},
                os.path.splitext(labels[0])[0])

    @property
    def num_classes(self) -> int:
        return len(self.label_encoder.classes_)

    def __len__(self):
        return len(self.data_paths)

    def _patch(self, path: Optional[str], mode: str, channels: int):
        if path and os.path.exists(path):
            try:
                return T.load_image(path, mode, (self.image_size,) * 2)
            except Exception as e:
                logger.warning("Error loading patch %s: %s; dummy used",
                               path, e)
        return T.zeros(channels, self.image_size)

    def __getitem__(self, idx: int) -> Dict:
        paths = self.data_paths[idx]
        sz = (self.image_size, self.image_size)
        sample = {
            "main_image": T.load_main_image(paths["main_image"], sz),
            "bathy_image": T.load_image(paths["bathy_image"], "RGB", sz),
            "sss_image": T.load_image(paths["sss_image"], "L", sz),
            "label": np.int32(self.labels[idx]),
        }
        sizes = self.all_discovered_patch_sizes
        sample["patch_bathy"] = {
            s: self._patch(paths["patch_bathy"].get(s), "RGB", 3)
            for s in sizes}
        sample["patch_sss"] = {
            s: self._patch(paths["patch_sss"].get(s), "L", 1) for s in sizes}
        return sample


class InferenceFolderDataset:
    """Unlabeled inference dataset."""

    def __init__(self, root_dir: str, image_size: int = IMAGE_SIZE):
        self.image_size = image_size
        self.root_dir = root_dir
        self.data: List[Dict[str, str]] = []
        self._load_data()

    def _find_main_image(self, folder_path: str) -> Optional[str]:
        matches = glob.glob(os.path.join(folder_path, "[fF]rame*.jpg"))
        return matches[0] if matches else None

    def _find_sss_image(self, folder_path: str) -> Optional[str]:
        candidates = [
            os.path.join(folder_path, f) for f in os.listdir(folder_path)
            if "SSS" in f and f.lower().endswith(_SSS_SUFFIXES)
            and "patch_" not in f
        ]
        selected, max_nonzero = None, -1
        for p in candidates:
            try:
                n = T.image_nonzero_count(p, "L")
            except Exception as e:
                logger.warning("Error loading SSS image %s: %s", p, e)
                continue
            if n > max_nonzero:
                max_nonzero, selected = n, p
        return selected

    def _find_bathy_image(self, folder_path: str) -> Optional[str]:
        for name in ("patch_30m_combined_bathy.png", "combined_bathy.jpg"):
            p = os.path.join(folder_path, name)
            if os.path.exists(p):
                return p
        logger.debug("Missing bathy data in %s", folder_path)
        return None

    def _load_data(self) -> None:
        processed, loaded = 0, 0
        for folder in os.listdir(self.root_dir):
            folder_path = os.path.join(self.root_dir, folder)
            if not os.path.isdir(folder_path):
                continue
            processed += 1
            main = self._find_main_image(folder_path)
            sss = self._find_sss_image(folder_path)
            bathy = self._find_bathy_image(folder_path)
            if main is None or sss is None or bathy is None:
                continue
            paths = [main, sss, bathy]
            if not all(os.path.exists(p) for p in paths):
                continue
            valid = True
            for p in paths:
                try:
                    if T.image_sum(p) == 0:
                        valid = False
                        break
                except Exception as e:
                    logger.warning("Error reading image %s: %s", p, e)
                    valid = False
                    break
            if not valid:
                continue
            self.data.append({"main_image": main, "bathy_image": bathy,
                              "sss_image": sss})
            loaded += 1
        logger.info("Total folders successfully loaded: %d / processed: %d",
                    loaded, processed)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, str]:
        item = self.data[idx]
        name = os.path.basename(item.get("main_image", ""))
        sz = (self.image_size, self.image_size)

        def load(key, path, mode, channels):
            try:
                if key == "main_image":
                    return T.load_main_image(path, sz)
                return T.load_image(path, mode, sz)
            except Exception as e:
                logger.warning("Error loading %s for %s: %s; black image used",
                               path, key, e)
                # a black image through the standard transform, so the
                # fallback equals the packed cache's normalised uint8 zeros
                z = T.zeros(channels, self.image_size)
                return T.normalize_optical(z) if key == "main_image" else z

        main = load("main_image", item["main_image"], "RGB", 3)
        bathy = load("bathy_image", item["bathy_image"], "RGB", 3)
        sss = load("sss_image", item["sss_image"], "L", 1)
        return main, bathy, sss, name


class ConcatDataset:
    """Minimal ConcatDataset over InferenceFolderDatasets."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx: int):
        if idx < 0:
            idx += len(self)
        if not 0 <= idx < len(self):
            raise IndexError(f"index {idx} out of range for "
                             f"ConcatDataset of length {len(self)}")
        ds = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[ds][idx - int(self._offsets[ds])]

    @property
    def data(self):
        """Chained per-sample path records (for data/packing.py)."""
        out = []
        for d in self.datasets:
            out.extend(getattr(d, "data", []))
        return out
