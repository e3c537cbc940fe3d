"""Inference folder dataset (port of the inference half of
``multimodal_auv_tpu/data/datasets.py``).

``InferenceFolderDataset`` follows the reference's scan rules: per sample
folder, main = ``[fF]rame*.jpg``, bathy = ``patch_30m_combined_bathy.png``
or ``combined_bathy.jpg``, SSS = the non-patch ``*SSS*`` image with the most
nonzero pixels; folders with missing or all-black images are skipped;
per-image decode failures fall back to black images. Samples are NHWC
float32 numpy arrays.
"""
from __future__ import annotations

import glob
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from multimodal_auv_torch.config import IMAGE_SIZE
from multimodal_auv_torch.data import transforms as T

logger = logging.getLogger(__name__)

_SSS_SUFFIXES = (".png", ".jpg", ".jpeg", ".tif", ".bmp")


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
            except (OSError, ValueError) as e:
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
                except (OSError, ValueError) as e:
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
            except (OSError, ValueError) as e:
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
