"""Inference dataset packing: decode once, feed forever (port of the
inference half of ``multimodal_auv_tpu/data/packing.py``).

``pack_inference_dataset`` decodes an InferenceFolderDataset once (threaded)
into uint8 arrays (N, S, S, C) — ``main.npy``, ``bathy.npy``, ``sss.npy`` —
plus ``names.json`` and ``pack_meta.json``; ``PackedBatches`` then serves
uint8 batches whose normalisation runs on the device (ops/preprocess.py).
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from multimodal_auv_torch.config import IMAGE_SIZE

logger = logging.getLogger(__name__)


def _hash_paths(h, paths) -> None:
    """Fold path|mtime_ns|size (or path|missing) of each path into ``h``."""
    for p in paths:
        try:
            st = os.stat(p)
            h.update(f"{p}|{st.st_mtime_ns}|{st.st_size};".encode())
        except OSError:
            h.update(f"{p}|missing;".encode())


def inference_fingerprint(dataset) -> str:
    """sha1 over every referenced path + mtime/size in sample order: a
    cache with another fingerprint was packed from other files."""
    h = hashlib.sha1()
    for it in dataset.data:
        _hash_paths(h, (it["main_image"], it["bathy_image"], it["sss_image"]))
    return h.hexdigest()


def _decode_or_zeros(path: Optional[str], mode: str, size: int) -> np.ndarray:
    """Decode one image, or the uint8 black image the unpacked dataset's
    fallbacks feed (missing path, unreadable file)."""
    from multimodal_auv_torch.data.transforms import load_image_u8

    channels = 3 if mode == "RGB" else 1
    if path is None:
        return np.zeros((size, size, channels), np.uint8)
    try:
        return load_image_u8(path, mode, (size, size))
    except (OSError, ValueError) as e:
        logger.warning("Error decoding %s: %s; zeros dummy used", path, e)
        return np.zeros((size, size, channels), np.uint8)


def pack_inference_dataset(dataset, out_dir: str, size: int = IMAGE_SIZE,
                           workers: Optional[int] = None) -> Dict[str, object]:
    """Pack an InferenceFolderDataset into {main,bathy,sss}.npy + names."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(dataset)
    arrays = {
        key: np.lib.format.open_memmap(
            os.path.join(out_dir, f"{key}.npy"), mode="w+", dtype=np.uint8,
            shape=(n, size, size, c))
        for key, c in (("main", 3), ("bathy", 3), ("sss", 1))
    }
    items = [dataset.data[i] for i in range(n)]

    def work(i):
        it = items[i]
        arrays["main"][i] = _decode_or_zeros(it["main_image"], "RGB", size)
        arrays["bathy"][i] = _decode_or_zeros(it["bathy_image"], "RGB", size)
        arrays["sss"][i] = _decode_or_zeros(it["sss_image"], "L", size)
        return os.path.basename(it["main_image"])

    workers = workers or max((os.cpu_count() or 2) - 2, 1)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        names = list(pool.map(work, range(n)))
    with open(os.path.join(out_dir, "names.json"), "w") as f:
        json.dump(names, f)
    with open(os.path.join(out_dir, "pack_meta.json"), "w") as f:
        json.dump({"size": size,
                   "fingerprint": inference_fingerprint(dataset)}, f)
    for a in arrays.values():
        a.flush()
    logger.info("Packed %d samples into %s", n, out_dir)
    return {**arrays, "names": names}


def load_packed(out_dir: str) -> Dict[str, object]:
    with open(os.path.join(out_dir, "names.json")) as f:
        names = json.load(f)
    return {
        "main": np.load(os.path.join(out_dir, "main.npy"), mmap_mode="r"),
        "bathy": np.load(os.path.join(out_dir, "bathy.npy"), mmap_mode="r"),
        "sss": np.load(os.path.join(out_dir, "sss.npy"), mmap_mode="r"),
        "names": names,
    }


class PackedBatches:
    """Iterate uint8 batches (main, bathy, sss, names) from packed arrays.
    The final batch is ragged: consumers pad it and mask the pad
    (engine/predict.py does)."""

    def __init__(self, packed: Dict[str, object], batch_size: int):
        self.packed = packed
        self.batch_size = batch_size
        self.n = packed["main"].shape[0]

    def __len__(self):
        return -(-self.n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                         list]]:
        bs = self.batch_size
        for i in range(0, self.n, bs):
            sl = slice(i, min(i + bs, self.n))
            yield (np.asarray(self.packed["main"][sl]),
                   np.asarray(self.packed["bathy"][sl]),
                   np.asarray(self.packed["sss"][sl]),
                   list(self.packed["names"][sl]))
