"""Dataset packing: decode once, feed forever (port of
``multimodal_auv_tpu/data/packing.py``).

``pack_inference_dataset`` decodes an InferenceFolderDataset once (threaded)
into uint8 arrays (N, S, S, C) — ``main.npy``, ``bathy.npy``, ``sss.npy`` —
plus ``names.json`` and ``pack_meta.json``; ``PackedBatches`` then serves
uint8 batches whose normalisation runs on the device (ops/preprocess.py).

``pack_training_dataset`` does the same for a MultimodalFolderDataset at a
fixed patch-type pair, with ``labels.npy`` and ``meta.json``;
``PackedTrainBatches`` serves its (shuffled) epochs as uint8 dict batches.
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
    fallbacks feed (missing path, a file that fails to decode for any
    reason, as in the JAX package: one bad file is a logged zeros image,
    never the end of the pack)."""
    from multimodal_auv_torch.data.transforms import load_image_u8

    channels = 3 if mode == "RGB" else 1
    if path is None:
        return np.zeros((size, size, channels), np.uint8)
    try:
        return load_image_u8(path, mode, (size, size))
    except Exception as e:
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


def dataset_fingerprint(dataset) -> str:
    """sha1 over every path a MultimodalFolderDataset references (with
    mtime and size) and its encoded labels: a packed training cache with
    another fingerprint was built from other data and must be repacked."""
    h = hashlib.sha1()
    for it in dataset.data_paths:
        paths = [it["main_image"], it["bathy_image"], it["sss_image"]]
        for d in (it.get("patch_bathy") or {}, it.get("patch_sss") or {}):
            paths.extend(d[k] for k in sorted(d))
        _hash_paths(h, paths)
    h.update(np.asarray(dataset.labels, np.int64).tobytes())
    return h.hexdigest()


def _select_patch_path(item: Dict, patch_type: Optional[str], kind: str,
                       discovered) -> Optional[str]:
    """Path-level twin of engine/loops.py::select_patch: both resolve the
    patch type with ``resolve_patch_size`` against the dataset-wide
    discovered sizes, so the pack selects the files the unpacked loader
    feeds. None when this item has no file of the resolved size (the
    unpacked path feeds zeros there, and so does the pack)."""
    from multimodal_auv_torch.data.datasets import resolve_patch_size

    full = item["bathy_image"] if kind == "bathy" else item["sss_image"]
    size = resolve_patch_size(patch_type, kind, discovered)
    if size is None:
        return full
    return (item.get(f"patch_{kind}") or {}).get(size)


def pack_training_dataset(dataset, out_dir: str,
                          bathy_patch_type: Optional[str] = None,
                          sss_patch_type: Optional[str] = None,
                          size: int = IMAGE_SIZE,
                          workers: Optional[int] = None) -> Dict[str, object]:
    """Pack a MultimodalFolderDataset for a fixed patch-type pair into
    uint8 memmaps + int labels, so training epochs after the first cost
    memory bandwidth instead of a decode per sample."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(dataset)
    arrays = {
        key: np.lib.format.open_memmap(
            os.path.join(out_dir, f"{key}.npy"), mode="w+", dtype=np.uint8,
            shape=(n, size, size, c))
        for key, c in (("main", 3), ("bathy", 3), ("sss", 1))
    }
    items = [dataset.data_paths[i] for i in range(n)]
    discovered = getattr(dataset, "all_discovered_patch_sizes", ())

    def work(i):
        it = items[i]
        arrays["main"][i] = _decode_or_zeros(it["main_image"], "RGB", size)
        arrays["bathy"][i] = _decode_or_zeros(
            _select_patch_path(it, bathy_patch_type, "bathy", discovered),
            "RGB", size)
        arrays["sss"][i] = _decode_or_zeros(
            _select_patch_path(it, sss_patch_type, "sss", discovered),
            "L", size)

    workers = workers or max((os.cpu_count() or 2) - 2, 1)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(work, range(n)))
    np.save(os.path.join(out_dir, "labels.npy"),
            np.asarray(dataset.labels, np.int32))
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"bathy_patch_type": bathy_patch_type,
                   "sss_patch_type": sss_patch_type,
                   "classes": [str(c) for c in dataset.label_encoder.classes_],
                   "fingerprint": dataset_fingerprint(dataset)}, f)
    for a in arrays.values():
        a.flush()
    logger.info("Packed %d training samples into %s", n, out_dir)
    return load_packed_training(out_dir)


def load_packed_training(out_dir: str) -> Dict[str, object]:
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    return {
        "main": np.load(os.path.join(out_dir, "main.npy"), mmap_mode="r"),
        "bathy": np.load(os.path.join(out_dir, "bathy.npy"), mmap_mode="r"),
        "sss": np.load(os.path.join(out_dir, "sss.npy"), mmap_mode="r"),
        "labels": np.load(os.path.join(out_dir, "labels.npy")),
        "meta": meta,
    }


class PackedTrainBatches:
    """Epoch iterator over a packed training set (optionally a subset of
    indices, for the 80/20 split). Yields dict batches in the epoch loops'
    schema with uint8 images, for steps built with ``packed_inputs=True``.
    ``shuffle`` permutes the indices with ``np.random.default_rng(seed +
    epoch)``; rows within a batch are read in sorted order."""

    def __init__(self, packed: Dict[str, object], batch_size: int,
                 indices=None, shuffle: bool = False, seed: int = 0):
        self.packed = packed
        self.batch_size = batch_size
        self.indices = np.asarray(
            indices if indices is not None
            else np.arange(packed["main"].shape[0]))
        self.shuffle = shuffle
        self._epoch = 0
        self._seed = seed

    def __len__(self):
        return -(-len(self.indices) // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle epoch to an absolute index (as
        DataLoader.set_epoch)."""
        self._epoch = int(epoch)

    def __iter__(self):
        idx = self.indices
        if self.shuffle:
            idx = np.random.default_rng(self._seed + self._epoch).permutation(
                idx)
            self._epoch += 1
        for i in range(0, len(idx), self.batch_size):
            yield self._materialize(np.sort(idx[i:i + self.batch_size]))

    def _materialize(self, take: np.ndarray) -> Dict[str, np.ndarray]:
        """The batch of the packed rows ``take``."""
        return {
            "main_image": np.asarray(self.packed["main"][take]),
            "bathy_image": np.asarray(self.packed["bathy"][take]),
            "sss_image": np.asarray(self.packed["sss"][take]),
            "label": np.asarray(self.packed["labels"][take], np.int32),
        }


class HostShardPackedBatches(PackedTrainBatches):
    """Multi-process packed feeding, the twin of ``data/loaders.py::
    HostShardLoader``: every data rank iterates the SAME seeded global
    batch order but reads ONLY its contiguous rows [pi * B / P, (pi + 1) *
    B / P) of each global batch from the memmaps. Batches stay
    GLOBAL-shaped: the other ranks' image rows are zeros, the labels are
    all filled (from the in-memory labels array), and the mesh's step
    wrappers take this rank's rows back out."""

    def __init__(self, packed: Dict[str, object], batch_size: int,
                 indices=None, shuffle: bool = False, seed: int = 0, *,
                 process_index: int, process_count: int):
        super().__init__(packed, batch_size, indices, shuffle, seed)
        if batch_size % process_count:
            raise ValueError(
                f"batch_size ({batch_size}) must be divisible by the data "
                f"axis ({process_count}): every rank feeds an equal slice "
                f"of each global batch")
        self.process_index, self.process_count = process_index, process_count
        self.rows_per_host = batch_size // process_count

    @classmethod
    def from_batches(cls, b: PackedTrainBatches, process_index: int,
                     process_count: int) -> "HostShardPackedBatches":
        out = cls(b.packed, b.batch_size, b.indices, shuffle=b.shuffle,
                  seed=b._seed, process_index=process_index,
                  process_count=process_count)
        out._epoch = b._epoch
        return out

    def _materialize(self, take: np.ndarray) -> Dict[str, np.ndarray]:
        n = len(take)
        lo = self.process_index * self.rows_per_host
        hi = min(lo + self.rows_per_host, n)
        own = take[lo:hi] if lo < n else take[:0]
        batch = {}
        for out_key, in_key in (("main_image", "main"),
                                ("bathy_image", "bathy"),
                                ("sss_image", "sss")):
            mm = self.packed[in_key]
            arr = np.zeros((n,) + tuple(mm.shape[1:]), mm.dtype)
            if len(own):
                arr[lo:hi] = mm[own]
            batch[out_key] = arr
        batch["label"] = np.asarray(self.packed["labels"][take], np.int32)
        return batch


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
