"""Data loaders and the train/test split (port of
``multimodal_auv_tpu/data/loaders.py``): a loader that decodes samples in a
thread pool and prefetches collated numpy batches while the device runs
the previous one, optionally shuffling per epoch.

The split is the reference's: sklearn's ``train_test_split`` over indices
with test_size=0.2, random_state=42 (its data/loaders.py:12-17), here
computed without sklearn by the same rule.
"""
from __future__ import annotations

import logging
import math
import os
import queue
import threading
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, List, Optional, Sequence

import numpy as np

from multimodal_auv_torch.config import IMAGE_SIZE
from multimodal_auv_torch.parallel.distributed import barrier, is_coordinator
from multimodal_auv_torch.data.datasets import (
    ConcatDataset,
    InferenceFolderDataset,
    MultimodalFolderDataset,
)

logger = logging.getLogger(__name__)

_PREFETCH = 4  # collated batches queued ahead of the consumer


class Subset:
    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]

    # index-dependent attributes are re-indexed to the subset: delegating
    # them would return all-N records for an n-row split
    _REINDEXED = ("labels", "data", "data_paths")

    def __getattr__(self, name):
        if name.startswith("__") or "dataset" not in self.__dict__:
            raise AttributeError(name)
        if name in self._REINDEXED:
            full = getattr(self.dataset, name)
            return [full[i] for i in self.indices]
        return getattr(self.dataset, name)


def split_indices(n: int, test_size: float = 0.2, random_state: int = 42):
    """The train/test index split, as sklearn's ``train_test_split(
    list(range(n)), test_size, random_state)`` computes it: a
    ``RandomState(random_state)`` permutation, the first ceil(test_size * n)
    indices for test, the rest for train. The packed and unpacked training
    paths share this one helper, so neither trains on the other's test
    samples."""
    perm = np.random.RandomState(random_state).permutation(n)
    n_test = math.ceil(test_size * n)
    return perm[n_test:].tolist(), perm[:n_test].tolist()


def split_dataset(dataset, test_size: float = 0.2, random_state: int = 42):
    train_idx, test_idx = split_indices(len(dataset), test_size, random_state)
    return Subset(dataset, train_idx), Subset(dataset, test_idx)


def _collate(samples: List[Any]):
    """Stack a list of samples (dicts, tuples, arrays, scalars, strings)."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: _collate([s[k] for s in samples]) for k in first}
    if isinstance(first, tuple):
        return tuple(_collate([s[i] for s in samples])
                     for i in range(len(first)))
    if isinstance(first, str):
        return list(samples)
    return np.stack([np.asarray(s) for s in samples])


class DataLoader:
    """Iterable over collated numpy batches, with threaded decode and a
    bounded prefetch queue (``num_workers=0``: inline). ``shuffle``
    permutes the samples with ``np.random.default_rng(seed + epoch)``."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: Optional[int] = None, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        if num_workers is None:
            num_workers = max((os.cpu_count() or 2) - 2, 0)
        self.num_workers = num_workers

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle epoch to an absolute index (the epoch loops do,
        so a resumed run replays an uninterrupted run's sample order);
        standalone iteration counts epochs itself."""
        self._epoch = int(epoch)

    def _batches(self) -> List[List[int]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        return [idx[i:i + self.batch_size].tolist()
                for i in range(0, len(idx), self.batch_size)]

    def __iter__(self) -> Iterator:
        batches = self._batches()
        self._epoch += 1
        if self.num_workers == 0:
            for b in batches:
                yield _collate(self._load_samples(b, map))
            return

        q: "queue.Queue" = queue.Queue(maxsize=_PREFETCH)
        stop = threading.Event()

        def put(item) -> bool:
            # a plain put could block forever once the consumer stops
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                for b in batches:
                    if stop.is_set():
                        return
                    try:
                        samples = self._load_samples(b, pool.map)
                    except Exception as e:  # handed to the consumer, raised there
                        put(e)
                        return
                    if not put(_collate(samples)):
                        return
            put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=10)


    def _load_samples(self, b: List[int], mapper) -> List[Any]:
        """The samples of batch ``b``, decoded through ``mapper`` (``map``,
        or the worker pool's)."""
        return list(mapper(self.dataset.__getitem__, b))


class HostShardLoader(DataLoader):
    """Multi-process feeding, torch's DistributedSampler's analogue (port
    of the JAX package's ``HostShardLoader``): every data rank iterates
    the SAME global index order (same seed, same pinned epoch), but
    decodes ONLY its contiguous rows [pi * B / P, (pi + 1) * B / P) of each
    global batch. Batches stay GLOBAL-shaped: the rows of other ranks are
    zero-filled placeholders with their true labels (read from
    ``dataset.labels``, no decode), so the eval ledgers see every label.
    The mesh's step wrappers take this rank's rows back out; placeholder
    rows never reach a step. ``process_index`` / ``process_count``: the
    data rank and the data axis size (the mc ranks of one data rank read
    the same rows)."""

    def __init__(self, dataset, batch_size: int, *, process_index: int,
                 process_count: int, **kw):
        super().__init__(dataset, batch_size, **kw)
        if batch_size % process_count:
            raise ValueError(
                f"batch_size ({batch_size}) must be divisible by the data "
                f"axis ({process_count}): every rank feeds an equal slice "
                f"of each global batch")
        self.process_index, self.process_count = process_index, process_count
        self.rows_per_host = batch_size // process_count
        self._zero_template = None

    @classmethod
    def from_loader(cls, loader: DataLoader, process_index: int,
                    process_count: int) -> "HostShardLoader":
        out = cls(loader.dataset, loader.batch_size, shuffle=loader.shuffle,
                  num_workers=loader.num_workers, seed=loader.seed,
                  process_index=process_index, process_count=process_count)
        out._epoch = loader._epoch
        return out

    def _placeholder(self, label) -> Any:
        if self._zero_template is None:
            self._zero_template = _zeros_like_sample(self.dataset[0])
        out = dict(self._zero_template)  # nested arrays shared, read-only
        out["label"] = np.int32(label)
        return out

    def _load_samples(self, b: List[int], mapper) -> List[Any]:
        lo = self.process_index * self.rows_per_host
        hi = min(lo + self.rows_per_host, len(b))
        owned = (list(mapper(self.dataset.__getitem__, b[lo:hi]))
                 if lo < len(b) else [])
        labels = getattr(self.dataset, "labels", None)
        return [owned[j - lo] if lo <= j < hi
                else self._placeholder(labels[i] if labels is not None
                                       else 0)
                for j, i in enumerate(b)]


def _zeros_like_sample(sample):
    if isinstance(sample, dict):
        return {k: _zeros_like_sample(v) for k, v in sample.items()}
    if isinstance(sample, (list, tuple)):
        return type(sample)(_zeros_like_sample(v) for v in sample)
    if isinstance(sample, (str, bytes)) or sample is None:
        return sample
    return np.zeros_like(np.asarray(sample))


def prepare_datasets_and_loaders(
    root_dir: str,
    batch_size_unimodal: int = 8,
    batch_size_multimodal: int = 12,
    num_workers: Optional[int] = None,
    image_size: Optional[int] = None,
):
    """The reference's loaders (its data/loaders.py:19-60): the labelled
    dataset, its class histogram logged, split 80/20, and 4 loaders
    (unimodal/multimodal x train/test), num_classes, and the dataset."""
    kw = {"image_size": image_size} if image_size else {}
    dataset = MultimodalFolderDataset(root_dir, **kw)
    counts = Counter(dataset.label_encoder.inverse_transform(dataset.labels))
    logger.info("Class histogram: %s", dict(counts))
    train_ds, test_ds = split_dataset(dataset)
    loaders = [DataLoader(ds, bs, shuffle=shuffle, num_workers=num_workers)
               for bs in (batch_size_unimodal, batch_size_multimodal)
               for ds, shuffle in ((train_ds, True), (test_ds, False))]
    return (*loaders, dataset.num_classes, dataset)


def prepare_packed_train_loaders(
    root_dir: str,
    batch_size: int,
    bathy_patch_type: Optional[str] = None,
    sss_patch_type: Optional[str] = None,
    cache_dir: Optional[str] = None,
    seed: int = 0,
    image_size: Optional[int] = None,
):
    """Decode-once training loaders: pack the labelled dataset for a fixed
    patch-type pair (data/packing.py) and serve uint8 dict batches from
    memmaps, with the same 80/20 split as ``prepare_datasets_and_loaders``.
    Pair with steps built with ``packed_inputs=True``. A cache packed from
    other files is repacked. Under a process group rank 0 writes the cache
    and every rank reads it after a barrier. Returns (train_batches, test_batches,
    num_classes, dataset)."""
    from multimodal_auv_torch.data.packing import (
        PackedTrainBatches,
        dataset_fingerprint,
        load_packed_training,
        pack_training_dataset,
    )

    kw = {"image_size": image_size} if image_size else {}
    dataset = MultimodalFolderDataset(root_dir, **kw)
    counts = Counter(dataset.label_encoder.inverse_transform(dataset.labels))
    logger.info("Class histogram: %s", dict(counts))
    sz = image_size or IMAGE_SIZE
    out = os.path.join(
        cache_dir or os.path.join(root_dir, ".packed_train_cache"),
        f"{bathy_patch_type or 'full'}_{sss_patch_type or 'full'}_{sz}")
    if is_coordinator():
        # rank 0 writes the cache; the others read it after the barrier
        if not os.path.exists(os.path.join(out, "meta.json")):
            pack_training_dataset(dataset, out, bathy_patch_type,
                                  sss_patch_type, size=sz)
        packed = load_packed_training(out)
        if (packed["main"].shape[0] != len(dataset)
                or packed["meta"].get("fingerprint") != dataset_fingerprint(
                    dataset)):
            logger.warning("Stale packed cache %s (content mismatch); "
                           "repacking", out)
            pack_training_dataset(dataset, out, bathy_patch_type,
                                  sss_patch_type, size=sz)
    barrier()
    packed = load_packed_training(out)
    train_idx, test_idx = split_indices(len(dataset))
    train = PackedTrainBatches(packed, batch_size, train_idx, shuffle=True,
                               seed=seed)
    test = PackedTrainBatches(packed, batch_size, test_idx)
    return train, test, dataset.num_classes, dataset


def prepare_inference_datasets_and_loaders(
        dirs: Sequence[str], batch_size: int = 4,
        num_workers: Optional[int] = None,
        image_size: Optional[int] = None) -> DataLoader:
    """Concat N inference dirs into one loader, in order."""
    kw = {"image_size": image_size} if image_size else {}
    datasets = [InferenceFolderDataset(d, **kw) for d in dirs]
    ds = datasets[0] if len(datasets) == 1 else ConcatDataset(datasets)
    return DataLoader(ds, batch_size, num_workers=num_workers)


def prepare_inference_dataloader(data_directory: str, batch_size: int = 4,
                                 num_workers: Optional[int] = None,
                                 image_size: Optional[int] = None) -> DataLoader:
    """Single-directory variant."""
    return prepare_inference_datasets_and_loaders(
        [data_directory], batch_size, num_workers, image_size=image_size)
