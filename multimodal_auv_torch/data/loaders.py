"""Inference data loader (port of the inference half of
``multimodal_auv_tpu/data/loaders.py``): a non-shuffling loader that decodes
samples in a thread pool and prefetches collated numpy batches while the
device runs the previous one.
"""
from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, List, Optional, Sequence

import numpy as np

from multimodal_auv_torch.data.datasets import ConcatDataset, InferenceFolderDataset

_PREFETCH = 4  # collated batches queued ahead of the consumer


def _collate(samples: List[Any]):
    """Stack a list of samples (tuples, arrays, strings)."""
    first = samples[0]
    if isinstance(first, tuple):
        return tuple(_collate([s[i] for s in samples])
                     for i in range(len(first)))
    if isinstance(first, str):
        return list(samples)
    return np.stack([np.asarray(s) for s in samples])


class DataLoader:
    """Iterable over collated numpy batches in dataset order, with threaded
    decode and a bounded prefetch queue (``num_workers=0``: inline)."""

    def __init__(self, dataset, batch_size: int,
                 num_workers: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        if num_workers is None:
            num_workers = max((os.cpu_count() or 2) - 2, 0)
        self.num_workers = num_workers

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def _batches(self) -> List[List[int]]:
        n, bs = len(self.dataset), self.batch_size
        return [list(range(i, min(i + bs, n))) for i in range(0, n, bs)]

    def __iter__(self) -> Iterator:
        batches = self._batches()
        if self.num_workers == 0:
            for b in batches:
                yield _collate([self.dataset[i] for i in b])
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
                        samples = list(pool.map(self.dataset.__getitem__, b))
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
