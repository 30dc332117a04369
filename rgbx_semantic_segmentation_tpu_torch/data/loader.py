"""Threaded host data pipeline (the port's counterpart of
rgbx_semantic_segmentation_tpu/data/loader.py).

Replaces the reference's torch DataLoader + DistributedSampler
(dataloader.py:129-166): worker threads run the augmentation pipeline (the
native C++ image ops release the GIL) and a bounded queue overlaps host
preprocessing with the device step.

Epoch length oversampling (batch_size * niters_per_epoch) matches the reference's
train_dataset construction (dataloader.py:147).

For a given (seed, epoch) the batches are those of the JAX TrainLoader, bit
for bit, whatever the number of workers: the batch order is keyed by (seed,
epoch), each sample's augmentation by (epoch, index), and the workers'
batches are handed over in batch order. Two differences from the JAX
loader: a consumer that stops early (closes the generator) stops and joins
the workers, and a worker's exception is raised in the consumer. Batches
are uint8 torch tensors (normalised on the device by the train step), in
pinned memory when a card is present, so that the step's non_blocking copy
to the card is asynchronous.

In a data-parallel run (`rank`, `world`) each rank loads only its rows of
the same global batches (parallel/multihost.process_batch_slice): the
ranks' batches, concatenated in rank order, are the one-process batch.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from rgbx_semantic_segmentation_tpu_torch.config import Config
from rgbx_semantic_segmentation_tpu_torch.data.dataset import RGBXDataset
from rgbx_semantic_segmentation_tpu_torch.data.preprocess import (
    TrainPre, ValPre)
from rgbx_semantic_segmentation_tpu_torch.native import cv_ops as native_ops
from rgbx_semantic_segmentation_tpu_torch.parallel.multihost import (
    process_batch_slice)

_KEYS = ("rgb", "modal_x", "label")


def _collate(samples, pin_memory: bool = False) -> Dict[str, torch.Tensor]:
    """Stack the samples' arrays into tensors; with pin_memory the stack is
    written straight into page-locked memory (no second copy)."""
    out = {}
    for key in _KEYS:
        arrs = [s[key] for s in samples]
        if not pin_memory:
            out[key] = torch.from_numpy(np.stack(arrs))
            continue
        t = torch.empty((len(arrs),) + arrs[0].shape,
                        dtype=torch.from_numpy(arrs[0]).dtype, pin_memory=True)
        np.stack(arrs, out=t.numpy())
        out[key] = t
    return out


class TrainLoader:
    """Shuffled, drop-last batch iterator with threaded prefetch; with
    `rank` and `world`, rank `rank`'s rows of each global batch.

    `ops` are the augmentation's image ops: the native library by default
    (built here, at construction: a failed build raises with the compiler's
    message), or data.cv_ops for the numpy versions. `pin_memory` defaults
    to whether a CUDA device is present: the port's entry points train on
    the card unless asked otherwise."""

    def __init__(self, cfg: Config, root: Optional[str] = None,
                 num_workers: Optional[int] = None, seed: Optional[int] = None,
                 prefetch: int = 4, ops=native_ops,
                 pin_memory: Optional[bool] = None, rank: int = 0,
                 world: int = 1):
        self.cfg = cfg
        # This rank's rows of every global batch (raises unless it divides).
        self.rows = process_batch_slice(cfg.train.batch_size, rank, world)
        seed = cfg.train.seed if seed is None else seed
        self.seed = seed
        if ops is native_ops:
            native_ops.lib()
        pre = TrainPre(
            norm_mean=cfg.dataset.norm_mean, norm_std=cfg.dataset.norm_std,
            image_hw=(cfg.dataset.image_height, cfg.dataset.image_width),
            num_classes=cfg.dataset.num_classes,
            background=cfg.dataset.background,
            train_scale_array=cfg.train.train_scale_array,
            rng=np.random.RandomState(seed + 1), normalize=False, ops=ops)
        file_length = cfg.train.batch_size * cfg.train.niters_per_epoch
        self.dataset = RGBXDataset(cfg.dataset, "train", pre,
                                   file_length=file_length, root=root)
        self.batch_size = cfg.train.batch_size
        self.num_workers = (num_workers if num_workers is not None
                            else min(cfg.train.num_workers, 8))
        self.prefetch = prefetch
        self.pin_memory = (torch.cuda.is_available() if pin_memory is None
                           else pin_memory)
        self.niters = len(self.dataset) // self.batch_size

    def _batch(self, idxs) -> Dict[str, torch.Tensor]:
        return _collate([self.dataset[i] for i in idxs], self.pin_memory)

    def epoch(self, epoch: int) -> Iterator[Dict[str, torch.Tensor]]:
        """Yield `niters` batches for one epoch. Close the generator (or let
        it be collected) to stop early: the workers stop and are joined."""
        self.dataset.set_epoch(epoch)
        # Deterministic per-(seed, epoch) batch order: the config seed folds in
        # so two runs with different seeds see different batch orders, like the
        # reference's set_epoch'd DistributedSampler (dataloader.py:153-156).
        order = np.random.RandomState(
            (999983 * (epoch + 1) + self.seed) % (2 ** 31)).permutation(
            len(self.dataset))
        n_batches = self.niters
        idx_batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                       [self.rows] for i in range(n_batches)]

        if self.num_workers <= 0:
            for idxs in idx_batches:
                yield self._batch(idxs)
            return

        stop = threading.Event()
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        task_q: "queue.Queue" = queue.Queue()
        for bi, idxs in enumerate(idx_batches):
            task_q.put((bi, idxs))

        def worker():
            while not stop.is_set():
                try:
                    bi, idxs = task_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    item = (bi, self._batch(idxs), None)
                except Exception as e:  # handed to the consumer, raised there
                    item = (bi, None, e)
                # A bounded wait, so a stop is seen while the queue is full.
                while not stop.is_set():
                    try:
                        out_q.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        pass

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        results = {}
        try:
            next_bi = 0
            while next_bi < n_batches:
                bi, batch, err = out_q.get()
                if err is not None:
                    raise err
                results[bi] = batch
                while next_bi in results:
                    yield results.pop(next_bi)
                    next_bi += 1
        finally:
            stop.set()
            for t in threads:
                t.join()

    def __iter__(self):
        epoch = 0
        while True:
            yield from self.epoch(epoch)
            epoch += 1


class ValLoader:
    """Sequential eval iterator yielding single samples; raw (unnormalised)
    images unless `preprocess`."""

    def __init__(self, cfg: Config, root: Optional[str] = None,
                 preprocess: bool = False):
        pre = None
        if preprocess:
            pre = ValPre(cfg.dataset.norm_mean, cfg.dataset.norm_std,
                         (cfg.dataset.image_height, cfg.dataset.image_width))
        self.dataset = RGBXDataset(cfg.dataset, "val", pre, root=root)

    def __len__(self):
        return len(self.dataset)

    def __iter__(self):
        for i in range(len(self.dataset)):
            yield self.dataset[i]
