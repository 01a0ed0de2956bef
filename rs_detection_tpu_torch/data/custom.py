"""Labelled tile dataset (counterpart of ``rs_detection_tpu/data/
custom.py:CustomDataset``): the mmdet-style ``labels.pkl`` (a list of
{filename, width, height, ann: {bboxes [n, 5] rotated boxes, labels,
bboxes_ignore}}), hboxes and polygons derived from the rotated boxes at
load, empty tiles filtered out or resampled, the transform pipeline, and
batches of dense arrays (``collate_batch``) in a seeded order, decoded
on a thread pool and prefetched by a background thread."""

from __future__ import annotations

import os
import pickle
import queue
import threading
from typing import Iterator, List, Optional

import numpy as np

from ..ops.box_ops import rotated_box_to_bbox_np
from ..utils.registry import DATASETS
from .collate import collate_batch
from .io import load_rgb
from .transforms import Compose, np_random, own_draws


@DATASETS.register_module()
class CustomDataset:
    CLASSES: Optional[List[str]] = None

    def __init__(self, images_dir=None, annotations_file=None,
                 dataset_dir=None, transforms=None, batch_size=1,
                 num_workers=0, shuffle=False, drop_last=False,
                 filter_empty_gt=True, filter_min_size=-1, max_gt=512):
        """``dataset_dir`` stands for ``images_dir = dataset_dir/images``
        and ``annotations_file = dataset_dir/labels.pkl``.
        ``filter_empty_gt`` drops the tiles without boxes or with a side
        under ``filter_min_size``; without it an empty tile is replaced,
        when drawn, by a tile drawn with ``np.random``."""
        if dataset_dir is not None:
            images_dir = os.path.join(dataset_dir, "images")
            annotations_file = os.path.join(dataset_dir, "labels.pkl")
        self.images_dir = os.path.abspath(images_dir)
        self.annotations_file = os.path.abspath(annotations_file)
        self.transforms = Compose(transforms)
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.filter_empty_gt = filter_empty_gt
        self.max_gt = max_gt
        self._pool = None
        # (rank, world) of a data-parallel run: with workers, ``batches``
        # yields the rank's rows of each global batch (set by the runner)
        self.shard = None

        with open(self.annotations_file, "rb") as f:
            self.img_infos = pickle.load(f)
        if filter_empty_gt:
            self.img_infos = [
                info for info in self.img_infos
                if len(info["ann"]["bboxes"]) > 0
                and min(info["width"], info["height"]) >= filter_min_size]
        self.total_len = len(self.img_infos)

    def __len__(self):
        return self.total_len

    def _read_ann_info(self, idx: int):
        while True:
            info = self.img_infos[idx]
            if len(info["ann"]["bboxes"]) > 0:
                break
            idx = int(np_random().randint(self.total_len))
        ann = info["ann"]
        img_path = os.path.join(self.images_dir, info["filename"])
        image = load_rgb(img_path)
        width, height = image.size
        ignore = ann.get("bboxes_ignore", np.zeros((0, 5), np.float32))
        hboxes, polys = rotated_box_to_bbox_np(ann["bboxes"])
        hboxes_ig, polys_ig = rotated_box_to_bbox_np(ignore)
        target = dict(
            rboxes=np.asarray(ann["bboxes"], np.float32),
            hboxes=hboxes, polys=polys,
            labels=np.asarray(ann["labels"], np.int32),
            rboxes_ignore=np.asarray(ignore, np.float32),
            hboxes_ignore=hboxes_ig, polys_ignore=polys_ig,
            classes=self.CLASSES,
            ori_img_size=(width, height), img_size=(width, height),
            scale_factor=1.0, filename=info["filename"],
            img_file=img_path)
        return image, target

    def __getitem__(self, idx: int):
        image, target = self._read_ann_info(idx)
        return self.transforms(image, target)

    def batches(self, seed: Optional[int] = None) -> Iterator:
        """(images, targets, metas) batches of one epoch: in order, or
        shuffled by ``np.random.RandomState(seed)``; the last short batch
        kept unless ``drop_last``. With ``num_workers > 0`` the samples of
        a batch are read on a thread pool (PIL decode and the numpy
        transforms release the GIL): this thread draws one seed per sample
        from ``np.random``, in order, and each sample draws its
        augmentations from generators of that seed (``own_draws``), so a
        seeded epoch gives the same batches whatever the threads' order.
        With no workers the samples draw from the global generators, in
        the JAX package's order.

        With workers and ``shard`` = (rank, world) a batch is the rank's
        rows of the global batch: the rank reads only its samples, the
        seeds drawn for the whole batch (so each sample draws what it
        draws in one process), and collates them to their own largest
        image (the runner pads them to the global batch's shape). The
        world size must divide every batch, the last one too."""
        order = np.arange(self.total_len)
        if self.shuffle:
            np.random.RandomState(seed).shuffle(order)
        nb = self.total_len // self.batch_size if self.drop_last \
            else -(-self.total_len // self.batch_size)
        pool = self._worker_pool()
        for b in range(nb):
            idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
            if len(idxs) == 0:
                break
            if pool is not None:
                mine = self._shard_rows(len(idxs))
                seeds = np.random.randint(2**31, size=len(idxs))
                items = list(pool.map(self._own_draws_item, idxs[mine],
                                      seeds[mine]))
            else:
                items = [self[int(i)] for i in idxs]
            samples = [(np.asarray(img, np.float32), tgt)
                       for img, tgt in items]
            images, targets = collate_batch(samples, self.max_gt)
            yield images, targets, [tgt for _, tgt in items]

    def _shard_rows(self, n: int) -> slice:
        """The rank's rows of a batch of ``n``."""
        if self.shard is None:
            return slice(None)
        rank, world = self.shard
        if n % world:
            raise ValueError(f"a batch of {n} does not split over a world "
                             f"of {world} processes")
        k = n // world
        return slice(rank * k, (rank + 1) * k)

    def _own_draws_item(self, idx, seed):
        with own_draws(int(seed)):
            return self[int(idx)]

    def _worker_pool(self):
        """One pool per dataset, made at first use and kept across
        epochs (an abandoned epoch would leave a per-epoch pool's threads
        waiting)."""
        if self.num_workers <= 0:
            return None
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
        return self._pool

    def close(self):
        """Release the worker pool (safe to call again)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def prefetch(self, seed=None, depth: int = 2) -> Iterator:
        """``batches(seed)`` made ``depth`` batches ahead by a background
        thread. An error there is raised here; closing the iterator early
        stops the thread."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        done = threading.Event()
        end = object()

        def put(item):
            while not done.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for item in self.batches(seed):
                    if not put(item):
                        return
                put(end)
            except BaseException as e:  # handed to the consumer
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            done.set()
            t.join()

    def evaluate(self, results, work_dir, epoch, logger=None):
        raise NotImplementedError(f"{type(self).__name__} has no evaluation")
