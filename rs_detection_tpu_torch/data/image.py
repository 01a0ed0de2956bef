"""Unlabeled test-tile dataset (counterpart of
``rs_detection_tpu/data/image.py``): carries ``img_file``,
``ori_img_size`` and ``scale_factor`` through to the merge step, and
tags flip-TTA batches with their ``flip_mode``."""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

from ..utils.general import list_images
from ..utils.registry import DATASETS
from .collate import collate_batch
from .io import load_rgb
from .transforms import Compose


@DATASETS.register_module()
class ImageDataset:
    """The images under ``images_dir`` (or the paths in ``images_file``),
    sorted. ``num_workers``, ``shuffle`` and ``max_gt`` are accepted and
    unused, as in the JAX dataset: batches are read in order, on the
    caller's thread."""

    def __init__(self, images_dir=None, images_file=None,
                 dataset_type="DOTA", transforms=None, batch_size=1,
                 num_workers=0, shuffle=False, max_gt=1):
        self.images = (list_images(images_dir) if images_dir
                       else list(images_file))
        self.dataset_type = dataset_type
        self.transforms = Compose(transforms)
        self.batch_size = batch_size
        self.total_len = len(self.images)

    def __len__(self):
        return self.total_len

    def __getitem__(self, idx: int):
        path = self.images[idx]
        image = load_rgb(path)
        target = dict(
            ori_img_size=image.size,
            img_size=image.size,
            scale_factor=1.0,
            img_file=path,
            filename=os.path.basename(path),
        )
        return self.transforms(image, target)

    def batches(self, flip_mode: Optional[str] = None) -> Iterator:
        """Yield (images, targets, metas); ``flip_mode`` in {None, 'H',
        'V', 'HV'} flips the transformed images for test-time
        augmentation (the merge step flips the boxes back). The last
        batch is padded with zero images whose meta is None."""
        nb = -(-self.total_len // self.batch_size)
        for b in range(nb):
            idxs = range(b * self.batch_size,
                         min((b + 1) * self.batch_size, self.total_len))
            samples, metas = [], []
            for i in idxs:
                img, tgt = self[i]
                arr = np.asarray(img, np.float32)
                if flip_mode:
                    if "H" in flip_mode:
                        arr = arr[:, ::-1]
                    if "V" in flip_mode:
                        arr = arr[::-1]
                    tgt["flip_mode"] = flip_mode
                samples.append((np.ascontiguousarray(arr), tgt))
                metas.append(tgt)
            while len(samples) < self.batch_size:
                samples.append((np.zeros_like(samples[0][0]), None))
                metas.append(None)
            images, targets = collate_batch(samples, max_gt=1)
            yield images, targets, metas
